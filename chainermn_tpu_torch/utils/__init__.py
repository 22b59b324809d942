"""Utilities: the synthetic datasets of the examples."""

from .toy_datasets import SyntheticImageDataset, get_mnist

__all__ = ["SyntheticImageDataset", "get_mnist"]
