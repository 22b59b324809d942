"""Utilities: the synthetic datasets of the examples."""

from .toy_datasets import (SyntheticImageDataset,
                           SyntheticTranslationDataset, get_mnist)

__all__ = ["SyntheticImageDataset", "SyntheticTranslationDataset",
           "get_mnist"]
