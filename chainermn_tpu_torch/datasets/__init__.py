"""Datasets: rank shards and the empty dataset (port of
``chainermn_tpu/datasets``)."""

from .empty_dataset import create_empty_dataset
from .scatter_dataset import (
    SubDataset,
    rescatter,
    scatter_dataset,
    scatter_dataset_all,
    scatter_index,
    weighted_shard_counts,
)

__all__ = ["SubDataset", "create_empty_dataset", "rescatter",
           "scatter_dataset", "scatter_dataset_all", "scatter_index",
           "weighted_shard_counts"]
