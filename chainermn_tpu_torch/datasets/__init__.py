"""Datasets: rank shards (port of ``chainermn_tpu/datasets``'s
``scatter_dataset``)."""

from .scatter_dataset import (
    SubDataset,
    scatter_dataset,
    scatter_index,
    weighted_shard_counts,
)

__all__ = ["SubDataset", "scatter_dataset", "scatter_index",
           "weighted_shard_counts"]
