"""Empty dataset (port of ``chainermn_tpu/datasets/empty_dataset.py``;
ChainerMN's ``create_empty_dataset(dataset)``): a length-preserving
dataset of ``None`` for ranks that only consume activations in
model-parallel execution, which must still step as many times as the
ranks that hold data."""

from __future__ import annotations


class _EmptyDataset:
    def __init__(self, length: int):
        self._length = length

    def __len__(self) -> int:
        return self._length

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [None] * len(range(*i.indices(self._length)))
        if not -self._length <= i < self._length:
            raise IndexError(i)
        return None


def create_empty_dataset(dataset):
    """A dataset of ``None`` as long as ``dataset``."""
    return _EmptyDataset(len(dataset))
