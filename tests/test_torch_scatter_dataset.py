"""Port parity of dataset scattering: ``scatter_index`` and
``scatter_dataset`` give the JAX package's shards exactly (the same
``np.random.RandomState(seed).permutation``, weights and equalized
wrap-pad)."""

import itertools

import numpy as np
import pytest

from chainermn_tpu.datasets import scatter_dataset as jax_scatter_dataset
from chainermn_tpu.datasets import scatter_index as jax_scatter_index
from chainermn_tpu.datasets import weighted_shard_counts as jax_counts
from chainermn_tpu_torch.datasets import (
    scatter_dataset,
    scatter_index,
    weighted_shard_counts,
)


class _Comm:
    """A rank's view of a world for the metadata-only scatter: its rank,
    the world size, and a seed broadcast (rank 0's seed wins)."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def bcast_obj(self, obj, root=0):
        return obj


class _JaxComm(_Comm):
    process_count, process_index = 1, 0


GRID = list(itertools.product((0, 1, 7, 10, 33), (1, 2, 3, 4),
                              (False, True), (True, False)))


@pytest.mark.parametrize("n,size,shuffle,equalize", GRID)
def test_scatter_index_identical(n, size, shuffle, equalize):
    for rank in range(size):
        got = scatter_index(n, size, rank, shuffle=shuffle, seed=5,
                            equalize=equalize)
        ref = jax_scatter_index(n, size, rank, shuffle=shuffle, seed=5,
                                equalize=equalize)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]


@pytest.mark.parametrize("weights", [(1, 1, 1), (3, 1, 1), (0, 2, 1),
                                     (0.5, 0.25, 0.25)])
@pytest.mark.parametrize("equalize", [True, False])
def test_weighted_shards_identical(weights, equalize):
    assert weighted_shard_counts(31, weights, min_count=1) == jax_counts(
        31, weights, min_count=1)
    for rank in range(3):
        got = scatter_index(31, 3, rank, shuffle=True, seed=2,
                            equalize=equalize, weights=weights)
        ref = jax_scatter_index(31, 3, rank, shuffle=True, seed=2,
                                equalize=equalize, weights=weights)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]
    with pytest.raises(ValueError):
        weighted_shard_counts(10, (-1, 1))


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_scatter_dataset_shards_identical(size, shuffle):
    data = [f"row{i}" for i in range(23)]
    for rank in range(size):
        got = scatter_dataset(data, _Comm(rank, size), shuffle=shuffle,
                              seed=9)
        ref = jax_scatter_dataset(data, _JaxComm(rank, size),
                                  shuffle=shuffle, seed=9, rank=rank,
                                  n_shards=size)
        np.testing.assert_array_equal(got.indices, ref.indices)
        assert len(got) == len(ref) == -(-23 // size)
        assert [got[i] for i in range(len(got))] == list(ref[:])
        assert got[-1] == ref[-1] and got[0:2] == ref[0:2]
