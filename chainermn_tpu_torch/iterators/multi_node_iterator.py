"""Multi-node iterator (port of
``chainermn_tpu/iterators/multi_node_iterator.py``; ChainerMN's
``create_multi_node_iterator(actual_iterator, comm, rank_master=0)``):
every rank receives the master's batch stream, the pattern of model
parallelism, where every stage needs the same input.  Each rank draws
from its own iterator, as the JAX one does, and the master's batch
replaces it (``bcast_obj``) when the world has more than one rank.
"""

from __future__ import annotations


class _MultiNodeIterator:
    def __init__(self, actual_iterator, comm, rank_master: int = 0):
        self._it = actual_iterator
        self._comm = comm
        self._rank_master = rank_master

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        if self._comm.size > 1:
            batch = self._comm.bcast_obj(batch, root=self._rank_master)
        return batch

    next = __next__

    def __getattr__(self, name):
        it = self.__dict__.get("_it")
        if it is None:
            raise AttributeError(name)
        return getattr(it, name)


def create_multi_node_iterator(actual_iterator, comm, rank_master: int = 0):
    """Every rank sees ``rank_master``'s batches (see the module
    docstring)."""
    return _MultiNodeIterator(actual_iterator, comm, rank_master)
