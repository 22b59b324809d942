"""Synchronized iterator (port of
``chainermn_tpu/iterators/synchronized_iterator.py``; ChainerMN's
``create_synchronized_iterator(actual_iterator, comm)``): every rank
draws the same shuffle order each epoch.

The seed is the communicator's ``sync_seed`` (drawn once, rank 0's
broadcast), mixed with a per-communicator call counter so that two
iterators made from one communicator (train and validation) draw
independent orders.  The reseed is exact integer arithmetic into a
numpy ``RandomState``, so the orders equal the JAX function's for the
same seed and call count.
"""

from __future__ import annotations

import numpy as np


def create_synchronized_iterator(actual_iterator, comm):
    """Reseed ``actual_iterator`` (a ``SerialIterator``, or anything
    drawing its orders from ``_rng``) with the communicator's agreed
    seed, then reset it.  Every rank must make its calls in the same
    order, as the reference's per-call broadcast required."""
    count = getattr(comm, "_sync_iterator_calls", 0)
    comm._sync_iterator_calls = count + 1
    rng = np.random.RandomState(
        (comm.sync_seed + 0x9E3779B9 * count) % (2**31 - 1))
    if hasattr(actual_iterator, "_rng"):
        actual_iterator._rng = rng
        if hasattr(actual_iterator, "reset"):
            actual_iterator.reset()
    return actual_iterator
