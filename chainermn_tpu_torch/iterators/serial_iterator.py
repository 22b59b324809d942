"""Epoch-aware batch iterators (port of
``chainermn_tpu/iterators/serial_iterator.py``).

They yield stacked numpy batches; the training loop's ``Updater`` moves
each batch to the card.  From the same seed :class:`SerialIterator`
draws the JAX package's order, batch for batch (both are numpy), and
``serialize``/``restore`` carry its full position and generator state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _collate(samples):
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(np.stack([np.asarray(s[i]) for s in samples])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in first}
    return np.stack([np.asarray(s) for s in samples])


class SerialIterator:
    """Batches of ``batch_size`` samples, reshuffled each epoch when
    ``shuffle``; with ``drop_last`` an epoch ends before a short batch.
    ``epoch``, ``is_new_epoch`` and ``epoch_detail`` follow Chainer's
    iterator."""

    def __init__(self, dataset, batch_size: int, *, repeat: bool = True,
                 shuffle: bool = True, seed: Optional[int] = None,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        self.epoch = 0
        self.is_new_epoch = False
        self._pos = 0
        self._order = self._new_order()

    def _new_order(self):
        n = len(self.dataset)
        return self._rng.permutation(n) if self._shuffle else np.arange(n)

    def reset(self):
        self.epoch = 0
        self._pos = 0
        self.is_new_epoch = False
        self._order = self._new_order()

    @property
    def epoch_detail(self) -> float:
        return self.epoch + self._pos / max(len(self.dataset), 1)

    def __iter__(self):
        return self

    def __next__(self):
        n = len(self.dataset)
        if self._pos >= n or (self._drop_last
                              and self._pos + self.batch_size > n):
            if not self._repeat and self._pos > 0:
                raise StopIteration
            self.epoch += 1
            self.is_new_epoch = True
            self._pos = 0
            self._order = self._new_order()
        else:
            self.is_new_epoch = False
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return _collate([self.dataset[int(i)] for i in idx])

    next = __next__

    def serialize(self) -> dict:
        """The iterator's position, order and full generator state, so a
        restored run reshuffles as the uninterrupted one would.  O(1):
        the order is returned by reference (the iterator replaces it
        each epoch and never writes into it)."""
        kind, keys, pos, has_gauss, cached = self._rng.get_state()
        return {"epoch": self.epoch, "pos": self._pos, "order": self._order,
                "rng_kind": kind, "rng_keys": keys.copy(), "rng_pos": pos,
                "rng_has_gauss": has_gauss, "rng_cached": cached}

    def restore(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        self._rng.set_state((
            str(state["rng_kind"]), np.asarray(state["rng_keys"], np.uint32),
            int(state["rng_pos"]), int(state["rng_has_gauss"]),
            float(state["rng_cached"])))
        # a copy: the state may be restored again, and must not alias
        # the order this iterator goes on with
        self._order = np.array(state["order"])


class EpochIterator:
    """One non-repeating pass over a dataset (the evaluator's).

    ``pad_to``: pad the final partial batch to a multiple of ``pad_to``
    by wrapping to the dataset's start, as the JAX package does so that
    a batch divides over its chips."""

    def __init__(self, dataset, batch_size: int, pad_to: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_to = max(pad_to, 1)

    def __iter__(self):
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            idx = list(range(start, min(start + self.batch_size, n)))
            if len(idx) % self.pad_to:
                pad = self.pad_to - len(idx) % self.pad_to
                idx += [i % n for i in range(pad)]
            yield _collate([self.dataset[i] for i in idx])
