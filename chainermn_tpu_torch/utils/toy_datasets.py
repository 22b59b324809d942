"""Toy datasets (port of ``chainermn_tpu/utils/toy_datasets.py``):
deterministic synthetic classification sets with the shapes of MNIST
and ImageNet and a learnable signal (class centroids + noise), so the
examples' loss has to go down, and the toy translation corpus of the
seq2seq examples.  The arrays are the JAX package's,
bit for bit, from the same seeds: both are numpy.  A real ``mnist.npz``
is read where one is given (``path=`` or ``CHAINERMN_TORCH_MNIST``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

MNIST_ENV = "CHAINERMN_TORCH_MNIST"


class SyntheticImageDataset:
    """Classification dataset: per-class centroid + Gaussian noise.
    Items are ``(x, y)``: ``x`` of ``shape`` in ``dtype``, ``y`` an
    int32 label."""

    def __init__(self, n: int, shape: Tuple[int, ...] = (28, 28),
                 n_classes: int = 10, seed: int = 0, noise: float = 0.35,
                 dtype=np.float32, centroid_seed: int = 12345):
        # the centroids (the task) are seeded apart from the samples, so
        # train and test splits share classes
        self._centroids = np.random.RandomState(centroid_seed).randn(
            n_classes, *shape).astype(dtype)
        rng = np.random.RandomState(seed)
        self._labels = rng.randint(0, n_classes, size=n).astype(np.int32)
        self._noise = noise
        self._shape = shape
        self._dtype = dtype
        self._n = n
        # per-sample noise seeded by index: O(1) memory at any size
        self._seed = seed

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if not -self._n <= i < self._n:
            raise IndexError(i)
        if i < 0:
            i += self._n
        y = self._labels[i]
        rng = np.random.RandomState((self._seed * 1_000_003 + i) % (2**31))
        x = self._centroids[y] + self._noise * rng.randn(*self._shape).astype(
            self._dtype)
        return x.astype(self._dtype), np.int32(y)


class SyntheticTranslationDataset:
    """Deterministic toy "translation" corpus for the seq2seq examples,
    in place of ChainerMN's WMT En-Fr: each source is a random token
    sequence; its target the reversed source mapped through a fixed
    vocabulary permutation (``RandomState(9876)``), then EOS and PAD.
    Items are ``(src (max_len,) int32, tgt (max_len + 1,) int32)``."""

    def __init__(self, n: int, vocab: int = 32, max_len: int = 8,
                 seed: int = 0):
        from ..models.seq2seq import EOS, N_SPECIAL, PAD

        self._pad, self._eos, self._n_special = PAD, EOS, N_SPECIAL
        self._n = n
        self._vocab = vocab
        self._max_len = max_len
        self._seed = seed
        # the "language": a fixed permutation of the non-special tokens
        perm = np.random.RandomState(9876).permutation(vocab - N_SPECIAL)
        self._map = np.concatenate(
            [np.arange(N_SPECIAL), perm + N_SPECIAL]).astype(np.int32)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if not -self._n <= i < self._n:
            raise IndexError(i)
        if i < 0:
            i += self._n
        rng = np.random.RandomState((self._seed * 999_983 + i) % (2**31))
        length = rng.randint(2, self._max_len + 1)
        src = rng.randint(self._n_special, self._vocab, size=length)
        tgt = self._map[src[::-1]]
        src_p = np.full((self._max_len,), self._pad, np.int32)
        src_p[:length] = src
        tgt_p = np.full((self._max_len + 1,), self._pad, np.int32)
        tgt_p[:length] = tgt
        tgt_p[length] = self._eos
        return src_p, tgt_p


def get_mnist(path: Optional[str] = None, n_train: int = 60000,
              n_test: int = 10000, seed: int = 0):
    """(train, test) datasets of ((28, 28) float32, int32 label) pairs:
    real MNIST from an ``mnist.npz`` where one is given, else the
    synthetic stand-in of the same shapes."""
    path = path or os.environ.get(MNIST_ENV)
    if path and os.path.exists(path):
        with np.load(path) as d:
            xtr = d["x_train"].astype(np.float32) / 255.0
            ytr = d["y_train"].astype(np.int32)
            xte = d["x_test"].astype(np.float32) / 255.0
            yte = d["y_test"].astype(np.int32)
        train = [(xtr[i], ytr[i]) for i in range(len(xtr))]
        test = [(xte[i], yte[i]) for i in range(len(xte))]
        return train, test
    train = SyntheticImageDataset(n_train, seed=seed)
    test = SyntheticImageDataset(n_test, seed=seed + 1)
    return train, test
