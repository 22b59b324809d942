"""Dataset scattering.

Port of ``chainermn_tpu/datasets/scatter_dataset.py`` (``scatter_index``,
``scatter_dataset``, ``rescatter``, ``scatter_dataset_all`` and the
weighted split they use).  Scattering is
metadata only: every rank agrees on the seed (one object broadcast),
builds the same ``np.random.RandomState(seed).permutation``, and keeps
its slice of indices into the original dataset, so the port's shards,
weights and equalized wrap-pad are identical to the JAX package's.
The port runs one process per card, so a shard is a rank's.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np


class SubDataset:
    """A view of ``dataset`` through ``order[start:end]`` (parity with the
    chainer ``SubDataset`` shards the reference scattered).

    Shards are equalized in length by wrapping around the permutation, so
    all ranks run the same number of iterations per epoch (the reference
    achieved this by slicing near-equal ranges; we pad the short shards).
    """

    def __init__(self, dataset, order: np.ndarray, start: int, end: int):
        self._dataset = dataset
        self._order = order
        self._start = start
        self._end = end

    def __len__(self) -> int:
        return self._end - self._start

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        if i < 0:
            i += len(self)
        return self._dataset[int(self._order[self._start + i])]

    @property
    def indices(self) -> np.ndarray:
        return self._order[self._start : self._end]


def weighted_shard_counts(total: int, weights: Sequence[float], *,
                          min_count: int = 0) -> list:
    """Per-rank sample counts for a weighted split of ``total`` samples.

    Largest-remainder method with DETERMINISTIC remainder placement:
    each rank's quota is ``total * w_r / sum(w)``; floors are taken,
    and the remaining samples go to the largest fractional parts, ties
    broken by the LOWER rank — which makes equal weights reproduce the
    equalized split's "first ``rem`` ranks absorb the remainder"
    pattern exactly.  ``min_count`` lifts short shards (stealing one
    sample at a time from the currently largest shard, ties again to
    the lower rank) so an equalized weighted shard can never be empty.

    An EXPLICIT zero weight is legal and means "this rank owns no
    samples" — the probationary-host contract (scale-up: a candidate
    runs report windows on a weight-0 shard before it may carry state).
    Zero-weight ranks get exactly 0, never receive remainder samples,
    and are exempt from the ``min_count`` lift; at least one weight
    must still be positive (someone has to own the data), and negative
    or non-finite weights stay errors.
    """
    w = np.asarray(list(weights), dtype=np.float64)
    if w.ndim != 1 or w.size == 0:
        raise ValueError(f"weights must be a non-empty 1-D sequence, "
                         f"got shape {w.shape}")
    if not np.all(np.isfinite(w)) or np.any(w < 0):
        raise ValueError(
            f"weights must be finite and >= 0 (zero = a probationary "
            f"rank owning no samples; demotion, not a negative weight, "
            f"removes a rank); got {list(weights)!r}"
        )
    if not np.any(w > 0):
        raise ValueError(
            f"at least one weight must be > 0, got {list(weights)!r}"
        )
    pos = w > 0
    size = int(w.size)
    total = int(total)
    if min_count * int(np.count_nonzero(pos)) > total:
        raise ValueError(
            f"cannot give {int(np.count_nonzero(pos))} shards >= "
            f"{min_count} sample(s) each from {total} total"
        )
    quota = total * (w / w.sum())
    counts = np.floor(quota).astype(np.int64)
    frac = quota - counts
    # float-noise guards around the exact integer total
    while counts.sum() > total:
        counts[int(np.argmax(counts))] -= 1
    rem = int(total - counts.sum())
    if rem > 0:
        # largest fractional part first; ties -> lowest rank; a
        # zero-weight rank's frac is exactly 0.0 but float noise can
        # zero a positive rank's frac too — the remainder must land on
        # ranks that OWN data
        ranked = [i for i in np.lexsort((np.arange(size), -frac))
                  if pos[i]]
        counts[ranked[:rem]] += 1
    while True:
        short = np.where((counts < min_count) & pos)[0]
        if short.size == 0:
            break
        donor = int(np.argmax(counts))  # ties -> lowest rank
        if counts[donor] <= min_count:
            raise ValueError(
                f"cannot satisfy min_count={min_count} over "
                f"{size} shards of {total} samples"
            )
        counts[donor] -= 1
        counts[int(short[0])] += 1
    return [int(c) for c in counts]


def _weighted_split(order: np.ndarray, size: int, rank: int,
                    weights: Sequence[float], equalize: bool):
    """Weighted contiguous split of ``order``.  With ``equalize`` every
    shard is padded (by wrapping ITS OWN indices — the per-shard form
    of the equal split's wrap-around pad) to the widest shard's length,
    so every rank still steps the same number of times per epoch: the
    lockstep-SPMD contract an adaptive rebalance must not break.

    A weight-0 shard owns NO samples of its own (see
    :func:`weighted_shard_counts`); under ``equalize`` it is padded
    from the HEAD of the epoch permutation — pure re-served padding,
    so the probationary rank still steps in lockstep while drawing
    nothing the data-owning ranks don't already cover."""
    if len(weights) != size:
        raise ValueError(
            f"got {len(weights)} weights for {size} shards"
        )
    counts = weighted_shard_counts(
        len(order), weights, min_count=1 if equalize else 0
    )
    if not equalize:
        offsets = np.concatenate([[0], np.cumsum(counts)])
        return order, int(offsets[rank]), int(offsets[rank + 1])
    width = max(counts)
    segments, off = [], 0
    for c in counts:
        seg = order[off:off + c]
        off += c
        if c == 0:
            # np.resize of an EMPTY segment would fabricate zeros
            # (indices the shard never owned); a weight-0 shard's
            # lockstep pad is the permutation's head instead
            seg = order[:width]
        segments.append(np.resize(seg, width))  # wrap-pad within shard
    out = np.concatenate(segments)
    return out, rank * width, (rank + 1) * width


def scatter_index(n: int, size: int, rank: int, *,
                  shuffle: bool = False, seed: Optional[int] = None,
                  equalize: bool = True,
                  weights: Optional[Sequence[float]] = None,
                  order: Optional[np.ndarray] = None):
    """Index shard for ``rank`` of ``size`` over a dataset of length ``n``,
    as ``(order, start, end)``: the shard is ``order[start:end]``.

    ``weights``: explicit per-rank shard weights (the straggler-adaptive
    rebalance substrate — see :func:`weighted_shard_counts` for the
    deterministic remainder placement).  ``order``: a precomputed base
    permutation to re-split (how a rebalance re-shards the SAME epoch
    permutation under new weights instead of redrawing it).
    """
    if order is None:
        order = np.arange(n)
        if shuffle:
            order = np.random.RandomState(seed).permutation(n)
    else:
        order = np.asarray(order)
    if weights is not None:
        return _weighted_split(order, size, rank, weights, equalize)
    if equalize and len(order) % size:
        pad = size - len(order) % size
        order = np.concatenate([order, order[:pad]])
    per = len(order) // size
    rem = len(order) % size
    start = rank * per + min(rank, rem)
    end = start + per + (1 if rank < rem else 0)
    return order, start, end


def _shard(dataset, base: np.ndarray, n_shards: int, rank: int,
           equalize: bool, weights) -> SubDataset:
    """Shard ``rank`` of ``n_shards`` over the permutation ``base``,
    carrying what :func:`rescatter` needs: ``base_order`` and
    ``scatter_spec``."""
    order, start, end = scatter_index(
        len(dataset), n_shards, rank, equalize=equalize, weights=weights,
        order=base,
    )
    sub = SubDataset(dataset, order, start, end)
    sub.base_order = base
    sub.scatter_spec = {
        "n_shards": int(n_shards), "rank": int(rank),
        "equalize": bool(equalize),
        "weights": None if weights is None
        else tuple(float(w) for w in weights),
    }
    return sub


def _agreed_base(dataset, comm, root: int, shuffle: bool,
                 seed: Optional[int]) -> np.ndarray:
    """The base permutation every rank builds from root's seed."""
    if seed is None:
        seed = int(np.random.randint(0, 2**31 - 1))
    seed = comm.bcast_obj(int(seed), root=root)
    if shuffle:
        return np.random.RandomState(seed).permutation(len(dataset))
    return np.arange(len(dataset))


def scatter_dataset(
    dataset: Sequence[Any],
    comm,
    root: int = 0,
    shuffle: bool = False,
    seed: Optional[int] = None,
    *,
    force_equal_length: bool = True,
    weights: Optional[Sequence[float]] = None,
) -> SubDataset:
    """This rank's shard of ``dataset`` (parity: ChainerMN's
    ``scatter_dataset``): shard ``comm.rank`` of ``comm.size``, padded
    to equal lengths by wrapping unless ``force_equal_length=False``.
    Rank ``root``'s seed wins when ranks pass different ones.  The shard
    carries ``base_order`` and ``scatter_spec`` for :func:`rescatter`."""
    base = _agreed_base(dataset, comm, root, shuffle, seed)
    return _shard(dataset, base, comm.size, comm.rank, force_equal_length,
                  weights)


def rescatter(sub: SubDataset, weights: Sequence[float]) -> SubDataset:
    """Re-shard a scattered dataset under new per-rank ``weights``,
    keeping the original permutation (every rank re-splits the same
    ``base_order``, so agreeing on the weights is agreeing on the new
    shard map).  Only shards made by :func:`scatter_dataset` carry the
    metadata it needs."""
    spec = getattr(sub, "scatter_spec", None)
    base = getattr(sub, "base_order", None)
    if spec is None or base is None:
        raise ValueError(
            "rescatter needs a SubDataset produced by scatter_dataset "
            "(carrying base_order + scatter_spec)"
        )
    return _shard(sub._dataset, base, spec["n_shards"], spec["rank"],
                  spec["equalize"], weights)


def scatter_dataset_all(dataset, comm, shuffle: bool = False,
                        seed: Optional[int] = None) -> list:
    """Every rank's shard at once, in rank order (the JAX package's
    single-controller convenience; here each process sees them all,
    from the one agreed permutation).  ``seed`` defaults to 0."""
    base = _agreed_base(dataset, comm, 0, shuffle, 0 if seed is None
                        else seed)
    return [_shard(dataset, base, comm.size, r, True, None)
            for r in range(comm.size)]
