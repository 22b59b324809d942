"""Deterministic bucket planner for the gradient wire.

Port of ``chainermn_tpu/comm_wire/planner.py`` (``make_plan``,
``plan_of_tree``, ``BucketPlan.plan_hash``, ``flatten_to_buckets``,
``unflatten_from_buckets``).  A plan is a pure function of the leaves'
shapes and dtypes: leaves, in order, group into contiguous
dtype-homogeneous buckets of a target byte size (4 MiB), coalesced
upward to at most ``max_buckets`` (6); each bucket then costs one
all-reduce.  For the same ordered ``(shape, dtype)`` list the port gives
the same buckets and the same ``plan_hash()`` hex digest as the JAX
package: dtypes are named as numpy names them (``"float32"``), never
``torch.float32``.

The leaf order is the caller's.  The train step passes a
TransformerLM's parameters in flax's flatten order
(``models.convert.flax_ordered_parameters``); their shapes are the
port's own (an ``nn.Linear`` weight is the transpose of the flax
kernel), so bucket sizes and offsets match the JAX plan while the hash
covers the port's shapes.
"""

from __future__ import annotations

import hashlib
from typing import Any, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024
DEFAULT_MAX_BUCKETS = 6


class LeafSlot(NamedTuple):
    """Where one gradient leaf lives inside its bucket."""

    index: int  # position in leaf order
    offset: int  # element offset into the bucket's flat buffer
    size: int  # element count
    shape: Tuple[int, ...]


class Bucket(NamedTuple):
    dtype: str  # numpy dtype name (buckets are dtype-homogeneous)
    size: int  # total elements
    slots: Tuple[LeafSlot, ...]


class BucketPlan(NamedTuple):
    """An ordered tuple of buckets covering every leaf exactly once."""

    buckets: Tuple[Bucket, ...]
    n_leaves: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def plan_hash(self) -> str:
        """Stable content hash: the cross-process agreement token
        (byte-for-byte the JAX package's format)."""
        h = hashlib.sha256()
        h.update(f"n_leaves={self.n_leaves}".encode())
        for b in self.buckets:
            h.update(f"|{b.dtype}:{b.size}".encode())
            for s in b.slots:
                h.update(f";{s.index},{s.offset},{s.size},{s.shape}".encode())
        return h.hexdigest()

    def describe(self) -> str:
        return " ".join(
            f"[{i}]{b.dtype}x{b.size}({len(b.slots)} leaves)"
            for i, b in enumerate(self.buckets)
        )


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``torch.bfloat16`` ->
    ``"bfloat16"``, as ml_dtypes names it)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


def _leaf_spec(leaf) -> Tuple[Tuple[int, ...], str]:
    """(shape, dtype name) of a tensor, an array, or a ``(shape,
    dtype)`` pair."""
    if isinstance(leaf, tuple):
        shape, dtype = leaf
        return tuple(int(s) for s in shape), dtype_name(dtype)
    return tuple(int(s) for s in leaf.shape), dtype_name(leaf.dtype)


def make_plan(leaves: Sequence[Any],
              bucket_bytes: int = DEFAULT_BUCKET_BYTES,
              max_buckets: int = DEFAULT_MAX_BUCKETS) -> BucketPlan:
    """Plan buckets for ``leaves`` (tensors, arrays or ``(shape, dtype)``
    pairs, in order): a greedy walk with one open bucket per dtype, a
    leaf larger than the target in a bucket of its own, and the
    effective bucket size doubled until the plan fits ``max_buckets``
    (floor: one bucket per distinct dtype)."""
    if bucket_bytes < 1:
        raise ValueError(f"bucket_bytes must be >= 1, got {bucket_bytes}")
    specs = [_leaf_spec(leaf) for leaf in leaves]
    if not specs:
        return BucketPlan(buckets=(), n_leaves=0)

    def count(shape) -> int:
        return int(np.prod(shape, dtype=np.int64)) if shape else 1

    def walk(eff_bytes: int) -> List[Bucket]:
        open_slots: dict = {}  # dtype name -> (slots, elems, bytes)
        done: List[Tuple[int, Bucket]] = []

        def close(name):
            slots, elems, _ = open_slots.pop(name)
            done.append((slots[0].index, Bucket(name, elems, tuple(slots))))

        for i, (shape, name) in enumerate(specs):
            size = count(shape)
            nbytes = size * _itemsize(name)
            if name in open_slots:
                _, _, bts = open_slots[name]
                if bts + nbytes > eff_bytes and bts > 0:
                    close(name)
            if name not in open_slots:
                open_slots[name] = ([], 0, 0)
            slots, elems, bts = open_slots[name]
            slots.append(LeafSlot(i, elems, size, tuple(shape)))
            open_slots[name] = (slots, elems + size, bts + nbytes)
        for name in list(open_slots):
            close(name)
        done.sort(key=lambda t: t[0])
        return [b for _, b in done]

    eff = int(bucket_bytes)
    if max_buckets:
        total = sum(count(s) * _itemsize(n) for s, n in specs)
        eff = max(eff, -(-total // int(max_buckets)))
    buckets = walk(eff)
    while max_buckets and len(buckets) > int(max_buckets):
        if len(buckets) <= len({n for _, n in specs}):
            break  # dtype-homogeneity floor reached
        eff *= 2
        buckets = walk(eff)
    return BucketPlan(buckets=tuple(buckets), n_leaves=len(specs))


def plan_of_tree(leaves: Sequence[Any],
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 max_buckets: int = DEFAULT_MAX_BUCKETS) -> BucketPlan:
    """:func:`make_plan` of an ordered leaf list (the port's trees are
    ordered lists; see the module docstring for the order)."""
    return make_plan(list(leaves), bucket_bytes, max_buckets)


def flatten_to_buckets(plan: BucketPlan,
                       leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Pack the leaves into the plan's flat wire buffers, leaf data
    concatenated in leaf order within each bucket."""
    leaves = list(leaves)
    if len(leaves) != plan.n_leaves:
        raise ValueError(
            f"plan covers {plan.n_leaves} leaves; got {len(leaves)}"
        )
    out = []
    for b in plan.buckets:
        parts = [leaves[s.index].reshape(-1) for s in b.slots]
        flat = parts[0].clone() if len(parts) == 1 else torch.cat(parts)
        if dtype_name(flat.dtype) != b.dtype:
            raise ValueError(
                f"leaf dtype drifted from plan: bucket is {b.dtype}, got "
                f"{dtype_name(flat.dtype)} (replan on shape/dtype change)"
            )
        out.append(flat)
    return out


def unflatten_from_buckets(plan: BucketPlan,
                           buckets: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The leaves back out of the flat buffers, in leaf order (views of
    the buffers)."""
    out: List[Any] = [None] * plan.n_leaves
    for b, flat in zip(plan.buckets, buckets):
        for s in b.slots:
            out[s.index] = flat[s.offset:s.offset + s.size].view(s.shape)
    return out
