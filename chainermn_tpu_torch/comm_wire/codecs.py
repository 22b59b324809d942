"""Wire codecs: what the bytes of a gradient bucket look like in flight.

Port of ``chainermn_tpu/comm_wire/codecs.py`` for the cast codecs
(``WireConfig``, ``codec_of_dtype``, ``resolve_wire``,
``reduce_buckets``).  Each bucket costs one ``torch.distributed``
all-reduce (NCCL on cards):

========  ==============  =========================================
codec     wire bytes/elt  mechanism
========  ==============  =========================================
none      native          all-reduce in the bucket's own dtype
f32       4               upcast wire (for sub-f32 grads)
bf16      2               cast -> all-reduce -> cast back -> /n
f16       2               cast -> all-reduce -> cast back -> /n
========  ==============  =========================================

The mean divide happens AFTER casting back to the bucket's native
dtype, ``sum(cast(g)).to(native) / n``, as in the JAX package
(codecs.py:195-197): dividing on the wire would round twice.  Both cast
legs run through the hand-written ``fused_cast_scale`` kernel (K1,
``ops/fused_cast_scale.py``), where XLA fuses the converts in the JAX
package: to the wire with scale 1, and back with the divide folded in
as a multiply by ``1/n`` where that is exact (see
:func:`reduce_buckets`).  A codec whose wire dtype is the bucket's own
(``none``, and ``f32`` over fp32 buckets) casts nothing and launches no
kernel.  ``int8`` and error feedback wait for the next wire slice
(ROADMAP Queue 1, "Gradient wire, tier 1b").
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.fused_cast_scale import fused_cast_scale
from .planner import DEFAULT_BUCKET_BYTES, DEFAULT_MAX_BUCKETS

CODECS = ("none", "f32", "bf16", "f16")
_CAST_WIRE = {"f32": torch.float32, "bf16": torch.bfloat16,
              "f16": torch.float16}
_WAITING = ("int8",)


class WireConfig(NamedTuple):
    """Wire spec: codec and the bucket plan's knobs."""

    codec: str = "none"
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    max_buckets: int = DEFAULT_MAX_BUCKETS

    def validate(self) -> "WireConfig":
        if self.codec in _WAITING:
            raise NotImplementedError(
                f"wire codec {self.codec!r} is not ported yet: see ROADMAP "
                "Queue 1 'Gradient wire, tier 1b'"
            )
        if self.codec not in CODECS:
            raise ValueError(
                f"unknown wire codec {self.codec!r}; one of {CODECS}"
            )
        return self


def codec_of_dtype(dtype) -> str:
    """The codec of ChainerMN's ``allreduce_grad_dtype`` (float16 ->
    ``f16``, bfloat16 -> ``bf16``, float32 -> ``f32``, None -> ``none``)."""
    if dtype is None:
        return "none"
    from ..communicators.communicator_base import as_torch_dtype

    d = as_torch_dtype(dtype)
    for name, wd in _CAST_WIRE.items():
        if d == wd:
            return name
    raise ValueError(
        f"allreduce_grad_dtype {d} has no wire codec; use one of "
        f"{sorted(_CAST_WIRE)}"
    )


def resolve_wire(wire, comm) -> WireConfig:
    """Normalise the ``wire=`` argument of the multi-node optimizer:
    ``None``/``"auto"`` derives the codec from the communicator's
    ``allreduce_grad_dtype``; a codec name or a :class:`WireConfig`
    selects explicitly.  (The JAX package's ``"per_leaf"`` escape hatch
    is not ported: the port has one wire.)"""
    if wire is None or wire == "auto":
        codec = codec_of_dtype(getattr(comm, "allreduce_grad_dtype", None))
        return WireConfig(codec=codec).validate()
    if isinstance(wire, WireConfig):
        return wire.validate()
    if isinstance(wire, str):
        return WireConfig(codec=wire).validate()
    raise ValueError(
        f"wire must be None, 'auto', a codec name or a WireConfig; got "
        f"{wire!r}"
    )


def _fuses_divide(n: int, native: torch.dtype) -> bool:
    """Whether the cast back may multiply by ``1/n`` in place of the
    JAX order, cast back *then* divide (see :func:`reduce_buckets`)."""
    return native == torch.float32 and n > 0 and n & (n - 1) == 0


def reduce_buckets(buckets: Sequence[torch.Tensor], n: int,
                   config: WireConfig, group=None) -> List[torch.Tensor]:
    """Mean-reduce flat wire buckets over the ``n`` ranks of ``group``
    with the configured codec: one all-reduce per bucket.  Returns the
    means in each bucket's native dtype (new tensors; the inputs are
    not modified).

    A cast codec launches ``fused_cast_scale`` twice per bucket: to the
    wire dtype, then back.  The JAX order is cast back, *then* divide
    by ``n``; the kernel multiplies by a scale in fp32.  For an fp32
    bucket with ``n`` a power of two the two agree bit for bit: the
    wire value is exact in fp32 and ``1/n`` is exact, so ``x * (1/n)``
    and ``x / n`` are one real number, rounded once either way; the
    divide is fused into the cast back.  Otherwise the kernel casts
    back with scale 1 and the divide follows it: ``1/3`` is inexact,
    and a bf16 or fp16 bucket rounds on the cast back, so folding the
    divide in would skip the JAX order's second rounding where ``x/n``
    leaves the type's normal range (fp16 gradients below 2^-14 * n)."""
    wire_dtype: Optional[torch.dtype] = _CAST_WIRE.get(config.codec)
    if config.codec not in CODECS:
        raise ValueError(f"unknown wire codec {config.codec!r}")
    means = []
    for g in buckets:
        if wire_dtype is None or wire_dtype == g.dtype:
            w = g.clone()
            dist.all_reduce(w, group=group)
            means.append(w / n)
            continue
        w = fused_cast_scale(g, 1.0, wire_dtype)
        dist.all_reduce(w, group=group)
        if _fuses_divide(n, g.dtype):
            means.append(fused_cast_scale(w, 1.0 / n, g.dtype))
        else:
            means.append(fused_cast_scale(w, 1.0, g.dtype).div_(n))
    return means
