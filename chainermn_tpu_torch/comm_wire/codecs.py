"""Wire codecs: what the bytes of a gradient bucket look like in flight,
and how compressed rounding error is carried forward.

Port of ``chainermn_tpu/comm_wire/codecs.py`` (``WireConfig``,
``codec_of_dtype``, ``resolve_wire``, ``reduce_buckets``).  Each bucket
costs one ``torch.distributed`` all-reduce (NCCL on cards), and the
``int8`` codec one more for all of its buckets together:

========  ==============  =========================================
codec     wire bytes/elt  mechanism
========  ==============  =========================================
none      native          all-reduce in the bucket's own dtype
f32       4               upcast wire (for sub-f32 grads)
bf16      2               cast -> all-reduce -> cast back -> /n
f16       2               cast -> all-reduce -> cast back -> /n
int8      1 (+4/bucket)   per-bucket absmax scale agreed by ONE
                          batched MAX all-reduce, round-to-nearest
                          int8 payload, integer sum, decode
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
kernel.

int8: every rank must quantize on the same grid, so the buckets'
absmaxes are agreed first, all of them in one MAX all-reduce.  The
payload is widened to int32 for the sum (the partial sums of n ranks
leave int8's range).  Its legs are plain PyTorch passes, as they are
XLA's own passes in the JAX package: no TPU kernel computes them.

Error feedback (``error_feedback=True``): the part of each rank's
gradient that the codec rounded away, ``g - decode(encode(g))``, is
carried beside the optimizer and added into the next step's gradient
before encoding.  A cast codec's residual is ``g - cast_back(cast(g))``:
one more K1 launch per bucket, for the cast back of the local payload.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.fused_cast_scale import fused_cast_scale
from .planner import DEFAULT_BUCKET_BYTES, DEFAULT_MAX_BUCKETS

CODECS = ("none", "f32", "bf16", "f16", "int8")
_CAST_WIRE = {"f32": torch.float32, "bf16": torch.bfloat16,
              "f16": torch.float16}
_INT8_MAX = 127.0


class WireConfig(NamedTuple):
    """Wire spec: codec, the bucket plan's knobs, error feedback and the
    per-bucket collective schedule.

    ``schedule``: ``"auto"`` lets the planner pick per bucket
    (``comm_wire.schedules``), ``"flat"`` pins one all-reduce per
    bucket, ``"hier_rs_ag"`` asks for the multi-hop schedule (intra
    reduce-scatter, codec on the inter hop, intra all-gather) wherever
    the communicator has a genuine ``("mn_inter", "mn_intra")`` split.
    """

    codec: str = "none"
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    max_buckets: int = DEFAULT_MAX_BUCKETS
    error_feedback: bool = False
    schedule: str = "auto"

    def validate(self) -> "WireConfig":
        if self.codec not in CODECS:
            raise ValueError(
                f"unknown wire codec {self.codec!r}; one of {CODECS}"
            )
        if self.error_feedback and self.codec in ("none", "f32"):
            raise ValueError(
                f"error_feedback is meaningless for the lossless-or-"
                f"widening {self.codec!r} codec; use bf16/f16/int8"
            )
        from .schedules import GRAD_SCHEDULES

        if self.schedule not in ("auto",) + GRAD_SCHEDULES:
            raise ValueError(
                f"unknown wire schedule {self.schedule!r}; one of "
                f"{('auto',) + GRAD_SCHEDULES}"
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
        f"{sorted(_CAST_WIRE)} (or codec='int8' via a WireConfig)"
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


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` as a true divide on every device.  PyTorch's CUDA divide
    by a Python number multiplies by its reciprocal, one more rounding
    where ``1/n`` is inexact (``1/127``, ``1/3``); a 0-dim tensor on
    ``x``'s device (filled there: no host copy, no sync) keeps the JAX
    package's divide."""
    return x / torch.full((), float(n), dtype=torch.float32, device=x.device)


def uses_error_feedback(config: WireConfig) -> bool:
    """Whether ``config`` carries a residual (a lossy codec with
    ``error_feedback``)."""
    return bool(config.error_feedback) and config.codec not in ("none",
                                                                "f32")


def reduce_buckets(buckets: Sequence[torch.Tensor], n: int,
                   config: WireConfig,
                   residuals: Optional[Sequence[torch.Tensor]] = None,
                   group=None) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Mean-reduce flat wire buckets over the ``n`` ranks of ``group``
    with the configured codec: one all-reduce per bucket, and for
    ``int8`` one MAX all-reduce of every bucket's absmax before them.
    Returns ``(means, new_residuals)``: the means in each bucket's
    native dtype (new tensors; the inputs are not modified), and the
    error-feedback residuals (``[]`` unless the config uses error
    feedback).  ``residuals`` (the buckets' shapes and dtypes) are added
    into the buckets before encoding.

    A cast codec launches ``fused_cast_scale`` twice per bucket: to the
    wire dtype, then back (three times with error feedback: the
    residual casts the local payload back too).  The JAX order is cast
    back, *then* divide by ``n``; the kernel multiplies by a scale in
    fp32.  For an fp32 bucket with ``n`` a power of two the two agree
    bit for bit: the wire value is exact in fp32 and ``1/n`` is exact,
    so ``x * (1/n)`` and ``x / n`` are one real number, rounded once
    either way; the divide is fused into the cast back.  Otherwise the
    kernel casts back with scale 1 and the divide follows it: ``1/3`` is
    inexact, and a bf16 or fp16 bucket rounds on the cast back, so
    folding the divide in would skip the JAX order's second rounding
    where ``x/n`` leaves the type's normal range (fp16 gradients below
    2^-14 * n).

    The int8 legs follow the JAX arithmetic step for step, divides as
    divides: ``scale = max / 127``; ``q = clip(round(g / safe), +-127)``
    (round half to even, ``safe`` = 1 where the scale is 0); the mean
    ``(f32(sum(q)) * scale / n)`` cast to the native dtype; the residual
    ``g - f32(q) * scale``."""
    if config.codec not in CODECS:
        raise ValueError(f"unknown wire codec {config.codec!r}")
    ef = uses_error_feedback(config)
    buckets = list(buckets)
    if residuals:
        buckets = [g + r.to(g.dtype) for g, r in zip(buckets, residuals)]
    if config.codec == "int8":
        if not buckets:
            return [], []
        scales = int8_scales(buckets, group)
        pairs = [reduce_int8(g, scales[i], n, ef, group)
                 for i, g in enumerate(buckets)]
    else:
        wire_dtype = _CAST_WIRE.get(config.codec)
        pairs = [reduce_cast(g, wire_dtype, n, ef, group) for g in buckets]
    return [m for m, _ in pairs], [r for _, r in pairs if r is not None]


def storage_dtype(config: WireConfig, bucket_dtype: torch.dtype) -> torch.dtype:
    """The dtype a stored flat bucket keeps (double buffering's stale
    gradients): a cast codec's wire dtype unless that would widen the
    gradient (an f32 wire over bf16 buckets); ``none`` and ``int8``
    store natively (int8's grid is agreed only at the sync).  Parity:
    ``chainermn_tpu.comm_wire.codecs.storage_dtype``."""
    wd = _CAST_WIRE.get(config.codec)
    if wd is None or wd.itemsize >= bucket_dtype.itemsize:
        return bucket_dtype
    return wd


def encode_cast(g: torch.Tensor, wire_dtype: Optional[torch.dtype],
                ef: bool):
    """A cast codec's first leg (``wire_dtype`` None: codec ``none``):
    ``(payload to all-reduce, residual or None)``.  The payload is a new
    tensor, so the all-reduce may run in place on it."""
    if wire_dtype is None or wire_dtype == g.dtype:
        return g.clone(), (g - g if ef else None)
    w = fused_cast_scale(g, 1.0, wire_dtype)
    # the residual casts the local payload back before the all-reduce
    # overwrites it
    res = g - fused_cast_scale(w, 1.0, g.dtype) if ef else None
    return w, res


def decode_cast(w: torch.Tensor, native: torch.dtype, n: int) -> torch.Tensor:
    """A cast codec's second leg: the summed payload ``w`` back in the
    ``native`` dtype, divided by ``n`` (see :func:`reduce_buckets` for
    when the divide folds into K1's cast)."""
    if w.dtype == native:
        return _div(w, n)
    if _fuses_divide(n, native):
        return fused_cast_scale(w, 1.0 / n, native)
    return _div(fused_cast_scale(w, 1.0, native), n)


def reduce_cast(g: torch.Tensor, wire_dtype: Optional[torch.dtype], n: int,
                ef: bool, group=None):
    """One bucket through a cast codec (``wire_dtype`` None: codec
    ``none``): ``(mean, residual or None)``."""
    w, res = encode_cast(g, wire_dtype, ef)
    dist.all_reduce(w, group=group)
    return decode_cast(w, g.dtype, n), res


def int8_scales(values: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """The shared int8 grid of each tensor: every rank's fp32 absmax,
    maxed over ``group`` in one all-reduce, over 127."""
    absmax = torch.stack([v.float().abs().max() for v in values])
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    return _div(absmax, _INT8_MAX)


def reduce_int8(g: torch.Tensor, scale: torch.Tensor, n: int, ef: bool,
                group=None):
    """One bucket through the int8 codec on the agreed grid ``scale``:
    ``(mean, residual or None)``."""
    gf = g.float()
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(gf / safe), -_INT8_MAX,
                    _INT8_MAX).to(torch.int8)
    summed = q.to(torch.int32)  # int8's range cannot hold n ranks' sum
    dist.all_reduce(summed, group=group)
    mean = _div(summed.float() * scale, n).to(g.dtype)
    res = (gf - q.float() * scale).to(g.dtype) if ef else None
    return mean, res
