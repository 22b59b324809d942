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
(codecs.py:195-197): dividing on the wire would round twice.  The casts
are ``Tensor.to``, as XLA's converts are in the JAX package.  ``int8``
with error feedback, and the fused cast/scale kernel inside the wire,
wait for the data-parallel wire slice (ROADMAP Queue 1, "Gradient wire,
tier 1b").
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

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


def reduce_buckets(buckets: Sequence[torch.Tensor], n: int,
                   config: WireConfig, group=None) -> List[torch.Tensor]:
    """Mean-reduce flat wire buckets over the ``n`` ranks of ``group``
    with the configured codec: one all-reduce per bucket.  Returns the
    means in each bucket's native dtype (new tensors; the inputs are
    not modified)."""
    wire_dtype: Optional[torch.dtype] = _CAST_WIRE.get(config.codec)
    if config.codec not in CODECS:
        raise ValueError(f"unknown wire codec {config.codec!r}")
    means = []
    for g in buckets:
        w = g.clone() if wire_dtype is None else g.to(wire_dtype, copy=True)
        dist.all_reduce(w, group=group)
        means.append(w.to(g.dtype) / n)
    return means
