"""Fused cast and scale: ``(x.float() * scale).to(dtype)`` in one pass.

The port of ``chainermn_tpu.ops.pallas_attention.fused_cast_scale`` (the
TPU kernel ``_cast_scale_kernel``, pallas_attention.py:1463), the
counterpart of the cast/scale kernels ChainerMN's PureNcclCommunicator
launches around its reduced-precision all-reduce.  The gradient wire
(``comm_wire.codecs.reduce_buckets``) runs both cast legs of every
bucket through it.

On a CUDA tensor :func:`fused_cast_scale` launches the hand-written
Hopper kernel ``csrc/fused_cast_scale.cu`` (built by ``nvcc`` at first
use) or raises; it never falls back.  On a CPU tensor it runs the plain
PyTorch version, :func:`cast_scale_reference`.  The two are bit-equal:
both round ``scale`` to fp32 once, multiply in fp32 and round once to
``dtype`` (round-to-nearest-even; NaN stays NaN, fp16 overflow is inf).

``fused_cast_scale.launches`` counts kernel launches (the CPU path and
an empty input do not count).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB: Optional[ctypes.CDLL] = None


def _f32(scale: float) -> float:
    """``scale`` rounded to fp32 once, as JAX rounds a weakly typed
    Python float multiplying an fp32 array."""
    return float(np.float32(scale))


def cast_scale_reference(x: torch.Tensor, scale: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`fused_cast_scale`."""
    return (x.float() * _f32(scale)).to(dtype)


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` have the same dtype, shape and bits, NaN
    positions compared as positions (the NaN payload of a conversion
    differs between PyTorch's CPU and CUDA casts): the comparison the
    kernel is held to against :func:`cast_scale_reference`."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    bits = _BITS[a.dtype]
    return torch.equal(a.view(bits)[~nan], b.view(bits)[~nan])


def fused_cast_scale(x: torch.Tensor, scale: float,
                     dtype: torch.dtype) -> torch.Tensor:
    """``(x.float() * scale).to(dtype)`` for ``x`` and ``dtype`` each
    fp32, bf16 or fp16, any shape; returns a new tensor of ``x``'s
    shape.  An empty ``x`` returns an empty tensor without a launch
    (the TPU function's own contract)."""
    if x.device.type == "cpu":
        return cast_scale_reference(x, scale, dtype)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_cast_scale runs on CUDA (kernel) or CPU (plain "
            f"version), not {x.device}")
    for name, dt in (("input", x.dtype), ("output", dtype)):
        if dt not in _CODES:
            raise TypeError(f"fused_cast_scale {name} must be fp32, bf16 "
                            f"or fp16, got {dt}")
    if not x.is_contiguous():
        raise ValueError("fused_cast_scale takes a contiguous tensor (a view "
                         "at any element offset is fine)")
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        lib = _library()
        err = lib.fused_cast_scale(x.data_ptr(), out.data_ptr(), x.numel(),
                                   _CODES[x.dtype], _CODES[dtype],
                                   _f32(scale), stream)
    if err:
        raise RuntimeError("fused_cast_scale kernel launch failed: "
                           + lib.fused_cast_scale_error_string(err).decode())
    fused_cast_scale.launches += 1
    return out


fused_cast_scale.launches = 0


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("fused_cast_scale")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fused_cast_scale.argtypes = [ptr, ptr, ctypes.c_longlong, i32,
                                         i32, ctypes.c_float, ptr]
        lib.fused_cast_scale.restype = i32
        lib.fused_cast_scale_error_string.argtypes = [i32]
        lib.fused_cast_scale_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
