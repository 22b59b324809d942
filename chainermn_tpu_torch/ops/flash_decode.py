"""Flash decode: single-token attention against a paged KV cache.

The port of ``chainermn_tpu.ops.pallas_attention.flash_decode`` (the
TPU kernel ``_flash_decode_kernel``, pallas_attention.py:1271).  On a
CUDA tensor :func:`flash_decode` launches the hand-written Hopper kernel
``csrc/flash_decode.cu`` (built by ``nvcc`` at first use) or raises; it
never falls back.  On a CPU tensor it runs the plain PyTorch version,
:func:`paged_decode_reference`, which is what the CPU tests hold against
the JAX package.

``flash_decode.launches`` counts kernel launches (the CPU path does not
count), so a run can show that its decode steps went through the
kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128, 256)
_ENTRY = {torch.bfloat16: "flash_decode_bf16",
          torch.float32: "flash_decode_f32"}
_LIB: Optional[ctypes.CDLL] = None

# The kernel against paged_decode_reference on the same inputs
# (``torch.testing.assert_close`` arguments).  Both accumulate in fp32;
# they differ only in summation order (~1e-7 relative over <= 2048
# positions) and then round once to the output type.  In bf16 that can
# move an element by one bf16 ulp where the two fp32 results straddle a
# rounding boundary, and one ulp is at most 2^-7 of the element: so
# rtol 2^-7, with an atol far below any output's ulp for elements near
# zero.  Rounding the scores or the softmax weights to bf16 inside the
# kernel would exceed it.
TOLERANCE = {torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5),
             torch.float32: dict(rtol=1e-5, atol=1e-6)}


def flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Single-token paged-cache attention: each batch slot's one query
    attends against the pages its block table names.

    Args:
      q: (batch, heads, d), one query per decode slot.
      k_pages / v_pages: (num_pages, page_size, heads, d), the shared
        page pool of one layer (``serving.kv_cache.PagedKVCache``).
      block_tables: (batch, pages_per_slot) int32 page ids per slot.
      lengths: (batch,) int32 live cache positions per slot (the new
        token's k/v already written, so a decoding slot passes
        ``cached + 1``).  Length-0 slots return zeros.
    Returns:
      (batch, heads, d) in ``q.dtype``.

    Numerics: fp32 online softmax over the live positions; agrees with
    :func:`paged_decode_reference` (one exact fp32 softmax over the
    gathered cache) within :data:`TOLERANCE`.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, block_tables,
                                      lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_decode runs on CUDA (kernel) or CPU (plain version), "
            f"not {q.device}"
        )
    _check_args(q, k_pages, v_pages, block_tables, lengths)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    b, h, d = q.shape
    page_size = k_pages.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib = _library()
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, d, page_size, block_tables.shape[1], float(scale), stream,
        )
    if err:
        raise RuntimeError(
            "flash_decode kernel launch failed: "
            + lib.flash_decode_error_string(err).decode()
        )
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def _check_args(q, k_pages, v_pages, block_tables, lengths) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_decode kernel takes bf16 or fp32, got {q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("block_tables", block_tables), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "lengths": lengths}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3:
        raise ValueError(f"q must be (batch, heads, d), got {tuple(q.shape)}")
    b, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if k_pages.dim() != 4 or k_pages.shape[2:] != (h, d):
        raise ValueError(
            f"k_pages must be (num_pages, page_size, {h}, {d}), got "
            f"{tuple(k_pages.shape)}"
        )
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"v_pages {tuple(v_pages.shape)} != k_pages "
                         f"{tuple(k_pages.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be ({b}, pages_per_slot), got "
                         f"{tuple(block_tables.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_decode")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 6 + [i32] * 5 + [ctypes.c_float, ptr]
            fn.restype = i32
        lib.flash_decode_error_string.argtypes = [i32]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def paged_decode_reference(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`flash_decode`: gather every slot's pages
    into a contiguous buffer and run one exact fp32 softmax.  Same
    masking contract (positions >= length dead; length 0 -> zeros)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b = q.shape[0]
    page_size = k_pages.shape[1]
    bt = block_tables.long()
    kg = k_pages[bt]  # (b, n, page_size, h, d)
    vg = v_pages[bt]
    n_tot = kg.shape[1] * page_size
    kg = kg.reshape(b, n_tot, *kg.shape[3:]).float()
    vg = vg.reshape(b, n_tot, *vg.shape[3:]).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float() * scale, kg)
    pos = torch.arange(n_tot, device=q.device)[None, None, :]
    live = pos < lengths.long()[:, None, None]
    s = s.masked_fill(~live, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    # divide AFTER the PV product: the kernels' finalize order
    out = torch.einsum("bhk,bkhd->bhd", p, vg) / den
    # a length-0 slot has every position masked, so the softmax above is
    # a mean of garbage: zero it, as the kernels do
    out = out.masked_fill((lengths <= 0)[:, None, None], 0.0)
    return out.to(q.dtype)
