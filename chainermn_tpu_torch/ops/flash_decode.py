"""Flash decode: single-token attention against a paged KV cache.

The port of ``chainermn_tpu.ops.pallas_attention.flash_decode`` (the
TPU kernel ``_flash_decode_kernel``, pallas_attention.py:1271).  On a
CUDA tensor :func:`flash_decode` launches the hand-written Hopper kernel
``csrc/flash_decode.cu`` (built by ``nvcc`` at first use) or raises; it
never falls back.  On a CPU tensor it runs the plain PyTorch version,
:func:`paged_decode_reference`, which is what the CPU tests hold against
the JAX package.

The kernel splits each slot's live pages across blocks (split-K,
"flash-decoding"): :func:`decode_splits` picks the number of splits on
the host from the batch, the heads and the card's SM count, without
reading ``lengths``; the last block of each (slot, head) merges the
splits in the same launch.  ``flash_decode.launches`` counts wrapper
calls that launched it (the CPU path does not count), so a run can show
that its decode steps went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128, 256)
_ENTRY = {torch.bfloat16: "flash_decode_bf16",
          torch.float32: "flash_decode_f32"}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None
# (slot, head) arrival counters by (device, stream): zeros when made, and
# each launch leaves them zero
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}
_SM_COUNT: Dict[int, int] = {}
# (slot, head, split) blocks wanted on every SM
BLOCKS_PER_SM = 4

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
    pps = block_tables.shape[1]
    splits = decode_splits(b, h, pps, _sm_count(q.device.index))
    work = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _counters(q.device, stream, b * h)
        lib = _library()
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            work.data_ptr(), counters.data_ptr(), b, h, d, page_size, pps,
            splits, float(scale), stream,
        )
    if err:
        raise RuntimeError(
            "flash_decode kernel launch failed: "
            + lib.flash_decode_error_string(err).decode()
        )
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def decode_splits(batch: int, heads: int, pages_per_slot: int,
                  sm_count: int) -> int:
    """How many splits the kernel cuts each slot's live pages into:
    enough (slot, head, split) blocks for :data:`BLOCKS_PER_SM` on each
    of ``sm_count`` SMs, and no more than the table has pages.  On the
    device a slot of ``n`` live pages gives each split ``ceil(n /
    splits)`` whole pages."""
    want = -(-BLOCKS_PER_SM * sm_count // max(batch * heads, 1))
    return max(1, min(want, pages_per_slot))


def design(dtype, d: int, batch: int, heads: int, pages_per_slot: int,
           device="cuda") -> dict:
    """How the kernel cuts a launch at these shapes on ``device``'s
    card: its splits and blocks, the K/V rows a block stages at a time,
    the depth of its copy ring and where the splits merge (builds the
    library)."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    splits = decode_splits(batch, heads, pages_per_slot, _sm_count(index))
    lib = _library()
    return {"source": "csrc/flash_decode.cu", "splits": splits,
            "blocks": batch * heads * splits,
            "chunk_rows": lib.flash_decode_chunk(_DTYPE_CODE[dtype], d),
            "ring_stages": lib.flash_decode_stages(),
            "copies": "cp.async 16-byte",
            "merge": "last block of each (slot, head), same launch"}


def _sm_count(index: int) -> int:
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The (slot, head) arrival counters of launches on ``stream`` of
    the CUDA ``device``: made zero once, and left zero by every launch
    (the merging block resets its counter), so launches on one stream
    share them."""
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return c


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
            fn.argtypes = [ptr] * 8 + [i32] * 6 + [ctypes.c_float, ptr]
            fn.restype = i32
        lib.flash_decode_chunk.argtypes = [i32, i32]
        lib.flash_decode_chunk.restype = i32
        lib.flash_decode_stages.argtypes = []
        lib.flash_decode_stages.restype = i32
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
