"""Flash attention for training: forward and FlashAttention-2 backward.

The port of ``chainermn_tpu.ops.pallas_attention``'s training kernels:

* :func:`flash_forward` (K2) replaces ``_flash_forward`` /
  ``_flash_fwd_kernel`` (pallas_attention.py:471, :367);
* :func:`flash_backward_dq` (K3) replaces the dq half of
  ``_flash_backward`` (``_flash_bwd_dq_kernel``, :822, :619);
* :func:`flash_backward_dkv` (K4) replaces its dk/dv half
  (``_flash_bwd_dkv_kernel``, :747).

On CUDA tensors each wrapper launches its hand-written Hopper kernel,
built by ``nvcc`` at first use, or raises; it never falls back.  In
bf16, K2, K3 and K4 run on the tensor cores
(``csrc/flash_attention_sm90.cu``: ``wgmma`` with P and dS split into
bf16 hi + lo); in fp32, on the CUDA cores (``csrc/flash_attention.cu``).
On CPU tensors a wrapper runs its plain PyTorch version
(``*_reference``), which is what the CPU tests hold against the JAX
package.  Each wrapper counts its kernel launches in ``.launches`` (the
CPU path does not count).

The differentiable entry points mirror the JAX package's:
:func:`flash_attention`, :func:`flash_attention_with_lse` (both outputs
differentiable; the lse cotangent enters the backward as
``delta - g_lse``) and :func:`flash_attention_fn` (the
``attention_fn(q, k, v, causal, scale)`` hook of ``TransformerLM``).
``delta = rowsum(dO * O)`` is a torch op, as the JAX package computes it
in XLA outside its kernels.

Causal masking is top-left aligned, as in the JAX kernels: query ``i``
sees keys ``j <= i``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# q and k tile rows of both sources (one block per tile)
BLOCK_Q = BLOCK_K = 64
_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None
_SM90_LIB: Optional[ctypes.CDLL] = None

# The kernels against their plain versions on the same inputs.  Both
# compute in fp32 and differ only in summation order: over at most
# s <= 2048 terms that is at most 2^11 fp32 roundings, 2^-13 of the
# output's scale (its largest magnitude), which ``tolerance`` gives as
# atol.  A bf16 output then rounds once more, where the two fp32 values
# may straddle a rounding boundary: one bf16 ulp of the element, rtol
# 2^-7.  Rounding P (or dS) to bf16 inside a kernel moves elements by
# about 2^-9 of the output's typical size, at every element, and fails
# this (the negative control in tests/test_torch_kernels_cuda.py).  The
# tensor-core kernels therefore split P and dS into bf16 hi = bf16(x)
# and lo = bf16(x - hi), about 2^-17 of each element, inside it
# (tests/test_torch_flash_split.py).
RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -20}
ATOL_OF_SCALE = 2.0 ** -13


def tolerance(reference: torch.Tensor) -> dict:
    """``torch.testing.assert_close`` arguments for a kernel output
    against its plain version ``reference`` (see :data:`RTOL`)."""
    scale = float(reference.detach().abs().max()) if reference.numel() else 0.0
    return dict(rtol=RTOL[reference.dtype],
                atol=max(ATOL_OF_SCALE * scale, 1e-30))


# ----------------------------------------------------------------------
# Block census (host Python, as in the JAX package)
# ----------------------------------------------------------------------
def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _block_class(first_q, first_k, *, s_k, s_kp, causal, block_q, block_k,
                 s_q=None, s_qp=None):
    """(interior, masked) for one (q block, k block) pair: the JAX
    package's ``_block_class`` on Python ints."""
    live = (first_k <= first_q + block_q - 1) if causal else True
    needs_mask = (first_k + block_k - 1 > first_q) if causal else False
    if s_k < s_kp:
        needs_mask = needs_mask or (first_k + block_k > s_k)
    if s_q is not None and s_q < s_qp:
        needs_mask = needs_mask or (first_q + block_q > s_q)
    return live and not needs_mask, live and needs_mask


def block_census(s_q: int, s_k: int, block_q: int, block_k: int,
                 causal: bool, kind: str = "fwd") -> dict:
    """How many (q block, k block) pairs of one (batch*head) are dead,
    interior (live, unmasked) and masked (diagonal or ragged tail).
    ``kind="bwd"`` also masks the ragged q tail, as the backward kernels
    must (padded q rows would otherwise add to dk/dv).  Port of
    ``pallas_attention.block_census``; at ``BLOCK_Q``/``BLOCK_K`` it
    counts the tiles the CUDA kernels visit."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"kind must be fwd/bwd, got {kind!r}")
    s_qp, s_kp = _round_up(s_q, block_q), _round_up(s_k, block_k)
    n_q, n_k = s_qp // block_q, s_kp // block_k
    census = {"dead": 0, "interior": 0, "masked": 0,
              "n_q_blocks": n_q, "n_k_blocks": n_k}
    for j in range(n_q):
        for kb in range(n_k):
            interior, masked = _block_class(
                j * block_q, kb * block_k, s_k=s_k, s_kp=s_kp,
                causal=causal, block_q=block_q, block_k=block_k,
                s_q=s_q if kind == "bwd" else None, s_qp=s_qp,
            )
            key = "masked" if masked else (
                "interior" if interior else "dead")
            census[key] += 1
    return census


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------
def _causal_mask(s_q: int, s_k: int, device) -> torch.Tensor:
    q_idx = torch.arange(s_q, device=device)[:, None]
    k_idx = torch.arange(s_k, device=device)[None, :]
    return k_idx <= q_idx


def dense_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None):
    """Plain (out, lse) attention, the counterpart of the JAX package's
    ``_dense_attention_with_lse``: fp32 scores and softmax, ``out`` in
    q's dtype (b, s_q, h, d) and ``lse`` fp32 (b, s_q, h)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-2], s.shape[-1], s.device),
                          _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / den, v.float())
    lse = (m + torch.log(den))[..., 0]  # (b, h, s_q)
    return out.to(q.dtype), lse.transpose(1, 2)


def flash_forward_reference(q, k, v, causal: bool, scale: float):
    """Plain version of :func:`flash_forward`: ``(out, lse)`` with lse
    fp32 (b*h, s_q)."""
    out, lse = dense_attention_with_lse(q, k, v, causal, scale)
    b, s_q, h, _ = q.shape
    return out, lse.transpose(1, 2).reshape(b * h, s_q).contiguous()


def _probs_and_dscores(q, k, v, dout, lse, delta, causal, scale):
    """P recomputed from the saved lse (zero where masked) and
    dS = P * (dP - delta), fp32 (b, h, s_q, s_k)."""
    b, s_q, h, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.reshape(b, h, s_q, 1))
    if causal:
        p = p.masked_fill(~_causal_mask(s_q, k.shape[1], p.device), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta.reshape(b, h, s_q, 1))
    return p, ds


def flash_backward_dq_reference(q, k, v, dout, lse, delta, causal: bool,
                                scale: float) -> torch.Tensor:
    """Plain version of :func:`flash_backward_dq`."""
    _, ds = _probs_and_dscores(q, k, v, dout, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_backward_dkv_reference(q, k, v, dout, lse, delta, causal: bool,
                                 scale: float):
    """Plain version of :func:`flash_backward_dkv`."""
    p, ds = _probs_and_dscores(q, k, v, dout, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------
def _on_cpu(name: str, *tensors) -> bool:
    """True for CPU tensors (the plain version runs); raises for any
    device but CUDA."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA (kernel) or CPU (plain "
                         f"version), not {dev}")
    return False


def _kernel_operand(name: str, t: torch.Tensor, dtype, device):
    """``t`` as the kernel reads it: its own strides when the last dim
    is contiguous and every row starts 16-byte aligned, else a
    contiguous copy (same values; the kernel still runs)."""
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    per16 = 16 // t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % per16 for s in t.stride()[:-1])):
        t = t.contiguous()
    return t


def _check_qkv(q, k, v):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take bf16 or fp32, got "
                        f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (batch, seq, heads, d)")
    b, _, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if k.shape[0] != b or k.shape[2:] != (h, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")


def _strides(*tensors) -> ctypes.Array:
    vals = []
    for t in tensors:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _library().flash_attention_error_string(err)
                           .decode())


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float):
    """K2: ``(out, lse)`` of blocked online-softmax attention.

    q (b, s_q, h, d), k/v (b, s_k, h, d), bf16 or fp32 (d 64 or 128 on
    the card) -> out (b, s_q, h, d) in q's dtype and lse fp32
    (b*h, s_q).  bf16 runs on the tensor cores, fp32 on the CUDA
    cores."""
    if _on_cpu("flash_forward", q, k, v):
        return flash_forward_reference(q, k, v, causal, scale)
    _check_qkv(q, k, v)
    q, k, v = (_kernel_operand(n, t, q.dtype, q.device)
               for n, t in (("q", q), ("k", k), ("v", v)))
    b, s_q, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b * h, s_q, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = (_sm90_library().flash_attention_sm90_fwd
              if q.dtype == torch.bfloat16 else _library().flash_attention_fwd)
        err = fn(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, out), b, h, s_q, k.shape[1], float(scale),
            int(bool(causal)), stream)
    _raise_on(err, "flash_forward")
    flash_forward.launches += 1
    return out, lse


def flash_backward_dq(q, k, v, dout, lse, delta, causal: bool,
                      scale: float) -> torch.Tensor:
    """K3: dq from the saved lse and delta (both fp32 (b*h, s_q)); dq in
    q's dtype (bf16 on the tensor cores, fp32 on the CUDA cores)."""
    if _on_cpu("flash_backward_dq", q, k, v, dout):
        return flash_backward_dq_reference(q, k, v, dout, lse, delta,
                                           causal, scale)
    _check_qkv(q, k, v)
    q, k, v, dout = (_kernel_operand(n, t, q.dtype, q.device) for n, t in
                     (("q", q), ("k", k), ("v", v), ("dout", dout)))
    lse, delta = (_rows(n, t, q) for n, t in (("lse", lse),
                                              ("delta", delta)))
    b, s_q, h, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if dq.numel() == 0:
        return dq
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = (_sm90_library().flash_attention_sm90_bwd_dq
              if q.dtype == torch.bfloat16
              else _library().flash_attention_bwd_dq)
        err = fn(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), _strides(q, k, v, dout, dq), b, h, s_q,
            k.shape[1], float(scale), int(bool(causal)), stream)
    _raise_on(err, "flash_backward_dq")
    flash_backward_dq.launches += 1
    return dq


def flash_backward_dkv(q, k, v, dout, lse, delta, causal: bool,
                       scale: float):
    """K4: ``(dk, dv)`` from the saved lse and delta, in k's and v's
    dtype (bf16 on the tensor cores, fp32 on the CUDA cores)."""
    if _on_cpu("flash_backward_dkv", q, k, v, dout):
        return flash_backward_dkv_reference(q, k, v, dout, lse, delta,
                                            causal, scale)
    _check_qkv(q, k, v)
    q, k, v, dout = (_kernel_operand(n, t, q.dtype, q.device) for n, t in
                     (("q", q), ("k", k), ("v", v), ("dout", dout)))
    lse, delta = (_rows(n, t, q) for n, t in (("lse", lse),
                                              ("delta", delta)))
    b, s_q, h, d = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if dk.numel() == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = (_sm90_library().flash_attention_sm90_bwd_dkv
              if q.dtype == torch.bfloat16
              else _library().flash_attention_bwd_dkv)
        err = fn(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, dout, dk, dv),
            b, h, s_q, k.shape[1], float(scale), int(bool(causal)), stream)
    _raise_on(err, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


def _rows(name: str, t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """A per-row fp32 (b*h, s_q) operand (lse, delta), contiguous."""
    b, s_q, h, _ = q.shape
    if t.dtype != torch.float32 or tuple(t.shape) != (b * h, s_q):
        raise ValueError(f"{name} must be fp32 ({b * h}, {s_q}), got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return t.contiguous()


def smem_bytes(kernel: str, d: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one block of ``kernel`` (a wrapper's
    name) at head dim ``d`` and ``dtype``, as the CUDA source computes
    it (builds the library)."""
    if dtype == torch.bfloat16 and kernel in SM90_KERNELS:
        return _sm90_library().flash_attention_sm90_smem_bytes(
            SM90_KERNELS.index(kernel), d)
    return _library().flash_attention_smem_bytes(
        0 if kernel == "flash_forward" else 1, d)


# The wrappers whose bf16 kernels are in csrc/flash_attention_sm90.cu, in
# the order of its flash_attention_sm90_smem_bytes switch.
SM90_KERNELS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")


def design(kernel: str, dtype, d: int) -> dict:
    """How ``kernel`` (a wrapper's name) computes at ``dtype`` and head
    dim ``d``: the unit and instruction of each product, the copy ring
    and the shared memory of a block (builds the library)."""
    if dtype != torch.bfloat16 or kernel not in SM90_KERNELS:
        return {"source": "csrc/flash_attention.cu",
                "products": "fp32 FMA on the CUDA cores",
                "copies": "synchronous loads", "ring_stages": 1,
                "smem_bytes": smem_bytes(kernel, d, dtype)}
    rs = f"wgmma m64n{d}k16, A from registers split hi+lo (2 products)"
    products = {
        "flash_forward": {"Q.K^T": "wgmma m64n64k16, A and B from shared",
                          "P.V": rs},
        "flash_backward_dq": {"Q.K^T": "wgmma m64n64k16, both shared",
                              "dO.V^T": "wgmma m64n64k16, both shared",
                              "dS.K": rs},
        "flash_backward_dkv": {"K.Q^T": "wgmma m64n64k16, both shared",
                               "V.dO^T": "wgmma m64n64k16, both shared",
                               "P^T.dO": rs, "dS^T.Q": rs},
    }[kernel]
    return {"source": "csrc/flash_attention_sm90.cu", "products": products,
            "copies": "cp.async 16-byte, 128-byte swizzle",
            "ring_stages": _sm90_library().flash_attention_sm90_stages(),
            "smem_bytes": smem_bytes(kernel, d, dtype)}


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 4 + [ctypes.c_float, i32, ptr]
        lib.flash_attention_fwd.argtypes = [i32, i32] + [ptr] * 6 + tail
        lib.flash_attention_bwd_dq.argtypes = [i32, i32] + [ptr] * 8 + tail
        lib.flash_attention_bwd_dkv.argtypes = [i32, i32] + [ptr] * 9 + tail
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
                   lib.flash_attention_bwd_dkv):
            fn.restype = i32
        lib.flash_attention_smem_bytes.argtypes = [i32, i32]
        lib.flash_attention_smem_bytes.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _sm90_library() -> ctypes.CDLL:
    global _SM90_LIB
    if _SM90_LIB is None:
        lib = _build.load("flash_attention_sm90")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 4 + [ctypes.c_float, i32, ptr]
        lib.flash_attention_sm90_fwd.argtypes = [i32, i32] + [ptr] * 6 + tail
        lib.flash_attention_sm90_bwd_dq.argtypes = ([i32, i32] + [ptr] * 8
                                                    + tail)
        lib.flash_attention_sm90_bwd_dkv.argtypes = ([i32, i32] + [ptr] * 9
                                                     + tail)
        for fn in (lib.flash_attention_sm90_fwd,
                   lib.flash_attention_sm90_bwd_dq,
                   lib.flash_attention_sm90_bwd_dkv):
            fn.restype = i32
        lib.flash_attention_sm90_smem_bytes.argtypes = [i32, i32]
        lib.flash_attention_sm90_smem_bytes.restype = i32
        lib.flash_attention_sm90_stages.argtypes = []
        lib.flash_attention_sm90_stages.restype = i32
        _SM90_LIB = lib
    return _SM90_LIB


# ----------------------------------------------------------------------
# Differentiable entry points
# ----------------------------------------------------------------------
def _backward(q, k, v, out, lse, g, g_lse, causal, scale):
    """dq, dk, dv through K3 and K4.  ``g_lse`` (b, s_q, h) or None:
    since d lse_i / d s_ij = p_ij, it enters as ``delta - g_lse``."""
    b, s_q, h, _ = q.shape
    delta = (g.float() * out.float()).sum(-1)  # (b, s_q, h)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.transpose(1, 2).reshape(b * h, s_q).contiguous()
    dq = flash_backward_dq(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_backward_dkv(q, k, v, g, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, g, None, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


class _FlashAttentionWithLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        b, s_q, h, _ = q.shape
        return out, lse.reshape(b, h, s_q).transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, g, g_lse, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blocked flash attention, (b, s, h, d) x 3 -> (b, s_q, h, d),
    differentiable in q, k and v (port of
    ``pallas_attention.flash_attention``, without its TPU block knobs)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None):
    """``(out, lse)`` with both outputs differentiable; lse is the
    per-row log-sum-exp of the scaled scores, fp32 (b, s_q, h) (port of
    ``pallas_attention.flash_attention_with_lse``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttentionWithLse.apply(q, k, v, bool(causal), float(scale))


def flash_attention_fn():
    """The ``attention_fn(q, k, v, causal, scale)`` hook that
    ``TransformerLM`` calls (port of ``pallas_attention.flash_attention_fn``;
    the CUDA kernels have one tile geometry, so it takes no block
    knobs)."""

    def fn(q, k, v, causal, scale):
        return flash_attention(q, k, v, causal, scale)

    return fn
