"""The numerics argument of the tensor-core flash kernels, on the CPU.

The bf16 forward (K2), dq (K3) and dk/dv (K4) kernels in
``chainermn_tpu_torch/ops/csrc/flash_attention_sm90.cu`` compute the
products whose left operand is fp32 (P.V, dS.K, P^T.dO, dS^T.Q) on bf16
tensor cores by splitting that operand into ``hi = bf16(x)`` and
``lo = bf16(x - hi)``: ``x.B = hi.B + lo.B``, each a bf16 x bf16
product accumulated in fp32.  Here plain torch emulates that arithmetic
on numpy-seeded inputs and holds O, dQ, dK and dV to the same
``flash_attention.tolerance`` the kernels are held to on the card,
against the plain versions (fp32 P and dS).  A single bf16 rounding of
P and dS, the negative control, must fail it.
"""

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.ops import flash_attention as fa

# (batch, seq, heads, d, causal)
CASES = [(1, 256, 2, d, causal) for d in (64, 128) for causal in (True,
                                                                  False)]


def _inputs(case, seed=0):
    b, s, h, d, _ = case
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
            .bfloat16() for _ in range(4)]  # q, k, v, dO


def _scores(q, k, causal, scale):
    """fp32 scaled scores (b, h, s_q, s_k): products of bf16 values are
    exact in fp32, as on the tensor cores; masked scores -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~fa._causal_mask(s.shape[-2], s.shape[-1],
                                           s.device), -1e30)
    return s


def split_bf16(x):
    """``(hi, lo)`` bf16 with ``hi = bf16(x)`` and ``lo = bf16(x - hi)``
    (``x - hi`` is exact in fp32), as the kernels split P and dS."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _product(x, b, eq, split):
    """``einsum(eq, x, b)`` with the fp32 ``x`` rounded as a kernel
    would: hi + lo (``split``) or hi alone, each a bf16 x bf16 product
    summed in fp32."""
    hi, lo = split_bf16(x)
    out = torch.einsum(eq, hi.float(), b.float())
    if split:
        out = out + torch.einsum(eq, lo.float(), b.float())
    return out


def _emulated_forward(q, k, v, causal, scale, split):
    """The forward kernel's arithmetic: unnormalized P = exp(s - m),
    O = (P.V) / l."""
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _product(p, v, "bhqk,bkhd->bqhd", split)
    l = p.sum(-1).transpose(1, 2)[..., None]  # (b, s_q, h, 1)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def _probs_and_dscores(q, k, v, do, lse, delta, causal, scale):
    """P from the saved lse (zero where masked) and dS = P (dP - delta),
    fp32, as both backward kernels compute them."""
    b, s_q, h, _ = q.shape
    p = torch.exp(_scores(q, k, causal, scale) - lse.reshape(b, h, s_q, 1))
    if causal:
        p = p.masked_fill(~fa._causal_mask(s_q, k.shape[1], p.device), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.reshape(b, h, s_q, 1))


def _emulated_dq(q, k, v, do, lse, delta, causal, scale, split):
    """The dq kernel's arithmetic: dQ = dS.K * scale."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    return (_product(ds, k, "bhqk,bkhd->bqhd", split) * scale).to(q.dtype)


def _emulated_dkv(q, k, v, do, lse, delta, causal, scale, split):
    """The dk/dv kernel's arithmetic: dV = P^T.dO, dK = dS^T.Q * scale."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    dv = _product(p, do, "bhqk,bqhd->bkhd", split)
    dk = _product(ds, q, "bhqk,bqhd->bkhd", split) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _outputs(case, split):
    """(emulated, plain) pairs for O, dQ, dK and dV."""
    q, k, v, do = _inputs(case)
    causal = case[4]
    scale = q.shape[-1] ** -0.5
    b, s_q, h, _ = q.shape
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, causal, scale)
    delta = ((do.float() * ref_out.float()).sum(-1).transpose(1, 2)
             .reshape(b * h, s_q))
    args = (q, k, v, do, ref_lse, delta, causal, scale)
    ref_dq = fa.flash_backward_dq_reference(*args)
    ref_dk, ref_dv = fa.flash_backward_dkv_reference(*args)
    out = _emulated_forward(q, k, v, causal, scale, split)
    dq = _emulated_dq(*args, split)
    dk, dv = _emulated_dkv(*args, split)
    return {"out": (out, ref_out), "dq": (dq, ref_dq), "dk": (dk, ref_dk),
            "dv": (dv, ref_dv)}


def _ids(case):
    return f"d{case[3]}-{'causal' if case[4] else 'full'}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_hi_lo_split_within_tolerance(case):
    for name, (got, ref) in _outputs(case, split=True).items():
        assert got.dtype == ref.dtype == torch.bfloat16
        torch.testing.assert_close(got, ref, **fa.tolerance(ref),
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_single_bf16_fails_tolerance(case):
    """Negative control: P and dS rounded once to bf16 (about 2^-9 of
    each element) leave every one of O, dQ, dK and dV outside the
    tolerance."""
    for name, (got, ref) in _outputs(case, split=False).items():
        with pytest.raises(AssertionError):
            torch.testing.assert_close(got, ref, **fa.tolerance(ref))


def test_split_bf16_carries_16_bits():
    """hi is x rounded to bf16 and lo the rounded remainder: hi + lo is
    within 2^-16 of x relative, where hi alone is off by up to 2^-9."""
    x = torch.from_numpy(np.random.RandomState(1).rand(4096)
                         .astype(np.float32)) * 4 + 1e-3
    hi, lo = split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.bfloat16())
    rel = ((hi.float() + lo.float() - x).abs() / x).max()
    rel_hi = ((hi.float() - x).abs() / x).max()
    assert rel <= 2.0 ** -16 < 2.0 ** -10 < rel_hi <= 2.0 ** -8
