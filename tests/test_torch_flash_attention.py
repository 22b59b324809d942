"""Port parity of flash attention for training: values and all three
gradients of ``flash_attention`` (causal and not, ragged, cross, bf16),
``flash_attention_with_lse`` with an lse cotangent, and
``block_census``, each against the JAX package on the same numpy inputs
(its Pallas kernels in interpret mode, as tests/test_pallas_kernels.py
runs them).  On the CPU the port's wrappers run their plain versions,
the functions its CUDA kernels are held to on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops import pallas_attention as jpa
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.ops import flash_attention as fa

# Both sides compute scores, softmax and gradients in fp32, in different
# orders (the JAX kernels block-wise online, the plain versions dense):
# ``fa.tolerance`` allows 2^-13 of each output's scale for that, plus one
# bf16 ulp of each element where the outputs are bf16.
CASES = [
    # (batch, s_q, s_k, heads, d, causal, dtype)
    (2, 128, 128, 2, 64, True, "float32"),
    (2, 100, 100, 2, 64, True, "float32"),   # ragged causal
    (1, 70, 150, 2, 32, False, "float32"),   # non-causal cross
    (1, 90, 60, 2, 64, True, "float32"),     # causal, s_k < s_q
    (2, 96, 96, 2, 64, True, "bfloat16"),
    (1, 80, 120, 2, 64, False, "bfloat16"),
]


def _inputs(case, seed=0):
    b, s_q, s_k, h, d, _, dtype = case
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, s, h, d).astype(np.float32)
            for s in (s_q, s_k, s_k, s_q)]
    g_lse = rng.randn(b, s_q, h).astype(np.float32)
    if dtype == "bfloat16":  # round once, so both sides see equal values
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs, g_lse


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, ref):
    ref_t = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    got_t = got.detach().float()
    tol = fa.tolerance(ref_t.to(got.dtype))
    torch.testing.assert_close(got_t, ref_t, **tol)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_values_and_grads_match_jax(case):
    (q, k, v, do), _ = _inputs(case)
    causal, dtype = case[5], case[6]

    def jax_loss(q, k, v):
        out = jpa.flash_attention(q, k, v, causal, None, 64, 64, True)
        return jnp.sum(out.astype(jnp.float32) * _jax(do, "float32")), out

    (_, ref_out), ref_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))

    leaves = [_torch(a, dtype).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    assert out.dtype == getattr(torch, dtype) and out.shape == leaves[0].shape
    grads = torch.autograd.grad((out.float() * torch.from_numpy(do)).sum(),
                                leaves)
    _close(out, ref_out)
    for got, ref in zip(grads, ref_grads):
        assert got.dtype == getattr(torch, dtype)
        _close(got, ref)


@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[4]],
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_with_lse_matches_jax(case):
    """Both outputs and the gradients of a loss that uses the lse too:
    its cotangent enters the backward as ``delta - g_lse``."""
    (q, k, v, do), g_lse = _inputs(case, seed=1)
    causal, dtype = case[5], case[6]

    def jax_loss(q, k, v):
        out, lse = jpa.flash_attention_with_lse(q, k, v, causal, None, 64,
                                                64, True)
        loss = (jnp.sum(out.astype(jnp.float32) * _jax(do, "float32"))
                + jnp.sum(lse * _jax(g_lse, "float32")))
        return loss, (out, lse)

    (_, (ref_out, ref_lse)), ref_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))

    leaves = [_torch(a, dtype).requires_grad_() for a in (q, k, v)]
    out, lse = fa.flash_attention_with_lse(*leaves, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (
        case[0], case[1], case[3])
    loss = ((out.float() * torch.from_numpy(do)).sum()
            + (lse * torch.from_numpy(g_lse)).sum())
    grads = torch.autograd.grad(loss, leaves)
    _close(out, ref_out)
    _close(lse, ref_lse)
    for got, ref in zip(grads, ref_grads):
        _close(got, ref)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("causal", [True, False])
def test_block_census_matches_jax(kind, causal):
    for s_q in (1, 63, 64, 65, 200, 256):
        for s_k in (1, 64, 100, 256):
            for bq, bk in ((64, 64), (32, 128), (128, 32)):
                assert fa.block_census(s_q, s_k, bq, bk, causal, kind) == \
                    jpa.block_census(s_q, s_k, bq, bk, causal, kind)


def test_block_census_rejects_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        fa.block_census(8, 8, 8, 8, True, "sideways")


def test_cpu_path_counts_no_launches_and_other_devices_raise():
    q = torch.randn(1, 8, 1, 16)
    n0 = (fa.flash_forward.launches, fa.flash_backward_dq.launches,
          fa.flash_backward_dkv.launches)
    leaf = q.clone().requires_grad_()
    fa.flash_attention(leaf, q, q, causal=True).sum().backward()
    assert (fa.flash_forward.launches, fa.flash_backward_dq.launches,
            fa.flash_backward_dkv.launches) == n0
    meta = torch.empty(1, 8, 1, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_forward(meta, meta, meta, True, 0.25)


def test_transformer_flash_hook_matches_dense_attend():
    """The ``attention_fn`` hook: an fp32 TransformerLM through the
    flash entry point agrees with its dense attend (both fp32 softmax;
    summation order only)."""
    dense = TransformerLM(64, 64, 2, 2, max_len=32, dtype=torch.float32)
    flash = TransformerLM(64, 64, 2, 2, max_len=32, dtype=torch.float32,
                          attention_fn=fa.flash_attention_fn())
    flash.load_state_dict(dense.state_dict())
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 32)))
    torch.testing.assert_close(flash(toks), dense(toks), rtol=1e-5,
                               atol=1e-5)
