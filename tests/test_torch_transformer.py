"""Port parity: ``lm_params_from_flax`` + the port's ``TransformerLM``
forward against flax ``TransformerLM.apply`` on the same weights and
tokens, and the flax numerics a straight port gets wrong (LayerNorm
epsilon 1e-6, tanh-approximate gelu)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from chainermn_tpu.models.transformer import MlpBlock as JaxMlpBlock
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu_torch.models import MlpBlock, TransformerLM, lm_params_from_flax
from chainermn_tpu_torch.models.transformer import LN_EPS

VOCAB, D, HEADS, LAYERS, MAXLEN = 96, 48, 4, 2, 64

# fp32: the frameworks' matmuls and LayerNorms round differently, a few
# ulps per op over 2 blocks and a 48-wide head
TOL_F32 = 1e-5
# bf16 compute: each side rounds every dense output, attention product
# and residual add to 8 significant bits, at different places (e.g.
# jax's bf16 gelu vs torch's fp32-internal one).  The logits here are
# below 0.5, where one bf16 ulp is 2^-9 (2e-3); allow 8 such ulps of
# drift through the two blocks (measured: 3.1e-3)
TOL_BF16 = 1.6e-2


def _flax_lm(dtype):
    model = JaxLM(vocab_size=VOCAB, d_model=D, n_heads=HEADS,
                  n_layers=LAYERS, max_len=MAXLEN, dtype=dtype)
    params = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8), jnp.int32),
    )
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_lm(params, dtype):
    lm = TransformerLM(VOCAB, D, HEADS, LAYERS, max_len=MAXLEN, dtype=dtype)
    lm.load_state_dict(lm_params_from_flax(params))  # strict: keys match
    return lm


@pytest.mark.parametrize("dtype,tol", [
    ("float32", TOL_F32), ("bfloat16", TOL_BF16),
])
def test_forward_matches_flax(dtype, tol):
    model, params = _flax_lm(getattr(jnp, dtype))
    lm = _port_lm(params, getattr(torch, dtype))
    toks = np.random.RandomState(3).randint(0, VOCAB, (2, 24))
    ref = np.asarray(model.apply(params, jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        got = lm(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_converter_maps_dense_kernels_to_linear_layout():
    _, params = _flax_lm(jnp.float32)
    sd = lm_params_from_flax(params)
    p = params["params"]["TransformerBlock_1"]
    np.testing.assert_array_equal(
        sd["blocks.1.attn.qkv.weight"].numpy(),
        p["SelfAttention_0"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["blocks.1.mlp.fc1.bias"].numpy(),
        p["MlpBlock_0"]["Dense_0"]["bias"])
    assert sd["blocks.1.attn.qkv.weight"].shape == (3 * D, D)
    assert all(t.dtype == torch.float32 for t in sd.values())


def test_mlp_uses_tanh_gelu():
    """flax ``nn.gelu`` is the tanh approximation; the exact erf gelu
    would differ by ~1e-3 here."""
    x = np.random.RandomState(0).randn(4, 16).astype(np.float32) * 2
    block = JaxMlpBlock(32, dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, block.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(block.apply(params, jnp.asarray(x)))
    mlp = MlpBlock(16, 32, torch.float32)
    p = params["params"]
    mlp.load_state_dict({
        "fc1.weight": torch.from_numpy(p["Dense_0"]["kernel"].T.copy()),
        "fc1.bias": torch.from_numpy(p["Dense_0"]["bias"].copy()),
        "fc2.weight": torch.from_numpy(p["Dense_1"]["kernel"].T.copy()),
        "fc2.bias": torch.from_numpy(p["Dense_1"]["bias"].copy()),
    })
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_layer_norm_epsilon_is_flax_default():
    """Rows of variance ~1e-6 make epsilon visible: 1e-5 (torch's
    default) would shrink them ~3x against flax's 1e-6."""
    x = np.random.RandomState(1).randn(4, D).astype(np.float32) * 1e-3
    ref = np.asarray(nn.LayerNorm().apply(
        {"params": {"scale": jnp.ones(D), "bias": jnp.zeros(D)}},
        jnp.asarray(x)))
    lm = TransformerLM(VOCAB, D, HEADS, LAYERS, max_len=MAXLEN,
                       dtype=torch.float32)
    assert LN_EPS == 1e-6
    with torch.no_grad():
        got = lm.ln_f(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_seeded_init_is_deterministic_and_flax_shaped():
    a = TransformerLM(VOCAB, D, HEADS, LAYERS, max_len=MAXLEN, seed=5)
    b = TransformerLM(VOCAB, D, HEADS, LAYERS, max_len=MAXLEN, seed=5)
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert float(a.embed.weight.detach().std()) == pytest.approx(
        0.02, rel=0.1)
    w = a.blocks[0].attn.qkv.weight.detach()
    assert float(w.std()) == pytest.approx(D ** -0.5, rel=0.1)
    assert float(w.abs().max()) <= 2 * D ** -0.5 / 0.8796 + 1e-6
