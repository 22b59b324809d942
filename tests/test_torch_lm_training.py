"""Port parity of the LM training path: ``lm_loss`` and every parameter
gradient of a 2-layer TransformerLM through the flash-attention hook,
and the parameters after k AdamW steps of the data-parallel step at
world size 2 (gloo, data sharded by ``scatter_dataset``), each against
the JAX package on the same numpy inputs (its flash kernels in
interpret mode, its step on a 2-device CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu as jcmn
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import lm_loss as jax_lm_loss
from chainermn_tpu.ops.pallas_attention import flash_attention_fn as jax_flash_fn
from chainermn_tpu.datasets import scatter_index as jax_scatter_index
from chainermn_tpu.comm_wire import plan_of_tree as jax_plan_of_tree
from chainermn_tpu_torch.models import TransformerLM, lm_loss, lm_params_from_flax
from chainermn_tpu_torch.ops import flash_attention_fn

import test_torch_world as torch_world

CFG = dict(vocab=128, d_model=64, n_heads=2, n_layers=2, max_len=32,
           batch=4, seed=7)
SEQ = 32
STEPS = 3
N_ROWS = 12

# fp32: the frameworks' matmuls, LayerNorms and flash blocks sum in
# different orders, a few fp32 ulps per op through 2 blocks and a
# 64-wide head: 1e-5 relative for the loss, and 1e-4 relative with 1e-6
# absolute for the gradients, many of whose entries are near zero
# (measured: loss 2.0e-7 relative; largest gradient gap 1.3e-6 of its
# parameter's largest gradient entry)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# bf16 compute: each side rounds every dense output and residual to 8
# bits at different places (as tests/test_torch_transformer.py's
# forward tolerance), so a gradient is held to 5 % of its largest entry
# (measured: loss 7.9e-6 relative, largest gap 2.3 % of the largest
# entry)
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_SHARE = 5e-2
# AdamW after 3 steps at lr 3e-4: each update is lr * m_hat /
# (sqrt(v_hat) + 1e-8), so an entry whose gradient is of the order of
# eps turns fp32 gradient differences into parameter differences of up
# to lr; such entries are rare.  Every entry within 3e-5, and 99.9 % of
# them within 1e-6 (measured: largest 1.06e-5, at 9 of 109,824 entries
# above 1e-6; the 99.99th percentile 3.6e-7).  A wrong learning rate or
# bias correction moves entries by ~1e-4.
PARAM_ATOL = 3e-5
PARAM_RTOL = 0.0
PARAM_BULK_ATOL, PARAM_BULK_SHARE = 1e-6, 0.999


def _flax_lm(dtype, attention_fn):
    model = JaxLM(vocab_size=CFG["vocab"], d_model=CFG["d_model"],
                  n_heads=CFG["n_heads"], n_layers=CFG["n_layers"],
                  max_len=CFG["max_len"], dtype=dtype,
                  attention_fn=attention_fn)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _tokens(n, seed):
    return np.random.RandomState(seed).randint(0, CFG["vocab"], (n, SEQ))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_and_grads_match_jax(dtype):
    model, params = _flax_lm(getattr(jnp, dtype), jax_flash_fn())
    toks = _tokens(3, 11)

    def loss_fn(p):
        return jax_lm_loss(model.apply(p, jnp.asarray(toks, jnp.int32)),
                           jnp.asarray(toks, jnp.int32))

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    ref = lm_params_from_flax(jax.tree_util.tree_map(np.asarray, ref_grads))

    lm = TransformerLM(CFG["vocab"], CFG["d_model"], CFG["n_heads"],
                       CFG["n_layers"], max_len=CFG["max_len"],
                       dtype=getattr(torch, dtype),
                       attention_fn=flash_attention_fn())
    lm.load_state_dict(lm_params_from_flax(params))
    t = torch.from_numpy(toks)
    loss = lm_loss(lm(t), t)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    loss.backward()
    grads = {k: p.grad for k, p in lm.named_parameters()}
    assert set(grads) == set(ref)
    if dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(ref_loss),
                                   rtol=LOSS_RTOL)
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref[k].numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=k)
    else:
        np.testing.assert_allclose(loss.item(), float(ref_loss),
                                   rtol=BF16_LOSS_RTOL)
        for k, g in grads.items():
            r = ref[k].numpy()
            gap = np.abs(g.numpy() - r).max() / max(np.abs(r).max(), 1e-12)
            assert gap <= BF16_GRAD_SHARE, (k, gap)


def test_lm_loss_is_next_token_cross_entropy():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 5, 7).astype(np.float32)
    toks = rng.randint(0, 7, (2, 5))
    ref = float(jax_lm_loss(jnp.asarray(logits), jnp.asarray(toks)))
    got = float(lm_loss(torch.from_numpy(logits), torch.from_numpy(toks)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.fixture(scope="module")
def world2():
    """One gloo world of 2 runs the port's training path (the parity
    run, then the non-finite guard); the JAX step runs the same data on
    a 2-device CPU mesh."""
    model, params = _flax_lm(jnp.float32, jax_flash_fn())
    dataset = _tokens(N_ROWS, 3)
    state = {k: v.numpy() for k, v in lm_params_from_flax(params).items()}
    ranks = torch_world.run_world(
        torch_world.training_worker, 2, CFG, state, dataset, STEPS,
        "float32", timeout=240)
    return model, params, dataset, ranks


def _jax_run(model, params, dataset, shards):
    comm = jcmn.create_communicator("tpu", devices=jax.devices("cpu")[:2])
    opt = jcmn.create_multi_node_optimizer(
        optax.adamw(3e-4, weight_decay=0.01), comm)

    def loss_fn(p, b):
        return jax_lm_loss(model.apply(p, b), b)

    step = jcmn.build_train_step(comm, loss_fn, opt, donate=False)
    p, s = step.place(params, opt.init(params))
    per = CFG["batch"] // 2
    losses = []
    for i in range(STEPS):
        rows = np.concatenate([dataset[idx[i * per:(i + 1) * per]]
                               for idx in shards])
        p, s, m = step(p, s, jnp.asarray(rows, jnp.int32))
        losses.append(float(m["loss"]))
    return jax.tree_util.tree_map(np.asarray, p), losses


def test_shards_come_from_scatter_dataset(world2):
    _, _, dataset, ranks = world2
    for rank, res in enumerate(ranks):
        order, start, end = jax_scatter_index(
            len(dataset), 2, rank, shuffle=True, seed=CFG["seed"])
        np.testing.assert_array_equal(res["indices"], order[start:end])


def test_params_after_k_adamw_steps_match_jax(world2):
    """Parameters after 3 AdamW steps (lr 3e-4, weight decay 0.01, eps
    1e-8 on both sides) and the per-step mean losses."""
    model, params, dataset, ranks = world2
    ref_params, ref_losses = _jax_run(model, params, dataset,
                                      [r["indices"] for r in ranks])
    np.testing.assert_allclose(ranks[0]["losses"], ref_losses,
                               rtol=LOSS_RTOL)
    ref = lm_params_from_flax(ref_params)
    start = lm_params_from_flax(params)
    gaps = []
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(v, ranks[1]["params"][k], err_msg=k)
        np.testing.assert_allclose(v, ref[k].numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
        gaps.append(np.abs(v - ref[k].numpy()).ravel())
        # every parameter was updated
        assert np.abs(v - start[k].numpy()).max() > 1e-4, k
    gaps = np.concatenate(gaps)
    assert np.mean(gaps <= PARAM_BULK_ATOL) >= PARAM_BULK_SHARE


def test_wire_plan_has_the_jax_bucket_layout(world2):
    """The optimizer plans over the flax-ordered parameters: the same
    buckets (sizes, offsets, leaf indices) as the JAX plan of the flax
    tree."""
    _, params, _, ranks = world2
    from chainermn_tpu_torch.comm_wire import make_plan
    from chainermn_tpu_torch.models.convert import lm_leaves

    jplan = jax_plan_of_tree(params)
    shapes = {k: v.shape for k, v in ranks[0]["params"].items()}
    port = make_plan([(shapes[leaf.key], "float32")
                      for leaf in lm_leaves(CFG["n_layers"])])
    assert ranks[0]["plan_hash"] == ranks[1]["plan_hash"] == port.plan_hash()
    assert [(b.dtype, b.size) for b in port.buckets] == [
        (b.dtype, b.size) for b in jplan.buckets]
    assert [[(s.index, s.offset, s.size) for s in b.slots]
            for b in port.buckets] == [
        [(s.index, s.offset, s.size) for s in b.slots]
        for b in jplan.buckets]


def test_nonfinite_skip_agreed_across_ranks(world2):
    """One rank's NaN loss: under "skip" both ranks report the step
    non-finite and leave every parameter bit-identical; "abort" raises
    on both; the next clean step applies."""
    _, _, _, ranks = world2
    for res in ranks:
        assert res["skip_finite"] == 0.0
        assert res["skip_unchanged"]
        assert res["abort_raised"]
        assert res["clean_finite"] == 1.0
        assert res["clean_changed"]


def test_manual_loop_step_syncs(world2):
    """``loss.backward(); opt.step()`` by hand: the multi-node
    optimizer's own step means the gradients first, so two ranks fed
    different batches stay bit-identical."""
    _, _, _, ranks = world2
    for k, v in ranks[0]["manual_params"].items():
        np.testing.assert_array_equal(v, ranks[1]["manual_params"][k],
                                      err_msg=k)


def test_build_train_step_rejects_unknown_policy_and_plain_optimizer():
    from chainermn_tpu_torch import build_train_step

    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1)
    with pytest.raises(ValueError, match="nonfinite"):
        build_train_step(None, lambda b: b, opt, nonfinite="retry")
    with pytest.raises(TypeError, match="create_multi_node_optimizer"):
        build_train_step(None, lambda b: b, opt)
