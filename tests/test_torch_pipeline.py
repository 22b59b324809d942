"""Port parity of the GPipe pipeline tier (``parallel.pipeline``) and
the seq2seq encoder|decoder split on it, against
``tests/test_parallel.py::TestGPipe``/``TestPipelineTrainStep``/
``TestSeq2SeqPipeline``.

The JAX package runs the schedule as one SPMD scan over CPU devices;
the port as one process per stage, in gloo worlds of 2 and 4 (run
while the JAX side computes), and in-process at world 1.  Shared numpy
inputs go through both.

The JAX step's stage gradients are ``n_stage`` times the loss's: its
loss is ``psum``-ed over the stages, and under ``check_vma=False`` the
transpose of that psum sums every device's seed cotangent.  Adam is
blind to the scale except through ``eps``: Adam(k g, eps) is Adam(g,
eps / k).  So the port's step (the loss's own gradient) is held against
the JAX step with ``eps / n_stage``, and with the default ``eps``
against a float64 run of the same update without a pipeline (a plain
sequential model; for the seq2seq, the unpipelined loss).

Tolerances: ``gpipe``'s outputs and stage gradients 1e-5 relative L2
(fp32 ``tanh(h @ W)`` stages); the train steps' losses 1e-5 relative
and their parameters after 3 Adam steps within 3e-5 with 99.9 % of
entries within 1e-6 (as the LM's parity test holds Adam; against the
4-stage JAX step the 3e-5 alone, as that test says); remat against
no remat exactly equal (the same kernels recomputed); the one-stage
enc|dec pipeline against the unpipelined step on the same union
parameters, losses 1e-6 relative and parameters as above (the
microbatch sums add in another order).
"""

from concurrent.futures import ThreadPoolExecutor
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import chainermn_tpu as jcmn
from chainermn_tpu.parallel import build_pipeline_train_step as jax_build
from chainermn_tpu.parallel import gpipe as jax_gpipe

import test_torch_world as torch_world
import torch_mp_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, MB, NMICRO, LR, STEPS, EPS = 6, 2, 4, 0.05, 3, 1e-8
SEQ = dict(vocab=64, units=16, layers=2, seqlen=8)
SEQ_LR, SEQ_BATCH = 1e-3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's in-process torch work: the
    suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _adam_close(got, ref, share=0.999):
    gap = np.abs(np.asarray(got) - np.asarray(ref)).ravel()
    assert gap.max() < 3e-5 and np.mean(gap < 1e-6) >= share, (
        gap.max(), np.mean(gap < 1e-6))


def _gpipe_inputs(n):
    rng = np.random.RandomState(n)
    ws = (rng.randn(n, D, D) * 0.4).astype(np.float32)
    x = rng.randn(NMICRO, MB, D).astype(np.float32)
    w_loss = rng.randn(NMICRO, MB, D).astype(np.float32)
    return ws, x, w_loss


def _jax_gpipe(n, ws, x, w_loss):
    """The JAX test's pipeline on ``n`` devices: psum of the outputs and
    each stage's gradient of ``pmean(sum(psum(out)**2 * w_loss))``."""
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("mn",))

    def out(ws, x):
        y = jax_gpipe(lambda w, h: jnp.tanh(h @ w), jnp.squeeze(ws, 0), x,
                      "mn")
        return lax.psum(y, "mn")

    def loss(ws, x, wl):
        return lax.pmean(jnp.sum(out(ws, x) ** 2 * wl), "mn")

    run = lambda f, specs, out_spec: jax.jit(jax.shard_map(  # noqa: E731
        f, mesh=mesh, in_specs=specs, out_specs=out_spec, check_vma=False))
    y = run(out, (P("mn"), P()), P())(ws, x)
    g = run(jax.grad(loss), (P("mn"), P(), P()), P("mn"))(ws, x, w_loss)
    return np.asarray(y), np.asarray(g)


def _train_data():
    rng = np.random.RandomState(3)
    ws = (rng.randn(4, D, D) * 0.4).astype(np.float32)
    x = rng.randn(NMICRO, MB, D).astype(np.float32)
    t = rng.randn(NMICRO, MB, D).astype(np.float32)
    return ws, x, t


def _jax_train(ws, x, t):
    comm = jcmn.create_communicator("tpu", devices=jax.devices("cpu")[:4])
    opt = optax.adam(LR)
    step = jax_build(comm, lambda w, h: jnp.tanh(h @ w),
                     lambda y, t: jnp.mean((y - t) ** 2), opt, n_micro=NMICRO,
                     remat=False, donate=False)
    params, state = step.place(jnp.asarray(ws), opt.init(jnp.asarray(ws)))
    batch = step.place(jnp.asarray(ws), batch=(jnp.asarray(x),
                                               jnp.asarray(t)))[1]
    losses = []
    for _ in range(STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return losses, np.asarray(params)


def _float64_train(ws, x, t):
    """The same 3 Adam steps on the sequential model in float64."""
    w = torch.tensor(ws, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([w], lr=LR, eps=EPS)
    for _ in range(STEPS):
        opt.zero_grad()
        h = torch.from_numpy(x).double()
        for s in range(len(ws)):
            h = torch.tanh(h @ w[s])
        ((h - torch.from_numpy(t).double()) ** 2).mean().backward()
        opt.step()
    return w.detach().numpy()


def _float64_seq2seq(stacked, packed):
    """The same 3 Adam steps on the unpipelined seq2seq loss in float64,
    from stage 0's copy of the union parameters."""
    from chainermn_tpu_torch.parallel.seq2seq_pipeline import Seq2SeqStages

    class One:
        size, rank = 1, 0

    stages = Seq2SeqStages(One(), SEQ["vocab"], SEQ["units"], SEQ["layers"],
                           SEQ["seqlen"], device="cpu")
    stages.enc.double()
    stages.dec.double()
    p = {k: torch.tensor(v[0], dtype=torch.float64, requires_grad=True)
         for k, v in stacked.items()}
    opt = torch.optim.Adam(p.values(), lr=SEQ_LR, eps=EPS)
    rows = torch.tensor(packed).reshape(-1, packed.shape[-1])
    s = SEQ["seqlen"]
    for _ in range(STEPS):
        opt.zero_grad()
        stages.unpipelined_loss(p, rows[:, :s], rows[:, s:2 * s]).backward()
        opt.step()
    return {k: v.detach().numpy() for k, v in p.items()}


def _jax_seq2seq_pipeline():
    """``benchmarks/pipeline_seq2seq.py::build_pipeline_seq2seq`` on 2
    CPU devices: the stacked union parameters and packed batch it
    starts from, and a function that runs its 3 steps (losses and
    final parameters)."""
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from pipeline_seq2seq import build_pipeline_seq2seq

    comm = jcmn.create_communicator("flat", devices=jax.devices("cpu")[:2])
    step, params, opt_state, batch, _ = build_pipeline_seq2seq(
        comm, vocab=SEQ["vocab"], units=SEQ["units"], seqlen=SEQ["seqlen"],
        n_layers=SEQ["layers"], n_micro=NMICRO, batch=SEQ_BATCH, lr=SEQ_LR)
    init = jax.tree_util.tree_map(np.asarray, params)

    def run():
        p, s, b = step.place(params, opt_state, batch)
        losses = []
        for _ in range(STEPS):
            p, s, m = step(p, s, b)
            losses.append(float(np.asarray(m["loss"])))
        return losses, jax.tree_util.tree_map(np.asarray, p)

    return init, np.asarray(batch[0]), run


@pytest.fixture(scope="module")
def worlds():
    """The port's worlds of 2 and 4, run while the JAX side computes."""
    from chainermn_tpu_torch.models import seq2seq_params_from_flax

    g2, g4 = _gpipe_inputs(2), _gpipe_inputs(4)
    tws, tx, tt = _train_data()
    init, packed, jax_run = _jax_seq2seq_pipeline()
    stacked = {k: v.numpy() for k, v in seq2seq_params_from_flax(init).items()}
    with ThreadPoolExecutor(2) as pool:
        port2 = pool.submit(torch_world.run_world, W.jobs_worker, 2, [
            ("gpipe_worker", g2),
            ("seq2seq_pipeline_worker", (SEQ, stacked, packed, SEQ_LR,
                                         STEPS, (EPS, EPS / 2)))],
            timeout=240)
        port4 = pool.submit(torch_world.run_world, W.jobs_worker, 4, [
            ("gpipe_worker", g4),
            ("pipeline_step_worker", (tws, tx, tt, LR, STEPS, [
                (False, EPS), (True, EPS), (False, EPS / 4)]))], timeout=240)
        gpipe = {2: _jax_gpipe(2, *g2), 4: _jax_gpipe(4, *g4)}
        losses, final = jax_run()
        s2s_f64 = _float64_seq2seq(stacked, packed)
        train = _jax_train(tws, tx, tt)
        train_f64 = _float64_train(tws, tx, tt)
        ranks = {2: port2.result(), 4: port4.result()}
    return {"gpipe": {n: (gpipe[n], ranks[n]) for n in (2, 4)},
            "stacked": stacked,
            "seq2seq": (losses, seq2seq_params_from_flax(final), s2s_f64,
                        ranks[2]),
            "train": (train, train_f64, ranks[4])}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("remat", [False, True])
def test_gpipe_values_and_gradients_match_jax(worlds, world, remat):
    """The outputs (summed over the ranks: the last stage's, zeros
    elsewhere) and each stage's gradient."""
    (y, g), ranks = worlds["gpipe"][world]
    for r, got in enumerate(ranks):
        got_y, got_g = got[0][remat]
        assert _rel_l2(got_y, y) < 1e-5
        assert _rel_l2(got_g, g[r]) < 1e-5


def test_pipeline_train_step_matches_jax_and_remat_matches_plain(worlds):
    """3 Adam steps of 4 stages: the losses and each rank's stage against
    the JAX step (at ``eps / 4``: see the module docstring) and against
    float64; with remat exactly as without.  At the JAX test's lr 0.05
    the JAX step's own fp32 parameters lie up to 5e-6 from a float64 run
    (87 % of entries within 1e-6; XLA's CPU numerics, amplified by
    Adam), so against JAX only the 3e-5 bound is held; the port's lie
    within 1e-6 of float64 and are held to both."""
    (losses, params), f64, ranks = worlds["train"]
    for r, got in enumerate(ranks):
        plain_losses, plain_w = got[1][False, EPS]
        remat_losses, remat_w = got[1][True, EPS]
        jax_losses, jax_w = got[1][False, EPS / 4]
        np.testing.assert_allclose(plain_losses, losses, rtol=1e-5)
        np.testing.assert_allclose(jax_losses, losses, rtol=1e-5)
        _adam_close(jax_w, params[r], share=0.0)
        _adam_close(plain_w, f64[r])
        assert remat_losses == plain_losses
        np.testing.assert_array_equal(remat_w, plain_w)
    assert losses[-1] < losses[0]


def test_seq2seq_pipeline_matches_jax(worlds):
    """The enc|dec split at world 2 (the encoder's rank sends the packed
    (h, c) and targets, the decoder's forms the loss): losses and each
    rank's half of the union parameters against the JAX pipeline (at
    ``eps / 2``) and against float64; the half a rank does not use
    stays as it was."""
    losses, final, f64, ranks = worlds["seq2seq"]
    stacked = worlds["stacked"]
    for r, got in enumerate(ranks):
        mine = "enc." if r == 0 else "dec."
        for eps, ref in ((EPS / 2, lambda k: final[k].numpy()[r]),
                         (EPS, lambda k: f64[k])):
            res = got[1][eps]
            np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
            for k, v in res["params"].items():
                if k.startswith(mine):
                    _adam_close(v, ref(k))
                else:
                    np.testing.assert_array_equal(v, stacked[k][r])
    assert losses[-1] < losses[0]


@pytest.fixture
def comm1():
    """A gloo world of one in this process."""
    from chainermn_tpu_torch.communicators import create_communicator

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield create_communicator("pure_nccl")
    finally:
        dist.destroy_process_group()


def test_one_stage_seq2seq_pipeline_equals_unpipelined_step(comm1):
    """World 1 (a card's layout): the encoder and the decoder in one
    stage, 4 microbatches, against one unpipelined Adam step on the same
    union parameters and batch."""
    from chainermn_tpu_torch.models import Decoder, Encoder
    from chainermn_tpu_torch.parallel.seq2seq_pipeline import (
        Seq2SeqStages, carry_width, pack_batch, union_params)

    rng = np.random.RandomState(0)
    src = torch.from_numpy(rng.randint(3, SEQ["vocab"], (SEQ_BATCH,
                                                          SEQ["seqlen"])))
    ys = torch.from_numpy(rng.randint(3, SEQ["vocab"], (SEQ_BATCH,
                                                         SEQ["seqlen"])))
    stacked = union_params(Encoder(SEQ["vocab"], SEQ["units"], SEQ["layers"]),
                           Decoder(SEQ["vocab"], SEQ["units"], SEQ["layers"],
                                   seed=5), 1)
    packed = pack_batch(src, ys, NMICRO, carry_width(
        SEQ["units"], SEQ["layers"], SEQ["seqlen"])).numpy()
    got = W.seq2seq_pipeline_run(comm1, SEQ, stacked, packed, SEQ_LR, STEPS)

    stages = Seq2SeqStages(comm1, SEQ["vocab"], SEQ["units"], SEQ["layers"],
                           SEQ["seqlen"])
    twin = {k: torch.tensor(v[0], requires_grad=True)
            for k, v in stacked.items()}
    opt = torch.optim.Adam(twin.values(), lr=SEQ_LR)
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = stages.unpipelined_loss(twin, src, ys)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
    for k, v in twin.items():
        _adam_close(got["params"][k], v.detach().numpy())


def test_rejections(comm1):
    """As the JAX step: a multi-node optimizer, a communicator with two
    axes and a batch with another microbatch count are refused; so is a
    batch the microbatch count does not divide."""
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.parallel import (build_pipeline_train_step,
                                              place_stage_params)
    from chainermn_tpu_torch.parallel.seq2seq_pipeline import pack_batch

    ws, x, t = _train_data()
    w = place_stage_params(ws, comm1)
    stage = lambda p, h: torch.tanh(h @ p)  # noqa: E731
    mse = lambda y, t: ((y - t) ** 2).mean()  # noqa: E731
    mn = create_multi_node_optimizer(torch.optim.Adam([w]), comm1)
    with pytest.raises(ValueError, match="plain torch.optim"):
        build_pipeline_train_step(comm1, stage, mse, mn, n_micro=NMICRO)
    with pytest.raises(ValueError, match="flat"):
        build_pipeline_train_step(create_communicator("hierarchical"), stage,
                                  mse, torch.optim.Adam([w]), n_micro=NMICRO)
    step = build_pipeline_train_step(comm1, stage, mse,
                                     torch.optim.Adam([w]),
                                     n_micro=2 * NMICRO)
    with pytest.raises(ValueError, match="n_micro"):
        step(w, (torch.from_numpy(x), torch.from_numpy(t)))
    with pytest.raises(ValueError, match="divisible"):
        pack_batch(torch.zeros(8, 4), torch.zeros(8, 4), 3, 40)
