"""Port parity of the optimizer's tier 2: double buffering, ZeRO stage 1,
gradient accumulation and remat, against the JAX package's
``create_multi_node_optimizer(double_buffering=, zero_redundancy=)`` and
``build_train_step(accum_steps=, remat=)`` on the same numpy inputs.

The multi-rank cases run in one spawned gloo world per world size (2,
3, and 4 as 2 x 2 nodes for ``hier_rs_ag``), each through
``torch_mp_workers.jobs_worker``, while the JAX side computes on as many
CPU devices; accumulation and remat run in a gloo world of one in this
process against a one-device JAX mesh.

Tolerances:

* the quadratic cases (``0.5 * |w - mean(x)|^2``, dyadic data whose
  every sum and SGD step is exact) are bit-equal where the optimizer is
  SGD: double buffering's zero-then-stale values, its bf16 buffer bucket
  by bucket against the JAX ``state.prev_grads`` of each device, and its
  parameters (world 2);
* Adam's arithmetic differs between optax and ``torch.optim`` (torch
  updates the first moment by ``lerp``, the second by ``addcmul``), and
  XLA's fp32 trajectories drift from float64 by up to ~2e-6 here
  (ROADMAP Queue 3), so Adam's parameters are held within 3e-5 of the
  JAX step (the LM bound's), the MLP's double buffering within the whole
  LM bound (99.9 % within 1e-6 as well), the ZeRO moments within 1e-4
  of their largest entry; SGD on the MLP within 1e-6;
* the port's ZeRO against the port's plain wrapper on the same inputs is
  bit-equal (the shards step by the same elementwise arithmetic), at
  worlds 2 and 3 on the flat wire; the ZeRO state is compared row by row
  with the JAX ``inner_state`` (``_to_blocks`` layout), its padding
  exactly zero;
* accumulation: ``rtol=1e-5, atol=1e-7`` against the port without
  accumulation (the JAX test's bounds), 1e-6 against a float64 run,
  and 3e-5 (the LM bound's) against the JAX step with the same
  ``accum_steps``, whose fp32 Adam trajectory drifts from float64 by
  up to 1.7e-6 (ROADMAP Queue 3); the BatchNorm aux case within 1e-6;
* remat against no remat in the port: bit-equal (the same kernels run
  again); 1e-6 against a float64 run, 3e-5 against JAX.

World 3 sums the bf16 wire per addition in gloo where XLA rounds once
(ROADMAP Queue 3, image slice): once Adam has moved the parameters off the
dyadic grid a gradient may round one bf16 ulp apart, so the world-3
bf16 case is held within ``steps * lr * 2^-8`` (parameters) and 2^-6
of the largest entry (moments); its ZeRO still equals the port's plain wrapper bit
for bit.
"""

from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import chainermn_tpu as jcmn
from chainermn_tpu import comm_wire as jcw
from chainermn_tpu_torch.communicators import FAKE_NODE_SIZE_ENV

import test_torch_world as torch_world
import torch_mp_workers as W
from test_torch_hierarchical import jax_hier_comm
from test_torch_wire_int8 import PER, STEPS, mlp_case

FAKE = {FAKE_NODE_SIZE_ENV: "2"}
SMALL = dict(bucket_bytes=24, max_buckets=0)  # about a bucket a leaf


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's in-process torch work: the
    suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dyadic(rng, shape, lo=-8, hi=9):
    return (rng.randint(lo, hi, shape) / 8.0).astype(np.float32)


def _quad(n, shapes, steps, seed, per=2):
    """Dyadic parameters and per-step batches (``(steps, n * per,
    *shape)`` a leaf)."""
    rng = np.random.RandomState(seed)
    return ([_dyadic(rng, s) for s in shapes],
            [_dyadic(rng, (steps, n * per) + s) for s in shapes])


def _rank_rows(n, w_shape, steps, per=2):
    """The JAX tests' batch: rank r's rows all r."""
    x = np.repeat(np.arange(n, dtype=np.float32), per)
    x = np.broadcast_to(x[:, None], (n * per,) + w_shape)
    return [np.broadcast_to(x, (steps,) + x.shape).copy()]


SHAPES = [(5,), (3, 4), (7,)]


def _cases(n):
    """Every quadratic case of world ``n``: ``name -> (w0, xs, inner,
    lr, opt_kw, checks)``."""
    out = {}
    if n == 2:
        out["db_stale"] = ([np.zeros(2, np.float32)],
                           _rank_rows(2, (2,), 2), "sgd", 1.0,
                           dict(double_buffering=True), ())
        w0, xs = _quad(2, SHAPES, 3, 1)
        out["db_buffer"] = (w0, xs, "sgd", 0.5, dict(
            double_buffering=True, wire=dict(codec="bf16", **SMALL)),
            ("skip",))
        out["zero_adam"] = ([np.full(8, 0.3, np.float32)],
                            _rank_rows(2, (8,), 3), "adam", 0.1,
                            dict(zero_redundancy=True), ("zero",))
    if n in (2, 3):
        out["zero_pad"] = (
            [np.asarray([0.1, -0.2, 0.3, 0.5, -0.4], np.float32)],
            _rank_rows(n, (5,), 3), "adam", 0.05,
            dict(zero_redundancy=True), ("zero",))
        w0, xs = _quad(n, SHAPES, 3, 2)
        out["zero_multi"] = (w0, xs, "adam", 0.1, dict(
            zero_redundancy=True, wire=dict(codec="bf16", **SMALL)),
            ("zero",))
    if n == 4:
        w0, xs = _quad(4, SHAPES, 3, 3)
        out["zero_hier"] = (w0, xs, "adam", 0.1, dict(
            zero_redundancy=True,
            wire=dict(codec="bf16", schedule="hier_rs_ag", **SMALL)),
            ("zero",))
    return out


def _jax_comm(n):
    if n == 4:
        return jax_hier_comm()
    return jcmn.create_communicator("tpu", devices=jax.devices("cpu")[:n])


def _jax_quad(n, w0, xs, inner, lr, opt_kw):
    """The JAX step of one quadratic case: per-step parameters, losses,
    the final state, the optimizer and the final parameters."""
    comm = _jax_comm(n)
    kw = dict(opt_kw)
    if isinstance(kw.get("wire"), dict):
        kw["wire"] = jcw.WireConfig(**kw["wire"])
    opt = {"sgd": optax.sgd, "adam": optax.adam}[inner](lr)
    mn = jcmn.create_multi_node_optimizer(opt, comm, **kw)

    def loss(p, b):
        return sum(0.5 * jnp.sum((w - x.mean(0)) ** 2) for w, x in zip(p, b))

    step = jcmn.build_train_step(comm, loss, mn, donate=False)
    p0 = [jnp.asarray(w) for w in w0]
    p, s = step.place(p0, mn.init(p0))
    params, losses = [], []
    for i in range(xs[0].shape[0]):
        p, s, m = step(p, s, tuple(jnp.asarray(x[i]) for x in xs))
        params.append([np.asarray(w) for w in jax.device_get(p)])
        losses.append(float(m["loss"]))
    return {"params": params, "losses": losses, "state": s, "opt": mn,
            "p": p}


def _per_device(x):
    return [np.asarray(sh.data).astype(np.float32) for sh in sorted(
        x.addressable_shards, key=lambda sh: sh.device.id)]


def _jax_mlp_db(inner, lr):
    model, v, (x, y) = mlp_case(2)
    comm = _jax_comm(2)
    opt = {"sgd": optax.sgd, "adam": optax.adam}[inner](lr)
    mn = jcmn.create_multi_node_optimizer(opt, comm, double_buffering=True)

    def loss_fn(p, b):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(p, b[0]), b[1]).mean()

    step = jcmn.build_train_step(comm, loss_fn, mn, donate=False)
    p, s = step.place(v, mn.init(v))
    losses = []
    for i in range(STEPS):
        rows = slice(i * 2 * PER, (i + 1) * 2 * PER)
        p, s, m = step(p, s, (jnp.asarray(x[rows]), jnp.asarray(y[rows])))
        losses.append(float(m["loss"]))
    return losses, [np.asarray(leaf) for leaf in
                    jax.tree_util.tree_leaves(jax.device_get(p))]


MLP_RUNS = [("sgd", 0.05), ("adam", 1e-3)]


@pytest.fixture(scope="module")
def worlds():
    """The port's worlds of 2, 3 and 2 x 2, run while the JAX side
    computes."""
    _, v, data = mlp_case(2)
    cases = {n: _cases(n) for n in (2, 3, 4)}
    with ThreadPoolExecutor(3) as pool:
        port = {
            2: pool.submit(torch_world.run_world, W.jobs_worker, 2, [
                ("quad_cases_worker", (cases[2],)),
                ("mlp_db_worker", (v, data, STEPS, MLP_RUNS))],
                timeout=240),
            3: pool.submit(torch_world.run_world, W.jobs_worker, 3, [
                ("quad_cases_worker", (cases[3],))], timeout=240),
            4: pool.submit(torch_world.run_world, W.jobs_worker, 4, [
                ("quad_cases_worker", (cases[4], FAKE))], env=FAKE,
                timeout=240)}
        ref = {(n, name): _jax_quad(n, *case[:5])
               for n in cases for name, case in cases[n].items()}
        mlp = {inner: _jax_mlp_db(inner, lr) for inner, lr in MLP_RUNS}
        ranks = {n: [r[0] for r in f.result()] for n, f in port.items()}
        ranks["mlp"] = [r[1] for r in port[2].result()]
    return cases, ref, ranks, mlp


# ----------------------------------------------------------------------
# double buffering
# ----------------------------------------------------------------------
def test_double_buffering_applies_zeros_then_stale(worlds):
    """JAX ``TestDoubleBuffering::test_first_update_is_zero_then_stale``
    at world 2: step 1 applies zeros, step 2 the mean of step 1's
    gradients (``mean(0 - r) = -0.5``, so ``w = 0.5``), bit-equal to the
    JAX step."""
    _, ref, ranks, _ = worlds
    want = ref[2, "db_stale"]["params"]
    for r in ranks[2]:
        got = r["db_stale"]["params"]
        np.testing.assert_array_equal(got[0][0], np.zeros(2, np.float32))
        np.testing.assert_array_equal(got[1][0], np.full(2, 0.5, np.float32))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])


def test_double_buffering_buffer_equals_jax_prev_grads(worlds):
    """The bf16 wire, three buckets: after each of 3 SGD steps every
    rank's stored buffer equals its device's ``state.prev_grads`` bucket
    by bucket, bit for bit (the buffer of the last step), and the
    parameters of every step equal the JAX step's."""
    _, ref, ranks, _ = worlds
    jref = ref[2, "db_buffer"]
    prev = [_per_device(b) for b in jref["state"].prev_grads]
    assert len(prev) == 3  # 20, 48 and 28 bytes over a 24-byte target
    for rank, r in enumerate(ranks[2]):
        got = r["db_buffer"]
        assert len(got["buffer"][-1]) == len(prev)
        for b, want in zip(got["buffer"][-1], prev):
            np.testing.assert_array_equal(b, want[rank])
        for g, w in zip(got["params"], jref["params"]):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got["losses"], jref["losses"], rtol=1e-6)


def test_double_buffering_skip_keeps_the_buffer(worlds):
    """One rank's NaN loss under ``nonfinite="skip"``: both ranks skip,
    the buffer and the parameters stay as they were."""
    _, _, ranks, _ = worlds
    for r in ranks[2]:
        assert r["db_buffer"]["skip_finite"] == 0.0
        assert r["db_buffer"]["skip_kept"]


@pytest.mark.parametrize("inner", [i for i, _ in MLP_RUNS])
def test_double_buffering_mlp_steps_match_jax(worlds, inner):
    """The MNIST MLP (fp32 wire), 3 steps of SGD or Adam with double
    buffering at world 2 against the JAX step: every rank's parameters
    equal rank 0's; losses within 1e-5; SGD's parameters within 1e-6,
    Adam's within the LM bound."""
    *_, ranks, mlp = worlds
    losses, leaves = mlp[inner]
    for r in ranks["mlp"]:
        for a, b in zip(r[inner]["params"], ranks["mlp"][0][inner]["params"]):
            np.testing.assert_array_equal(a, b)
    got = ranks["mlp"][0][inner]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    gap = np.concatenate([np.abs(a - b).ravel()
                          for a, b in zip(got["params"], leaves)])
    if inner == "sgd":
        assert gap.max() <= 1e-6, gap.max()
    else:
        assert gap.max() < 3e-5 and np.mean(gap < 1e-6) >= 0.999


# ----------------------------------------------------------------------
# ZeRO
# ----------------------------------------------------------------------
ZERO = [(2, "zero_adam"), (2, "zero_pad"), (2, "zero_multi"),
        (3, "zero_pad"), (3, "zero_multi"), (4, "zero_hier")]


def _world3_bf16(n, name):
    """A bf16 wire summed over 3 ranks: gloo rounds after each addition,
    XLA once (ROADMAP Queue 3, image slice)."""
    return n == 3 and name == "zero_multi"


def _param_atol(n, name, lr, steps=3):
    """3e-5 (the LM bound's) where the two sides sum alike; at world 3
    on the bf16 wire a gradient may round one bf16 ulp (2^-8 relative)
    apart a step, which moves Adam's normalized update by at most
    ``lr * 2^-8``."""
    return steps * lr * 2.0 ** -8 if _world3_bf16(n, name) else 3e-5


@pytest.mark.parametrize("n,name", ZERO, ids=lambda c: str(c))
def test_zero_matches_jax_zero_and_the_plain_wrapper(worlds, n, name):
    """Parameters after 3 Adam steps (``TestZeroRedundancy::
    test_matches_plain_adam`` / ``_with_padding``, and multi-leaf cases
    whose buckets concatenate blocked leaves column-wise) against the
    JAX ZeRO step, within :func:`_param_atol`; on the flat wire the
    port's ZeRO equals the port's plain wrapper bit for bit."""
    cases, ref, ranks, _ = worlds
    want = ref[n, name]["params"][-1]
    atol = _param_atol(n, name, cases[n][name][3])
    for r in ranks[n]:
        got = r[name]
        for a, b in zip(got["params"][-1], want):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        if name != "zero_hier":
            for a, b in zip(got["params"][-1], got["plain_params"][-1]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,name", ZERO, ids=lambda c: str(c))
def test_zero_state_is_block_r_of_jax_state(worlds, n, name):
    """Rank r holds row r of the JAX ``inner_state``'s ``(n, k)`` Adam
    moments (``_to_blocks``: the tail zero-padded, the padding exactly
    zero), within 1e-4 of each moment's largest entry (2^-6 at world 3
    on the bf16 wire: a gradient one bf16 ulp apart); its moment bytes equal the JAX ``hbm_bytes_per_rank``'s
    (less each side's scalar counts), its parameter bytes too; the
    ZeRO plan's schedules; ``reshard_state`` names the Resilience
    item."""
    _, ref, ranks, _ = worlds
    jref = ref[n, name]
    adam = jref["state"].inner_state[0]
    mu, nu = [np.asarray(m) for m in adam.mu], [np.asarray(m) for m in adam.nu]
    hbm = jref["opt"].hbm_bytes_per_rank(jref["p"], jref["state"])
    sizes = [w.size for w in jref["params"][-1]]
    share = 2.0 ** -6 if _world3_bf16(n, name) else 1e-4
    for rank, r in enumerate(ranks[n]):
        got = r[name]
        assert len(got["state"]) == len(mu)
        for st, m, v, size in zip(got["state"], mu, nu, sizes):
            assert st["exp_avg"].shape == (1, m.shape[1]) and m.shape[0] == n
            np.testing.assert_allclose(st["exp_avg"][0], m[rank], rtol=0,
                                       atol=share * np.abs(m).max())
            np.testing.assert_allclose(st["exp_avg_sq"][0], v[rank], rtol=0,
                                       atol=share * np.abs(v).max())
            pad = n * m.shape[1] - size
            start = size - rank * m.shape[1]
            if pad and start < m.shape[1]:
                tail = st["exp_avg"][0, max(start, 0):]
                np.testing.assert_array_equal(tail, 0.0)
        assert got["hbm"]["params"] == hbm["params"]
        assert (got["hbm"]["opt_state"] - 4 * got["n_scalars"]
                == hbm["opt_state"] - 8)
        want = ("hier_rs_ag",) if name == "zero_hier" else ("flat",)
        assert set(got["schedules"]) == set(want)
        assert "Resilience" in got["reshard_error"]


def test_zero_hier_keeps_ownership_linear(worlds):
    """At 2 x 2 the staged scatter's local transpose keeps rank
    ``i*K+j`` on block ``i*K+j``: rank r's shard holds row r of the
    JAX state (checked above) and the four ranks' parameters agree."""
    _, _, ranks, _ = worlds
    for r in ranks[4]:
        for a, b in zip(r["zero_hier"]["params"][-1],
                        ranks[4][0]["zero_hier"]["params"][-1]):
            np.testing.assert_array_equal(a, b)
        assert r["zero_hier"]["warnings"] == []


@pytest.fixture
def comm():
    """A gloo world of one in this process."""
    import chainermn_tpu_torch as cmn

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield cmn.create_communicator("pure_nccl")
    finally:
        dist.destroy_process_group()


REFUSALS = [
    (dict(double_buffering=True, overlap="bucket"), {}),
    (dict(double_buffering=True, zero_redundancy=True), {}),
    (dict(double_buffering=True), dict(codec="bf16", error_feedback=True)),
    (dict(zero_redundancy=True), dict(codec="bf16", error_feedback=True)),
    (dict(zero_redundancy=True), dict(codec="int8")),
]


@pytest.mark.parametrize("kw,wire", REFUSALS, ids=range(len(REFUSALS)))
def test_refusals_raise_the_jax_messages(comm, kw, wire):
    """Each refused combination raises the JAX package's ``ValueError``
    with its message."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import WireConfig

    jcomm = _jax_comm(1)
    with pytest.raises(ValueError) as want:
        jcmn.create_multi_node_optimizer(
            optax.adam(0.1), jcomm,
            wire=jcw.WireConfig(**wire) if wire else "auto", **kw)
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(ValueError) as got:
        cmn.create_multi_node_optimizer(
            torch.optim.Adam(p), comm,
            wire=WireConfig(**wire) if wire else "auto", **kw)
    assert str(got.value) == str(want.value)


def test_autotuner_and_hier_collapse(comm):
    """``tune_trace=`` and ``profile=`` raise ``NotImplementedError``
    naming "Optimizer, tier 2"; ZeRO's ``hier_rs_ag`` without a genuine
    split warns and plans ``flat``."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.comm_wire import WireConfig

    p = [torch.nn.Parameter(torch.zeros(3))]
    for kw in (dict(tune_trace=object()), dict(profile="auto")):
        with pytest.raises(NotImplementedError, match="Optimizer, tier 2"):
            cmn.create_multi_node_optimizer(torch.optim.Adam(p), comm, **kw)
    with pytest.warns(UserWarning, match="collapsing to 'flat'"):
        opt = cmn.create_multi_node_optimizer(
            torch.optim.Adam(p), comm, zero_redundancy=True,
            wire=WireConfig("bf16", schedule="hier_rs_ag"))
    assert opt.wire_plan().schedules == ("flat",)


# ----------------------------------------------------------------------
# accumulation and remat (a world of one against one JAX device)
# ----------------------------------------------------------------------
def _run_port(comm, params, loss, inner, steps, batch, **kw):
    import chainermn_tpu_torch as cmn

    opt = cmn.create_multi_node_optimizer(inner, comm)
    step = cmn.build_train_step(comm, loss, opt, **kw)
    losses = [float(step(batch)["loss"]) for _ in range(steps)]
    return [p.detach().numpy().copy() for p in params], losses


def _run_jax(params, loss, opt, steps, batch, **kw):
    comm = _jax_comm(1)
    mn = jcmn.create_multi_node_optimizer(opt, comm)
    step = jcmn.build_train_step(comm, loss, mn, donate=False, **kw)
    p, s = step.place(params, mn.init(params))
    losses = []
    for _ in range(steps):
        p, s, m = step(p, s, batch)
        losses.append(float(m["loss"]))
    return jax.device_get(p), losses


X_ACCUM = np.random.RandomState(0).randn(32, 4).astype(np.float32)


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_accumulation_matches_jax_and_the_unaccumulated_step(comm, accum):
    """``TestGradAccumulation::test_matches_unaccumulated``: Adam 0.1 on
    ``mean((x @ w - 1)^2)``, 3 steps, with ``accum_steps``: within the
    JAX test's bounds of the port's unaccumulated step and within 1e-6
    of a float64 run of it; within 3e-5 of the JAX step with the same
    ``accum_steps`` (XLA's fp32 trajectory itself lies 1.7e-6 from
    float64 here, the port's 2e-8)."""
    def jloss(p, b):
        return jnp.mean((b @ p["w"] - 1.0) ** 2)

    jp, jl = _run_jax({"w": jnp.ones((4,)) * 0.3}, jloss, optax.adam(0.1),
                      3, jnp.asarray(X_ACCUM), accum_steps=accum)
    runs = {}
    for a, dtype in ((1, torch.float64), (1, torch.float32),
                     (accum, torch.float32)):
        w = torch.nn.Parameter(torch.full((4,), 0.3, dtype=dtype))
        x = torch.from_numpy(X_ACCUM).to(dtype)
        runs[a, dtype] = _run_port(
            comm, [w], lambda b: ((b @ w - 1.0) ** 2).mean(),
            torch.optim.Adam([w], lr=0.1), 3, x, accum_steps=a)
    (w_port,), l_port = runs[accum, torch.float32]
    np.testing.assert_allclose(l_port, runs[1, torch.float32][1], rtol=1e-5)
    np.testing.assert_allclose(w_port, runs[1, torch.float32][0][0],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(w_port, runs[1, torch.float64][0][0],
                               atol=1e-6)
    np.testing.assert_allclose(l_port, jl, rtol=1e-5)
    np.testing.assert_allclose(w_port, np.asarray(jp["w"]), atol=3e-5)


def test_accumulation_errors_are_the_jax_messages(comm):
    """An indivisible batch and ``accum_steps < 1`` raise the JAX
    messages."""
    import chainermn_tpu_torch as cmn

    def jloss(p, b):
        return jnp.sum(b @ p["w"])

    comm1 = _jax_comm(1)
    mn = jcmn.create_multi_node_optimizer(optax.sgd(0.1), comm1)
    step = jcmn.build_train_step(comm1, jloss, mn, donate=False,
                                 accum_steps=3)
    p0 = {"w": jnp.ones((4,))}
    p, s = step.place(p0, mn.init(p0))
    with pytest.raises(ValueError) as want:
        step(p, s, jnp.zeros((32, 4)))
    with pytest.raises(ValueError) as want0:
        jcmn.build_train_step(comm1, jloss, mn, accum_steps=0)
    w = torch.nn.Parameter(torch.ones(4))
    opt = cmn.create_multi_node_optimizer(torch.optim.SGD([w], lr=0.1), comm)
    port = cmn.build_train_step(comm, lambda b: (b @ w).sum(), opt,
                                accum_steps=3)
    with pytest.raises(ValueError) as got:
        port(torch.zeros(32, 4))
    with pytest.raises(ValueError) as got0:
        cmn.build_train_step(comm, lambda b: (b @ w).sum(), opt,
                             accum_steps=0)
    assert str(got.value) == str(want.value)
    assert str(got0.value) == str(want0.value)


class _JaxBNNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.Dense(8)(x)
        x = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                          epsilon=1e-5)(x)
        return fnn.Dense(1)(fnn.relu(x))[:, 0]


class _BNNet(torch.nn.Module):
    """``_JaxBNNet`` with the port's BatchNorm (flax numerics)."""

    def __init__(self, variables, dropout=False):
        from chainermn_tpu_torch.models.resnet import BatchNorm

        super().__init__()
        p = variables["params"]
        self.d0, self.d1 = torch.nn.Linear(4, 8), torch.nn.Linear(8, 1)
        self.bn = BatchNorm(8)
        self.dropout = dropout
        with torch.no_grad():
            for lin, name in ((self.d0, "Dense_0"), (self.d1, "Dense_1")):
                lin.weight.copy_(torch.from_numpy(
                    np.array(p[name]["kernel"]).T))
                lin.bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))

    def forward(self, x, generator=None):
        from chainermn_tpu_torch.models._layers import dropout

        h = self.bn(self.d0(x)[:, :, None, None])[:, :, 0, 0]
        if self.dropout:
            h = dropout(h, 0.5, generator)
        return self.d1(torch.relu(h))[:, 0]


def _bn_case():
    rng = np.random.RandomState(5)
    x = (rng.randn(16, 4) * 2.0 + 1.0).astype(np.float32)
    t = rng.randn(16).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, _JaxBNNet().init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    return v, x, t


def test_accumulation_with_batchnorm_state_matches_jax(comm):
    """``TestGradAccumulation::test_with_aux_state`` with BatchNorm
    running statistics: ``accum_steps=2``, 2 SGD steps; each
    microbatch's forward starts from the step's statistics and the
    step's statistics are their mean, as the JAX aux rule; parameters
    and statistics within 1e-6 of the JAX step (``has_aux=True,
    merge_aux=...``)."""
    v, x, t = _bn_case()
    model = _JaxBNNet()

    def jloss(p, b):
        out, upd = model.apply(p, b[0], mutable=["batch_stats"])
        return jnp.mean((out - b[1]) ** 2), upd["batch_stats"]

    jp, _ = _run_jax(v, jloss, optax.sgd(0.05), 2,
                     (jnp.asarray(x), jnp.asarray(t)), accum_steps=2,
                     has_aux=True,
                     merge_aux=lambda p, a: {"params": p["params"],
                                             "batch_stats": a})
    net = _BNNet(v)
    _run_port(comm, [], lambda b: ((net(b[0]) - b[1]) ** 2).mean(),
              torch.optim.SGD(net.parameters(), lr=0.05), 2,
              (torch.from_numpy(x), torch.from_numpy(t)), accum_steps=2,
              model_state=[net.bn.running_mean, net.bn.running_var])
    bs = jp["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(net.bn.running_mean.numpy(), bs["mean"],
                               atol=1e-6)
    np.testing.assert_allclose(net.bn.running_var.numpy(), bs["var"],
                               atol=1e-6)
    np.testing.assert_allclose(net.d0.weight.detach().numpy().T,
                               jp["params"]["Dense_0"]["kernel"], atol=1e-6)
    np.testing.assert_allclose(net.d1.bias.detach().numpy(),
                               jp["params"]["Dense_1"]["bias"], atol=1e-6)
    np.testing.assert_allclose(net.bn.weight.detach().numpy(),
                               jp["params"]["BatchNorm_0"]["scale"],
                               atol=1e-6)


REMAT = [(True, None), ("nothing_saveable",
                        jax.checkpoint_policies.nothing_saveable),
         ("dots_saveable", jax.checkpoint_policies.dots_saveable)]


@pytest.mark.parametrize("remat,policy", REMAT,
                         ids=["true", "nothing_saveable", "dots_saveable"])
def test_remat_matches_plain_and_jax(comm, remat, policy):
    """``TestRemat``: the tanh MLP, Adam 0.05, ``accum_steps=2``, 3
    steps: remat (the JAX policies by name) bit-equal to the port
    without remat and within 1e-6 of a float64 run; within 3e-5 of the
    JAX step with the same policy (losses 1e-4 relative; XLA's fp32
    trajectory drifts from float64 as in the accumulation test)."""
    rng = np.random.RandomState(0)
    w1 = (rng.randn(4, 8) * 0.4).astype(np.float32)
    w2 = (rng.randn(8, 2) * 0.4).astype(np.float32)
    x = rng.randn(32, 4).astype(np.float32)

    def jloss(p, b):
        return jnp.mean((jnp.tanh(b @ p["w1"]) @ p["w2"]) ** 2)

    jp, jl = _run_jax({"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}, jloss,
                      optax.adam(0.05), 3, jnp.asarray(x), accum_steps=2,
                      remat=True if policy is None else policy)
    runs = {}
    for r, dtype in ((False, torch.float64), (False, torch.float32),
                     (remat, torch.float32)):
        p1 = torch.nn.Parameter(torch.from_numpy(w1.copy()).to(dtype))
        p2 = torch.nn.Parameter(torch.from_numpy(w2.copy()).to(dtype))
        runs[r, dtype] = _run_port(
            comm, [p1, p2], lambda b: ((torch.tanh(b @ p1) @ p2) ** 2).mean(),
            torch.optim.Adam([p1, p2], lr=0.05), 3,
            torch.from_numpy(x).to(dtype), accum_steps=2, remat=r)
    got, plain = runs[remat, torch.float32], runs[False, torch.float32]
    for a, b in zip(got[0], plain[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == plain[1]
    for a, b, c in zip(got[0], runs[False, torch.float64][0],
                       (jp["w1"], jp["w2"])):
        np.testing.assert_allclose(a, b, atol=1e-6)
        np.testing.assert_allclose(a, np.asarray(c), atol=3e-5)
    np.testing.assert_allclose(got[1], jl, rtol=1e-4)


def _bn_run(comm, remat, dropout=False, in_closure=True, steps=1):
    """The BatchNorm net, SGD 0.5; its dropout draws from a generator
    held in ``loss_fn``'s closure, or (``in_closure=False``) reached
    through an attribute, where the recompute cannot find it."""
    v, x, t = _bn_case()
    net = _BNNet(v, dropout=dropout)
    gen = torch.Generator().manual_seed(3)
    holder = type("Holder", (), {"gen": gen})

    def direct(b):
        return ((net(b[0], gen) - b[1]) ** 2).mean()

    def through_attribute(b):
        return ((net(b[0], holder.gen) - b[1]) ** 2).mean()

    _run_port(comm, [], direct if in_closure else through_attribute,
              torch.optim.SGD(net.parameters(), lr=0.5), steps,
              (torch.from_numpy(x), torch.from_numpy(t)), remat=remat,
              model_state=[net.bn.running_mean, net.bn.running_var])
    return [p.detach().numpy().copy() for p in net.parameters()] + [
        net.bn.running_mean.numpy().copy(), net.bn.running_var.numpy().copy()]


def test_remat_replays_the_dropout_mask(comm):
    """Dropout drawn from an explicit generator in ``loss_fn``'s closure:
    with remat the recompute replays the forward's mask, so 2 steps
    equal the steps without remat bit for bit; a generator the
    recompute cannot see (reached through an attribute) draws another
    mask in the recompute, and the gradients differ."""
    plain = _bn_run(comm, False, dropout=True, steps=2)
    for a, b in zip(_bn_run(comm, True, dropout=True, steps=2), plain):
        np.testing.assert_array_equal(a, b)
    unreplayed = _bn_run(comm, True, dropout=True, in_closure=False,
                         steps=2)
    assert any(not np.array_equal(a, b) for a, b in zip(unreplayed, plain))


def test_remat_updates_running_statistics_once(comm):
    """BatchNorm under remat: the recompute puts the running statistics
    back, so after 2 steps they (and the parameters) equal the steps'
    without remat bit for bit."""
    plain = _bn_run(comm, False, steps=2)
    for a, b in zip(_bn_run(comm, True, steps=2), plain):
        np.testing.assert_array_equal(a, b)
