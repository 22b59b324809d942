"""Port parity of the model-parallel tier: point to point, the
differentiable collectives and ``MultiNodeChainList``.

The JAX package runs these in one controller (``shard_map`` over CPU
devices, ``MultiNodeChainList`` over ``naive`` communicators); the port
runs one process per rank.  Shared numpy inputs go through both: the
port in a gloo world of 3 (the collectives, ``send``/``recv``,
``exchange``, and chains: a straight one of 4 stages on the default
ranks, joins, the external input, a dead branch, a 0 -> 1 -> 0 -> 1
chain, a tuple edge, a missing producer), one of 2 (the ``seq2seq_mp1``
chain) and in-process at world 1.  Each rank's result is held against
the JAX package's row or device for that rank
(``tests/test_functions.py``, ``tests/test_link.py``).

Tolerances: moves and ``pseudo_connect`` are exact; sums of 3 fp32 rows
in another order 1e-6 absolute (1e-5 relative); the chains' outputs,
losses and gradients 1e-5 relative L2 per array (fp32 Dense and tanh
layers); the seq2seq chain's losses 1e-5 relative, gradients 1e-5
relative L2, and parameters after 3 Adam steps within 3e-5 with 99.9 %
of entries within 1e-6 (Adam's first steps move each entry by about
``lr`` whatever its gradient's size, so rounding there is amplified, as
in the LM's parity test).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from flax import linen as fnn
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import chainermn_tpu as jcmn
from chainermn_tpu import functions as JF
from chainermn_tpu.link import MultiNodeChainList as JaxChain
from chainermn_tpu.models.seq2seq import seq2seq_loss as jax_seq2seq_loss
from chainermn_tpu.models.seq2seq import teacher_forcing as jax_tf
from chainermn_tpu.utils import SyntheticTranslationDataset

import test_torch_world as torch_world
import torch_mp_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 3
SHIFTS = (1, -1, 2)
SEQ = dict(vocab=32, units=16, layers=2)
SEQ_LR, SEQ_STEPS, SEQ_BATCH, SEQ_LEN = 1e-3, 3, 8, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's in-process torch work: the
    suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# The JAX side
# ----------------------------------------------------------------------
def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("mn",))


def _jax_collective(name):
    return {
        "psum": lambda x: JF.psum(x, "mn"),
        "pmean": lambda x: JF.pmean(x, "mn"),
        "pmax": lambda x: JF.pmax(x, "mn"),
        "pmin": lambda x: JF.pmin(x, "mn"),
        "all_gather": lambda x: JF.all_gather(x, "mn", axis=0),
        "all_gather_stacked": lambda x: JF.all_gather(x, "mn", axis=1,
                                                      tiled=False),
        "all_to_all": lambda x: JF.all_to_all(x, "mn", split_axis=0,
                                              concat_axis=1),
        "ppermute": lambda x: JF.ppermute(x, "mn", W.PERM),
        "bcast": lambda x: JF.bcast(x, "mn", root=2),
        "gather": lambda x: JF.gather(x, "mn", root=1, axis=0),
        "scatter": lambda x: JF.scatter(x, "mn", root=0, axis=0),
        "reduce_scatter": lambda x: JF.reduce_scatter(x, "mn"),
    }[name]


def _shmap(f, n, n_in=1):
    return jax.jit(jax.shard_map(f, mesh=_mesh(n), in_specs=(P("mn"),) * n_in,
                                 out_specs=P("mn"), check_vma=False))


def _flat(a):
    """Per-rank rows -> the global array that ``P("mn")`` splits."""
    return a.reshape(-1, *a.shape[2:])


def _rows(a, n):
    """A global shard_map output as its ``n`` per-device blocks."""
    a = np.asarray(a)
    return a.reshape(n, a.shape[0] // n, *a.shape[1:])


class JBlock(fnn.Module):
    width: int

    @fnn.compact
    def __call__(self, x):
        return jnp.tanh(fnn.Dense(self.width)(x))


class JJoin(fnn.Module):
    width: int

    @fnn.compact
    def __call__(self, a, b):
        return fnn.Dense(self.width)(jnp.concatenate([a, b], axis=-1))


class JPair(fnn.Module):
    width: int

    @fnn.compact
    def __call__(self, x):
        return jnp.tanh(fnn.Dense(self.width)(x)), x


class JFromPair(fnn.Module):
    width: int = 0

    def __call__(self, pair):
        return pair[0] * pair[1]


JAX_KINDS = {"block": JBlock, "join": JJoin, "pair": JPair,
             "from_pair": JFromPair}

# name -> [(kind, width, rank_in, rank)]; rank None: the default
# (len(stages) % size)
GRAPHS = {
    "straight": [("block", 5, None if i == 0 else (i - 1) % 3, None)
                 for i in range(4)],
    "join": [("block", 5, None, 0), ("block", 5, None, 1),
             ("join", 3, [0, 1], 2)],
    "fan_out": [("block", 5, None, 0), ("block", 5, 0, 1),
                ("join", 4, [0, 1], 2)],
    "external_input": [("block", 5, None, 0), ("join", 4, [0, None], 1)],
    "dead_branch": [("block", 5, None, 0), ("block", 5, 0, 2),
                    ("block", 3, 0, 1)],
    "revisit_0101": [("block", 5, None, 0), ("block", 5, 0, 1),
                     ("block", 5, 1, 0), ("block", 4, 0, 1)],
    "tuple_edge": [("pair", 5, None, 0), ("from_pair", 0, 0, 1),
                   ("block", 3, 1, 2)],
    "missing_producer": [("block", 4, 3, 0)],
}


def _jax_graph_init(stages, n, x):
    """The JAX chain of ``stages`` on ``n`` CPU devices and its params,
    or the ValueError its ``init`` raises."""
    chain = JaxChain(jcmn.create_communicator(
        "naive", devices=jax.devices("cpu")[:n]))
    for kind, width, rank_in, r in stages:
        chain.add_link(JAX_KINDS[kind](width), rank_in=rank_in, rank=r)
    try:
        return chain, jax.jit(chain.init)(jax.random.PRNGKey(0),
                                          jnp.asarray(x))
    except ValueError as e:
        return chain, str(e)


def _jax_graph_eval(chain, params, x):
    """Its output, loss ``sum(y ** 2)`` and per-stage gradients (one
    compiled program each: the chain's eager stage-by-stage dispatch is
    the slow part on the CPU)."""
    if isinstance(params, str):
        return {"error": params}
    loss, grads = jax.jit(chain.value_and_grad(lambda y: jnp.sum(y ** 2)))(
        params, jnp.asarray(x))
    return {"y": np.asarray(jax.jit(chain.__call__)(params, jnp.asarray(x))),
            "loss": float(loss),
            "grads": [jax.tree_util.tree_map(np.asarray, g) for g in grads]}


def _port_graphs(graphs, inits, n_in):
    """The port's stages with the JAX init's parameters, or zeros where
    the JAX declaration failed (the port must then fail the same way)."""
    def params(name, i, width):
        p = inits[name][1]
        if not isinstance(p, str):
            return jax.tree_util.tree_map(np.asarray, p[i]).get("params", {})
        return {"Dense_0": {"kernel": np.zeros((n_in, width), np.float32),
                            "bias": np.zeros(width, np.float32)}}

    return {name: [(kind, params(name, i, width), rank_in, r)
                   for i, (kind, width, rank_in, r) in enumerate(st)]
            for name, st in graphs.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ----------------------------------------------------------------------
# The worlds
# ----------------------------------------------------------------------
def _collective_inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(WORLD, WORLD, 6).astype(np.float32)
    values = {name: _rows(_shmap(_jax_collective(name), WORLD)(_flat(x)),
                          WORLD) for name in W.COLLECTIVES}
    weights = {name: rng.randn(*v.shape).astype(np.float32)
               for name, v in values.items()}
    return x, values, weights


@pytest.fixture(scope="module")
def world3():
    """The port's world of 3, run while the JAX side computes."""
    x, values, weights = _collective_inputs()
    rng = np.random.RandomState(2)
    ew = rng.randn(WORLD, 4).astype(np.float32)
    xc = rng.randn(2, 5).astype(np.float32)
    inits = {k: _jax_graph_init(v, WORLD, xc) for k, v in GRAPHS.items()}
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(
            torch_world.run_world, W.jobs_worker, WORLD, [
                ("functions_worker", (x, weights)),
                ("exchange_worker", (x[:, 0, :4], ew, SHIFTS)),
                ("chain_worker", (_port_graphs(GRAPHS, inits, 5), xc))],
            timeout=240)
        jax_graphs = {k: _jax_graph_eval(*inits[k], xc) for k in GRAPHS}
        ranks = port.result()
    return x, values, weights, ew, jax_graphs, ranks


# ----------------------------------------------------------------------
# Point to point and the collectives
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", W.COLLECTIVES)
def test_collective_value_and_transpose_match_jax(world3, name):
    x, values, weights, _, _, ranks = world3
    fn = _jax_collective(name)
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][0][name]["value"], values[name][r],
                                   rtol=1e-5, atol=1e-6)
    grad = _shmap(jax.grad(lambda x, w: jnp.sum(fn(x) * w)), WORLD, 2)
    if name in ("pmax", "pmin"):
        with pytest.raises(NotImplementedError, match=f"'{name}'"):
            grad(_flat(x), _flat(weights[name]))
        for r in range(WORLD):
            assert f"'{name}'" in ranks[r][0][name]["error"]
        return
    grads = _rows(grad(_flat(x), _flat(weights[name])), WORLD)
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][0][name]["grad"], grads[r],
                                   rtol=1e-5, atol=1e-6)


def test_send_recv_value_and_gradient(world3):
    """The JAX test's send (here 1 -> 2): the value arrives, and the
    cotangent of ``sum(3 y)`` rides back to the source only."""
    x, _, _, _, _, ranks = world3
    last = WORLD - 1

    def loss(x):
        y = JF.send(x, "mn", dest=last, source=1)
        return jnp.where(lax.axis_index("mn") == last, jnp.sum(y * 3.0), 0.0)

    jv = _rows(_shmap(lambda x: JF.send(x, "mn", dest=last, source=1),
                      WORLD)(_flat(x)), WORLD)
    jg = _rows(_shmap(jax.grad(loss), WORLD)(_flat(x)), WORLD)
    np.testing.assert_array_equal(ranks[last][0]["p2p_value"], jv[last])
    np.testing.assert_array_equal(ranks[1][0]["p2p_grad"], jg[1])
    for r in (0, last):
        assert ranks[r][0]["p2p_grad"] is None and not jg[r].any()


def test_send_recv_tuple_with_an_int_leaf(world3):
    """A tuple edge: float leaves carry their gradients back, an int
    leaf crosses without one (both sides tell from the dtype)."""
    x, _, _, _, _, ranks = world3
    last = WORLD - 1
    h, ints, c = ranks[0][0]["tuple_value"]
    np.testing.assert_array_equal(h, x[last] * 2.0)
    np.testing.assert_array_equal(ints, np.arange(5, dtype=np.int32))
    np.testing.assert_array_equal(c, x[last])
    assert ranks[0][0]["tuple_int_requires_grad"] is False
    np.testing.assert_array_equal(ranks[last][0]["tuple_grad"],
                                  np.full_like(x[last], 2 * 5.0 + 7.0))


def test_send_obj_recv_obj(world3):
    x, _, _, _, _, ranks = world3
    got = ranks[WORLD - 1][0]["obj"]
    assert got["from"] == 0
    np.testing.assert_array_equal(got["x"], x[0])


def test_pseudo_connect_value_and_grad(world3):
    y, d_grad, a_grad = world3[5][0][0]["pseudo"]
    jy = JF.pseudo_connect(jnp.ones((3,)), jnp.arange(4.0))
    jd = jax.grad(lambda d: jnp.sum(JF.pseudo_connect(d, jnp.arange(4.0))
                                    ** 2))(jnp.ones((3,)))
    np.testing.assert_array_equal(y, np.asarray(jy))
    np.testing.assert_array_equal(d_grad, np.asarray(jd))
    np.testing.assert_array_equal(a_grad, 2 * np.arange(4.0))


@pytest.mark.parametrize("shift", SHIFTS)
def test_exchange_ring_matches_jax(world3, shift):
    x, _, _, ew, _, ranks = world3
    ex = x[:, 0, :4]
    f = lambda x: JF.exchange(x, "mn", shift=shift)  # noqa: E731
    jv = _rows(_shmap(f, WORLD)(ex), WORLD)
    jg = _rows(_shmap(jax.grad(lambda x, w: jnp.sum(f(x) * w)), WORLD, 2)(
        ex, ew), WORLD)
    for r in range(WORLD):
        y, g = ranks[r][1][shift]
        np.testing.assert_array_equal(y, jv[r][0])
        np.testing.assert_array_equal(g, jg[r][0])


# ----------------------------------------------------------------------
# MultiNodeChainList
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_chain_graphs_match_jax(world3, name):
    """A straight chain of 4 stages on the default ranks (the fourth
    back on rank 0), joins (``rank_in=[0, 1]``), an output read by two
    consumers (its cotangents add up), the external input inside a list
    (``[0, None]``), a dead branch (zero gradients), a chain that visits
    rank 0 and rank 1 twice, a tuple edge, and a missing producer (the
    JAX package's ValueError, on every rank): the output on the last
    stage's rank, the loss on every rank and each stage's gradients."""
    jax_graph, ranks, stages = world3[4][name], world3[5], GRAPHS[name]
    got = [r[2][name] for r in ranks]
    if "error" in jax_graph:
        for g in got:
            assert g == {"error": jax_graph["error"]}
        return
    rank_of = [r if r is not None else i % WORLD
               for i, (_, _, _, r) in enumerate(stages)]
    assert _rel_l2(got[rank_of[-1]]["y"], jax_graph["y"]) < 1e-5
    for g in got:
        assert abs(g["loss"] - jax_graph["loss"]) <= 1e-5 * abs(
            jax_graph["loss"])
    for i, (kind, _, _, _) in enumerate(stages):
        if kind == "from_pair":
            continue
        kernel, bias = got[rank_of[i]]["grads"][i]
        ref = jax_graph["grads"][i]["params"]["Dense_0"]
        for a, b in ((kernel, ref["kernel"]), (bias, ref["bias"])):
            if not np.asarray(b).any():  # a dead branch: exact zeros
                np.testing.assert_array_equal(a, 0.0)
            else:
                assert _rel_l2(a, b) < 1e-5, (name, i)


def test_placed_module_routing_and_default_ranks():
    """``create_multi_node_n_step_rnn`` with routing gives a
    ``PlacedModule``, whose edges ``add_link`` applies; the default
    rank is ``len(stages) % size``; only this rank's stages are
    registered."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.link import MultiNodeChainList, PlacedModule
    from chainermn_tpu_torch.links import (MultiNodeNStepRNN,
                                           create_multi_node_n_step_rnn)

    placed = create_multi_node_n_step_rnn(4, 8, 2, rank_in=None, rank_out=1)
    assert isinstance(placed, PlacedModule) and placed.rank_out == 1
    assert isinstance(create_multi_node_n_step_rnn(4, 8), MultiNodeNStepRNN)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        chain = MultiNodeChainList(create_communicator("pure_nccl"))
        chain.add_link(placed).add_link(torch.nn.Identity(), rank_in=0)
        assert [chain.stage_rank(i) for i in range(2)] == [0, 0]
        assert chain._stages[0].rank_out == 1
        assert len(chain.local) == 2
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# The seq2seq_mp1 chain
# ----------------------------------------------------------------------
def _mp1_stages():
    sys.path.insert(0, os.path.join(REPO, "examples", "seq2seq"))
    from seq2seq_mp1 import DecoderStage, EncoderStage

    return EncoderStage, DecoderStage


def _seq2seq_batches():
    ds = SyntheticTranslationDataset(SEQ_STEPS * SEQ_BATCH, vocab=SEQ["vocab"],
                                     max_len=SEQ_LEN, seed=0)
    return [tuple(np.stack([ds[i][k] for i in range(s * SEQ_BATCH,
                                                    (s + 1) * SEQ_BATCH)])
                  for k in (0, 1)) for s in range(SEQ_STEPS)]


class _Compiled:
    """A flax stage whose ``apply`` is one compiled program: the JAX
    chain differentiates each stage eagerly, which re-traces an LSTM's
    scan on every call on the CPU."""

    def __init__(self, module):
        self.init = module.init
        self.apply = jax.jit(module.apply)


@pytest.fixture(scope="module")
def seq2seq_jax():
    """The JAX chain (encoder on device 0, decoder on 1) for 3 Adam
    steps: losses, the first step's gradients, the final parameters;
    and the port's chain at world 2 on the same initial parameters,
    run meanwhile."""
    enc_cls, dec_cls = _mp1_stages()
    chain = JaxChain(jcmn.create_communicator(
        "naive", devices=jax.devices("cpu")[:2]))
    chain.add_link(_Compiled(enc_cls(SEQ["vocab"], SEQ["units"],
                                     SEQ["layers"])),
                   rank_in=None, rank_out=1, rank=0)
    chain.add_link(_Compiled(dec_cls(SEQ["vocab"], SEQ["units"],
                                     SEQ["layers"])),
                   rank_in=[0, None], rank_out=None, rank=1)
    batches = _seq2seq_batches()

    def inputs(xs, ys):
        ys_in, ys_out = jax_tf(jnp.asarray(ys))
        return [jnp.asarray(xs), ys_in], ys_out

    # each stage initialised by one compiled init (the chain's own init
    # dispatches op by op), then placed on its stage's device
    x0 = inputs(*batches[0])[0]
    enc_p = jax.jit(chain._stages[0].module.init)(jax.random.PRNGKey(0),
                                                  x0)
    state = jax.jit(chain._stages[0].module.apply)(enc_p, x0)
    dec_p = jax.jit(chain._stages[1].module.init)(jax.random.PRNGKey(1),
                                                  state, x0)
    params = [jax.device_put(p, chain._device(st))
              for p, st in zip((enc_p, dec_p), chain._stages)]
    init = [jax.tree_util.tree_map(np.asarray, p) for p in params]
    step = chain.value_and_grad(jax_seq2seq_loss)
    opt = chain.optimizer(optax.adam(SEQ_LR))
    state = opt.init(params)
    losses, grads = [], None
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(torch_world.run_world, W.seq2seq_chain_worker, 2,
                           SEQ, init, batches, SEQ_LR, timeout=180)
        for xs, ys in batches:
            x, ys_out = inputs(xs, ys)
            loss, g = step(params, x, ys_out)
            grads = grads or [jax.tree_util.tree_map(np.asarray, t)
                              for t in g]
            params, state = opt.update(g, state, params)
            losses.append(float(loss))
        world2 = port.result()
    final = [jax.tree_util.tree_map(np.asarray, p) for p in params]
    return init, batches, losses, grads, final, world2


def _check_seq2seq_chain(jax_run, port_ranks):
    from chainermn_tpu_torch.models import seq2seq_params_from_flax

    losses, grads, final = jax_run[2:5]
    for got in port_ranks:
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    stage_rank = {0: 0, 1: len(port_ranks) - 1}
    for i in (0, 1):
        got = port_ranks[stage_rank[i]]
        ref_g = seq2seq_params_from_flax(grads[i])
        ref_p = seq2seq_params_from_flax(final[i])
        assert sorted(got["grads"][i]) == sorted(ref_g)
        for k, g in got["grads"][i].items():
            assert _rel_l2(g, ref_g[k].numpy()) < 1e-5, k
        gap = np.concatenate([np.abs(v - ref_p[k].numpy()).ravel()
                              for k, v in got["params"][i].items()])
        assert gap.max() < 3e-5 and np.mean(gap < 1e-6) >= 0.999, (
            gap.max(), np.mean(gap < 1e-6))


def test_seq2seq_mp1_chain_world2_matches_jax(seq2seq_jax):
    """Encoder on rank 0, decoder on rank 1, the (h, c) state and its
    cotangent over gloo: loss, each stage's gradients and parameters
    after 3 Adam steps against the JAX chain on 2 CPU devices."""
    _check_seq2seq_chain(seq2seq_jax, seq2seq_jax[5])


def test_seq2seq_mp1_chain_world1_matches_jax(seq2seq_jax):
    """Both stages on the one rank (the card's layout): a same-rank
    edge is the tensor itself."""
    from chainermn_tpu_torch.communicators import create_communicator

    init, batches = seq2seq_jax[:2]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        got = W.seq2seq_chain_run(create_communicator("pure_nccl"), SEQ, init,
                                  batches, SEQ_LR)
    finally:
        dist.destroy_process_group()
    _check_seq2seq_chain(seq2seq_jax, [got])
