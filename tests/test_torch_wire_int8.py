"""Port parity of the int8 gradient wire and error feedback on the flat
schedule: ``reduce_buckets`` of the port (gloo worlds of 2 and 3) against
the JAX package's ``reduce_buckets`` under ``shard_map`` on a CPU mesh of
the same size, on the same numpy inputs; ``WireConfig.validate`` against
the JAX package's; and SGD on an MLP over the int8 wire with error
feedback for a few steps against the JAX ``build_train_step``.

Tolerances: the codecs are held bit for bit (tolerance 0): int8's sum is
an integer sum, and the rest is the same fp32 arithmetic in the same
order on both sides.  The training run is held within bounds stated in
its docstring (the two frameworks' gradients differ by fp32 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import chainermn_tpu as jcmn
from chainermn_tpu import comm_wire as jcw
from chainermn_tpu.models.mlp import MLP as JaxMLP
from chainermn_tpu_torch import comm_wire as cw

import test_torch_world as torch_world

# (codec, error feedback, carry a residual in)
CASES = [("int8", False, False), ("int8", True, False), ("int8", True, True),
         ("bf16", True, True), ("f16", True, True)]


def _buckets(seed, ranks):
    """Per-rank buckets of the dtypes the wire carries, and residuals of
    their shapes: values over several binades, a bucket of zeros on
    every rank (its scale is 0), one rank far larger than the others."""
    rng = np.random.RandomState(seed)
    out = []
    for n, dtype, scale in ((1000, "float32", 1e-3), (300, "bfloat16", 1.0),
                            (64, "float32", 0.0), (257, "float32", 1e3),
                            (129, "float16", 10.0)):
        a = (rng.randn(ranks, n) * scale).astype(np.float32)
        a[-1] *= 4.0
        r = (rng.randn(ranks, n) * scale * 1e-2).astype(np.float32)
        out.append((torch.from_numpy(a).to(getattr(torch, dtype)),
                    torch.from_numpy(r).to(getattr(torch, dtype)), dtype))
    return out


def _jax_reduce(buckets, case, n):
    """The JAX package's reduce_buckets of each rank's rows: per rank,
    its means and new residuals as float32 numpy."""
    codec, ef, carry = case
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("mn",))
    arrays = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, d))
              for t, _, d in buckets]
    res = [jnp.asarray(r.float().numpy()).astype(getattr(jnp, d))
           for _, r, d in buckets]
    k = len(arrays)

    def body(*xs):
        rs = [x[0] for x in xs[k:]] if carry else None
        means, new = jcw.reduce_buckets(
            [x[0] for x in xs[:k]], ("mn",), n,
            jcw.WireConfig(codec=codec, error_feedback=ef), rs)
        return tuple(m[None] for m in means) + tuple(r[None] for r in new)

    fn = jax.shard_map(body, mesh=mesh, in_specs=P("mn"), out_specs=P("mn"),
                       check_vma=False)
    outs = [np.asarray(o.astype(jnp.float32)) for o in fn(*arrays, *res)]
    return outs[:k], outs[k:]


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def codec_world(request):
    n = request.param
    buckets = _buckets(10 + n, n)
    ranks = torch_world.run_world(
        torch_world.codec_worker, n, [b for b, _, _ in buckets],
        [r for _, r, _ in buckets], CASES, timeout=120)
    return n, buckets, ranks


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_reduce_buckets_bit_equal_jax(codec_world, case):
    """Means (in each bucket's dtype) and new residuals bit-equal to the
    JAX package's on every rank, at worlds 2 and 3 (tolerance 0).  The
    cast codecs' means are compared at world 2 only: at world 3 the
    bf16/fp16 sum itself rounds per addition in gloo and once in XLA
    (tests/test_torch_comm_wire.py::test_world3_sum_rounds_per_addition);
    their residuals are local and compared at both."""
    n, buckets, ranks = codec_world
    ref_means, ref_res = _jax_reduce(buckets, case, n)
    codec, ef, _ = case
    for r, res in enumerate(ranks):
        got = res[case]
        assert len(got["residuals"]) == (len(buckets) if ef else 0)
        for (m, dtype), (_, _, native), want in zip(got["means"], buckets,
                                                    ref_means):
            assert dtype == f"torch.{native}"
            if codec == "int8" or n == 2:
                np.testing.assert_array_equal(m, want[r], err_msg=str(case))
        for (g, dtype), (_, _, native), want in zip(got["residuals"],
                                                    buckets, ref_res):
            assert dtype == f"torch.{native}"
            np.testing.assert_array_equal(g, want[r], err_msg=str(case))


def test_int8_adds_exactly_one_collective(codec_world):
    """int8: one MAX all-reduce of the fp32 absmaxes of every bucket,
    then one int32 sum per bucket; a cast codec one sum per bucket, with
    error feedback or without."""
    _, buckets, ranks = codec_world
    sizes = [b.shape[1] for b, _, _ in buckets]
    for res in ranks:
        for case in CASES:
            calls = res[case]["calls"]
            if case[0] == "int8":
                assert calls == [("float32", len(buckets), "max")] + [
                    ("int32", s, "sum") for s in sizes]
            else:
                assert [(n, op) for _, n, op in calls] == [
                    (s, "sum") for s in sizes]


def test_int8_zero_bucket_is_safe(codec_world):
    """A bucket that is zero on every rank has scale 0: encoded on the
    grid of 1 (``safe``), its mean and residual are zeros, not NaN."""
    _, buckets, ranks = codec_world
    i = [k for k, (b, _, _) in enumerate(buckets) if not b.any()][0]
    for res in ranks:
        for case in CASES[:2]:
            assert not res[case]["means"][i][0].any()
        assert not res[("int8", True, False)]["residuals"][i][0].any()


def test_int8_residual_is_what_the_grid_lost(codec_world):
    """The residual is ``g - decode(encode(g))`` of this rank's own
    bucket: within half a grid step of zero (and the rounding of the
    residual to the bucket's dtype)."""
    _, buckets, ranks = codec_world
    for r, res in enumerate(ranks):
        for (g, _, dtype), (got, _) in zip(
                buckets, res[("int8", True, False)]["residuals"]):
            scale = float(g.float().abs().max()) / 127
            eps = torch.finfo(getattr(torch, dtype)).eps
            assert np.abs(got).max() <= scale / 2 * (1 + eps) + 1e-30


class _Comm:
    allreduce_grad_dtype = None


@pytest.mark.parametrize("kw,match", [
    (dict(codec="int4"), "codec"),
    (dict(codec="none", error_feedback=True), "error_feedback"),
    (dict(codec="f32", error_feedback=True), "error_feedback"),
    (dict(codec="int8", schedule="ring"), "schedule"),
])
def test_validate_rejects_as_jax(kw, match):
    """The port's WireConfig.validate refuses what the JAX package's does
    (tests/test_comm_wire.py TestWireConfig), with the same message."""
    with pytest.raises(ValueError, match=match) as ref:
        jcw.WireConfig(**kw).validate()
    with pytest.raises(ValueError, match=match) as got:
        cw.WireConfig(**kw).validate()
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("codec", ["bf16", "f16", "int8"])
@pytest.mark.parametrize("schedule", ["auto", "flat", "hier_rs_ag"])
def test_validate_accepts_as_jax(codec, schedule):
    cfg = dict(codec=codec, error_feedback=True, schedule=schedule)
    assert tuple(cw.WireConfig(**cfg).validate()) == tuple(
        jcw.WireConfig(**cfg).validate())
    assert cw.resolve_wire(cw.WireConfig(**cfg), _Comm()).schedule == schedule
    assert cw.resolve_wire("int8", _Comm()) == cw.WireConfig("int8")


# ----------------------------------------------------------------------
# SGD over the int8 wire with error feedback, against build_train_step
# ----------------------------------------------------------------------
STEPS, LR, PER = 3, 0.05, 8


def mlp_case(world):
    """The MNIST MLP (n_units 64, fp32), its flax variables (numpy) and
    the global batches of STEPS steps of PER rows a rank (numpy)."""
    model = JaxMLP(n_units=64, dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28))))
    rng = np.random.RandomState(3)
    x = rng.randn(STEPS * world * PER, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, len(x)).astype(np.int32)
    return model, v, (x, y)


def jax_wire_run(model, v, data, comm, world, wire):
    """The JAX step over ``comm`` with ``wire``: params, each device's
    residual (its own buffer: the carry is per rank) and losses after
    STEPS steps of world x PER rows, and the wire plan."""
    mn = jcmn.create_multi_node_optimizer(optax.sgd(LR), comm, wire=wire)

    def loss_fn(p, b):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(p, b[0]), b[1]).mean()

    step = jcmn.build_train_step(comm, loss_fn, mn, donate=False)
    p, s = step.place(v, mn.init(v))
    x, y = data
    losses = []
    for i in range(STEPS):
        rows = slice(i * world * PER, (i + 1) * world * PER)
        p, s, m = step(p, s, (jnp.asarray(x[rows]), jnp.asarray(y[rows])))
        losses.append(float(m["loss"]))
    leaves = [np.asarray(leaf) for leaf in
              jax.tree_util.tree_leaves(jax.device_get(p))]
    res = [[np.asarray(sh.data) for sh in sorted(
        r.addressable_shards, key=lambda sh: sh.device.id)]
        for r in s.wire_residual]
    return leaves, res, losses, mn.wire_plan(v)


FLIPS = 4  # elements allowed one int8 step apart, per rank and bucket


def assert_wire_run_close(ranks, ref):
    """The residual round-trips through the optimizer's state_dict.
    Every rank's parameters bit-identical to rank 0's; losses within
    1e-5 relative of the JAX step's; parameters within 1e-6 and each
    rank's residual within 1e-6 of its device's in the JAX step, except
    at most ``FLIPS`` elements a rank that are one int8 grid step apart
    (the step read as twice the largest residual): the two frameworks'
    fp32 gradients differ by rounding, and an element that straddles a
    rounding boundary encodes one step apart (its parameter then moves
    lr * step / n apart; error feedback carries the step into the next
    update).  Measured: world 2, no such element (parameters 3.0e-8,
    residuals 2.1e-7 apart); world 4 as 2 x 2, one element of one
    rank's shard (4.4e-3 apart, its parameter 5.5e-5 = lr * step / 4)."""
    leaves, res, losses, wplan = ref
    n = len(ranks)
    for r in ranks:
        for a, b in zip(r["params"], ranks[0]["params"]):
            np.testing.assert_array_equal(a, b)
        assert r["plan_hash"] == wplan.plan_hash()
        assert tuple(r["schedules"]) == tuple(wplan.schedules)
        assert r["state_dict_residual"] and r["loaded_residual"]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    step = max(2 * float(np.abs(w).max()) for dev in res for w in dev)
    for got, want in zip(ranks[0]["params"], leaves):
        gap = np.abs(got - want)
        assert (gap > 1e-6).sum() <= FLIPS * n
        assert gap.max() <= LR * step / n * STEPS + 1e-6
    for rank, r in enumerate(ranks):
        assert len(r["residual"]) == len(res)
        for got, want in zip(r["residual"], res):
            assert got.shape == want[rank].shape
            gap = np.abs(got - want[rank])
            far = gap > 1e-6
            assert far.sum() <= FLIPS
            assert np.all(np.abs(gap[far] - step) <= step * 0.02
                          + 1e-6)


@pytest.fixture(scope="module")
def flat_int8_world():
    model, v, data = mlp_case(2)
    wire = dict(codec="int8", error_feedback=True)
    ranks = torch_world.run_world(
        torch_world.wire_train_worker, 2, "pure_nccl", v, data, STEPS, LR,
        wire, {}, timeout=180)
    comm = jcmn.create_communicator("tpu", devices=jax.devices("cpu")[:2])
    ref = jax_wire_run(model, v, data, comm, 2, jcw.WireConfig(**wire))
    return ranks, ref


def test_mlp_int8_ef_steps_match_jax(flat_int8_world):
    """World 2, one flat bucket (the MLP's 55,050 parameters): the port's
    build_train_step over the int8 wire with error feedback against the
    JAX step, within the bounds of ``assert_wire_run_close``; each
    rank's residual is the full bucket."""
    ranks, ref = flat_int8_world
    assert ref[3].schedules == ("flat",)
    for r in ranks:
        assert [g.shape for g in r["residual"]] == [(55050,)]
    assert_wire_run_close(ranks, ref)


def test_nonfinite_skip_keeps_the_residual(flat_int8_world):
    """One rank's NaN loss under nonfinite="skip": both ranks skip, and
    the error-feedback residual stays what it was, with the parameters
    (the JAX step selects the whole optimizer state, residual included,
    optimizers.py:1306-1318)."""
    ranks, _ = flat_int8_world
    for r in ranks:
        assert r["skip_finite"] == 0.0
        assert r["skip_kept_residual"] and r["skip_kept_params"]
        assert any(np.abs(g).max() > 0 for g in r["residual"])
