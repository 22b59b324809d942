"""Port parity of the hierarchical communicator and the scheduled wire:
a gloo world of 4 grouped into 2 nodes of 2 (``CHAINERMN_TORCH_FAKE_NODE_
SIZE=2``) against the JAX package's ``create_communicator(
"hierarchical")`` on 4 CPU devices grouped into 2 slices of 2 (the
``_node_key`` patch of tests/test_schedules.py), on the same numpy
inputs.

Tolerances: the plan and its hash are equal as strings; ``reduce_wire``
is bit-equal (tolerance 0) to the JAX package's: at intra width 2 the
full-precision reduce-scatter adds two fp32 values (which commutes),
the inter hop's sum of two bf16 values rounds once on both sides, and
int8's is an integer sum; a ``flat`` bucket over 4 ranks is compared on
data whose sums are exact in any order.  The training run is held
within the bounds stated in its docstring.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import chainermn_tpu as jcmn
from chainermn_tpu import comm_wire as jcw
from chainermn_tpu.communicators import _topology
from chainermn_tpu_torch import comm_wire as cw
from chainermn_tpu_torch.communicators import FAKE_NODE_SIZE_ENV

import test_torch_world as torch_world
from test_torch_wire_int8 import (
    LR, STEPS, assert_wire_run_close, jax_wire_run, mlp_case)

FAKE = {FAKE_NODE_SIZE_ENV: "2"}
AXES = ("mn_inter", "mn_intra")


def jax_hier_comm(n=4, node=2, **kw):
    """The JAX hierarchical communicator over n CPU devices grouped into
    slices of ``node`` consecutive devices (the mesh is fixed when it is
    built, so the patch lives through the call only)."""
    orig = _topology._node_key
    _topology._node_key = lambda d: ("slice", d.id // node)
    try:
        return jcmn.create_communicator(
            "hierarchical", devices=jax.devices("cpu")[:n], **kw)
    finally:
        _topology._node_key = orig


@pytest.fixture(scope="module")
def comm_world():
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    return x, torch_world.run_world(torch_world.hier_comm_worker, 4, FAKE, x,
                                    timeout=120)


def test_topology_axes_and_groups(comm_world):
    """2 x 2: sync axes ("mn_inter", "mn_intra") of sizes (2, 2), as the
    JAX mesh; rank r is node r // 2, intra rank r % 2; its intra group
    is its node, its inter group the ranks of its intra rank."""
    _, ranks = comm_world
    ref = jax_hier_comm()
    assert dict(ref.mesh.shape) == {"mn_inter": 2, "mn_intra": 2}
    for r, res in enumerate(ranks):
        assert res["mesh_shape"] == dict(ref.mesh.shape)
        assert res["axis_names"] == tuple(ref.axis_names) == AXES
        assert res["flat_mesh_shape"] == {"mn": 4}
        assert res["intra"] == (r % 2, 2) and res["inter"] == (r // 2, 2)
        assert res["groups"] == [[r - r % 2, r - r % 2 + 1], [r % 2,
                                                             r % 2 + 2]]
        assert res["warnings"] == []


def test_plain_collectives_equal_the_flat_communicators(comm_world):
    """allreduce (sum, mean, max), bcast and allgather of the
    hierarchical communicator give the flat communicator's values
    (both run on the default group), which are the reductions of the
    inputs; the communicators still waiting raise, naming the ROADMAP."""
    x, ranks = comm_world
    for res in ranks:
        for k, v in res["hier"].items():
            np.testing.assert_array_equal(v, res["flat"][k], err_msg=k)
        np.testing.assert_allclose(res["hier"]["sum"], x.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(res["hier"]["bcast"], x[3])
        np.testing.assert_array_equal(res["hier"]["allgather"], x)
        assert res["waiting"] == [
            (True, n) for n in ("two_dimensional", "non_cuda_aware",
                                "hybrid", "mesh")]


# ----------------------------------------------------------------------
# the plan: schedules and hash
# ----------------------------------------------------------------------
def _mlp_variables():
    from chainermn_tpu.models.mlp import MLP

    return jax.eval_shape(MLP(n_units=64).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 28, 28)))


def _resnet50_variables():
    from chainermn_tpu.models.resnet import ResNet50

    return jax.eval_shape(ResNet50(num_classes=1000).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))


def _specs(tree):
    return [(tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
            for leaf in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("schedule", ["auto", "flat", "hier_rs_ag"])
def test_wire_plan_and_hash_equal_jax(codec, schedule):
    """``plan_wire`` of the MLP's leaves (n_units 64: one 220 KB bucket,
    over the 64 KiB rule) on the 2 x 2 axes, on the flat axes of 4 and
    on the one-node (1, 4) axes: the schedules, the census, the shard
    sizes and ``plan_hash()`` equal the JAX package's plan on its own
    meshes."""
    v = _mlp_variables()
    wire = dict(codec=codec, error_feedback=True, schedule=schedule)
    meshes = [(jax_hier_comm(), {"mn_inter": 2, "mn_intra": 2}),
              (jcmn.create_communicator("tpu", devices=jax.devices("cpu")[:4]),
               {"mn": 4}),
              (jax_hier_comm(node=4), {"mn_inter": 1, "mn_intra": 4})]
    for jcomm, shape in meshes:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = jcw.plan_wire(v, jcw.WireConfig(**wire), jcomm.mesh)
            got = cw.plan_wire(_specs(v), cw.WireConfig(**wire), shape)
        assert got.schedules == ref.schedules
        assert got.schedule_census() == ref.schedule_census()
        assert [got.shard_size(i) for i in range(got.n_buckets)] == [
            ref.shard_size(i) for i in range(ref.n_buckets)]
        assert got.plan_hash() == ref.plan_hash()
    hier = cw.plan_wire(_specs(v), cw.WireConfig(**wire), meshes[0][1])
    assert hier.schedule_census() == (
        {"flat": 1} if schedule == "flat" else {"hier_rs_ag": 1})


def test_resnet50_plan_hash_equal_jax_at_world_1():
    """The chip's path: ResNet-50 (1000 classes, its {"params",
    "batch_stats"} leaves) over the hierarchical communicator of one
    rank, axes (1, 1): four flat buckets, the JAX plan's hash."""
    v = _resnet50_variables()
    ref = jcw.plan_wire(v, jcw.WireConfig("bf16"),
                        jax_hier_comm(n=1, node=1).mesh)
    got = cw.plan_wire(_specs(v), cw.WireConfig("bf16"),
                       {"mn_inter": 1, "mn_intra": 1})
    assert got.schedules == ref.schedules == ("flat",) * 4
    assert got.plan_hash() == ref.plan_hash()


def test_schedule_decision_rule():
    """``auto`` stages exactly the buckets whose inter-hop saving reaches
    64 KiB (16,384 fp32 elements on 2 x 2); the profile and bcast_tree
    wait for the optimizer's tier 2."""
    split = cw.axis_split(AXES, (2, 2))
    assert split == cw.AxisSplit("mn_inter", "mn_intra", 2, 2)
    for axes, sizes in ((AXES, (1, 4)), (AXES, (4, 1)), (("mn",), (4,))):
        assert cw.axis_split(axes, sizes) is None
    mesh = dict(zip(AXES, (2, 2)))
    for nbytes in (4, 65532, 65536, 65540, 1 << 24):
        assert cw.schedule_for_bucket(nbytes, mesh) == \
            jcw.schedule_for_bucket(nbytes, mesh)
        assert cw.hier_inter_savings(nbytes, split) == \
            jcw.hier_inter_savings(nbytes, jcw.axis_split(AXES, (2, 2)))
    with pytest.raises(NotImplementedError, match="Optimizer, tier 2"):
        cw.schedule_for_bucket(1 << 20, mesh, profile=object())
    from chainermn_tpu_torch.comm_wire.schedules import bcast_tree_stages

    with pytest.raises(NotImplementedError, match="Optimizer, tier 2"):
        bcast_tree_stages(AXES, (2, 2))


# ----------------------------------------------------------------------
# reduce_wire over 2 x 2
# ----------------------------------------------------------------------
# one bucket per leaf: a target of 1 byte and no cap
KNOBS = dict(bucket_bytes=1, max_buckets=0)
CASES = [("bf16", False, False), ("bf16", True, True), ("int8", False, False),
         ("int8", True, False), ("int8", True, True), ("none", False, False)]


def _exact(rng, shape, exps):
    """Values whose sums over any ranks, in any order, are exact in fp32
    and in bf16: small integers times a power of two per element."""
    k = rng.randint(-15, 16, shape).astype(np.float32)
    return k * np.exp2(exps).astype(np.float32)


def _wire_inputs(seed):
    """Per-rank leaves: two fp32 leaves that stage (one of odd length,
    padded), a bf16 leaf that stages, a small fp32 leaf that stays flat
    (exact data, and an exact residual: its sum over 4 ranks is exact in
    bf16 with the residual added); residuals of each bucket's carry
    shape (the shard for a staged bucket)."""
    rng = np.random.RandomState(seed)
    exps = rng.randint(-12, 4, 500)
    leaves = [(rng.randn(4, 20001) * 1e-2).astype(np.float32),
              (rng.randn(4, 40000) * 3.0).astype(np.float32),
              (rng.randn(4, 70000)).astype(np.float32),
              _exact(rng, (4, 500), exps)]
    leaves[1][2] *= 8.0
    dtypes = ["float32", "float32", "bfloat16", "float32"]
    wplan = jcw.plan_wire(
        [jax.ShapeDtypeStruct(x.shape[1:], jnp.dtype(d))
         for x, d in zip(leaves, dtypes)],
        jcw.WireConfig("int8", **KNOBS), jax_hier_comm().mesh)
    residuals = [(rng.randn(4, wplan.shard_size(i)) * 1e-4).astype(np.float32)
                 for i in range(wplan.n_buckets - 1)]
    residuals.append(_exact(rng, (4, 500), exps))  # the sum stays exact
    return ([(torch.from_numpy(x).to(getattr(torch, d)), d)
             for x, d in zip(leaves, dtypes)],
            [torch.from_numpy(r).to(getattr(torch, d))
             for r, d in zip(residuals, dtypes)], wplan)


def _jax_reduce_wire(leaves, residuals, case):
    codec, ef, carry = case
    comm = jax_hier_comm()
    cfg = jcw.WireConfig(codec, error_feedback=ef, **KNOBS)
    arrays = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, d))
              for t, d in leaves]
    res = [jnp.asarray(r.float().numpy()).astype(a.dtype)
           for r, a in zip(residuals, arrays)]
    k = len(arrays)

    def body(*xs):
        bs = [x[0] for x in xs[:k]]
        wplan = jcw.plan_wire(bs, cfg, comm.mesh)
        means, new = jcw.reduce_wire(bs, wplan, 4, cfg,
                                     [x[0] for x in xs[k:]] if carry else None)
        return tuple(m[None] for m in means) + tuple(r[None] for r in new)

    fn = jax.shard_map(body, mesh=comm.mesh, in_specs=P(AXES),
                       out_specs=P(AXES), check_vma=False)
    outs = [np.asarray(o.astype(jnp.float32)) for o in fn(*arrays, *res)]
    return outs[:k], outs[k:]


@pytest.fixture(scope="module")
def wire_world():
    leaves, residuals, wplan = _wire_inputs(4)
    ranks = torch_world.run_world(
        torch_world.codec_worker, 4, [t for t, _ in leaves], residuals,
        CASES, "hierarchical", FAKE, KNOBS, timeout=180)
    return leaves, residuals, wplan, ranks


def test_wire_world_plans_as_jax(wire_world):
    """The leaves plan three staged buckets and one flat one, with the
    JAX plan's hash, on every rank."""
    _, _, wplan, ranks = wire_world
    assert wplan.schedules == ("hier_rs_ag",) * 3 + ("flat",)
    for res in ranks:
        assert res["mesh_shape"] == {"mn_inter": 2, "mn_intra": 2}
        assert res["plan"] == (wplan.plan_hash(), wplan.schedules)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_reduce_wire_bit_equal_jax(wire_world, case):
    """Means and residuals (shard-shaped for the staged buckets) of every
    rank bit-equal to the JAX package's ``reduce_wire`` on the 2 x 2
    mesh (tolerance 0)."""
    leaves, residuals, wplan, ranks = wire_world
    ref_means, ref_res = _jax_reduce_wire(leaves, residuals, case)
    for r, res in enumerate(ranks):
        got = res[case]
        assert len(got["residuals"]) == (len(leaves) if case[1] else 0)
        for (m, dtype), (_, native), want in zip(got["means"], leaves,
                                                 ref_means):
            assert dtype == f"torch.{native}"
            np.testing.assert_array_equal(m, want[r], err_msg=str(case))
        for i, ((g, _), want) in enumerate(zip(got["residuals"], ref_res)):
            assert g.shape == (wplan.shard_size(i),)
            np.testing.assert_array_equal(g, want[r], err_msg=str(case))


def test_staged_collectives(wire_world):
    """A staged bucket costs an all-reduce over its intra group (gloo's
    reduce-scatter), one over its inter group on the shard, and an
    all-gather; int8 adds one MAX all-reduce of the fp32 absmaxes per
    schedule class (the flat bucket's, then the staged buckets' over
    the inter group)."""
    leaves, _, wplan, ranks = wire_world
    for res in ranks:
        calls = res[("int8", True, True)]["calls"]
        staged = [wplan.padded_size(i) for i in range(3)]
        shards = [wplan.shard_size(i) for i in range(3)]
        assert calls == (
            [("float32", 1, "max"), ("int32", 500, "sum")]
            + [(d, n, "sum") for (_, d), n in zip(leaves, staged)]
            + [("float32", 3, "max")]
            + [("int32", n, "sum") for n in shards])


# ----------------------------------------------------------------------
# SGD over hierarchical + int8 + error feedback
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def hier_train_world():
    model, v, data = mlp_case(4)
    wire = dict(codec="int8", error_feedback=True)
    ranks = torch_world.run_world(
        torch_world.wire_train_worker, 4, "hierarchical", v, data, STEPS, LR,
        wire, FAKE, timeout=180)
    ref = jax_wire_run(model, v, data, jax_hier_comm(), 4,
                       jcw.WireConfig(**wire))
    return ranks, ref


def test_mlp_hier_int8_ef_steps_match_jax(hier_train_world):
    """World 4 as 2 x 2: the MLP's one bucket staged (``hier_rs_ag``),
    int8 on the inter hop with error feedback, 3 SGD steps through
    build_train_step against the JAX step on the 2 x 2 mesh, within the
    bounds of ``assert_wire_run_close``; each rank's residual is its
    shard (27,525 of the 55,050 elements)."""
    ranks, ref = hier_train_world
    assert ref[3].schedules == ("hier_rs_ag",)
    for r in ranks:
        assert r["mesh_shape"] == {"mn_inter": 2, "mn_intra": 2}
        assert [g.shape for g in r["residual"]] == [(27525,)]
    assert_wire_run_close(ranks, ref)


def test_ragged_topology_warns_and_plans_flat():
    """3 ranks in nodes of 2 and 1: the layout degrades to (1, 3) with
    the reference's warning, and an explicit hier_rs_ag collapses to
    flat with a warning, as the JAX package's plan on its ragged mesh
    (the same hash)."""
    ranks = torch_world.run_world(torch_world.ragged_worker, 3, FAKE,
                                  timeout=120)
    with pytest.warns(UserWarning, match="ragged topology"):
        jcomm = jax_hier_comm(n=3, node=2)
    with pytest.warns(UserWarning, match="collapsing"):
        ref = jcw.plan_wire([jax.ShapeDtypeStruct((20000,), jnp.float32)],
                            jcw.WireConfig("bf16", schedule="hier_rs_ag"),
                            jcomm.mesh)
    for shape, schedules, plan_hash, caught in ranks:
        assert shape == {"mn_inter": 1, "mn_intra": 3}
        assert schedules == ("flat",)
        assert plan_hash == ref.plan_hash()
        assert any("ragged topology" in m for m in caught)
        assert any("collapsing" in m for m in caught)
