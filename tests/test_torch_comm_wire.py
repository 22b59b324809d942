"""Port parity of the gradient wire: ``make_plan`` buckets and the
``plan_hash`` hex digest for the LM's leaf list, and ``reduce_buckets``
for the cast codecs, each against the JAX package on the same inputs
(its psum on a 2-device CPU mesh, the port's all-reduce in a gloo world
of 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from chainermn_tpu import comm_wire as jcw
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu_torch import comm_wire as cw
from chainermn_tpu_torch.models import TransformerLM, flax_ordered_parameters

import test_torch_world as torch_world

# the repo's headline LM (bench.py:784): its leaf list at full width
FULL = dict(vocab_size=32768, d_model=1024, n_heads=8, n_layers=8,
            max_len=2048)
PLAN_KNOBS = [(cw.DEFAULT_BUCKET_BYTES, cw.DEFAULT_MAX_BUCKETS),
              (1 << 20, 6), (1 << 16, 0), (1 << 22, 2), (1, 3)]


def _jax_leaves(cfg):
    shapes = jax.eval_shape(JaxLM(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_leaves(shapes)


def _same_plan(port, ref):
    assert port.n_leaves == ref.n_leaves
    assert [(b.dtype, b.size, tuple(tuple(s) for s in b.slots))
            for b in port.buckets] == [
        (b.dtype, b.size, tuple(tuple(s) for s in b.slots))
        for b in ref.buckets]
    assert port.plan_hash() == ref.plan_hash()


@pytest.mark.parametrize("knobs", PLAN_KNOBS, ids=str)
def test_lm_plan_and_hash_equal_jax(knobs):
    leaves = _jax_leaves(FULL)
    ref = jcw.make_plan(leaves, *knobs)
    port = cw.make_plan([(tuple(l.shape), l.dtype.name) for l in leaves],
                        *knobs)
    _same_plan(port, ref)
    if knobs == PLAN_KNOBS[0]:
        # 545 MB of fp32 leaves over at most 6 buckets: 4, the tied
        # embedding (134 MB) alone in one
        assert port.n_buckets == 4


def test_mixed_dtype_plan_equal_jax():
    """dtype names are numpy's, so torch and JAX leaves of the same
    dtypes plan alike (buckets are dtype-homogeneous)."""
    rng = np.random.RandomState(0)
    dtypes = ["float32", "bfloat16", "float16", "int32", "float32"]
    specs = [((int(rng.randint(1, 300)), int(rng.randint(1, 50))),
              dtypes[i % len(dtypes)]) for i in range(40)]
    ref = jcw.make_plan([jax.ShapeDtypeStruct(s, jnp.dtype(d))
                         for s, d in specs], 1 << 14, 4)
    torch_leaves = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in specs]
    _same_plan(cw.make_plan(torch_leaves, 1 << 14, 4), ref)
    assert cw.make_plan([]).n_buckets == 0
    with pytest.raises(ValueError, match="bucket_bytes"):
        cw.make_plan(specs, 0)


def test_port_parameters_plan_in_flax_order():
    """The port's parameters in flax order (the weight carrier's order)
    give the JAX plan's buckets; their shapes are the port's, so only
    the hash differs where a Linear weight is transposed."""
    cfg = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=11, max_len=16)
    lm = TransformerLM(cfg["vocab_size"], cfg["d_model"], cfg["n_heads"],
                       cfg["n_layers"], max_len=cfg["max_len"])
    ordered = [p for _, p in flax_ordered_parameters(lm)]
    assert len(ordered) == len(list(lm.parameters()))
    ref = jcw.make_plan(_jax_leaves(cfg), 1 << 12, 5)
    port = cw.make_plan(ordered, 1 << 12, 5)
    assert [[(s.index, s.offset, s.size) for s in b.slots]
            for b in port.buckets] == [
        [(s.index, s.offset, s.size) for s in b.slots] for b in ref.buckets]


def test_flatten_unflatten_round_trip():
    rng = np.random.RandomState(1)
    leaves = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in ((3, 4), (5,), (2, 2, 2), (7, 1))]
    leaves.append(torch.ones(6, dtype=torch.bfloat16))
    plan = cw.make_plan(leaves, 40, 0)
    flat = cw.flatten_to_buckets(plan, leaves)
    assert [f.numel() for f in flat] == [b.size for b in plan.buckets]
    back = cw.unflatten_from_buckets(plan, flat)
    for a, b in zip(leaves, back):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="plan covers"):
        cw.flatten_to_buckets(plan, leaves[:-1])


def test_resolve_wire_and_codec_of_dtype():
    class Comm:
        allreduce_grad_dtype = None

    comm = Comm()
    assert cw.resolve_wire("auto", comm) == cw.WireConfig("none")
    for dt, name in ((torch.bfloat16, "bf16"), (np.float16, "f16"),
                     ("float32", "f32"), (None, "none")):
        assert cw.codec_of_dtype(dt) == name
        assert jcw.codec_of_dtype(
            None if dt is None else
            (jnp.bfloat16 if dt is torch.bfloat16 else dt)) == name
        comm.allreduce_grad_dtype = dt
        assert cw.resolve_wire(None, comm).codec == name
    assert cw.resolve_wire("bf16", comm).codec == "bf16"
    with pytest.raises(ValueError, match="no wire codec"):
        cw.codec_of_dtype(torch.float64)
    with pytest.raises(ValueError, match="unknown wire codec"):
        cw.resolve_wire("f8", comm)
    assert cw.resolve_wire("int8", comm).codec == "int8"


def _buckets(seed, ranks=2):
    """Per-rank buckets in the dtypes the wire carries."""
    rng = np.random.RandomState(seed)
    out = []
    for n, dtype, scale in ((1000, "float32", 1e-3), (300, "bfloat16", 1.0),
                            (257, "float16", 10.0), (64, "float32", 1e3)):
        a = (rng.randn(ranks, n) * scale).astype(np.float32)
        out.append((torch.from_numpy(a).to(getattr(torch, dtype)), dtype))
    return out


def _jax_reduce(buckets, codec, n=2):
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("mn",))
    arrays = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, d))
              for t, d in buckets]

    def body(*bs):
        means, _ = jcw.reduce_buckets([b[0] for b in bs], ("mn",), n,
                                      jcw.WireConfig(codec=codec))
        return tuple(m[None] for m in means)

    fn = jax.shard_map(body, mesh=mesh, in_specs=P("mn"), out_specs=P("mn"),
                       check_vma=False)
    return [np.asarray(o[0].astype(jnp.float32)) for o in fn(*arrays)]


@pytest.fixture(scope="module")
def wire_world():
    buckets = _buckets(5)
    ranks = torch_world.run_world(torch_world.wire_worker, 2,
                                  [t for t, _ in buckets], timeout=120)
    return buckets, ranks


@pytest.mark.parametrize("codec", ["none", "f32", "bf16", "f16"])
def test_reduce_buckets_equal_jax(wire_world, codec):
    """Two ranks: each side adds two values and rounds once to the wire
    dtype, casts back, then divides by 2 in the native dtype, so the
    means are bit-identical (tolerance 0), on both ranks."""
    buckets, ranks = wire_world
    ref = _jax_reduce(buckets, codec)
    for res in ranks:
        for (got, dtype), (_, native), r in zip(res[codec], buckets, ref):
            assert dtype == f"torch.{native}"
            np.testing.assert_array_equal(got, r)


def test_cast_back_before_divide(wire_world):
    """The bf16 wire on fp32 buckets divides after the cast back: the
    mean is the bf16 sum, cast to fp32, halved (no second rounding)."""
    buckets, ranks = wire_world
    t, _ = buckets[0]
    want = (t[0].bfloat16() + t[1].bfloat16()).float() / 2
    np.testing.assert_array_equal(ranks[0]["bf16"][0][0], want.numpy())


def _exact_buckets(seed, ranks):
    """Per-rank buckets whose sums over the ranks are exact in bf16 and
    fp16 in any order: small integers times a power of two that every
    rank shares per element."""
    rng = np.random.RandomState(seed)
    out = []
    for n, dtype in ((1000, "float32"), (300, "bfloat16"), (64, "float32")):
        k = rng.randint(-15, 16, (ranks, n)).astype(np.float32)
        a = k * np.exp2(rng.randint(-12, 4, n)).astype(np.float32)
        out.append((torch.from_numpy(a).to(getattr(torch, dtype)), dtype))
    return out


@pytest.fixture(scope="module")
def wire_world3():
    """One gloo world of 3 reduces general buckets and exact-sum ones."""
    general, exact = _buckets(6, ranks=3), _exact_buckets(7, ranks=3)
    ranks = torch_world.run_world(torch_world.wire_worker, 3,
                                  [t for t, _ in general + exact],
                                  timeout=120)
    k = len(general)
    split = [{c: r[c][:k] for c in CODECS_RUN} for r in ranks]
    exact_ranks = [{c: r[c][k:] for c in CODECS_RUN} for r in ranks]
    return (general, split), (exact, exact_ranks), ranks


CODECS_RUN = ("none", "f32", "bf16", "f16")
# the cast codecs over the bucket dtypes they cast: fp32 and bf16
CAST_CASES = [("bf16", "float32"), ("f16", "float32"), ("f16", "bfloat16"),
              ("bf16", "bfloat16")]


def _assert_cast_codec_equal(buckets, ranks, codec, native, world):
    ref = _jax_reduce(buckets, codec, n=world)
    checked = 0
    for res in ranks:
        for (got, dtype), (_, bucket_dtype), r in zip(res[codec], buckets,
                                                      ref):
            if bucket_dtype == native:
                assert dtype == f"torch.{native}"
                np.testing.assert_array_equal(got, r)
                checked += 1
    assert checked == world * sum(d == native for _, d in buckets)


@pytest.mark.parametrize("codec,native", CAST_CASES)
def test_cast_legs_bit_equal_to_jax_world2(wire_world, codec, native):
    """World 2: with both cast legs on the fused cast/scale kernel (its
    plain version on the CPU), and an fp32 bucket's divide fused into
    the cast back as a multiply by 1/2, the means are bit-identical to
    the JAX reduce_buckets on every rank (tolerance 0)."""
    buckets, ranks = wire_world
    _assert_cast_codec_equal(buckets, ranks, codec, native, 2)


@pytest.mark.parametrize("codec,native", CAST_CASES)
def test_cast_legs_bit_equal_to_jax_world3(wire_world3, codec, native):
    """World 3, where the kernel casts back with scale 1 and the divide
    by 3 follows it: bit-identical to the JAX reduce_buckets (tolerance
    0) on buckets whose sum over the ranks is exact in the wire dtype.
    On other buckets the sum itself differs (see
    test_world3_sum_rounds_per_addition); the legs and the divide are
    what this test holds equal."""
    _, (buckets, ranks), _ = wire_world3
    _assert_cast_codec_equal(buckets, ranks, codec, native, 3)


@pytest.mark.parametrize("codec", ["bf16", "f16"])
def test_world3_sum_rounds_per_addition(wire_world3, codec):
    """Over 3 ranks the wire's sum is the collective's: gloo (and NCCL's
    ring) round to the wire dtype after each addition, while XLA's CPU
    psum adds the bf16/fp16 payloads in fp32 and rounds once.  So on
    general buckets the means differ from the JAX package's by the
    rounding of the partial sums: at most a half-ulp of the wire dtype,
    twice, of the ranks' summed magnitudes (over n = 3: 2^-8 and 2^-11
    relative for bf16 and fp16).  Measured: 20-23 % of a bucket's
    elements differ (none for fp16 over bf16 buckets), the largest gap
    1.0e-5 on the fp32 bucket of values ~1e-3, and at most 1.18x the
    analysis's bound (a bf16 bucket adds the rounding of its divide).
    The bound is twice the analysis's."""
    (buckets, ranks), _, _ = wire_world3
    ref = _jax_reduce(buckets, codec, n=3)
    half_ulp = {"bf16": 2.0 ** -8, "f16": 2.0 ** -11}[codec]
    for res in ranks:
        for (got, _), (t, native), r in zip(res[codec], buckets, ref):
            if native not in ("float32", "bfloat16"):
                continue
            mag = t.float().abs().sum(0).numpy() / 3
            bound = 2 * 2 * half_ulp * mag + 1e-30
            assert np.all(np.abs(got - r) <= bound), (codec, native)


@pytest.mark.parametrize("world", [2, 3])
def test_cast_legs_run_through_fused_cast_scale(wire_world, wire_world3,
                                                world):
    """Each cast codec calls the kernel twice for a bucket whose dtype
    differs from the wire's (to the wire with scale 1, back with scale
    1/n for an fp32 bucket at a power-of-two world, else scale 1 and a
    divide after it) and never for one that matches; codec none never."""
    if world == 2:
        buckets, ranks = wire_world
    else:
        (general, _), (exact, _), ranks = wire_world3
        buckets = general + exact
    wire = {"bf16": "torch.bfloat16", "f16": "torch.float16",
            "f32": "torch.float32"}
    for codec in CODECS_RUN:
        want = []
        for _, native in buckets:
            native = f"torch.{native}"
            if codec == "none" or wire[codec] == native:
                continue
            back = 1.0 / world if (native == "torch.float32"
                                   and world == 2) else 1.0
            want += [(native, wire[codec], 1.0), (wire[codec], native, back)]
        for res in ranks:
            assert res["calls"][codec] == want, codec
