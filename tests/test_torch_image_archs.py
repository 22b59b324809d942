"""Port parity of the ImageNet example's other architectures: VGG16,
AlexNet, NIN, GoogLeNet and GoogLeNetBN (96 x 96 images, 7 classes,
batch 2), each against ``chainermn_tpu.models`` (flax) on the same numpy
inputs after converting the flax variables; their wire plans against
the JAX plans; flax's asymmetric ``"SAME"`` padding; dropout; and the
synchronized GoogLeNetBN's data-parallel step at world 2 against the
JAX step.

Dropout draws from different generators on the two sides, so parity
runs with it off (``deterministic=True`` on both); its train-mode mask
is held to its statistics and its generator.

Tolerances, each stated where it is used: fp32 forward rtol 1e-5 /
atol 1e-5 (summation order only); bf16 forward within 2 % of the
largest logit of the jitted flax model (XLA keeps some bf16 values in
fp32 under jit: ROADMAP Queue 3); fp32 gradients by their
relative L2 norm over every parameter and that of each parameter, per
arch (a max pool or ReLU routes a gradient by a comparison that rounding
can flip), or, in evaluation mode, within 1e-4 of each parameter's
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu as jcmn
from chainermn_tpu import models as jm
from chainermn_tpu.comm_wire import plan_of_tree as jax_plan_of_tree
from chainermn_tpu.links import create_mnbn_model as jax_create_mnbn_model
from chainermn_tpu_torch import models as pm
from chainermn_tpu_torch.comm_wire import make_plan
from chainermn_tpu_torch.communicators import FAKE_NODE_SIZE_ENV
from chainermn_tpu_torch.models import _layers
from chainermn_tpu_torch.models.convert import (
    alexnet_params_from_flax, googlenet_params_from_flax,
    nin_params_from_flax, vgg16_params_from_flax)
from chainermn_tpu_torch.ops.losses import softmax_cross_entropy

import test_torch_world as torch_world
from test_torch_hierarchical import jax_hier_comm

IMG, CLASSES, BATCH = 96, 7, 2
# arch -> (JAX class, port class, converter, port kwargs)
ARCHS = {
    "vgg16": (jm.VGG16, pm.VGG16, vgg16_params_from_flax, {"image_size": IMG}),
    "alex": (jm.AlexNet, pm.AlexNet, alexnet_params_from_flax,
             {"image_size": IMG}),
    "nin": (jm.NIN, pm.NIN, nin_params_from_flax, {}),
    "googlenet": (jm.GoogLeNet, pm.GoogLeNet, googlenet_params_from_flax, {}),
    "googlenetbn": (jm.GoogLeNetBN, pm.GoogLeNetBN,
                    googlenet_params_from_flax, {}),
}
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_LOGITS_SHARE = 2e-2
F32_GRAD_SHARE = 1e-4


def _variables(arch, seed=0):
    """The flax variables (numpy) of ``arch`` at IMG, moved off their
    initial values where a BatchNorm's would hide a branch."""
    model = ARCHS[arch][0](num_classes=CLASSES, train=False)
    v = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, IMG, IMG, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    if "batch_stats" not in v:
        return v
    rng = np.random.RandomState(seed + 1)

    def move(path, a):
        name = path[-1].key
        if name in ("scale", "bias", "mean"):
            return (a + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        if name == "var":
            return (a * np.exp(0.3 * rng.randn(*a.shape))).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(move, v)


@pytest.fixture(scope="module")
def variables():
    return {arch: _variables(arch) for arch in ARCHS}


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(BATCH, IMG, IMG, 3).astype(np.float32),
            rng.randint(0, CLASSES, BATCH).astype(np.int32))


def _port(arch, v, dtype):
    _, cls, convert, kw = ARCHS[arch]
    m = cls(num_classes=CLASSES, dtype=getattr(torch, dtype), **kw)
    m.load_state_dict(convert(v))
    return m


def _share(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_eval_forward_matches_flax(variables, arch, dtype):
    """Evaluation mode (no dropout; GoogLeNetBN on its running
    statistics): fp32 within rtol 1e-5 / atol 1e-5 (measured at most
    1.0e-6, AlexNet's); bf16 within 2 % of the largest logit of the
    jitted flax model (measured 0.5-0.9 %)."""
    x, _ = _inputs(2)
    model = ARCHS[arch][0](num_classes=CLASSES, dtype=getattr(jnp, dtype),
                           train=False)
    ref = np.asarray(jax.jit(model.apply)(variables[arch], jnp.asarray(x)))
    m = _port(arch, variables[arch], dtype).eval()
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (BATCH, CLASSES)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, **F32)
    else:
        assert _share(out.numpy(), ref) <= BF16_LOGITS_SHARE


def _jax_train(arch, v, x, y):
    """Loss, logits, gradients and (GoogLeNetBN) new batch_stats of one
    training forward with dropout off, jitted."""
    model = ARCHS[arch][0](num_classes=CLASSES, dtype=jnp.float32, train=True)
    stats = v.get("batch_stats")

    def loss_fn(p):
        tree = {"params": p} if stats is None else {"params": p,
                                                    "batch_stats": stats}
        out, mut = model.apply(tree, jnp.asarray(x), deterministic=True,
                               mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(y)).mean()
        return loss, (out, mut.get("batch_stats"))

    (loss, (out, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    tree = {"params": grads}
    if new_stats is not None:
        tree["batch_stats"] = new_stats
    return float(loss), np.asarray(out), jax.tree_util.tree_map(np.asarray,
                                                                tree)


def _rel_l2(model, want):
    """The relative L2 norm, over every parameter, of the port's
    gradients against ``want``."""
    num = sum(float(((p.grad.numpy() - want[k].numpy()) ** 2).sum())
              for k, p in model.named_parameters())
    den = sum(float((want[k].numpy() ** 2).sum())
              for k, _ in model.named_parameters())
    return (num / den) ** 0.5


def _leaf_rel_l2(model, want):
    """The relative L2 norm of each parameter's gradient against
    ``want``, by name."""
    return {k: float(np.linalg.norm(p.grad.numpy() - want[k].numpy())
                     / np.linalg.norm(want[k].numpy()))
            for k, p in model.named_parameters()}


# fp32 train-step gradients against flax, by arch: (relative L2 over
# every parameter, relative L2 of each parameter), each with its
# measured value at these inputs in the test's docstring
GRAD_BOUNDS = {"vgg16": (1e-5, 2e-5), "alex": (1e-5, 2e-5),
               "googlenet": (1e-5, 2e-5), "nin": (1e-2, 5e-2),
               "googlenetbn": (0.1, 0.2)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_gradients_and_statistics_match_flax(variables, arch):
    """One fp32 training forward and backward, dropout off; gradients
    held by their relative L2 norm over every parameter and by that of
    each parameter (GRAD_BOUNDS), so a gradient wrong in one small leaf
    (a bias, the last dense layer, one Inception branch) fails.

    Without BatchNorm: logits and loss within rtol 1e-5 / atol 1e-5.
    VGG16, AlexNet and GoogLeNet: gradients within 1e-5 over every
    parameter (measured 3.7e-7 to 1.4e-6) and 2e-5 in each (measured at
    most 2.7e-6, VGG16's first convolution).  NIN: max pools and ReLUs
    route a gradient by a comparison, and where two values agree to fp32
    rounding the frameworks may route it apart; here a pool window after
    NIN's first stack does (the stem's gradient moves by 3.6 % of its
    largest entry), so NIN's gradients are held within 1e-2 over every
    parameter (measured 1.6e-3) and 5e-2 in each (measured 1.9e-2, the
    first stack's); test_fp32_gradients_against_float64 shows that
    rounding moved the port's side.
    GoogLeNetBN normalizes its last stage over 18 values a channel
    (batch 2 of 3 x 3 maps), where summation order moves the logits by
    ~1e-4 of their scale (measured 7.7e-5 and 6.4e-5 of the largest
    logit over two batches; bound 3e-4) and the running statistics by
    ~1e-5 (measured 2.4e-5; bound 1e-4), and the gradients within 0.1
    over every parameter (measured 0.013-0.028 over three batches) and
    0.2 in each (measured 0.055 at most).  Its evaluation-mode
    gradients are held per parameter in
    test_googlenetbn_eval_gradients_match_flax."""
    x, y = _inputs(3)
    ref_loss, ref_out, ref = _jax_train(arch, variables[arch], x, y)
    m = _port(arch, variables[arch], "float32").train()
    out = m(torch.from_numpy(x), deterministic=True)
    loss = softmax_cross_entropy(out, torch.from_numpy(y))
    loss.backward()
    want = ARCHS[arch][2](ref)
    buffers = dict(m.named_buffers())
    assert set(buffers) == {k for k in want if "running" in k}
    assert (len(buffers) > 0) == (arch == "googlenetbn")
    whole, each = GRAD_BOUNDS[arch]
    assert _rel_l2(m, want) <= whole
    worst = max(_leaf_rel_l2(m, want).items(), key=lambda kv: kv[1])
    assert worst[1] <= each, worst
    if arch != "googlenetbn":
        np.testing.assert_allclose(out.detach().numpy(), ref_out, **F32)
        np.testing.assert_allclose(loss.item(), ref_loss, **F32)
        return
    assert _share(out.detach().numpy(), ref_out) <= 3e-4
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-4)
    for k, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)


def _grads64(arch, v, x, y):
    """The port's gradients in float64 (parameters, inputs and every
    operation), dropout off, training mode."""
    m = _port(arch, v, "float32").double()
    for mod in m.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = torch.float64
    out = m.train()(torch.from_numpy(x).double(), deterministic=True)
    softmax_cross_entropy(out, torch.from_numpy(y)).backward()
    return {k: p.grad.numpy() for k, p in m.named_parameters()}


@pytest.mark.parametrize("arch,port_bound,jax_bound", [
    ("nin", 1e-2, 1e-5), ("googlenetbn", 0.1, 0.1)])
def test_fp32_gradients_against_float64(variables, arch, port_bound,
                                        jax_bound):
    """Where the two frameworks' fp32 gradients part (the train-step
    test above), a float64 run of the port says which side rounding
    moved: relative L2 over every parameter.  NIN: the JAX gradient
    lies within 1e-5 of float64 (measured 3.8e-7), the port's within
    1e-2 (measured 1.6e-3: a max pool routed its gradient by rounding).
    GoogLeNetBN: both move, within 0.1 (measured 0.024 the port's, 0.015
    JAX's): its train-mode gradient is ill-conditioned in fp32 at this
    batch."""
    x, y = _inputs(3)
    _, _, ref = _jax_train(arch, variables[arch], x, y)
    jax32 = {k: t.numpy() for k, t in ARCHS[arch][2](ref).items()}
    m = _port(arch, variables[arch], "float32").train()
    softmax_cross_entropy(m(torch.from_numpy(x), deterministic=True),
                          torch.from_numpy(y)).backward()
    port32 = {k: p.grad.numpy() for k, p in m.named_parameters()}
    exact = _grads64(arch, variables[arch], x, y)

    def rel_l2(a):
        num = sum(float(((a[k] - exact[k]) ** 2).sum()) for k in exact)
        return (num / sum(float((g ** 2).sum()) for g in exact.values())) ** 0.5

    assert rel_l2(port32) <= port_bound
    assert rel_l2(jax32) <= jax_bound


def test_googlenetbn_eval_gradients_match_flax(variables):
    """GoogLeNetBN's gradients in evaluation mode (its BatchNorms affine
    on the running statistics): every parameter within 1e-4 of its
    largest entry (measured 2.1e-6)."""
    v = variables["googlenetbn"]
    x, y = _inputs(3)
    model = jm.GoogLeNetBN(num_classes=CLASSES, dtype=jnp.float32,
                           train=False)

    def loss_fn(p):
        out = model.apply({"params": p, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(y)).mean()

    g = jax.tree_util.tree_map(np.asarray,
                               jax.jit(jax.grad(loss_fn))(v["params"]))
    want = googlenet_params_from_flax({"params": g})
    m = _port("googlenetbn", v, "float32").eval()
    softmax_cross_entropy(m(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    for k, p in m.named_parameters():
        assert _share(p.grad.numpy(), want[k].numpy()) <= F32_GRAD_SHARE, k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_plan_hash_equals_jax(variables, arch):
    """The flax-ordered leaves (``Conv_10`` before ``Conv_2``,
    ``Inception_k`` by name, ``batch_stats`` first) give the JAX plan of
    the flax tree, ``plan_hash`` included, at IMG and at full width (224
    x 224, 1000 classes); the optimizer's leaves in that order fill the
    same buckets."""
    v = variables[arch]
    m = _port(arch, v, "float32")
    tree = {k: v[k] for k in ("params", "batch_stats") if k in v}
    for knobs in [(), (1 << 14, 3)]:
        ref = jax_plan_of_tree(tree, *knobs)
        assert make_plan(pm.flax_leaf_specs(m), *knobs).plan_hash() == \
            ref.plan_hash(), knobs
        ordered = make_plan([t for _, t in pm.flax_ordered_parameters(m)],
                            *knobs)
        assert [[(s.index, s.offset, s.size) for s in b.slots]
                for b in ordered.buckets] == [
            [(s.index, s.offset, s.size) for s in b.slots]
            for b in ref.buckets]
    keys = [k for k, _ in pm.flax_ordered_parameters(m)]
    assert len(keys) == len(set(keys)) == len(m.state_dict())
    jcls, cls, _, kw = ARCHS[arch]
    full = jax.eval_shape(jcls(num_classes=1000).init,
                          {"params": jax.random.PRNGKey(0),
                           "dropout": jax.random.PRNGKey(1)},
                          jnp.zeros((1, 224, 224, 3)))
    full = {k: full[k] for k in ("params", "batch_stats") if k in full}
    with torch.device("meta"):  # shapes only: nothing is allocated
        port = cls(num_classes=1000, **{k: 224 for k in kw})
    assert make_plan(pm.flax_leaf_specs(port)).plan_hash() == \
        jax_plan_of_tree(full).plan_hash()


def test_alexnet_stem_pads_same_asymmetrically():
    """flax's default ``padding="SAME"`` on AlexNet's 11 x 11 / 4 stem
    pads 3 before and 4 after at 96 (and at 224): the port's stem equals
    flax's ``nn.Conv``, and torch's symmetric ``padding=`` (4 and 4)
    gives another map, so this fails if the padding were made
    symmetric."""
    from flax import linen as nn

    assert _layers.same_pads(96, 11, 4) == (3, 4)
    assert _layers.same_pads(224, 11, 4) == (3, 4)
    rng = np.random.RandomState(4)
    x = rng.randn(1, IMG, IMG, 3).astype(np.float32)
    conv = nn.Conv(96, (11, 11), strides=(4, 4))
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(conv.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    m = pm.AlexNet(num_classes=CLASSES, dtype=torch.float32, image_size=IMG)
    with torch.no_grad():
        m.convs[0].weight.copy_(torch.from_numpy(
            np.array(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
        m.convs[0].bias.copy_(torch.from_numpy(np.array(
            v["params"]["bias"])))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = _layers.conv(_layers.pad_same(xt, 11, 4), m.convs[0],
                           torch.float32).numpy()
        symmetric = torch.nn.functional.conv2d(
            xt, m.convs[0].weight, m.convs[0].bias, 4, padding=4).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert symmetric.shape != ref.shape or not np.allclose(symmetric, ref,
                                                           atol=1e-3)


@pytest.mark.parametrize("size", [96, 48, 24, 12])
def test_googlenet_stride2_pool_pads_same_asymmetrically(size):
    """GoogLeNet's 3 x 3 / 2 ``max_pool(padding="SAME")`` pads 0 before
    and 1 after (with -inf) at every even size: the port's pool equals
    flax's on a ramp (whose maxima sit at the windows' far corners), and
    ``F.max_pool2d(padding=1)`` shifts every window, so this fails if the
    padding were made symmetric."""
    from flax import linen as nn

    assert _layers.same_pads(size, 3, 2) == (0, 1)
    x = np.arange(size * size * 2, dtype=np.float32).reshape(1, size, size, 2)
    ref = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                 padding="SAME")).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = _layers.max_pool(xt, 3, 2, same=True).numpy()
    symmetric = torch.nn.functional.max_pool2d(xt, 3, 2, padding=1).numpy()
    np.testing.assert_array_equal(got, ref)
    assert symmetric.shape == ref.shape and not np.array_equal(symmetric, ref)


def test_googlenet_forward_fails_with_symmetric_pools(variables, monkeypatch):
    """The whole GoogLeNet, its stride-2 pools padded as torch pads
    (symmetric), no longer matches flax at 96: the padding matters end
    to end, not only in the pool."""
    x, _ = _inputs(5)
    model = jm.GoogLeNet(num_classes=CLASSES, dtype=jnp.float32, train=False)
    ref = np.asarray(jax.jit(model.apply)(variables["googlenet"],
                                          jnp.asarray(x)))
    m = _port("googlenet", variables["googlenet"], "float32").eval()
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), ref, **F32)
    real = _layers.same_pads

    def symmetric(n, k, s):
        total = sum(real(n, k, s))
        return (total + 1) // 2, (total + 1) // 2

    monkeypatch.setattr(_layers, "same_pads", symmetric)
    with torch.no_grad():
        out = m(torch.from_numpy(x)).numpy()
    assert not np.allclose(out, ref, **F32)


def test_dropout_rate_generator_and_gate():
    """``flax.linen.Dropout``'s rule, ``where(bernoulli(keep), x / keep,
    0)``: over 2^17 elements the dropped share lies within 5 binomial
    standard deviations of the rate (0.5 and 0.4), kept values are
    ``x / keep``; one generator seed gives one mask, two seeds two
    masks.  In a model, dropout runs only in training mode: evaluation
    (and ``deterministic=True``) gives the same logits every call."""
    n = 1 << 17
    x = torch.full((n,), 3.0)
    for rate in (0.5, 0.4):
        keep = 1 - rate
        y = _layers.dropout(x, rate, torch.Generator().manual_seed(0))
        dropped = float((y == 0).float().mean())
        sigma = (rate * keep / n) ** 0.5
        assert abs(dropped - rate) <= 5 * sigma, (rate, dropped)
        np.testing.assert_allclose(y[y != 0].numpy(), 3.0 / keep, rtol=1e-6)
        again = _layers.dropout(x, rate, torch.Generator().manual_seed(0))
        other = _layers.dropout(x, rate, torch.Generator().manual_seed(1))
        assert torch.equal(y, again) and not torch.equal(y, other)
    m = pm.GoogLeNet(num_classes=CLASSES, dtype=torch.float32)
    xi = torch.from_numpy(_inputs(6)[0])
    with torch.no_grad():
        m.train()
        a = m(xi, generator=torch.Generator().manual_seed(2))
        b = m(xi, generator=torch.Generator().manual_seed(2))
        c = m(xi, generator=torch.Generator().manual_seed(3))
        off = m(xi, deterministic=True)
        m.eval()
        e1, e2 = m(xi), m(xi)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, off)
    assert torch.equal(e1, e2) and torch.equal(e1, off)


def test_nin_small_image_raises_value_error():
    """At 64 x 64 a VALID pool collapses NIN's map: both sides raise
    ``ValueError`` (a zero-size mean would be NaN)."""
    x = jnp.zeros((1, 64, 64, 3))
    model = jm.NIN(num_classes=CLASSES, train=False)
    with pytest.raises(ValueError, match="too small"):
        model.init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="too small"):
        pm.NIN(num_classes=CLASSES)(torch.zeros(1, 64, 64, 3))


STEPS, LR, MOMENTUM, MNBN_IMG = 1, 0.01, 0.9, 64


def test_mnbn_googlenetbn_dp_step_matches_jax():
    """GoogLeNetBN (fp32, 64 x 64, 10 classes) made synchronized by
    ``create_mnbn_model`` on both sides, over the hierarchical
    communicator of 2 nodes of 1 rank with the fp32 wire, 8 images a
    rank, one step of SGD (lr 0.01, momentum 0.9), dropout off.  Both
    ranks' states bit-identical; the plan's hash the JAX plan's; 57 x 2
    MNBN all-reduces; the loss within 1e-5 relative and the running
    statistics (the forward's) within 1e-4 (measured 6.6e-6).

    GoogLeNetBN's train-mode gradient at init is ill-conditioned in
    fp32 (its BatchNorms see few values a channel at the last stage, and
    max pools and ReLUs route a gradient by comparisons that rounding
    can flip: test_fp32_gradients_against_float64), and each further
    step amplifies the difference; ResNet-50 held 1e-5 over three steps
    (tests/test_torch_mnbn.py).  So one step is taken, and its update is
    held by its relative L2 norm over every parameter, within 0.1
    (measured 0.025)."""
    jcomm = jax_hier_comm(n=2, node=1)
    model = jax_create_mnbn_model(
        jm.GoogLeNetBN(num_classes=10, dtype=jnp.float32), jcomm)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, MNBN_IMG, MNBN_IMG, 3))))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    rng = np.random.RandomState(2)
    data = (rng.randn(16, MNBN_IMG, MNBN_IMG, 3).astype(np.float32),
            rng.randint(0, 10, 16).astype(np.int32))
    ranks = torch_world.run_world(
        torch_world.mnbn_googlenet_worker, 2, v, data, STEPS, LR, MOMENTUM,
        {FAKE_NODE_SIZE_ENV: "1"}, timeout=300)

    def loss_fn(p, b):
        out, mut = model.apply(p, b[0], mutable=["batch_stats"],
                               deterministic=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            out, b[1]).mean(), mut["batch_stats"]

    mn = jcmn.create_multi_node_optimizer(
        optax.sgd(LR, momentum=MOMENTUM), jcomm)
    step = jcmn.build_train_step(
        jcomm, loss_fn, mn, donate=False, has_aux=True,
        merge_aux=lambda p, aux: {**p, "batch_stats": aux})
    p, s = step.place(v, mn.init(v))
    x, y = data
    shards = [r["indices"] for r in ranks]
    per = len(shards[0]) // STEPS
    losses = []
    for i in range(STEPS):
        idx = np.concatenate([sh[i * per:(i + 1) * per] for sh in shards])
        p, s, m = step(p, s, (jnp.asarray(x[idx]), jnp.asarray(y[idx])))
        losses.append(float(m["loss"]))
    ref = googlenet_params_from_flax(jax.tree_util.tree_map(np.asarray, p))
    start = googlenet_params_from_flax(v)
    state = ranks[0]["state"]
    assert set(state) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(state[k], ranks[1]["state"][k],
                                      err_msg=k)
    params = [k for k in ref if "running" not in k]
    num = sum(float(((state[k] - ref[k].numpy()) ** 2).sum()) for k in params)
    den = sum(float(((ref[k].numpy() - start[k].numpy()) ** 2).sum())
              for k in params)
    stats = max(float(np.abs(state[k] - ref[k].numpy()).max())
                for k in ref if "running" in k)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    assert (num / den) ** 0.5 <= 0.1
    assert stats <= 1e-4
    for r in ranks:
        assert r["flax_plan_hash"] == mn.wire_plan(v).plan_hash()
        assert r["calls"] == [2 * 57] * STEPS
