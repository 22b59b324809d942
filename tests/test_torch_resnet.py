"""Port parity of the image models: a 50-layer ResNet (``num_filters``
8, 32 x 32 images, 10 classes), ResNet-18's blocks, the MNIST MLP, the
BatchNorm and the losses, each against the JAX package (flax) on the
same numpy inputs; and ResNet-50's wire plan against the JAX plan of
``{"params", "batch_stats"}``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu.comm_wire import plan_of_tree as jax_plan_of_tree
from chainermn_tpu.models.mlp import MLP as JaxMLP
from chainermn_tpu.models.resnet import ResNet18 as JaxResNet18
from chainermn_tpu.models.resnet import ResNet50 as JaxResNet50
from chainermn_tpu.ops import losses as jax_losses
from chainermn_tpu_torch.comm_wire import make_plan
from chainermn_tpu_torch.models import (
    MLP, ResNet18, ResNet50, flax_leaf_specs, flax_ordered_parameters,
    mlp_params_from_flax, resnet_params_from_flax)
from chainermn_tpu_torch.ops.losses import accuracy, softmax_cross_entropy

SMALL = dict(num_classes=10, num_filters=8)
IMAGE, BATCH = 32, 8


def _perturbed(variables, seed):
    """Flax variables with every BatchNorm scale, bias and running
    statistic moved off its initial value (the blocks' last scales start
    at zero, which would hide their branch)."""
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map(np.asarray, variables)

    def move(path, a):
        name = path[-1].key
        if name in ("scale", "bias", "mean"):
            return (a + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        if name == "var":
            return (a * np.exp(0.3 * rng.randn(*a.shape))).astype(np.float32)
        return np.array(a)

    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope="module")
def resnet50_vars():
    model = JaxResNet50(**SMALL)
    v = jax.jit(model.init)(jax.random.PRNGKey(0),
                            jnp.zeros((1, IMAGE, IMAGE, 3)))
    return _perturbed(v, 1)


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32),
            rng.randint(0, SMALL["num_classes"], BATCH))


def _jax_train(model, variables, x, y):
    """Loss, logits, new batch_stats and parameter gradients of one
    training forward (``apply(mutable=["batch_stats"])``), jitted."""
    def loss_fn(p):
        out, mut = model.apply({"params": p,
                                "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(y)).mean()
        return loss, (out, mut["batch_stats"])

    (loss, (out, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tree = jax.tree_util.tree_map(np.asarray, {"params": grads,
                                               "batch_stats": stats})
    return float(loss), np.asarray(out), tree


def _port(cls, variables, dtype):
    m = cls(**SMALL, dtype=getattr(torch, dtype))
    m.load_state_dict(resnet_params_from_flax(variables))
    return m


def _port_train(model, x, y):
    out = model(torch.from_numpy(x))
    loss = softmax_cross_entropy(out, torch.from_numpy(y))
    loss.backward()
    return loss, out.detach()


# fp32.  The frameworks sum convolutions and BatchNorm statistics in
# different orders; through 50 layers whose last stage normalizes over
# 8 x 1 x 1 values per channel that moves the logits by ~1e-5 of their
# scale, the running statistics by a few fp32 ulps, and a gradient by
# ~1e-4 of its parameter's largest entry (measured: logits 1.0e-5 of
# the largest logit, statistics 3.3e-6, gradients 8.3e-5 of the largest
# entry).  Bounds 3x, 3x and 24x those.
F32_LOGITS_SHARE, F32_STATS_ATOL, F32_GRAD_SHARE = 3e-5, 1e-5, 2e-3
# bf16.  Under jit, XLA keeps some of the flax model's bf16 values in
# fp32 (excess precision), so the JAX package disagrees with itself:
# jitted against eager, its logits by 5.4 % of the largest and its
# gradients by 0.46 relative L2 over every parameter, at this depth and
# batch (the last stage normalizes 8 values a channel).  The port
# rounds where the flax code says, as eager JAX does: logits and
# running statistics are held against eager JAX (measured 3.0 % of the
# largest logit, statistics 9.2e-3 absolute), the gradients against the
# jitted step as a whole (measured 0.44 relative L2; 0.28 against eager
# JAX's gradients, which take 46 s to compute).  A single block, where
# rounding has not compounded, is held tighter in
# test_one_block_bf16_matches_eager_flax.
BF16_LOGITS_SHARE, BF16_STATS_ATOL, BF16_GRAD_L2 = 0.1, 5e-2, 0.6


def _share(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet50_train_forward_stats_and_grads_match_flax(resnet50_vars,
                                                           dtype):
    jm = JaxResNet50(**SMALL, dtype=getattr(jnp, dtype))
    x, y = _batch(2)
    ref_loss, ref_out, ref = _jax_train(jm, resnet50_vars, x, y)
    m = _port(ResNet50, resnet50_vars, dtype)
    loss, out = _port_train(m, x, y)
    grads = resnet_params_from_flax(ref)
    stats = {k: b.numpy() for k, b in m.named_buffers()}
    assert out.dtype == torch.float32 and out.shape == (BATCH, 10)
    if dtype == "float32":
        assert _share(out.numpy(), ref_out) <= F32_LOGITS_SHARE
        np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
        for k, v in stats.items():
            np.testing.assert_allclose(v, grads[k].numpy(), rtol=0,
                                       atol=F32_STATS_ATOL, err_msg=k)
        for k, p in m.named_parameters():
            assert _share(p.grad.numpy(), grads[k].numpy()) <= F32_GRAD_SHARE, k
        return
    with jax.disable_jit():
        eager_out, eager_mut = jm.apply(
            resnet50_vars, jnp.asarray(x), mutable=["batch_stats"])
    eager = resnet_params_from_flax(
        {"params": resnet50_vars["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               eager_mut["batch_stats"])})
    assert _share(out.numpy(), np.asarray(eager_out)) <= BF16_LOGITS_SHARE
    for k, v in stats.items():
        np.testing.assert_allclose(v, eager[k].numpy(), rtol=0,
                                   atol=BF16_STATS_ATOL, err_msg=k)
    num = sum(float(((p.grad.numpy() - grads[k].numpy()) ** 2).sum())
              for k, p in m.named_parameters())
    den = sum(float((grads[k].numpy() ** 2).sum())
              for k, _ in m.named_parameters())
    assert (num / den) ** 0.5 <= BF16_GRAD_L2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet50_eval_forward_matches_flax(resnet50_vars, dtype):
    """Evaluation mode normalizes with the running statistics: fp32 as
    the training forward's bound (measured 2.9e-7); bf16, against the
    jitted flax model and its excess precision, within 2 % of the
    largest logit (measured 0.52 %)."""
    jm = JaxResNet50(**SMALL, dtype=getattr(jnp, dtype), train=False)
    x, _ = _batch(3)
    ref = np.asarray(jax.jit(jm.apply)(resnet50_vars, jnp.asarray(x)))
    m = _port(ResNet50, resnet50_vars, dtype).eval()
    with torch.no_grad():
        out = m(torch.from_numpy(x)).numpy()
    bound = F32_LOGITS_SHARE if dtype == "float32" else 2e-2
    assert _share(out, ref) <= bound
    # evaluation leaves the running statistics alone
    for k, b in m.named_buffers():
        np.testing.assert_array_equal(
            b.numpy(), resnet_params_from_flax(resnet50_vars)[k].numpy())


def test_one_block_bf16_matches_eager_flax():
    """bf16 through the stem and one Bottleneck against eager flax (every
    op rounded where the flax code says): logits within 1 % of the
    largest (measured 0.07 %), running statistics within 1e-4
    (measured 1.7e-5), each gradient within 15 % of its largest entry
    (measured 5.8 %: the two autodiffs round the bf16 cotangents at
    different ops)."""
    from chainermn_tpu.models.resnet import Bottleneck as JaxBottleneck
    from chainermn_tpu.models.resnet import ResNet as JaxResNet
    from chainermn_tpu_torch.models import Bottleneck, ResNet

    jm = JaxResNet(stage_sizes=[1], block_cls=JaxBottleneck,
                   dtype=jnp.bfloat16, **SMALL)
    v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(3),
                                    jnp.zeros((1, IMAGE, IMAGE, 3))), 2)
    x, y = _batch(2)

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(y)).mean(), (out, mut["batch_stats"])

    with jax.disable_jit():
        (_, (ref_out, stats)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(v["params"])
    ref = resnet_params_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": g, "batch_stats": stats}))
    m = ResNet([1], Bottleneck, dtype=torch.bfloat16, **SMALL)
    m.load_state_dict(resnet_params_from_flax(v))
    _, out = _port_train(m, x, y)
    assert _share(out.numpy(), np.asarray(ref_out)) <= 1e-2
    for k, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
    for k, p in m.named_parameters():
        assert _share(p.grad.numpy(), ref[k].numpy()) <= 0.15, k


def test_resnet18_basic_blocks_match_flax():
    """ResNet-18's BasicBlock layout through the same converter (fp32
    training forward and running statistics; measured 1.5e-6 and
    4.8e-7)."""
    jm = JaxResNet18(**SMALL, dtype=jnp.float32)
    v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                    jnp.zeros((1, IMAGE, IMAGE, 3))), 4)
    x, y = _batch(5)
    _, ref_out, ref = _jax_train(jm, v, x, y)
    m = _port(ResNet18, v, "float32")
    _, out = _port_train(m, x, y)
    assert _share(out.numpy(), ref_out) <= F32_LOGITS_SHARE
    want = resnet_params_from_flax(ref)
    for k, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[k].numpy(), rtol=0,
                                   atol=F32_STATS_ATOL, err_msg=k)


def test_resnet50_plan_and_hash_equal_jax(resnet50_vars):
    """The flax-ordered leaves (batch_stats first, as jax sorts them)
    give the JAX plan of {"params", "batch_stats"}, plan_hash included;
    the optimizer's leaves (the port's layouts) the same buckets.  At
    full width (224 x 224, 1000 classes) too: 4 fp32 buckets."""
    m = _port(ResNet50, resnet50_vars, "float32")
    tree = {"params": resnet50_vars["params"],
            "batch_stats": resnet50_vars["batch_stats"]}
    knobs = [(), (1 << 14, 3), (1 << 12, 0)]
    for kn in knobs:
        ref = jax_plan_of_tree(tree, *kn)
        port = make_plan(flax_leaf_specs(m), *kn)
        assert port.plan_hash() == ref.plan_hash(), kn
        ordered = make_plan([t for _, t in flax_ordered_parameters(m)], *kn)
        assert [[(s.index, s.offset, s.size) for s in b.slots]
                for b in ordered.buckets] == [
            [(s.index, s.offset, s.size) for s in b.slots]
            for b in ref.buckets]
    keys = [k for k, _ in flax_ordered_parameters(m)]
    assert keys[:2] == ["bn_init.running_mean", "bn_init.running_var"]
    assert len(keys) == len(set(keys)) == len(m.state_dict())

    full = jax.eval_shape(JaxResNet50(num_classes=1000).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    ref = jax_plan_of_tree({"params": full["params"],
                            "batch_stats": full["batch_stats"]})
    port = make_plan(flax_leaf_specs(ResNet50(num_classes=1000)))
    assert port.plan_hash() == ref.plan_hash()
    assert port.n_buckets == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_forward_and_grads_match_flax(dtype):
    """fp32: summation order only, within 1e-5 of the largest entry
    (measured 4.8e-7 for the logits, 5.6e-7 for a gradient); bf16: the
    logits agree (measured bit for bit), the gradients within 3 % of
    their largest entry (measured 0.97 %: the two autodiffs round the
    bf16 cotangents at different ops)."""
    jm = JaxMLP(n_units=64, dtype=getattr(jnp, dtype))
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                                   jnp.zeros((1, 28, 28))))
    rng = np.random.RandomState(6)
    x = rng.randn(16, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 16)

    def loss_fn(p):
        out = jm.apply(p, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(y)).mean(), out

    (_, ref_out), g = jax.value_and_grad(loss_fn, has_aux=True)(v)
    ref = mlp_params_from_flax(jax.tree_util.tree_map(np.asarray, g))
    m = MLP(n_units=64, dtype=getattr(torch, dtype))
    m.load_state_dict(mlp_params_from_flax(v))
    out = m(torch.from_numpy(x))
    softmax_cross_entropy(out, torch.from_numpy(y)).backward()
    logits_bound, grad_bound = ((1e-5, 1e-5) if dtype == "float32"
                                else (1e-2, 3e-2))
    assert out.dtype == torch.float32
    assert _share(out.detach().numpy(), np.asarray(ref_out)) <= logits_bound
    for k, p in m.named_parameters():
        assert _share(p.grad.numpy(), ref[k].numpy()) <= grad_bound, k


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_losses_match_jax(z_loss):
    rng = np.random.RandomState(8)
    logits = (rng.randn(32, 10) * 4).astype(np.float32)
    labels = rng.randint(0, 10, 32)
    got = softmax_cross_entropy(torch.from_numpy(logits).bfloat16(),
                                torch.from_numpy(labels), z_loss=z_loss)
    ref = jax_losses.softmax_cross_entropy(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels), z_loss=z_loss)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_array_equal(
        accuracy(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
        float(jax_losses.accuracy(jnp.asarray(logits), jnp.asarray(labels))))
