"""Port parity of the image data-parallel step: the MNIST MLP and a
50-layer ResNet (``num_filters`` 8, 32 x 32, 10 classes) trained k
steps at world size 2 (gloo, shards from ``scatter_dataset``) with SGD
(momentum for the ResNet) over the bf16 gradient wire, against the JAX
package's ``build_train_step`` on a 2-device CPU mesh (the ResNet's with
``has_aux=True, merge_aux=...``, as ``examples/imagenet/
train_imagenet.py`` builds it); and the multi-node evaluator and the
persistent-state all-reduce of the same worlds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import chainermn_tpu as jcmn
from chainermn_tpu.comm_wire import plan_of_tree as jax_plan_of_tree
from chainermn_tpu.models.mlp import MLP as JaxMLP
from chainermn_tpu.models.resnet import ResNet50 as JaxResNet50
from chainermn_tpu_torch.comm_wire import make_plan
from chainermn_tpu_torch.models import mlp_params_from_flax, resnet_params_from_flax
from chainermn_tpu_torch.models.convert import flax_shape, mlp_leaves

import test_torch_world as torch_world

STEPS = 3
MLP_LR, RESNET_LR, MOMENTUM = 0.05, 0.1, 0.9


def _data(n, shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, *shape).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


def _jax_run(loss_fn, variables, opt, data, shards, has_aux=False,
             merge_aux=None):
    comm = jcmn.create_communicator("tpu", devices=jax.devices("cpu")[:2],
                                    allreduce_grad_dtype=jnp.bfloat16)
    mn = jcmn.create_multi_node_optimizer(opt, comm)
    step = jcmn.build_train_step(comm, loss_fn, mn, donate=False,
                                 has_aux=has_aux, merge_aux=merge_aux)
    p, s = step.place(variables, mn.init(variables))
    x, y = data
    per = len(shards[0]) // STEPS
    losses = []
    for i in range(STEPS):
        idx = np.concatenate([sh[i * per:(i + 1) * per] for sh in shards])
        p, s, m = step(p, s, (jnp.asarray(x[idx]), jnp.asarray(y[idx])))
        losses.append(float(m["loss"]))
    return jax.tree_util.tree_map(np.asarray, p), losses, mn


def _resnet_leaves():
    from chainermn_tpu_torch.models import ResNet50
    from chainermn_tpu_torch.models.convert import resnet_leaves

    return resnet_leaves(ResNet50(num_classes=10, num_filters=8))


def _gaps(port_state, ref_state, keys):
    return {k: float(np.abs(port_state[k] - ref_state[k].numpy()).max())
            for k in keys}


@pytest.fixture(scope="module")
def mlp_world():
    model = JaxMLP(n_units=64)
    v = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28))))
    data = _data(48, (28, 28), 1)
    ranks = torch_world.run_world(
        torch_world.image_dp_worker, 2, "mlp", v, data, STEPS, MLP_LR, 0.0,
        "bfloat16", timeout=240)
    return model, v, data, ranks


@pytest.fixture(scope="module")
def resnet_world():
    model = JaxResNet50(num_classes=10, num_filters=8, dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    data = _data(48, (32, 32, 3), 2)
    ranks = torch_world.run_world(
        torch_world.image_dp_worker, 2, "resnet50", v, data, STEPS,
        RESNET_LR, MOMENTUM, "float32", timeout=300)
    return model, v, data, ranks


def test_mlp_params_after_k_sgd_steps_match_jax(mlp_world):
    """bf16 MLP, plain SGD at lr 0.05, the bf16 wire on both sides:
    every rank bit-identical to the other, and each parameter within
    5e-4 of the JAX step's (measured 9.8e-5: the bf16 dense layers round
    at different places, then each bf16 gradient on the wire may land a
    rounding step apart); losses within 1 % (measured 2.3e-4)."""
    model, v, data, ranks = mlp_world

    def loss_fn(p, b):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(p, b[0]), b[1]).mean()

    ref_p, ref_losses, _ = _jax_run(loss_fn, v, optax.sgd(MLP_LR), data,
                                     [r["indices"] for r in ranks])
    ref = mlp_params_from_flax(ref_p)
    start = mlp_params_from_flax(v)
    for k in ref:
        np.testing.assert_array_equal(ranks[0]["state"][k],
                                      ranks[1]["state"][k], err_msg=k)
        np.testing.assert_allclose(ranks[0]["state"][k], ref[k].numpy(),
                                   rtol=0, atol=5e-4, err_msg=k)
        assert np.abs(ranks[0]["state"][k] - start[k].numpy()).max() > 1e-3
    np.testing.assert_allclose(ranks[0]["losses"], ref_losses, rtol=1e-2)
    assert ranks[0]["codec"] == "bf16"
    # the bucket plan of the flax tree, from the port's leaves
    shapes = [flax_shape(leaf, ranks[0]["state"][leaf.key].shape)
              for leaf in mlp_leaves()]
    assert make_plan([(s, "float32") for s in shapes]).plan_hash() == \
        jax_plan_of_tree(v).plan_hash()


def test_resnet_params_and_stats_after_k_momentum_steps_match_jax(
        resnet_world):
    """fp32 ResNet, SGD lr 0.1 momentum 0.9, the bf16 wire, 8 images a
    rank a step: the running statistics (each rank's EMA of its own
    shard, mean-reduced after the update; merged after the optimizer on
    the JAX side) and every parameter after 3 steps, on both ranks.  An
    fp32 gradient that straddles a bf16 rounding boundary crosses the
    wire a bf16 step (2^-8 of its size) apart on the two sides, and
    momentum and the BatchNorms carry that on: measured, parameters
    within 9.8e-4 of the JAX step's and 4.7 % of their own update,
    statistics within 8.9e-5, losses 5.3e-5 relative.  For scale, the
    bf16 wire itself moves the JAX step's parameters by 2.1e-2 and its
    statistics by 3.8e-3 from its fp32-wire run.  Bounds: 3e-3, 15 %
    of each parameter's update, 3e-4 and 3e-4."""
    model, v, data, ranks = resnet_world

    def loss_fn(p, b):
        out, mut = model.apply(p, b[0], mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            out, b[1]).mean(), mut["batch_stats"]

    ref_v, ref_losses, _ = _jax_run(
        loss_fn, v, optax.sgd(RESNET_LR, momentum=MOMENTUM), data,
        [r["indices"] for r in ranks], has_aux=True,
        merge_aux=lambda p, aux: {**p, "batch_stats": aux})
    ref = resnet_params_from_flax(ref_v)
    start = resnet_params_from_flax(v)
    state = ranks[0]["state"]
    for k in ref:
        np.testing.assert_array_equal(state[k], ranks[1]["state"][k],
                                      err_msg=k)
    stats = [k for k in ref if "running" in k]
    params = [k for k in ref if "running" not in k]
    # 53 BatchNorms (2 statistics, 2 parameters), 53 convolutions, a head
    assert len(stats) == 2 * 53 and len(params) == 2 * 53 + 53 + 2
    for k in stats:
        np.testing.assert_allclose(state[k], ref[k].numpy(), rtol=0,
                                   atol=3e-4, err_msg=k)
        assert np.abs(state[k] - start[k].numpy()).max() > 1e-3, k
    for k in params:
        np.testing.assert_allclose(state[k], ref[k].numpy(), rtol=0,
                                   atol=3e-3, err_msg=k)
        update = np.abs(ref[k].numpy() - start[k].numpy()).max()
        assert np.abs(state[k] - ref[k].numpy()).max() <= 0.15 * update, k
    np.testing.assert_allclose(ranks[0]["losses"], ref_losses, rtol=3e-4)
    # the wire plans {"params", "batch_stats"}: the JAX plan's buckets
    jplan = jax_plan_of_tree(v)
    port = make_plan([(flax_shape(leaf, state[leaf.key].shape), "float32")
                      for leaf in _resnet_leaves()])
    assert port.plan_hash() == jplan.plan_hash()
    assert ranks[0]["plan_hash"] == ranks[1]["plan_hash"]


@pytest.mark.parametrize("arch", ["mlp", "resnet50"])
def test_multi_node_evaluator_means_over_ranks(mlp_world, resnet_world,
                                               arch):
    """Each rank evaluates its own shard (in eval mode, training mode
    restored after); the reported metrics are the ranks' mean, the same
    on every rank.  AllreducePersistent means every buffer."""
    ranks = (mlp_world if arch == "mlp" else resnet_world)[3]
    for res in ranks:
        assert res["training_after_eval"]
        for k, v in res["eval"].items():
            mean = np.mean([r["local_eval"][k] for r in ranks])
            np.testing.assert_allclose(v, mean, rtol=1e-12)
            assert v == ranks[0]["eval"][k]
        assert set(res["eval"]) == {"val/loss", "val/accuracy"}
        if arch == "resnet50":
            assert res["persistent"] == [0.5]
        else:
            assert res["persistent"] == []
    assert ranks[0]["local_eval"] != ranks[1]["local_eval"]


@pytest.mark.parametrize("arch", ["mlp", "resnet50"])
def test_nonfinite_skip_restores_model_state(mlp_world, resnet_world, arch):
    """One rank's NaN loss under nonfinite="skip": both ranks agree the
    step was not finite and leave every parameter and running statistic
    bit-identical, though the forward had already moved the statistics."""
    ranks = (mlp_world if arch == "mlp" else resnet_world)[3]
    for res in ranks:
        assert res["skip_finite"] == 0.0
        assert res["skip_unchanged"]
