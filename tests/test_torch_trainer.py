"""Port parity of the training loop's pieces: the MNIST example's twin
against the JAX example on the same arguments and initial weights, the
iterators and the synthetic datasets (the same arrays and order from the
same seeds), the triggers, the Trainer's extension protocol and state,
and what the entry points refuse."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.iterators.serial_iterator import EpochIterator as JaxEpochIterator
from chainermn_tpu.iterators.serial_iterator import SerialIterator as JaxSerialIterator
from chainermn_tpu.models.mlp import MLP as JaxMLP
from chainermn_tpu.utils import toy_datasets as jax_toy
from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch.examples import train_imagenet, train_mnist
from chainermn_tpu_torch.iterators import EpochIterator, SerialIterator
from chainermn_tpu_torch.training import IntervalTrigger, Trainer, Updater, get_trigger
from chainermn_tpu_torch.training import extensions as T
from chainermn_tpu_torch.utils import SyntheticImageDataset, get_mnist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name, path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", *path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MNIST_ARGS = ["--epoch", "2", "--n-train", "1024", "--n-test", "256",
              "--batchsize", "128", "--unit", "100", "--lr", "0.05"]


def test_mnist_twin_final_log_matches_jax_example(tmp_path, monkeypatch):
    """The JAX example on the 8-device CPU mesh (one controller: the
    whole shuffled train set, batches of 128 split over the chips) and
    the port's twin in a world of one (gloo, the same set and batches),
    both from the flax initialisation the JAX example draws.  bf16
    compute: the JAX step's gradient is the mean of 8 chips' bf16
    partial products, the port's one product of all 128 rows, so the
    numbers part by rounding: losses within 2 % (measured 0.2 % and
    0.3 % for the validation loss), validation accuracy within 0.02
    (measured equal, 1.0)."""
    monkeypatch.chdir(tmp_path)
    jax_example = _jax_example("jax_train_mnist", ("mnist", "train_mnist.py"))
    ref = jax_example.main(MNIST_ARGS + ["--cpu-mesh"])
    params = jax.tree_util.tree_map(np.asarray, JaxMLP(n_units=100).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28))))
    log = train_mnist.main(MNIST_ARGS + ["--device", "cpu"], params=params)
    got = log[-1]
    assert len(log) == 2 and log[0]["loss"] > got["loss"]
    for k in ("epoch", "iteration"):
        assert got[k] == ref[k], k
    for k in ("loss", "val/loss"):
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-2, err_msg=k)
    assert abs(got["val/accuracy"] - ref["val/accuracy"]) <= 0.02
    assert (tmp_path / "result" / "log.json").exists()


def test_datasets_equal_jax():
    ds, ref = SyntheticImageDataset(20, shape=(8, 8, 3), seed=3), \
        jax_toy.SyntheticImageDataset(20, shape=(8, 8, 3), seed=3)
    for i in (0, 7, 19, -1):
        (x, y), (rx, ry) = ds[i], ref[i]
        np.testing.assert_array_equal(x, rx)
        assert y == ry and x.dtype == rx.dtype and y.dtype == ry.dtype
    assert len(ds[2:5]) == 3
    with pytest.raises(IndexError):
        ds[20]
    (tr, te), (rtr, rte) = get_mnist(n_train=30, n_test=10), \
        jax_toy.get_mnist(n_train=30, n_test=10)
    np.testing.assert_array_equal(tr[29][0], rtr[29][0])
    np.testing.assert_array_equal(te[9][0], rte[9][0])


def test_mnist_npz_is_read_where_given(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "mnist.npz"
    np.savez(path, x_train=rng.randint(0, 256, (5, 28, 28)),
             y_train=np.arange(5), x_test=rng.randint(0, 256, (2, 28, 28)),
             y_test=np.arange(2))
    tr, te = get_mnist(str(path))
    rtr, _ = jax_toy.get_mnist(str(path))
    assert len(tr) == 5 and len(te) == 2
    np.testing.assert_array_equal(tr[4][0], rtr[4][0])


def test_serial_iterator_order_and_state_equal_jax():
    data = [(np.full(2, i, np.float32), np.int32(i)) for i in range(10)]
    it, ref = SerialIterator(data, 4, seed=7), JaxSerialIterator(data, 4,
                                                                 seed=7)
    for _ in range(7):
        (x, y), (rx, ry) = next(it), next(ref)
        np.testing.assert_array_equal(y, ry)
        assert (it.epoch, it.is_new_epoch, it.epoch_detail) == (
            ref.epoch, ref.is_new_epoch, ref.epoch_detail)
    state = it.serialize()
    want = [next(it)[1] for _ in range(5)]
    again = SerialIterator(data, 4, seed=0)
    again.restore(state)
    assert all(np.array_equal(w, next(again)[1]) for w in want)
    once = SerialIterator(data, 3, repeat=False, shuffle=False)
    assert [b[1].tolist() for b in once] == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]


def test_epoch_iterator_pads_like_jax():
    data = [(np.zeros(1), np.int32(i)) for i in range(7)]
    got = [b[1].tolist() for b in EpochIterator(data, 3, pad_to=2)]
    ref = [b[1].tolist() for b in JaxEpochIterator(data, 3, pad_to=2)]
    assert got == ref == [[0, 1, 2, 0], [3, 4, 5, 0], [6, 0]]


def test_interval_trigger():
    class Fake:
        iteration, epoch = 0, 0

    t = get_trigger((2, "iteration"))
    fired = []
    for i in range(1, 7):
        Fake.iteration = i
        fired.append(t(Fake))
    assert fired == [False, True, False, True, False, True]
    assert get_trigger(t) is t and get_trigger(None).unit == "epoch"
    t2 = IntervalTrigger(1, "epoch")
    t2.restore(t.state())
    assert t2.state() == {"last_fired": 6}
    with pytest.raises(ValueError):
        IntervalTrigger(1, "minute")


class _Step:
    """A stand-in train step: records its batches."""

    class comm:
        device = torch.device("cpu")
        size = 2
        rank = 0

    def __init__(self):
        self.batches = []

    def __call__(self, batch):
        self.batches.append(batch)
        return {"loss": torch.tensor(float(len(self.batches)))}


def test_trainer_runs_extensions_by_priority_and_trigger():
    data = [(np.full(3, i, np.float32), np.int32(i)) for i in range(8)]
    step = _Step()
    trainer = Trainer(Updater(SerialIterator(data, 2, shuffle=False), step),
                      stop_trigger=(6, "iteration"))
    calls = []
    trainer.extend(lambda t: calls.append(("low", t.iteration)),
                   trigger=(1, "iteration"), priority=1, name="low")
    trainer.extend(lambda t: calls.append(("high", t.iteration)),
                   trigger=(3, "iteration"), priority=500)
    log = T.LogReport(filename=None, trigger=(1, "epoch"))
    trainer.extend(log)
    trainer.extend(T.Throughput(4, comm=_Step.comm), trigger=(1, "iteration"))
    trainer.run()
    assert trainer.iteration == 6 and len(step.batches) == 6
    assert calls[:4] == [("low", 1), ("low", 2), ("high", 3), ("low", 3)]
    x, y = step.batches[0]
    assert isinstance(x, torch.Tensor) and y.tolist() == [0, 1]
    assert [e["iteration"] for e in log.log] == [5]
    assert "samples_per_sec_per_chip" in trainer.observation
    assert trainer.get_extension("low") is not None
    state = trainer.state_dict()
    assert state["iteration"] == 6 and state["iterator"]["pos"] == 4
    other = Trainer(Updater(SerialIterator(data, 2, shuffle=False), _Step()))
    other.load_state_dict(state)
    assert other.iteration == 6 and other.updater.epoch == 1


def test_print_report_writes_rank_zero_rows(capsys):
    log = T.LogReport(filename=None)

    class Tr:
        iteration, epoch, elapsed_time = 4, 1, 0.5
        observation = {"loss": torch.tensor(0.25), "name": "x"}

    log(Tr)
    assert "name" not in log.log[0] and log.log[0]["loss"] == 0.25
    T.PrintReport(["epoch", "loss", "missing"], log)(Tr)
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["epoch", "loss", "missing"]
    assert out[1].split() == ["1", "0.25"]

    class Rank1:
        rank = 1

    T.PrintReport(["epoch"], log, comm=Rank1)(Tr)
    assert capsys.readouterr().out == ""


def test_unported_paths_raise_naming_roadmap():
    trainer = Trainer(Updater(iter([]), _Step()))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer.run(max_restarts=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer.run_elastic(lambda comm: None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_imagenet.main(["--native-loader", "--device", "cpu"])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for main in (train_mnist.main, train_imagenet.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])


def test_imagenet_twin_trains_resnet18_on_cpu(tmp_path, monkeypatch):
    """The ImageNet twin end to end in a world of one on the CPU: a few
    iterations of ResNet-18 on the synthetic set, the bf16 wire, the
    evaluator; finite losses."""
    monkeypatch.chdir(tmp_path)
    log = train_imagenet.main([
        "--arch", "resnet18", "--image-size", "32", "--n-train", "16",
        "--n-val", "8", "--batchsize", "8", "--num-classes", "10",
        "--allreduce-grad-dtype", "bfloat16", "--device", "cpu"])
    assert log[-1]["iteration"] == 3
    assert np.isfinite(log[-1]["loss"]) and np.isfinite(log[-1]["val/loss"])


def test_global_except_hook_installs_once():
    before = sys.excepthook
    try:
        global_except_hook.add_hook()
        hook = sys.excepthook
        assert hook is not before
        global_except_hook.add_hook()
        assert sys.excepthook is hook
    finally:
        global_except_hook.remove_hook()
    assert sys.excepthook is sys.__excepthook__
    sys.excepthook = before
