"""The multi-node checkpointer of the port: save and resume bit for bit
with the tree kept, the inventory's integrity checks (a flipped byte or
a truncated file drops a step), stale directories, the keep-newest GC,
the async writer, the agreement on the newest common step at world 2,
the world-size guard, the manifests' digests against the JAX package's
``resilience.elastic`` on the same directory, and ``restore_trainer``
resuming the ImageNet and MNIST twins where the uninterrupted run goes
on.

Every comparison is exact (tolerance 0): a snapshot stores the tensors'
bytes, and a resumed run on the CPU repeats the uninterrupted run's
operations in the same order.
"""

import collections
import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chainermn_tpu.resilience import elastic as jax_elastic
from chainermn_tpu.resilience import retry as jax_retry

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.resilience import (
    PayloadCorruptionError, RetryPolicy, TransientCommError,
    WorldResizeRequiredError, call_with_retry, elastic, is_transient,
    lockstep_allgather)

import test_torch_world as torch_world

Pair = collections.namedtuple("Pair", "a b")


@pytest.fixture
def comm():
    """A gloo world of one in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield cmn.create_communicator("pure_nccl")
    finally:
        dist.destroy_process_group()


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": collections.OrderedDict(
            w=torch.randn(4, 3, generator=g),
            b=torch.randn(3, generator=g).bfloat16()),
        "opt_state": (torch.arange(5), {"count": torch.tensor(7)},
                      Pair(torch.zeros(2, dtype=torch.float16), 2.5)),
        "trainer": {"iteration": 7, "order": np.arange(6), "name": "x",
                    "nothing": None, "steps": [1, 2]},
    }


def _assert_equal(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_equal(a, b)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("use_async", [False, True])
def test_save_resume_round_trip(comm, tmp_path, use_async):
    """Every leaf back bit for bit with its dtype, in the saved tree
    (OrderedDict, tuple, named tuple, numpy and Python leaves); with
    ``like`` the tensors land on ``like``'s devices; a state changed
    after ``save()`` returned does not reach the snapshot."""
    ckpt = cmn.create_multi_node_checkpointer("t", comm, path=str(tmp_path),
                                              use_async=use_async)
    state = _state()
    want = _state()
    ckpt.save(7, state)
    state["params"]["w"].add_(1.0)  # after save() returned
    state["trainer"]["order"][0] = 99
    step, got = ckpt.resume(like=want)
    assert step == 7
    _assert_equal(got, want)
    step, got = ckpt.resume()
    _assert_equal(got, want)
    ckpt.finalize()
    files = sorted(os.listdir(tmp_path / "t" / "step_000000000007"))
    assert files == ["manifest.json", "tensors.pt", "tree.pkl"]


def test_resume_on_an_empty_directory(comm, tmp_path):
    ckpt = cmn.create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    assert ckpt.resume() == (None, None)
    assert ckpt.newest_common_step() is None


def test_gc_keeps_the_newest(comm, tmp_path):
    ckpt = cmn.create_multi_node_checkpointer("t", comm, path=str(tmp_path),
                                              keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"x": torch.full((2,), float(s))})
    assert ckpt._available_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path / "t")) == [
        "step_000000000003", "step_000000000004"]
    step, got = ckpt.resume()
    assert step == 4 and torch.equal(got["x"], torch.full((2,), 4.0))


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 1)


@pytest.mark.parametrize("damage", ["flip tensors", "flip tree",
                                    "truncate", "remove", "torn manifest"])
def test_a_corrupt_snapshot_is_never_elected(comm, tmp_path, damage):
    """A flipped byte, a truncated or missing file, or a torn manifest in
    the newest step drops it from the inventory (of a restarted
    checkpointer, which hashes afresh): the agreement elects the step
    before, and resume loads that one."""
    ckpt = cmn.create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    for s in (1, 2):
        ckpt.save(s, {"x": torch.full((64,), float(s))})
    newest = tmp_path / "t" / "step_000000000002"
    target = {"flip tensors": "tensors.pt", "flip tree": "tree.pkl",
              "truncate": "tensors.pt", "remove": "tree.pkl",
              "torn manifest": "manifest.json"}[damage]
    path = str(newest / target)
    if damage.startswith("flip"):
        _flip_byte(path)
    elif damage == "truncate":
        _truncate(path)
    elif damage == "remove":
        os.remove(path)
    else:
        with open(path, "r+b") as f:
            f.truncate(10)
    restarted = cmn.create_multi_node_checkpointer("t", comm,
                                                   path=str(tmp_path))
    assert restarted.newest_common_step() == 1
    step, got = restarted.resume()
    assert step == 1 and torch.equal(got["x"], torch.full((64,), 1.0))


def test_stale_directories_ignored_and_swept(comm, tmp_path):
    """A crashed save's ``.tmp*`` and ``.old*`` directories are not steps,
    and the next save sweeps them."""
    ckpt = cmn.create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    ckpt.save(1, {"x": torch.ones(2)})
    root = tmp_path / "t"
    for stale in ("step_000000000005.tmp123", "step_000000000001.old9"):
        shutil.copytree(root / "step_000000000001", root / stale)
    assert ckpt._available_steps() == [1]
    assert ckpt.newest_common_step() == 1
    ckpt.save(2, {"x": torch.ones(2)})
    assert sorted(os.listdir(root)) == ["step_000000000001",
                                        "step_000000000002"]


def test_async_save_returns_before_commit_and_serializes(comm, tmp_path,
                                                         monkeypatch):
    """``use_async``: ``save()`` returns while the write waits on its
    thread (an in-flight save is not yet a step); the next save waits
    for it; both snapshots resume."""
    import threading

    from chainermn_tpu_torch.extensions import checkpoint as ckpt_mod

    gate = threading.Event()
    real = ckpt_mod._MultiNodeCheckpointer._commit

    def held(self, step, host):
        gate.wait(timeout=30)
        real(self, step, host)

    monkeypatch.setattr(ckpt_mod._MultiNodeCheckpointer, "_commit", held)
    ckpt = cmn.create_multi_node_checkpointer("t", comm, path=str(tmp_path),
                                              use_async=True, keep=3)
    first = tmp_path / "t" / "step_000000000001"
    ckpt.save(1, {"x": torch.full((2,), 1.0)})
    assert not first.exists()  # not committed yet
    gate.set()
    ckpt.save(2, {"x": torch.full((2,), 2.0)})  # waits for step 1
    assert first.is_dir()
    step, got = ckpt.resume()
    assert step == 2 and torch.equal(got["x"], torch.full((2,), 2.0))
    ckpt.finalize()
    assert ckpt._available_steps() == [1, 2]


def test_async_write_errors_are_raised(comm, tmp_path, monkeypatch):
    """A failed background write raises at the next drain, never
    silently."""
    from chainermn_tpu_torch.extensions import checkpoint as ckpt_mod

    def broken(self, step, host):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod._MultiNodeCheckpointer, "_commit", broken)
    ckpt = cmn.create_multi_node_checkpointer("t", comm, path=str(tmp_path),
                                              use_async=True)
    ckpt.save(1, {"x": torch.ones(1)})
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_until_finished()
    ckpt.finalize()


def test_orbax_tier_is_not_offered(comm, tmp_path):
    """PyTorch has no orbax: the port takes no ``use_orbax`` at all."""
    with pytest.raises(TypeError, match="use_orbax"):
        cmn.create_multi_node_checkpointer("t", comm, path=str(tmp_path),
                                           use_orbax=True)


def test_another_world_size_is_refused(comm, tmp_path):
    """A snapshot whose manifest names world size 2, resumed in a world
    of one: ``WorldResizeRequiredError`` without a template, and the
    resharder's ``NotImplementedError`` (naming the ROADMAP item) with
    one; never a wrong state."""
    ckpt = cmn.create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    ckpt.save(3, {"x": torch.ones(2)})
    step_dir = str(tmp_path / "t" / "step_000000000003")
    manifest = elastic.read_world_manifest(step_dir)
    manifest["world_size"] = 2
    elastic.write_manifest(manifest, os.path.join(step_dir,
                                                  elastic.MANIFEST_NAME))
    restarted = cmn.create_multi_node_checkpointer("t", comm,
                                                   path=str(tmp_path))
    with pytest.raises(WorldResizeRequiredError):
        restarted.resume()
    with pytest.raises(NotImplementedError, match="Resilience"):
        restarted.resume(like={"x": torch.ones(2)})


def test_manifest_and_digest_verdicts_equal_jax(comm, tmp_path):
    """The port's snapshot directory read by both packages'
    ``resilience.elastic``: the same per-file digests and the same
    ``verify_snapshot`` verdict, intact and after each kind of damage;
    the manifest names this world."""
    ckpt = cmn.create_multi_node_checkpointer("t", comm, path=str(tmp_path))
    ckpt.save(1, _state())
    step_dir = str(tmp_path / "t" / "step_000000000001")
    assert elastic.file_digests(step_dir) == jax_elastic.file_digests(step_dir)
    manifest = elastic.read_world_manifest(step_dir)
    assert manifest == jax_elastic.read_world_manifest(step_dir)
    assert manifest["format"] == jax_elastic.MANIFEST_FORMAT
    assert manifest["world_size"] == 1 and manifest["process_count"] == 1
    assert manifest["mesh_axes"] == {"mn": 1}
    assert manifest["files"] == elastic.file_digests(step_dir)
    assert elastic.snapshot_signature(step_dir) == \
        jax_elastic.snapshot_signature(step_dir)
    verdicts = []
    for damage in (None, _flip_byte, _truncate):
        work = str(tmp_path / f"copy{len(verdicts)}")
        shutil.copytree(step_dir, work)
        if damage is not None:
            damage(os.path.join(work, "tensors.pt"))
        verdicts.append((elastic.verify_snapshot(work),
                         jax_elastic.verify_snapshot(work)))
    with open(os.path.join(work, elastic.MANIFEST_NAME), "w") as f:
        f.write("{torn")
    verdicts.append((elastic.verify_snapshot(work),
                     jax_elastic.verify_snapshot(work)))
    assert verdicts == [(True, True), (False, False), (False, False),
                        (False, False)]
    with open(os.path.join(step_dir, elastic.MANIFEST_NAME)) as f:
        assert json.load(f) == manifest


def test_newest_common_step_at_world_2(tmp_path):
    """Each rank keeps its own ``rank_<r>`` directory; when rank 1 loses
    its newest step, both ranks elect the step before, and each loads
    its own state of that step."""
    ranks = torch_world.run_world(torch_world.checkpoint_agreement_worker,
                                  2, str(tmp_path), 1, timeout=120)
    for r, out in enumerate(ranks):
        assert out["own"] == [1, 2, 3]
        assert out["root"].endswith(os.path.join("agree", f"rank_{r}"))
        assert out["newest"] == 2 and out["step"] == 2
        assert out["w"] == [2.0 + 10 * r] * 3


def test_double_buffering_and_zero_state_round_trip_at_world_2(tmp_path):
    """The double-buffering buffer (bf16 buckets, SGD with momentum) and
    the ZeRO shards' Adam state (each rank its own block) go through the
    checkpointer at step 2 of 4 in a world of 2; a fresh model and
    optimizer resumed from the snapshot end the 4 steps bit-equal to the
    uninterrupted run, on every rank."""
    import torch_mp_workers as W

    rng = np.random.RandomState(7)
    w0 = [(rng.randint(-8, 9, s) / 8.0).astype(np.float32)
          for s in ((5,), (3, 4))]
    xs = [rng.randn(4, 4, *w.shape).astype(np.float32) for w in w0]
    wire = dict(codec="bf16", bucket_bytes=24, max_buckets=0)
    runs = [("db", "momentum", 0.1, dict(double_buffering=True, wire=wire)),
            ("zero", "adam", 0.1, dict(zero_redundancy=True, wire=wire))]
    ranks = torch_world.run_world(W.jobs_worker, 2, [
        ("tier2_checkpoint_worker", (str(tmp_path), w0, xs, runs))],
        timeout=120)
    for (out,) in ranks:
        assert out["db"]["keys"] == ["buffer", "param_groups", "state",
                                     "wire_residual"]
        assert out["zero"]["keys"] == ["param_groups", "state"]
        for name in ("db", "zero"):
            assert out[name]["at"] == 2
            for a, b in zip(out[name]["resumed"],
                            out[name]["uninterrupted"]):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(ranks[1][0]["zero"]["resumed"],
                    ranks[0][0]["zero"]["resumed"]):
        np.testing.assert_array_equal(a, b)


def _final_snapshot(path, name):
    root = os.path.join(path, "checkpoints", name)
    newest = sorted(d for d in os.listdir(root) if d.startswith("step_"))[-1]
    return int(newest[5:]), torch.load(os.path.join(root, newest,
                                                    "tensors.pt"))


def test_imagenet_twin_resumes_where_the_uninterrupted_run_goes_on(
        tmp_path, monkeypatch, capsys):
    """``train_imagenet --arch alex --prefetch 2 --checkpoint`` (96 x 96,
    10 classes, batch 4, dropout on, 6 batches an epoch, CPU): one epoch,
    then ``--epoch 2`` resumes from the first run's snapshot (iteration
    7: an epoch of the serial iterator ends on the draw that starts the
    next one) and ends at 13, where the uninterrupted 2-epoch run ends;
    the two final snapshots (parameters, momentum, iterator state and
    the dropout seeds' counter) are equal bit for bit.  A resume that
    skipped or repeated a buffered batch, or replayed the dropout seeds,
    would fail here."""
    from chainermn_tpu_torch.examples import train_imagenet

    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu", "--arch", "alex", "--image-size", "96",
            "--num-classes", "10", "--n-train", "24", "--n-val", "8",
            "--batchsize", "4", "--lr", "0.01", "--prefetch", "2"]
    first = train_imagenet.main(base + ["--checkpoint", "twin", "--epoch",
                                        "1"])
    assert first[-1]["iteration"] == 7
    capsys.readouterr()
    resumed = train_imagenet.main(base + ["--checkpoint", "twin", "--epoch",
                                          "2"])
    assert "resumed from iteration 7" in capsys.readouterr().out
    plain = train_imagenet.main(base + ["--checkpoint", "plain", "--epoch",
                                        "2"])
    assert resumed[-1]["iteration"] == plain[-1]["iteration"] == 13
    assert len(resumed) == 1  # the resumed run logs its own epoch only
    assert resumed[-1]["loss"] == plain[-1]["loss"]
    (s1, got), (s2, want) = (_final_snapshot(str(tmp_path), n)
                             for n in ("twin", "plain"))
    assert s1 == s2 == 13 and len(got) == len(want) > 16
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mnist_twin_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    """``train_mnist --checkpoint`` snapshots each epoch and a second
    invocation resumes from the newest one."""
    from chainermn_tpu_torch.examples import train_mnist

    monkeypatch.chdir(tmp_path)
    args = ["--device", "cpu", "--n-train", "256", "--n-test", "64",
            "--batchsize", "64", "--unit", "32", "--checkpoint", "m"]
    first = train_mnist.main(args + ["--epoch", "1"])
    capsys.readouterr()
    second = train_mnist.main(args + ["--epoch", "2"])
    it = first[-1]["iteration"]
    assert f"resumed from iteration {it}" in capsys.readouterr().out
    assert second[-1]["iteration"] == 2 * it - 1


@pytest.mark.parametrize("kw", [{}, dict(max_attempts=6, base_delay=0.01,
                                         multiplier=3.0, max_delay=0.5)])
def test_retry_policy_and_classification_equal_jax(kw):
    """The backoff schedule and the transient classification are the
    JAX module's."""
    assert RetryPolicy(**kw).schedule() == jax_retry.RetryPolicy(**kw).schedule()
    for exc in (TimeoutError("x"), RuntimeError("DEADLINE_EXCEEDED: y"),
                RuntimeError("the peer timed out"), RuntimeError("boom"),
                ValueError("deadline exceeded")):
        assert is_transient(exc) == jax_retry.is_transient(exc), exc
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)


def test_call_with_retry_absorbs_transients_and_bounds_them():
    """Transient failures are retried on the policy's schedule (no
    sleeping for real here); an unclassified error propagates at once;
    exhaustion raises ``TransientCommError`` naming the site, with the
    last failure chained."""
    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TimeoutError("slow peer")
        return "ok"

    policy = RetryPolicy(max_attempts=4, base_delay=0.1)
    assert call_with_retry(flaky, site="s", policy=policy,
                           sleep=slept.append) == "ok"
    assert slept == [0.1, 0.2] and len(calls) == 3

    def broken():
        calls.append(1)
        raise RuntimeError("not transient")

    calls.clear()
    with pytest.raises(RuntimeError, match="not transient"):
        call_with_retry(broken, site="s", policy=policy, sleep=slept.append)
    assert len(calls) == 1

    def always():
        raise TimeoutError("down")

    with pytest.raises(TransientCommError, match="site.*4 attempts") as e:
        call_with_retry(always, site="site", policy=policy,
                        sleep=lambda _: None)
    assert isinstance(e.value.__cause__, TimeoutError)


def test_lockstep_allgather_retries_a_torn_payload(comm):
    """The agreement's exchange retries a ``PayloadCorruptionError`` (as
    every rank sees the torn payload, every rank retries) and returns
    every rank's payload."""
    real = comm.allgather_obj
    failures = [PayloadCorruptionError("torn")]

    def torn_once(obj):
        if failures:
            raise failures.pop()
        return real(obj)

    comm.allgather_obj = torn_once
    assert lockstep_allgather(comm, [1, 2], site="t") == [[1, 2]]
    assert not failures
