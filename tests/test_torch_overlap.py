"""``overlap="bucket"`` against the synchronous wire (the contract of
``chainermn_tpu/comm_wire/overlap.py``: bit-identical results, the same
buckets, codec, summands and collective count; only the time of issue
moves), in one spawned gloo world of 2 and one of 3.

The flax-layout MNIST MLP trains 3 steps with SGD and momentum under the
``none``, ``bf16`` and ``int8`` + error-feedback codecs, with
``accum_steps=2``, and with a parameter that gets no gradient; every
comparison is exact (tolerance 0): parameters, losses and residuals.
The issue record (``MultiNodeOptimizer.issue_report``) shows the
buckets in reverse plan order, each flat cast bucket of the sequential
MLP issued from the backward, and the int8 ones after it.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import test_torch_world as torch_world
import torch_mp_workers as W

STEPS, PER = 3, 8
KNOBS = dict(bucket_bytes=8192, max_buckets=0)
CASES = [("none", dict(codec="none", **KNOBS), 1, False),
         ("bf16", dict(codec="bf16", **KNOBS), 1, False),
         ("int8_ef", dict(codec="int8", error_feedback=True, **KNOBS), 1,
          False),
         ("bf16_accum", dict(codec="bf16", **KNOBS), 2, False),
         ("unused", dict(codec="bf16", **KNOBS), 1, True)]


def _mlp_case(world):
    """The MNIST MLP's shapes (n_units 64) with weights from a seed,
    in flax's layout (``FlaxLayoutMLP``), and the batches."""
    rng = np.random.RandomState(0)
    dims = [(784, 64), (64, 64), (64, 10)]
    params = {f"Dense_{i}": {
        "bias": (rng.randn(o) * 0.1).astype(np.float32),
        "kernel": (rng.randn(i_, o) / np.sqrt(i_)).astype(np.float32)}
        for i, (i_, o) in enumerate(dims)}
    x = rng.randn(STEPS * world * PER, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, len(x)).astype(np.int32)
    return {"params": params}, (x, y)


@pytest.fixture(scope="module")
def worlds():
    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(
            torch_world.run_world, W.jobs_worker, n,
            [("overlap_worker", (*_mlp_case(n), STEPS, CASES))],
            timeout=240) for n in (2, 3)}
        return {n: [r[0] for r in f.result()] for n, f in futures.items()}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_overlap_is_bit_identical_to_the_synchronous_wire(worlds, world,
                                                           case):
    """Parameters, losses and error-feedback residuals of every rank
    equal the synchronous wire's bit for bit, and every rank's equal
    rank 0's."""
    for r in worlds[world]:
        sync, over = r[case]["none"], r[case]["bucket"]
        assert over["losses"] == sync["losses"]
        assert len(over["residual"]) == len(sync["residual"])
        for a, b in zip(over["params"] + over["residual"],
                        sync["params"] + sync["residual"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(over["params"], worlds[world][0][case]["bucket"]
                        ["params"]):
            np.testing.assert_array_equal(a, b)
        assert sync["reports"] == [[]] * STEPS


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", ["none", "bf16", "bf16_accum", "unused"])
def test_flat_buckets_issue_from_the_backward_in_reverse_plan_order(
        worlds, world, case):
    """Every step issues each bucket once, in reverse plan order, from a
    gradient hook; the first issued (the last layer's) while most of the
    plan's parameters still wait for their gradients.  With a parameter
    the loss never reaches, the buckets the hooks can complete issue
    from the backward and the rest, with zeros for it, after it."""
    for r in worlds[world]:
        run = r[case]["bucket"]
        nb = run["n_buckets"]
        assert nb >= 4 and set(run["schedules"]) == {"flat"}
        for report in run["reports"]:
            assert [b for b, _, _ in report] == list(range(nb))[::-1]
            n_params = 7 if case == "unused" else 6
            assert report[0][1] >= n_params - 2
            in_bwd = [inb for _, _, inb in report]
            if case == "unused":
                # the unused parameter (the module's own, so the first)
                # sits in bucket 0, the last in issue order: the others
                # issue from the backward, bucket 0 after it
                assert in_bwd == [True] * (nb - 1) + [False]
                assert report[-1][1] == 1
            else:
                assert all(in_bwd)


@pytest.mark.parametrize("world", [2, 3])
def test_int8_buckets_issue_after_the_backward(worlds, world):
    """int8's one batched MAX all-reduce needs every bucket's absmax, so
    its buckets issue at the end of the backward, in plan order."""
    for r in worlds[world]:
        run = r["int8_ef"]["bucket"]
        for report in run["reports"]:
            assert [b for b, _, _ in report] == list(range(run["n_buckets"]))
            assert not any(inb for _, _, inb in report)
