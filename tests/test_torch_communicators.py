"""Port parity of the communicators: the rank model and the collective
value matrix of tests/test_communicators.py (``TestCollectives``,
``TestDummy``, ``TestFactory``) for the ported names.

The JAX package's collectives take a stacked array (row r is rank r's
value) in one controller; the port's take each rank's own row in a real
world of processes.  One gloo world of 4 runs every ported name on rows
of the same numpy inputs, and each rank's result is held against row r
of the JAX ``naive`` communicator's result on the stacked inputs."""

import jax
import numpy as np
import pytest
import torch

from chainermn_tpu.communicators import create_communicator as jax_create
from chainermn_tpu.communicators._topology import Topology as JaxTopology
from chainermn_tpu_torch.communicators import Topology, create_communicator

import test_torch_world as torch_world

WORLD = 4
NAMES = ["pure_nccl", "tpu", "flat", "single_node", "naive", "dummy"]


def _inputs():
    rng = np.random.RandomState(0)
    x = {"x": rng.randn(WORLD, 3).astype(np.float32),
         "a2a": np.arange(WORLD * WORLD * 2, dtype=np.float32).reshape(
             WORLD, WORLD, 2),
         "rs": rng.randn(WORLD, 16).astype(np.float32),
         "x45": rng.randn(WORLD, 4, 5).astype(np.float32),
         "grad": rng.randn(WORLD, 2, 3).astype(np.float32)}
    for op in ("sum", "mean", "max", "min", "prod"):
        x[f"x_{op}"] = rng.randn(WORLD, 3).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def world4():
    inputs = _inputs()
    ranks = torch_world.run_world(torch_world.collectives_worker, WORLD,
                                  inputs, NAMES, timeout=180)
    return inputs, ranks


@pytest.fixture(scope="module")
def jax_naive():
    return jax_create("naive", devices=jax.devices("cpu")[:WORLD])


def _rows(a):
    return np.asarray(a)


@pytest.mark.parametrize("name", [n for n in NAMES if n != "dummy"])
def test_collective_value_matrix(world4, jax_naive, name):
    """Tolerance: the reductions of 4 fp32 rows in another order than
    numpy's, 1e-5 relative (as the JAX matrix); moves are exact."""
    inputs, ranks = world4
    j = jax_naive
    for op in ("sum", "mean", "max", "min", "prod"):
        ref = _rows(j.allreduce(inputs[f"x_{op}"], op=op))
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res[name]["allreduce"][op], ref[r],
                                       rtol=1e-5, err_msg=op)
    x = inputs["x"]
    for root in (0, 3):
        ref = _rows(j.bcast(x, root=root))
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res[name]["bcast"][root], ref[r])
    ref_ag = _rows(j.allgather(x))
    ref_g = _rows(j.gather(x, root=2))
    ref_sc = _rows(j.scatter(x, root=1))
    ref_a2a = _rows(j.alltoall(inputs["a2a"]))
    ref_rs = _rows(j.reduce_scatter(inputs["rs"]))
    ref_md = _rows(j.allreduce(inputs["x45"]))
    for r, res in enumerate(ranks):
        got = res[name]
        np.testing.assert_array_equal(got["allgather"], ref_ag)
        if r == 2:
            np.testing.assert_array_equal(got["gather"], ref_g)
        else:
            assert got["gather"] is None
        np.testing.assert_array_equal(got["scatter"], ref_sc[r])
        np.testing.assert_array_equal(got["alltoall"], ref_a2a[r])
        np.testing.assert_allclose(got["reduce_scatter"], ref_rs[r],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["multidim"], ref_md[r], rtol=1e-5)


@pytest.mark.parametrize("name", [n for n in NAMES if n != "dummy"])
def test_object_transport_and_model_helpers(world4, jax_naive, name):
    inputs, ranks = world4
    ref_grad = _rows(jax_naive.allreduce_grad({"g": inputs["grad"]})["g"])
    for r, res in enumerate(ranks):
        got = res[name]
        assert got["bcast_obj"] == {"from": 3}
        assert got["gather_obj"] == ([0, 10, 20, 30] if r == 0 else None)
        assert got["allgather_obj"] == [("r", i) for i in range(WORLD)]
        assert got["allreduce_obj"] == 10
        np.testing.assert_array_equal(got["bcast_data"], 0.0)  # rank 0's
        np.testing.assert_allclose(got["allreduce_grad"], ref_grad[r],
                                   rtol=1e-5)


def test_dummy_passthrough(world4):
    """``dummy`` returns each rank's own value from its reductions,
    broadcasts and all-to-alls, and leaves gradients alone."""
    inputs, ranks = world4
    for r, res in enumerate(ranks):
        got = res["dummy"]
        for op in ("sum", "max"):
            np.testing.assert_array_equal(got["allreduce"][op],
                                          inputs[f"x_{op}"][r])
        np.testing.assert_array_equal(got["bcast"][3], inputs["x"][r])
        np.testing.assert_array_equal(got["alltoall"], inputs["a2a"][r])
        np.testing.assert_array_equal(got["allreduce_grad"],
                                      inputs["grad"][r])


def test_rank_model(world4):
    """One host: every rank in one node.  Under the fake-node knob
    (size 2) the world factorizes into 2 nodes of 2, in rank order, as
    the JAX topology groups its fake slices."""
    _, ranks = world4
    for r, res in enumerate(ranks):
        got = res["pure_nccl"]
        assert (got["rank"], got["size"]) == (r, WORLD)
        assert got["device"] == "cpu"  # a gloo world runs on the CPU
        assert got["intra"] == (r, WORLD) and got["inter"] == (0, 1)
        assert res["fake_nodes"]["intra"] == (r % 2, 2)
        assert res["fake_nodes"]["inter"] == (r // 2, 2)
        assert res["single_node_raised"]


class _FakeDevice:
    def __init__(self, i, process_index):
        self.id = i
        self.process_index = process_index
        self.platform = "cpu"


@pytest.mark.parametrize("hosts", [[0, 0, 0, 0], [0, 0, 1, 1], [0, 1, 0, 1],
                                   [2, 2, 2, 0, 0, 1]])
def test_groupings_equal_jax_topology(hosts):
    """The JAX topology's hostname (process) grouping over the same
    node assignment gives the same intra/inter tables."""
    port = Topology.from_node_keys(0, [("host", h) for h in hosts])
    ref = JaxTopology.create([_FakeDevice(i, h) for i, h in
                              enumerate(hosts)])
    order = [d.id for d in ref.devices]  # the JAX table is node-sorted
    assert sorted(port.intra_sizes) == sorted(ref.intra_sizes)
    assert port.inter_size == ref.inter_size
    for pos, rank in enumerate(order):
        assert port.intra_ranks[rank] == ref.intra_ranks[pos]
        assert port.intra_sizes[rank] == ref.intra_sizes[pos]
    assert port.is_uniform() == ref.is_uniform()


def test_factory_names():
    with pytest.raises(ValueError, match="unknown communicator"):
        create_communicator("warp_drive")
    for name in ("two_dimensional", "non_cuda_aware", "hybrid", "mesh"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            create_communicator(name)
    # without a process group there is nothing to span
    assert not torch.distributed.is_initialized()
    for name in ("pure_nccl", "hierarchical"):
        with pytest.raises(RuntimeError, match="init_process_group"):
            create_communicator(name)
