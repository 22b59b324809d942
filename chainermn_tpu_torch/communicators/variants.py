"""Named communicator variants.

Port of ``chainermn_tpu/communicators/variants.py``.  Over
``torch.distributed`` the all-reduce algorithm belongs to the backend
(NCCL on cards, gloo on the CPU); what a variant controls is where its
collectives run and whether the gradient exchange happens at all:

* ``pure_nccl`` / ``tpu`` / ``flat`` -> the default process group: one
  NCCL domain over every card (ChainerMN's ``PureNcclCommunicator`` and
  ``FlatCommunicator``);
* ``hierarchical`` -> the default group for its own collectives, plus
  an intra-node and an inter-node process group, over which the
  gradient wire stages its ``hier_rs_ag`` buckets (ChainerMN's
  ``HierarchicalCommunicator``: intra reduce, inter all-reduce, intra
  broadcast; the JAX package's ``("mn_inter", "mn_intra")`` mesh);
* ``single_node``  -> the same, asserting one node;
* ``naive``        -> every collective staged through the host over a
  gloo group (ChainerMN's host-side MPI reduce; works with no card);
* ``dummy``        -> ``naive`` whose reductions, broadcasts and
  all-to-alls return the local value, and whose train step leaves the
  gradient exchange out (``no_exchange``): ``t_sync - t_dummy`` is the
  exposed cost of gradient sync.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist
from torch import nn

from .communicator_base import CommunicatorBase


class PureNcclCommunicator(CommunicatorBase):
    """The default process group (NCCL on cards): parity
    ``PureNcclCommunicator``, the production default."""


class FlatCommunicator(CommunicatorBase):
    """Parity: ``FlatCommunicator`` (one flat all-reduce over every
    rank)."""


class HierarchicalCommunicator(CommunicatorBase):
    """Two levels, inter-node x intra-node (parity:
    ``HierarchicalCommunicator``).  Its sync axes are the JAX package's
    ``("mn_inter", "mn_intra")`` of sizes ``(inter_size, intra_size)``;
    the gradient wire reduce-scatters a bucket over the intra-node group,
    all-reduces the shard over the inter-node group and all-gathers it
    over the intra-node group (``comm_wire.schedules``).  Its plain
    collectives run over the default group, so their values are the flat
    communicator's.

    Every rank creates every subgroup, in the same order, including the
    groups it is not in (``dist.new_group`` is collective: NCCL hangs
    otherwise): the intra-node groups node by node, then the inter-node
    groups by intra rank.  On a ragged topology (nodes of unequal size)
    the layout degrades to ``(1, size)``, with the reference's warning,
    and every bucket plans ``flat``.
    """

    def __init__(self, allreduce_grad_dtype=None):
        super().__init__(allreduce_grad_dtype)
        topo = self.topology
        if topo.is_uniform():
            grid = [[r for r in range(self.size) if topo.inter_ranks[r] == i]
                    for i in range(topo.inter_size)]
        else:
            sizes = sorted(set(topo.intra_sizes))
            warnings.warn(
                "HierarchicalCommunicator: ragged topology (ranks per "
                f"node: {sizes}) — the two-level intra/inter "
                "factorization degrades to a flat layout (width-1 "
                "'mn_inter' axis kept for axis-name compatibility); "
                "collectives will NOT be node-staged.  Use uniform "
                "nodes to restore the hierarchical schedule.")
            grid = [list(range(self.size))]
        self._mesh_shape = {"mn_inter": len(grid), "mn_intra": len(grid[0])}
        intra = inter = None
        for ranks in grid:
            g = dist.new_group(ranks)
            if self.rank in ranks:
                intra = g
        for j in range(len(grid[0])):
            ranks = [row[j] for row in grid]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                inter = g
        self._wire_groups = (intra, inter)

    @property
    def mesh_shape(self) -> dict:
        return dict(self._mesh_shape)

    @property
    def wire_groups(self):
        return self._wire_groups


class SingleNodeCommunicator(CommunicatorBase):
    """Parity: ``SingleNodeCommunicator``: asserts the world is one
    node."""

    def __init__(self, allreduce_grad_dtype=None):
        super().__init__(allreduce_grad_dtype)
        if self.inter_size != 1:
            raise ValueError(
                "SingleNodeCommunicator requires every rank on one node; "
                f"topology has inter_size={self.inter_size}"
            )


class NaiveCommunicator(CommunicatorBase):
    """Host-staged collectives over a gloo group (parity:
    ``NaiveCommunicator``, the CPU-only portability backend): tensors
    are copied to the host, reduced by gloo, and copied back to their
    device."""

    def _make_group(self):
        if dist.get_backend() == "gloo":
            return None
        return dist.new_group(backend="gloo")

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu()


class DummyCommunicator(NaiveCommunicator):
    """No exchange: reductions, broadcasts and all-to-alls return the
    local value (parity: ``DummyCommunicator``).  ``build_train_step``
    builds the same step with the gradient exchange left out."""

    no_exchange = True

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return x.clone()

    def bcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        return x.clone()

    def alltoall(self, x: torch.Tensor) -> torch.Tensor:
        return x.clone()

    def allreduce_grad(self, model: nn.Module, *, mean: bool = True) -> None:
        return None
