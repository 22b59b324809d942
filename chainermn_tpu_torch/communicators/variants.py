"""Named communicator variants.

Port of ``chainermn_tpu/communicators/variants.py``.  Over
``torch.distributed`` the all-reduce algorithm belongs to the backend
(NCCL on cards, gloo on the CPU); what a variant controls is where its
collectives run and whether the gradient exchange happens at all:

* ``pure_nccl`` / ``tpu`` / ``flat`` -> the default process group: one
  NCCL domain over every card (ChainerMN's ``PureNcclCommunicator`` and
  ``FlatCommunicator``);
* ``single_node``  -> the same, asserting one node;
* ``naive``        -> every collective staged through the host over a
  gloo group (ChainerMN's host-side MPI reduce; works with no card);
* ``dummy``        -> ``naive`` whose reductions, broadcasts and
  all-to-alls return the local value, and whose train step leaves the
  gradient exchange out (``no_exchange``): ``t_sync - t_dummy`` is the
  exposed cost of gradient sync.
"""

from __future__ import annotations

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
