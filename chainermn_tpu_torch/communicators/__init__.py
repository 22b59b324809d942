"""Communicator factory.

Port of ``chainermn_tpu/communicators/__init__.py``:
``create_communicator(communicator_name, allreduce_grad_dtype=None)``
dispatches a name to a class.  The caller initialises
``torch.distributed`` first (one process per card, ChainerMN's model);
``tpu`` and ``pure_nccl`` name the default process group, NCCL on cards
and gloo on the CPU.
"""

from __future__ import annotations

from .communicator_base import CommunicatorBase
from ._topology import FAKE_NODE_SIZE_ENV, Topology
from .variants import (
    DummyCommunicator,
    FlatCommunicator,
    HierarchicalCommunicator,
    NaiveCommunicator,
    PureNcclCommunicator,
    SingleNodeCommunicator,
)

_COMMUNICATORS = {
    "tpu": PureNcclCommunicator,
    "pure_nccl": PureNcclCommunicator,
    "flat": FlatCommunicator,
    "hierarchical": HierarchicalCommunicator,
    "single_node": SingleNodeCommunicator,
    "naive": NaiveCommunicator,
    "dummy": DummyCommunicator,
}

# names of the JAX package not ported yet, and the ROADMAP item that
# brings each
_WAITING = {
    "two_dimensional": "Queue 1 'Communicators, tier 2' (2-D "
                       "factorisation)",
    "non_cuda_aware": "Queue 1 'Communicators, tier 2' (host-staged "
                      "NCCL variant)",
    "hybrid": "Queue 1 'Model parallelism' (data x model groups)",
    "mesh": "Queue 1 'LM parallelism' (data x seq x model groups)",
}


def create_communicator(communicator_name: str = "pure_nccl",
                        allreduce_grad_dtype=None) -> CommunicatorBase:
    """Create a communicator by name: ``pure_nccl`` (default), ``tpu``,
    ``flat``, ``hierarchical``, ``single_node``, ``naive`` or ``dummy``.

    ``allreduce_grad_dtype``: optional reduced precision for the
    gradient all-reduce (``bfloat16``/``float16``, torch or numpy), as
    in ChainerMN's ``PureNcclCommunicator``."""
    if communicator_name in _WAITING:
        raise NotImplementedError(
            f"communicator {communicator_name!r} is not ported yet: see "
            f"ROADMAP {_WAITING[communicator_name]}"
        )
    try:
        cls = _COMMUNICATORS[communicator_name]
    except KeyError:
        raise ValueError(
            f"unknown communicator {communicator_name!r}; available: "
            f"{sorted(_COMMUNICATORS)}"
        ) from None
    return cls(allreduce_grad_dtype=allreduce_grad_dtype)


__all__ = [
    "CommunicatorBase",
    "DummyCommunicator",
    "FAKE_NODE_SIZE_ENV",
    "FlatCommunicator",
    "HierarchicalCommunicator",
    "NaiveCommunicator",
    "PureNcclCommunicator",
    "SingleNodeCommunicator",
    "Topology",
    "create_communicator",
]
