"""Rank topology of a one-process-per-GPU world.

Port of ``chainermn_tpu/communicators/_topology.py``.  The JAX package
derives its groupings from the device list of one controller; the port
runs one process per card, as ChainerMN did, so the groupings come from
the processes themselves, as in ChainerMN's ``init_ranks``: every rank
contributes its hostname, ranks sharing a hostname form a node.

Rank model (ChainerMN's):

* ``rank``       — the process's rank in the world;
* ``intra_rank`` — its index within its node, in rank order (the card a
  process drives: ``cuda:<intra_rank>``);
* ``inter_rank`` — the index of its node, in order of each node's first
  rank.

``CHAINERMN_TORCH_FAKE_NODE_SIZE=<k>`` (the counterpart of
``CHAINERMN_TPU_FAKE_SLICE_SIZE``) groups ranks into synthetic nodes of
``k`` consecutive ranks instead, so one host can stand in for several
nodes; unset, unparseable or non-positive means off.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Callable, Hashable, Sequence

FAKE_NODE_SIZE_ENV = "CHAINERMN_TORCH_FAKE_NODE_SIZE"


def fake_node_size() -> int:
    """The fake-node-size knob: 0 when off."""
    raw = os.environ.get(FAKE_NODE_SIZE_ENV)
    if not raw:
        return 0
    try:
        k = int(raw)
    except ValueError:
        return 0
    return k if k > 0 else 0


@dataclasses.dataclass(frozen=True)
class Topology:
    """Immutable rank table of a world (parity: the rank attributes of
    ChainerMN's ``CommunicatorBase``)."""

    rank: int
    node_keys: tuple  # node key per rank
    intra_ranks: tuple  # intra-node rank per rank
    inter_ranks: tuple  # node index per rank
    intra_sizes: tuple  # size of each rank's node
    inter_size: int

    @classmethod
    def from_node_keys(cls, rank: int, keys: Sequence[Hashable]) -> "Topology":
        """Group ranks by node key: nodes numbered in order of their
        first rank, intra ranks in rank order within each node."""
        unique: list = []
        for k in keys:
            if k not in unique:
                unique.append(k)
        counts: dict = {}
        intra = []
        for k in keys:
            intra.append(counts.get(k, 0))
            counts[k] = counts.get(k, 0) + 1
        return cls(rank=rank, node_keys=tuple(keys),
                   intra_ranks=tuple(intra),
                   inter_ranks=tuple(unique.index(k) for k in keys),
                   intra_sizes=tuple(counts[k] for k in keys),
                   inter_size=len(unique))

    @classmethod
    def create(cls, rank: int, size: int,
               allgather_obj: Callable[[object], list]) -> "Topology":
        """The world's topology: synthetic nodes under the fake-node
        knob, else ranks grouped by hostname (one object all-gather)."""
        k = fake_node_size()
        if k:
            keys = [("node", r // k) for r in range(size)]
        else:
            keys = [("host", h) for h in allgather_obj(socket.gethostname())]
        return cls.from_node_keys(rank, keys)

    @property
    def size(self) -> int:
        return len(self.node_keys)

    @property
    def intra_rank(self) -> int:
        return self.intra_ranks[self.rank]

    @property
    def intra_size(self) -> int:
        return self.intra_sizes[self.rank]

    @property
    def inter_rank(self) -> int:
        return self.inter_ranks[self.rank]

    def is_uniform(self) -> bool:
        """True if every node holds the same number of ranks."""
        return len(set(self.intra_sizes)) <= 1
