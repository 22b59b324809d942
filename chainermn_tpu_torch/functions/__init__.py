"""Differentiable communication (port of ``chainermn_tpu/functions``):
point to point (``send``, ``recv``, ``exchange``, ``pseudo_connect``)
and the collectives, each a ``torch.autograd.Function`` over the
communicator."""

from .collectives import (
    all_gather,
    all_to_all,
    allreduce_mean,
    bcast,
    gather,
    pmax,
    pmean,
    pmin,
    ppermute,
    psum,
    reduce_scatter,
    scatter,
)
from .point_to_point import exchange, pseudo_connect, recv, send

__all__ = [
    "send", "recv", "exchange", "pseudo_connect",
    "all_gather", "all_to_all", "bcast", "gather", "scatter",
    "reduce_scatter", "psum", "pmean", "pmax", "pmin", "ppermute",
    "allreduce_mean",
]
