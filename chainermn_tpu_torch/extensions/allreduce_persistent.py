"""All-reduce of persistent (non-gradient) state (port of
``chainermn_tpu/extensions/allreduce_persistent.py``, ChainerMN's
``AllreducePersistent``): BatchNorm running statistics averaged over
the ranks so that every rank carries the same state into evaluation
and snapshots.

One process per card holds its own buffers (the JAX package's
"stacked per-rank stats" case), so the reduce is one all-reduce of the
buffers packed into a flat tensor per dtype.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn


@torch.no_grad()
def allreduce_mean_(tensors: Sequence[torch.Tensor], comm) -> None:
    """Replace each tensor by its mean over the ranks, in place: one
    ``comm.allreduce(..., "mean")`` per dtype over the packed tensors."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = comm.allreduce(torch.cat([t.reshape(-1) for t in group]),
                              "mean")
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


class AllreducePersistent:
    """Trainer extension: mean every floating-point buffer of ``model``
    over the ranks (each epoch by default).  The train step's
    ``model_state`` already does this after every update; the extension
    serves loops that update the state without it."""

    priority = 250
    trigger = (1, "epoch")
    name = "allreduce_persistent"

    def __init__(self, model: nn.Module, comm):
        self._model = model
        self._comm = comm

    def __call__(self, trainer=None) -> None:
        allreduce_mean_([b for b in self._model.buffers()
                         if b.is_floating_point()], self._comm)
