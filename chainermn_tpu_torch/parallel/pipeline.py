"""Microbatched pipeline parallelism (the GPipe schedule).

Port of ``chainermn_tpu/parallel/pipeline.py`` (``gpipe`` :51,
``build_pipeline_train_step`` :127).  The JAX package writes the
schedule as one SPMD ``lax.scan`` over ticks, where every chip computes
on zeros while it waits and a ring ``ppermute`` carries the activation
(its wrap-around edge discarded).  The port keeps ChainerMN's one
process per rank, so each rank runs only its own part of the fill:
for each microbatch, receive from ``rank - 1`` (rank 0 takes the
microbatch), compute its stage, send to ``rank + 1`` (the last rank
keeps the output).  The backward drains the microbatches in reverse:
each transfer takes the rank's previous one as its delegate
(``functions.send``/``recv``/``pseudo_connect``), so both neighbours
run their transfers' gradients in the same order.

Stage parameters keep the JAX layout: leaves stacked over stages
(leading axis ``n_stage``); :func:`place_stage_params` gives each rank
its own slice as fresh leaf tensors, which a plain ``torch.optim``
optimizer then updates.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from .._tree import tree_map
from ..functions.point_to_point import pseudo_connect, recv, send


def place_stage_params(stacked, comm, device=None):
    """This rank's slice (row ``comm.rank``) of stage parameters stacked
    over stages: each leaf a fresh tensor on ``device`` (default: the
    communicator's) that requires grad."""
    device = torch.device(device) if device is not None else comm.device
    return tree_map(lambda a: torch.as_tensor(a)[comm.rank].detach().to(
        device, copy=True).requires_grad_(), stacked)


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          stage_params: Any, x_microbatches: torch.Tensor, comm, *,
          remat: bool = False) -> torch.Tensor:
    """Run a homogeneous-stage pipeline, rank s being stage s.

    ``stage_fn(params, h) -> h``: one stage; ``stage_params``: this
    rank's; ``x_microbatches``: ``(n_micro, micro_batch, ...)``, read by
    rank 0 only; ``remat``: recompute each stage's forward in the
    backward (``torch.utils.checkpoint``).

    Returns ``(n_micro, micro_batch, ...)``: the last stage's outputs on
    the last rank, zeros on the others.  Either is tied to the rank's
    transfers, so every rank runs its backward from what it computes
    from this result (a ``functions.psum`` of it, or the loss on the last
    rank and a zero cotangent elsewhere): the neighbours' gradient
    transfers then pair up."""
    fn = stage_fn
    if remat:
        def fn(p, h):
            return checkpoint(stage_fn, p, h, use_reentrant=False)
    me, last = comm.rank, comm.size - 1
    device = x_microbatches.device
    outs, tail = [], None
    for m in range(x_microbatches.shape[0]):
        if me == 0:
            h = x_microbatches[m]
        else:
            h = recv(comm, me - 1, delegate=tail, device=device)
            tail = h
        y = fn(stage_params, h)
        if me == last:
            outs.append(y)
        else:
            tail = send(y if tail is None else pseudo_connect(tail, y),
                        comm, me + 1)
    if me == last:
        out = torch.stack(outs)
    else:
        out = y.new_zeros((len(x_microbatches),) + tuple(y.shape))
    return out if tail is None else pseudo_connect(tail, out)


def build_pipeline_train_step(comm, stage_fn, loss_fn, optimizer, *,
                              n_micro: int, remat: bool = True):
    """A microbatched pipeline-parallel training step.

    ``stage_fn(stage_params, h) -> h``: one homogeneous stage;
    ``loss_fn(outputs, targets) -> scalar`` on the last stage's
    ``(n_micro, micro_batch, ...)`` block; ``optimizer``: a plain
    ``torch.optim`` optimizer over this rank's stage parameters (from
    :func:`place_stage_params`).  Stage gradients are local to their
    rank, so a multi-node optimizer (whose all-reduce would mix the
    stages' gradients) and a communicator with more than one axis are
    rejected.

    ``step(stage_params, (x_micro, targets)) -> {"loss": ...}``: zero
    the gradients, the GPipe fill and drain, the update.  ``x_micro`` is
    ``(n_micro, micro_batch, ...)`` and ``targets`` what ``loss_fn``
    takes, both given to every rank (rank 0 reads the inputs, the last
    rank the targets).  The loss forms on the last rank and is
    broadcast to all (fp32, 0-dim)."""
    from ..optimizers import MultiNodeOptimizer

    if isinstance(optimizer, MultiNodeOptimizer):
        raise ValueError(
            "build_pipeline_train_step takes a plain torch.optim optimizer: "
            "stage gradients are local to their rank and a multi-node "
            "wrapper's all-reduce would mix different stages' gradients")
    if len(comm.axis_names) != 1:
        raise ValueError("pipeline parallelism needs a flat (single-axis) "
                         f"communicator; got axes {comm.axis_names}")
    last = comm.size - 1

    def step(stage_params, batch):
        x_micro, targets = batch
        if x_micro.shape[0] != n_micro:
            raise ValueError(
                f"batch carries {x_micro.shape[0]} microbatches but the "
                f"step was built with n_micro={n_micro}; the schedule's "
                "bubble fraction depends on it: pass matching data")
        optimizer.zero_grad(set_to_none=True)
        out = gpipe(stage_fn, stage_params, x_micro, comm, remat=remat)
        if comm.rank == last:
            loss = loss_fn(out, targets)
            loss.backward()
            value = loss.detach().float()
        else:
            out.backward(torch.zeros_like(out))
            value = torch.zeros((), device=out.device)
        optimizer.step()
        return {"loss": comm.bcast(value, root=last)}

    step.n_stage = comm.size
    step.n_micro = n_micro
    return step
