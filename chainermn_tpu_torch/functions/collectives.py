"""Differentiable collective communication.

Port of the part of ``chainermn_tpu/functions/collectives.py`` that
synchronized BatchNorm needs: ``pmean``, here :func:`allreduce_mean`, an
``autograd.Function`` over the communicator's mean all-reduce.  Its
backward is the mean all-reduce of the gradient, the transpose that JAX
generates for ``lax.pmean`` inside the JAX package's train step
(``shard_map(..., check_vma=False)``, optimizers.py:1483): after the
wire's mean of the parameter gradients, a data-parallel step gets the
gradient of the full batch's loss.

The other collectives (all-gather, all-to-all, bcast, gather, scatter,
send/recv) wait for ROADMAP Queue 1 'Model parallelism'.
"""

from __future__ import annotations

import torch


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _mean(x, comm)

    @staticmethod
    def backward(ctx, grad):
        return _mean(grad, ctx.comm), None


def _mean(x: torch.Tensor, comm) -> torch.Tensor:
    allreduce_mean.calls += 1
    return comm.allreduce(x.contiguous(), "mean")


def allreduce_mean(x: torch.Tensor, comm) -> torch.Tensor:
    """The mean of ``x`` over ``comm``'s ranks (all-reduce, then a divide
    by the size, as ``lax.pmean``); differentiable, with the mean
    all-reduce of the gradient as its backward.

    ``allreduce_mean.calls`` counts the all-reduces, forward and
    backward."""
    return _AllReduceMean.apply(x, comm)


allreduce_mean.calls = 0
