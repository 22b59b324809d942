"""Synchronized (multi-node) batch normalization.

Port of ``chainermn_tpu/links/multi_node_batch_normalization.py``
(ChainerMN's ``MultiNodeBatchNormalization``): the batch statistics
span the whole data-parallel job.  In training, each layer computes its
local ``[mean, mean of squares]`` in fp32, means that ``(2, C)`` stack
over the communicator's ranks in one all-reduce
(``functions.allreduce_mean``, whose backward is the mean all-reduce of
the gradient), and normalizes with the global statistics.

Its numerics are the JAX module's, not ``models.resnet.BatchNorm``'s:

* epsilon 2e-5;
* ``var = E[x^2] - E[x]^2`` with no clamp;
* the running statistics take the global batch's mean and biased
  variance, ``running = 0.9 * running + 0.1 * batch``;
* ``inv = rsqrt(var + eps) * weight`` and ``offset = bias - mean * inv``
  are folded in fp32, then ``y = x.to(dtype) * inv.to(dtype) +
  offset.to(dtype)`` in the model's dtype;
* evaluation normalizes with the running statistics and communicates
  nothing.

The statistics, the all-reduce and the normalize are three separate
steps (:func:`batch_moments`, ``allreduce_mean``, :func:`normalize`):
a fused BatchNorm kernel fills the first and the last without touching
the middle.  Parameter and buffer names are ``BatchNorm``'s
(``weight``, ``bias``, ``running_mean``, ``running_var``), so the
``state_dict`` keys do not change.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..functions import allreduce_mean

MNBN_MOMENTUM = 0.9
MNBN_EPS = 2e-5


def batch_moments(x: torch.Tensor) -> torch.Tensor:
    """The local fp32 ``(2, C)`` stack ``[mean, mean of squares]`` over
    every axis but the channels (axis 1)."""
    xf = x.float()
    dims = tuple(d for d in range(x.dim()) if d != 1)
    return torch.stack([xf.mean(dim=dims), torch.square(xf).mean(dim=dims)])


def fold(mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
         bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 per-channel ``(inv, offset)`` of the normalize."""
    inv = torch.rsqrt(var + eps) * weight
    return inv, -mean * inv + bias


def normalize(x: torch.Tensor, inv: torch.Tensor, offset: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``x * inv + offset`` over channel axis 1, in ``dtype``."""
    shape = [1] * x.dim()
    shape[1] = -1
    return (x.to(dtype) * inv.to(dtype).view(shape)
            + offset.to(dtype).view(shape))


class MultiNodeBatchNormalization(nn.Module):
    """BatchNorm whose batch statistics span every rank of ``comm``
    (channels on axis 1: NCHW, or ``(N, C)``).

    ``comm=None`` normalizes over the local batch alone (the JAX
    module's ``axis_name=None``: the full-batch oracle of the tests).
    ``zero_scale`` starts the scale at 0 (the ResNet's last BatchNorm of
    each block).
    """

    def __init__(self, size: int, comm=None, *,
                 momentum: float = MNBN_MOMENTUM, eps: float = MNBN_EPS,
                 dtype: torch.dtype = torch.float32, zero_scale: bool = False):
        super().__init__()
        self.comm = comm
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(size) if zero_scale
                                   else torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))
        self.register_buffer("running_mean", torch.zeros(size))
        self.register_buffer("running_var", torch.ones(size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            stats = batch_moments(x)
            if self.comm is not None:
                stats = allreduce_mean(stats, self.comm)
            mean, sq_mean = stats[0], stats[1]
            var = sq_mean - torch.square(mean)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        inv, offset = fold(mean, var, self.weight, self.bias, self.eps)
        return normalize(x, inv, offset, self.dtype)
