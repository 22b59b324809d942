"""ResNet family (port of ``chainermn_tpu/models/resnet.py``): ResNet-18,
-50 and -101 with flax's numerics.

The model takes the JAX package's NHWC images and permutes them once to
NCHW; the permuted view of an NHWC tensor is PyTorch's ``channels_last``
layout, which the convolutions and BatchNorms keep.  Numerics that
follow the flax model rather than PyTorch's defaults:

* every convolution casts its input and its fp32 weight to the compute
  dtype before the product (``nn.Conv(dtype=bf16)``); the stem is 7x7 /
  stride 2 with padding 3, the 3x3 convolutions have explicit padding 1,
  the 1x1 projections flax's ``'SAME'``, which is 0 at any size;
* the stem's 3x3 / stride 2 max pool pads with -inf;
* :class:`BatchNorm` is ``flax.linen.BatchNorm(momentum=0.9,
  epsilon=1e-5)`` (see its docstring), and the last one of each block
  starts with a zero scale;
* the mean pool runs over H, W in the compute dtype, into an fp32 dense
  head; the logits are fp32.

``norm`` is the factory hook of the JAX model: ``norm(size, *, dtype,
zero_scale)`` returns the normalization module of each position, so a
synchronized BatchNorm can replace :class:`BatchNorm` without touching
the blocks.  ``models.convert.resnet_params_from_flax`` carries a flax
tree (``params`` and ``batch_stats``) over.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import init_flax_

BN_MOMENTUM = 0.9  # flax's convention: the running average keeps 0.9
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the
    channels of an NCHW tensor (the same statistics as flax's reduction
    over N, H, W of NHWC).

    Training: the batch statistics are reduced in fp32 with the fast
    variance ``E[x^2] - E[x]^2`` clamped at 0, and the *biased* batch
    variance goes into the running variance (``torch.nn.BatchNorm2d``
    would put the unbiased one there): ``running = 0.9 * running + 0.1 *
    batch``.  Evaluation normalizes with the running statistics.  Either
    way the normalization is fp32, ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias``, in flax's order, and its output is cast to
    ``dtype``.  Autograd differentiates through the statistics, as JAX
    does through ``_compute_stats``.
    """

    def __init__(self, size: int, *, dtype: torch.dtype = torch.float32,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(size) if zero_scale
                                   else torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))
        self.register_buffer("running_mean", torch.zeros(size))
        self.register_buffer("running_var", torch.ones(size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp(torch.square(xf).mean(dim=(0, 2, 3))
                              - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(self.running_mean * m
                                        + mean.detach() * (1.0 - m))
                self.running_var.copy_(self.running_var * m
                                       + var.detach() * (1.0 - m))
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = ((xf - mean[None, :, None, None]) * mul[None, :, None, None]
             + self.bias[None, :, None, None])
        return y.to(self.dtype)


def default_norm(size: int, *, dtype: torch.dtype = torch.float32,
                 zero_scale: bool = False) -> nn.Module:
    """Plain BatchNorm factory (the JAX package's ``default_norm``)."""
    return BatchNorm(size, dtype=dtype, zero_scale=zero_scale)


NormFactory = Callable[..., nn.Module]


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``flax.linen.Conv(dtype=dtype, use_bias=False)``: input and
    weight cast to the compute dtype, then the convolution."""
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride,
                    layer.padding)


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1,
          padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=padding,
                     bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4, with a 1x1 projection where the
    width or the stride changes."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int,
                 norm: NormFactory, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        out = features * 4
        self.conv1 = _conv(in_ch, features, 1)
        self.bn1 = norm(features, dtype=dtype)
        self.conv2 = _conv(features, features, 3, stride, 1)
        self.bn2 = norm(features, dtype=dtype)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = norm(out, dtype=dtype, zero_scale=True)
        self.proj = self.proj_bn = None
        if in_ch != out or stride != 1:
            self.proj = _conv(in_ch, out, 1, stride)
            self.proj_bn = norm(out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        y = F.relu(self.bn2(conv(y, self.conv2, self.dtype)))
        y = self.bn3(conv(y, self.conv3, self.dtype))
        residual = x
        if self.proj is not None:
            residual = self.proj_bn(conv(x, self.proj, self.dtype))
        return F.relu(y + residual)


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3, with a 1x1 projection where the width or the
    stride changes."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int,
                 norm: NormFactory, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(in_ch, features, 3, stride, 1)
        self.bn1 = norm(features, dtype=dtype)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = norm(features, dtype=dtype, zero_scale=True)
        self.proj = self.proj_bn = None
        if in_ch != features or stride != 1:
            self.proj = _conv(in_ch, features, 1, stride)
            self.proj_bn = norm(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        y = self.bn2(conv(y, self.conv2, self.dtype))
        residual = x
        if self.proj is not None:
            residual = self.proj_bn(conv(x, self.proj, self.dtype))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``ResNet(stage_sizes, block_cls)`` on NHWC images; returns fp32
    logits.  ``train()``/``eval()`` select batch or running statistics
    (the JAX model's ``train`` field)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls=Bottleneck,
                 num_classes: int = 1000, num_filters: int = 64, *,
                 norm: NormFactory = default_norm,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.conv_init = _conv(3, num_filters, 7, 2, 3)
        self.bn_init = norm(num_filters, dtype=dtype)
        blocks = []
        in_ch = num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                features = num_filters * 2 ** i
                blocks.append(block_cls(in_ch, features, stride, norm, dtype))
                in_ch = features * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(in_ch, num_classes)
        init_flax_(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> channels_last NCHW
        x = F.relu(self.bn_init(conv(x, self.conv_init, self.dtype)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for blk in self.blocks:
            x = blk(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.head.weight, self.head.bias)


def ResNet18(**kw) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], Bottleneck, **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet([3, 4, 23, 3], Bottleneck, **kw)
