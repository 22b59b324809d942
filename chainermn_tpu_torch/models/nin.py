"""Network-in-Network (port of ``chainermn_tpu/models/nin.py``): four
mlpconv stacks (a k x k convolution and two 1x1 convolutions, each with
bias and a ReLU), 3x3 / 2 ``"VALID"`` max pools between them, dropout
0.5 before the last stack, whose third convolution has ``num_classes``
channels, and a global mean pool as the head.

The stem is 11x11 / 4 ``"VALID"``, the other k x k convolutions pad
symmetrically.  An image too small for the pools (under 96 at the last
pool) raises ``ValueError`` as the JAX model does, where a zero-size
mean would otherwise be NaN.  ``models.convert.nin_params_from_flax``
carries a flax tree over.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ._layers import conv, dropout, dropout_off, init_flax_, max_pool


class MLPConv(nn.Module):
    """conv(k) -> relu -> 1x1 conv -> relu -> 1x1 conv -> relu (the JAX
    package's ``_MLPConv``)."""

    def __init__(self, in_ch: int, features: Sequence[int], kernel: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        f1, f2, f3 = features
        self.padding = padding
        self.convs = nn.ModuleList([nn.Conv2d(in_ch, f1, kernel, stride),
                                    nn.Conv2d(f1, f2, 1), nn.Conv2d(f2, f3, 1)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = torch.relu(conv(x, self.convs[0], dtype, self.padding))
        for layer in self.convs[1:]:
            x = torch.relu(conv(x, layer, dtype))
        return x


def _pool(x: torch.Tensor) -> torch.Tensor:
    if min(x.shape[2:]) < 3:
        raise ValueError(
            "NIN: input image too small — a VALID max_pool would collapse "
            f"the feature map of spatial shape {tuple(x.shape[2:])}; use "
            "an image size >= 96 (a zero-size mean would silently be NaN)")
    return max_pool(x, 3, 2)


class NIN(nn.Module):
    """``NIN(num_classes)`` on NHWC images; fp32 logits (the mean of the
    last stack's maps).  Dropout runs in training mode
    (``deterministic=True`` turns it off), its mask drawn from
    ``generator``."""

    def __init__(self, num_classes: int = 1000, *,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.mlpconvs = nn.ModuleList([
            MLPConv(3, (96, 96, 96), 11, stride=4),
            MLPConv(96, (256, 256, 256), 5, padding=2),
            MLPConv(256, (384, 384, 384), 3, padding=1),
            MLPConv(384, (1024, 1024, num_classes), 3, padding=1)])
        init_flax_(self, seed)

    def forward(self, x: torch.Tensor, *, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        det = dropout_off(self, deterministic)
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for stack in self.mlpconvs[:3]:
            x = _pool(stack(x, self.dtype))
        if not det:
            x = dropout(x, 0.5, generator)
        x = self.mlpconvs[3](x, self.dtype)
        return x.mean(dim=(2, 3)).float()
