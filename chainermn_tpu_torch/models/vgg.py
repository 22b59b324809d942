"""VGG-16 (port of ``chainermn_tpu/models/vgg.py``): thirteen 3x3
convolutions with bias in five stages, each stage closed by a 2x2 / 2
max pool, then three dense layers with dropout 0.5 after the first two.

NHWC images in, permuted once to NCHW (``channels_last``); convolutions
and the first two dense layers in the compute dtype over fp32
parameters, the last dense layer and the logits fp32.  The 7 x 7 x 512
map is flattened in flax's (h, w, c) order, so ``Dense_0``'s kernel
rows carry over as they are.  ``models.convert.vgg16_params_from_flax``
carries a flax tree over.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ._layers import (conv, dense, dropout, dropout_off, flatten_nhwc,
                      init_flax_, max_pool)

CFG = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
       (512, 512, 512))


class VGG16(nn.Module):
    """``VGG16(num_classes)`` on NHWC images; fp32 logits.  Dropout runs
    in training mode (``deterministic=True`` turns it off), its masks
    drawn from ``generator``."""

    def __init__(self, num_classes: int = 1000, *,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 image_size: int = 224):
        super().__init__()
        self.dtype = dtype
        convs, in_ch = [], 3
        for stage in CFG:
            for features in stage:
                convs.append(nn.Conv2d(in_ch, features, 3))
                in_ch = features
        self.convs = nn.ModuleList(convs)
        side = image_size // 2 ** len(CFG)
        self.fcs = nn.ModuleList([nn.Linear(side * side * in_ch, 4096),
                                  nn.Linear(4096, 4096),
                                  nn.Linear(4096, num_classes)])
        init_flax_(self, seed)

    def forward(self, x: torch.Tensor, *, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        det = dropout_off(self, deterministic)
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        layers = iter(self.convs)
        for stage in CFG:
            for _ in stage:
                x = torch.relu(conv(x, next(layers), self.dtype, padding=1))
            x = max_pool(x, 2, 2)
        x = flatten_nhwc(x)
        for fc in self.fcs[:2]:
            x = torch.relu(dense(x, fc, self.dtype))
            if not det:
                x = dropout(x, 0.5, generator)
        return dense(x, self.fcs[2], torch.float32)
