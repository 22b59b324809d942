"""AlexNet (port of ``chainermn_tpu/models/alexnet.py``): five
convolutions with bias (no LRN, as the JAX model drops it), three 3x3 /
2 max pools, three dense layers with dropout 0.5 after the first two.

The stem is ``nn.Conv(96, (11, 11), strides=(4, 4))`` with flax's
default ``padding="SAME"``: at 224 (and at 96) that pads 3 rows before
and 4 after, which torch's symmetric ``padding=`` cannot express, so the
input is padded explicitly (``_layers.pad_same``).  The pools are
``"VALID"``.  The 6 x 6 x 256 map (at 224) is flattened in flax's
(h, w, c) order.  ``models.convert.alexnet_params_from_flax`` carries a
flax tree over.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ._layers import (conv, dense, dropout, dropout_off, flatten_nhwc,
                      init_flax_, max_pool, pad_same)

STEM_K, STEM_S = 11, 4


def _pooled(n: int) -> int:
    return (n - 3) // 2 + 1


class AlexNet(nn.Module):
    """``AlexNet(num_classes)`` on NHWC images of ``image_size``; fp32
    logits.  Dropout runs in training mode (``deterministic=True`` turns
    it off), its masks drawn from ``generator``."""

    def __init__(self, num_classes: int = 1000, *,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 image_size: int = 224):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList([
            nn.Conv2d(3, 96, STEM_K, stride=STEM_S), nn.Conv2d(96, 256, 5),
            nn.Conv2d(256, 384, 3), nn.Conv2d(384, 384, 3),
            nn.Conv2d(384, 256, 3)])
        side = _pooled(_pooled(_pooled(-(-image_size // STEM_S))))
        self.fcs = nn.ModuleList([nn.Linear(side * side * 256, 4096),
                                  nn.Linear(4096, 4096),
                                  nn.Linear(4096, num_classes)])
        init_flax_(self, seed)

    def forward(self, x: torch.Tensor, *, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        det = dropout_off(self, deterministic)
        c = self.convs
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = torch.relu(conv(pad_same(x, STEM_K, STEM_S), c[0], self.dtype))
        x = max_pool(x, 3, 2)
        x = max_pool(torch.relu(conv(x, c[1], self.dtype, padding=2)), 3, 2)
        for layer in c[2:]:
            x = torch.relu(conv(x, layer, self.dtype, padding=1))
        x = flatten_nhwc(max_pool(x, 3, 2))
        for fc in self.fcs[:2]:
            x = torch.relu(dense(x, fc, self.dtype))
            if not det:
                x = dropout(x, 0.5, generator)
        return dense(x, self.fcs[2], torch.float32)
