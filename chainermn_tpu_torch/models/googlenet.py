"""GoogLeNet (Inception-v1) and its BatchNorm variant (port of
``chainermn_tpu/models/googlenet.py``), without the auxiliary heads, as
in the JAX model.

Each unit is a convolution (with bias when there is no norm), then the
norm of the ``norm`` factory when one is given (``GoogLeNetBN``), then
a ReLU.  The stem: 7x7 / 2 (padding 3), a 3x3 / 2 max pool, 1x1, 3x3
(padding 1), a 3x3 / 2 max pool; then nine inception blocks in three
stages with a 3x3 / 2 max pool before the second and third; a mean
pool, dropout 0.4 and an fp32 dense head.

Every max pool is flax's ``padding="SAME"``, padded with -inf: at stride
2 over an even size that is 0 rows before and 1 after (112 -> 56 -> 28
-> 14 -> 7), which torch's symmetric ``padding=`` cannot express
(``_layers.max_pool(same=True)``); at stride 1 it is 1 and 1.  The 1x1,
3x3 and 5x5 stride-1 convolutions of the blocks are symmetric.

``norm`` is the factory hook of the JAX model (``norm(size, *,
dtype)``), as in ``models.resnet``, so ``create_mnbn_model`` and
``mnbn_factory`` work on ``GoogLeNetBN`` unchanged.
``models.convert.googlenet_params_from_flax`` carries a flax tree
(``params``, and ``batch_stats`` for the BatchNorm variant) over.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ._layers import conv, dense, dropout, dropout_off, init_flax_, max_pool
from .resnet import NormFactory, default_norm

# (out1, proj3, out3, proj5, out5, proj_pool) per inception block, by
# stage (a max pool between stages): the v1 paper's table
STAGES = (
    ((64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64)),
    ((192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
     (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
     (256, 160, 320, 32, 128, 128)),
    ((256, 160, 320, 32, 128, 128), (384, 192, 384, 48, 128, 128)),
)


class _Units(nn.Module):
    """Convolution -> optional norm -> ReLU units, numbered as flax numbers
    a module's ``Conv_k`` and its norms."""

    def __init__(self, specs, norm: Optional[NormFactory], dtype):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList(
            [nn.Conv2d(i, o, k, stride=s, bias=norm is None)
             for i, o, k, s in specs])
        self.norms = nn.ModuleList(
            [] if norm is None else [norm(o, dtype=dtype)
                                     for _, o, _, _ in specs])

    def unit(self, j: int, x: torch.Tensor, padding: int = 0) -> torch.Tensor:
        y = conv(x, self.convs[j], self.dtype, padding)
        if len(self.norms):
            y = self.norms[j](y)
        return torch.relu(y)


class Inception(_Units):
    """Four branches, concatenated on the channels: 1x1; 1x1 -> 3x3;
    1x1 -> 5x5; a 3x3 / 1 max pool -> 1x1."""

    def __init__(self, in_ch: int, cfg: Sequence[int],
                 norm: Optional[NormFactory], dtype):
        out1, proj3, out3, proj5, out5, proj_pool = cfg
        super().__init__([(in_ch, out1, 1, 1), (in_ch, proj3, 1, 1),
                          (proj3, out3, 3, 1), (in_ch, proj5, 1, 1),
                          (proj5, out5, 5, 1), (in_ch, proj_pool, 1, 1)],
                         norm, dtype)
        self.out_channels = out1 + out3 + out5 + proj_pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.unit(0, x)
        b3 = self.unit(2, self.unit(1, x), padding=1)
        b5 = self.unit(4, self.unit(3, x), padding=2)
        bp = self.unit(5, max_pool(x, 3, 1, same=True))
        return torch.cat([b1, b3, b5, bp], dim=1)


class GoogLeNet(_Units):
    """``GoogLeNet(num_classes, norm=None)`` on NHWC images; fp32 logits.
    ``train()``/``eval()`` select batch or running statistics of the
    norms (the JAX model's ``train``); dropout runs in training mode
    (``deterministic=True`` turns it off), its mask drawn from
    ``generator``."""

    def __init__(self, num_classes: int = 1000, *,
                 norm: Optional[NormFactory] = None,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0):
        super().__init__([(3, 64, 7, 2), (64, 64, 1, 1), (64, 192, 3, 1)],
                         norm, dtype)
        blocks, in_ch = [], 192
        for stage in STAGES:
            for cfg in stage:
                blocks.append(Inception(in_ch, cfg, norm, dtype))
                in_ch = blocks[-1].out_channels
        self.inceptions = nn.ModuleList(blocks)
        self.head = nn.Linear(in_ch, num_classes)
        init_flax_(self, seed)

    def forward(self, x: torch.Tensor, *, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        det = dropout_off(self, deterministic)
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = max_pool(self.unit(0, x, padding=3), 3, 2, same=True)
        x = self.unit(2, self.unit(1, x), padding=1)
        x = max_pool(x, 3, 2, same=True)
        blocks = iter(self.inceptions)
        for si, stage in enumerate(STAGES):
            if si:
                x = max_pool(x, 3, 2, same=True)
            for _ in stage:
                x = next(blocks)(x)
        x = x.mean(dim=(2, 3))
        if not det:
            x = dropout(x, 0.4, generator)
        return dense(x, self.head, torch.float32)


def GoogLeNetBN(norm: NormFactory = default_norm, **kw) -> GoogLeNet:
    """GoogLeNet with a BatchNorm after every convolution (pass
    ``mnbn_factory(comm)``, or use ``create_mnbn_model``, for
    synchronized BatchNorm)."""
    return GoogLeNet(norm=norm, **kw)
