"""Layers that the image models share, with flax's numerics.

* :func:`conv` and :func:`dense` are ``flax.linen.Conv`` and ``Dense``
  with ``dtype``: input, kernel and bias cast to the compute dtype
  before the product.
* :func:`same_pads` is flax's ``padding="SAME"``: the total padding
  ``max((ceil(n / s) - 1) * s + k - n, 0)`` of a window ``k`` at stride
  ``s`` splits as ``total // 2`` before and the rest after, so a
  stride-2 window over an even size pads one more after than before
  (torch's symmetric ``padding=`` cannot say that).
* :func:`max_pool` pads with ``-inf``, as ``flax.linen.max_pool`` does.
* :func:`dropout` is ``flax.linen.Dropout``: ``where(bernoulli(keep),
  x / keep, 0)``, its mask drawn from ``generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype,
         padding=0) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride,
                    padding)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax's ``"SAME"`` padding of one spatial axis of size ``n``:
    ``(before, after)``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """``x`` (NCHW) padded as flax's ``"SAME"`` pads a ``k`` x ``k``
    window at stride ``s``."""
    top, bottom = same_pads(x.shape[2], k, s)
    left, right = same_pads(x.shape[3], k, s)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def max_pool(x: torch.Tensor, k: int, s: int, same: bool = False) -> torch.Tensor:
    """``flax.linen.max_pool(x, (k, k), strides=(s, s))``, ``"VALID"``
    or, with ``same``, ``"SAME"`` (padded with -inf)."""
    if same:
        x = pad_same(x, k, s, float("-inf"))
    return F.max_pool2d(x, k, s)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    # divide by a 0-dim tensor filled on the device: a CUDA divide by a
    # Python number multiplies by its reciprocal (one more rounding),
    # and torch.tensor() would copy from the host every call
    keep_t = torch.full((), keep, dtype=torch.float32, device=x.device)
    return torch.where(mask, x / keep_t,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> ``(N, H * W * C)`` in flax's (h, w, c) order, so the first
    dense layer's rows are the flax kernel's."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (2 sigma) with
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


def init_flax_(model: nn.Module, seed: int) -> None:
    """Every convolution and dense kernel of ``model`` LeCun-normal from
    ``seed``, every bias zero (flax's defaults)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, g)
                if m.bias is not None:
                    m.bias.zero_()


def dropout_off(module: nn.Module, deterministic: Optional[bool]) -> bool:
    """The JAX models' ``deterministic``: dropout is off in evaluation
    mode unless the caller says otherwise."""
    return not module.training if deterministic is None else deterministic
