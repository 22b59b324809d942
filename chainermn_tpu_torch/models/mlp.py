"""MNIST MLP (port of ``chainermn_tpu/models/mlp.py``).

Three dense layers with ReLU, compute in ``dtype`` (bf16 by default)
over fp32 parameters, fp32 logits: each layer casts its input, weight
and bias to the compute dtype before the product, as
``flax.linen.Dense(dtype=...)`` does.  Weights are in ``nn.Linear``
layout ``(out, in)``; ``models.convert.mlp_params_from_flax`` carries a
flax tree over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import _lecun_normal_, dense


class MLP(nn.Module):
    """``MLP(n_units, n_out)`` on inputs of ``n_in`` features (any
    trailing shape, flattened: 28 x 28 for MNIST)."""

    def __init__(self, n_units: int = 1000, n_out: int = 10, *,
                 n_in: int = 28 * 28, dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.l1 = nn.Linear(n_in, n_units)
        self.l2 = nn.Linear(n_units, n_units)
        self.l3 = nn.Linear(n_units, n_out)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in (self.l1, self.l2, self.l3):
                _lecun_normal_(layer.weight, g)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = F.relu(dense(x, self.l1, self.dtype))
        x = F.relu(dense(x, self.l2, self.dtype))
        return dense(x, self.l3, self.dtype).float()
