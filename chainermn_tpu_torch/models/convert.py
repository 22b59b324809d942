"""Weight carrier: a flax ``TransformerLM`` parameter tree as the port's
``state_dict``, and the flax leaf order.

The one place where the JAX package's layout meets the port's: flax
``Dense`` kernels are ``(in, out)`` and become ``nn.Linear`` weights
``(out, in)`` here; LayerNorm ``scale`` becomes ``weight``.  The same
table gives the order in which flax flattens the tree (sorted keys at
every level), which the gradient wire plans its buckets in
(``comm_wire.planner``): ``named_parameters()`` orders them otherwise.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn


class Leaf(NamedTuple):
    """One parameter as both frameworks name it."""

    path: Tuple[str, ...]  # flax path under 'params'
    key: str  # the port's state_dict key
    transposed: bool  # Dense kernel (in, out) <-> Linear weight (out, in)


def lm_leaves(n_layers: int) -> List[Leaf]:
    """Every parameter of an ``n_layers`` TransformerLM, in flax's
    flatten order (jax sorts dict keys, so ``TransformerBlock_10`` comes
    before ``TransformerBlock_2``)."""
    leaves = [Leaf(("embed", "embedding"), "embed.weight", False),
              Leaf(("pos_embed",), "pos_embed", False),
              Leaf(("LayerNorm_0", "scale"), "ln_f.weight", False),
              Leaf(("LayerNorm_0", "bias"), "ln_f.bias", False)]
    for i in range(n_layers):
        blk, pre = f"TransformerBlock_{i}", f"blocks.{i}"
        for ln, mod in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
            leaves += [Leaf((blk, ln, "scale"), f"{pre}.{mod}.weight", False),
                       Leaf((blk, ln, "bias"), f"{pre}.{mod}.bias", False)]
        for sub, dense, mod, bias in (
                ("SelfAttention_0", "Dense_0", "attn.qkv", False),
                ("SelfAttention_0", "Dense_1", "attn.proj", False),
                ("MlpBlock_0", "Dense_0", "mlp.fc1", True),
                ("MlpBlock_0", "Dense_1", "mlp.fc2", True)):
            leaves.append(Leaf((blk, sub, dense, "kernel"),
                               f"{pre}.{mod}.weight", True))
            if bias:
                leaves.append(Leaf((blk, sub, dense, "bias"),
                                   f"{pre}.{mod}.bias", False))
    return sorted(leaves, key=lambda leaf: leaf.path)


def flax_ordered_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """``(state_dict key, parameter)`` of a TransformerLM in flax's
    flatten order."""
    params = dict(model.named_parameters())
    return [(leaf.key, params[leaf.key]) for leaf in lm_leaves(model.n_layers)]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def lm_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """Map ``{'params': {...}}`` of the JAX ``TransformerLM`` (arrays as
    numpy) onto :class:`~chainermn_tpu_torch.models.transformer.
    TransformerLM`'s ``state_dict`` keys."""
    p = params["params"] if "params" in params else params
    n_layers = 0
    while f"TransformerBlock_{n_layers}" in p:
        n_layers += 1
    out: Dict[str, torch.Tensor] = {}
    for leaf in lm_leaves(n_layers):
        a = p
        for k in leaf.path:
            a = a[k]
        out[leaf.key] = _t(np.asarray(a).T if leaf.transposed else a)
    return out
