"""Weight carrier: a flax ``TransformerLM`` parameter tree as the port's
``state_dict``.

The one place where the JAX package's layout meets the port's: flax
``Dense`` kernels are ``(in, out)`` and become ``nn.Linear`` weights
``(out, in)`` here; LayerNorm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _layer_norm(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def lm_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """Map ``{'params': {...}}`` of the JAX ``TransformerLM`` (arrays as
    numpy) onto :class:`~chainermn_tpu_torch.models.transformer.
    TransformerLM`'s ``state_dict`` keys."""
    p = params["params"] if "params" in params else params
    out: Dict[str, torch.Tensor] = {
        "embed.weight": _t(p["embed"]["embedding"]),
        "pos_embed": _t(p["pos_embed"]),
    }
    i = 0
    while f"TransformerBlock_{i}" in p:
        blk, pre = p[f"TransformerBlock_{i}"], f"blocks.{i}"
        _layer_norm(blk["LayerNorm_0"], f"{pre}.ln1", out)
        _layer_norm(blk["LayerNorm_1"], f"{pre}.ln2", out)
        _linear(blk["SelfAttention_0"]["Dense_0"], f"{pre}.attn.qkv", out)
        _linear(blk["SelfAttention_0"]["Dense_1"], f"{pre}.attn.proj", out)
        _linear(blk["MlpBlock_0"]["Dense_0"], f"{pre}.mlp.fc1", out)
        _linear(blk["MlpBlock_0"]["Dense_1"], f"{pre}.mlp.fc2", out)
        i += 1
    _layer_norm(p["LayerNorm_0"], "ln_f", out)
    return out
