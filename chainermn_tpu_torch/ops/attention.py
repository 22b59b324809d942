"""Attention core: the plain dense attention the full-sequence
``TransformerLM`` forward uses (port of ``chainermn_tpu/ops/attention.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """(b, s, h, d) x 3 -> (b, s, h, d).  QK in the inputs' dtype, then
    an fp32 softmax, then PV in the inputs' dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        s_q, s_k = s.shape[-2], s.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
