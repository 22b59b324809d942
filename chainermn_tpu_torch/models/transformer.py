"""Transformer language model (port of ``chainermn_tpu/models/transformer.py``).

The non-parallel ``TransformerLM``: pre-LN blocks, a weight-tied output
head, compute in ``dtype`` (bf16 by default) over fp32 parameters, fp32
LayerNorm and fp32 logits, and :func:`lm_loss` for training.  The
attention core is the dense ``multi_head_attention`` unless an
``attention_fn(q, k, v, causal, scale)`` hook is given (the JAX
package's ``attention_fn``; ``ops.flash_attention.flash_attention_fn``
reaches the flash kernels).  No sequence or tensor parallelism, dropout,
vocab-parallel head or flax-style decode mode: serving decodes through
``serving.decode.PagedLM``, which reuses these modules' parameters.

Numerics that follow flax rather than PyTorch's defaults:

* LayerNorm epsilon is 1e-6 (``flax.linen.LayerNorm``), not 1e-5;
* ``gelu`` is the tanh approximation (``flax.linen.gelu``);
* a dense layer casts its input, weight and bias to the compute dtype
  before the product (``flax.linen.Dense(dtype=...)``), see :func:`dense`;
* the qkv projection is one ``3 * d_model`` layer split q|k|v.

Weights are in ``nn.Linear`` layout ``(out, in)``;
``models.convert.lm_params_from_flax`` carries a flax tree over.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention

LN_EPS = 1e-6  # flax.linen.LayerNorm's default

# attention_fn(q, k, v, causal, scale) -> out, all (batch, seq, heads, d)
AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, bool,
                        float], torch.Tensor]


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``flax.linen.Dense(dtype=dtype)``: input, weight and bias cast to
    the compute dtype, then the product."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's default Dense kernel init: truncated normal (2 sigma) with
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


class MlpBlock(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(dense(x, self.fc1, self.dtype), approximate="tanh")
        return dense(h, self.fc2, self.dtype)


class SelfAttention(nn.Module):
    """Causal self-attention: one fused qkv projection, the attention
    core (``attention_fn`` or the dense one), an output projection; no
    biases."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype,
                 attention_fn: Optional[AttentionFn] = None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model ({d_model}) % n_heads ({n_heads})")
        self.n_heads = n_heads
        self.dtype = dtype
        self.attention_fn = attention_fn
        self.qkv = nn.Linear(d_model, 3 * d_model, bias=False)
        self.proj = nn.Linear(d_model, d_model, bias=False)

    def project_qkv(self, x: torch.Tensor):
        """(b, s, d) -> q, k, v, each (b, s, heads, d_head)."""
        b, s, d = x.shape
        q, k, v = dense(x, self.qkv, self.dtype).split(d, dim=-1)
        shape = (b, s, self.n_heads, d // self.n_heads)
        return q.reshape(shape), k.reshape(shape), v.reshape(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        q, k, v = self.project_qkv(x)
        if self.attention_fn is not None:
            out = self.attention_fn(q, k, v, True, (d // self.n_heads) ** -0.5)
        else:
            out = multi_head_attention(q, k, v, causal=True)
        return dense(out.reshape(b, s, d), self.proj, self.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN residual block: fp32 LayerNorm, attention and MLP in the
    compute dtype."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dtype: torch.dtype,
                 attention_fn: Optional[AttentionFn] = None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = SelfAttention(d_model, n_heads, dtype, attention_fn)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp = MlpBlock(d_model, d_ff, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x.float()).to(self.dtype))
        return x + self.mlp(self.ln2(x.float()).to(self.dtype))


class TransformerLM(nn.Module):
    """Causal LM: tokens (batch, seq) -> fp32 logits (batch, seq, vocab).

    Parameters are fp32 and initialised from ``seed`` as flax
    initialises the JAX model (normal(0.02) embeddings, LeCun-normal
    dense kernels, zero biases); the two frameworks draw different
    numbers, so parity tests carry weights across with
    ``models.convert.lm_params_from_flax``.
    """

    def __init__(self, vocab_size: int, d_model: int = 256,
                 n_heads: int = 8, n_layers: int = 4,
                 d_ff: Optional[int] = None, max_len: int = 2048,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 attention_fn: Optional[AttentionFn] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.d_ff = d_ff or 4 * d_model
        self.max_len = max_len
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, n_heads, self.d_ff, dtype, attention_fn)
            for _ in range(n_layers)
        )
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        g = torch.Generator().manual_seed(int(seed))
        nn.init.normal_(self.embed.weight, std=0.02, generator=g)
        nn.init.normal_(self.pos_embed, std=0.02, generator=g)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, g)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final fp32 LayerNorm and the weight-tied fp32 head."""
        return self.ln_f(x.float()) @ self.embed.weight.T

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        s = tokens.shape[1]
        if s > self.max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_len={self.max_len}"
            )
        x = (self.embed(tokens) + self.pos_embed[:s]).to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.head(x)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy over a (batch, seq) token block, in fp32,
    the mean over (batch, seq - 1) (port of ``models.transformer.
    lm_loss``: optax's integer-label softmax cross entropy)."""
    vocab = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, vocab).float(),
                           tokens[:, 1:].reshape(-1))
