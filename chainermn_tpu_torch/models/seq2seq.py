"""Seq2seq (encoder-decoder LSTM), port of
``chainermn_tpu/models/seq2seq.py`` (:40-186): the model of ChainerMN's
``examples/seq2seq`` and its model-parallel split ``seq2seq_mp1``.

Sequences are padded to a fixed length with ``PAD``: the encoder zeroes
PAD embeddings and the loss masks PAD targets.  Everything is fp32; the
vocabulary projection ``W`` is fp32 as in the JAX ``Decoder``.  Greedy
translation decodes one token a step, carrying ``(h, c)``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..links.n_step_rnn import LSTMStack
from .transformer import _lecun_normal_

PAD = 0
EOS = 1
BOS = 2
N_SPECIAL = 3  # number of reserved token ids


def _embedding(n_vocab: int, n_units: int, g: torch.Generator) -> nn.Embedding:
    """flax ``nn.Embed``'s default init: normal with variance
    1 / n_vocab."""
    emb = nn.Embedding(n_vocab, n_units)
    with torch.no_grad():
        emb.weight.normal_(0.0, 1.0 / math.sqrt(n_vocab), generator=g)
    return emb


class Encoder(nn.Module):
    """Source embedding + LSTM stack.  ``forward(xs)`` on ``(batch,
    time)`` tokens returns ``((h, c), outputs)``."""

    def __init__(self, n_vocab: int, n_units: int, n_layers: int = 2, *,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.embed_x = _embedding(n_vocab, n_units, g)
        self.lstm = LSTMStack(n_units, n_units, n_layers, seed=seed + 1)

    def forward(self, xs: torch.Tensor):
        mask = (xs != PAD).unsqueeze(-1)
        ex = self.embed_x(xs) * mask.to(self.embed_x.weight.dtype)
        return self.lstm(ex)


class Decoder(nn.Module):
    """Target embedding + LSTM stack + vocabulary projection ``W``.
    ``forward(state, ys_in)`` teacher-forces the whole target sequence
    from the encoder's ``(h, c)`` (or zeros for None) and returns
    ``(new_state, logits)``."""

    def __init__(self, n_vocab: int, n_units: int, n_layers: int = 2, *,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.embed_y = _embedding(n_vocab, n_units, g)
        self.lstm = LSTMStack(n_units, n_units, n_layers, seed=seed + 1)
        self.W = nn.Linear(n_units, n_vocab)
        with torch.no_grad():
            _lecun_normal_(self.W.weight, g)
            self.W.bias.zero_()

    def forward(self, state, ys_in: torch.Tensor):
        new_state, hs = self.lstm(self.embed_y(ys_in), state)
        return new_state, self.W(hs)


class Seq2Seq(nn.Module):
    """Encoder-decoder with teacher forcing: ``forward(xs, ys_in)``
    returns logits of ``(batch, target_time, n_target_vocab)``."""

    def __init__(self, n_source_vocab: int, n_target_vocab: int,
                 n_units: int = 256, n_layers: int = 2, *, seed: int = 0):
        super().__init__()
        self.encoder = Encoder(n_source_vocab, n_units, n_layers, seed=seed)
        self.decoder = Decoder(n_target_vocab, n_units, n_layers,
                               seed=seed + 2)

    def forward(self, xs: torch.Tensor, ys_in: torch.Tensor) -> torch.Tensor:
        state, _ = self.encoder(xs)
        return self.decoder(state, ys_in)[1]

    def encode(self, xs: torch.Tensor):
        return self.encoder(xs)[0]

    def decode(self, state, ys_in: torch.Tensor):
        return self.decoder(state, ys_in)


def seq2seq_loss(logits: torch.Tensor, ys_out: torch.Tensor) -> torch.Tensor:
    """Masked token-mean cross entropy: PAD targets excluded, the sum
    over the batch's real tokens divided by their count."""
    mask = (ys_out != PAD).float()
    nll = F.cross_entropy(logits.flatten(0, -2).float(),
                          ys_out.flatten().long(), reduction="none")
    return (nll * mask.flatten()).sum() / mask.sum().clamp_min(1.0)


def seq2seq_metrics(logits: torch.Tensor, ys_out: torch.Tensor) -> dict:
    """``loss``, ``perp`` (its exp) and token ``accuracy`` over the
    non-PAD targets, as 0-dim tensors."""
    loss = seq2seq_loss(logits, ys_out)
    mask = ys_out != PAD
    correct = (logits.argmax(-1) == ys_out) & mask
    acc = correct.sum() / mask.sum().clamp_min(1)
    return {"loss": loss, "perp": torch.exp(loss), "accuracy": acc.float()}


def teacher_forcing(ys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ys_in, ys_out)`` = (BOS + the targets shifted right, the
    targets)."""
    bos = torch.full((ys.shape[0], 1), BOS, dtype=ys.dtype, device=ys.device)
    return torch.cat([bos, ys[:, :-1]], dim=1), ys


@torch.no_grad()
def translate(model: Seq2Seq, xs: torch.Tensor,
              max_length: int = 24) -> np.ndarray:
    """Greedy decode: encode once, then feed the argmax token back one
    step at a time for ``max_length`` steps, carrying ``(h, c)``.
    Returns int32 tokens ``(batch, max_length)`` with everything after
    the first EOS set to PAD."""
    state = model.encode(xs)
    tok = torch.full((xs.shape[0], 1), BOS, dtype=torch.long,
                     device=xs.device)
    steps = []
    for _ in range(max_length):
        state, logits = model.decode(state, tok)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        steps.append(tok)
    ys = torch.cat(steps, dim=1).cpu().numpy().astype(np.int32)
    done = np.cumsum(ys == EOS, axis=1) > 0
    after = np.concatenate([np.zeros_like(done[:, :1]), done[:, :-1]], axis=1)
    ys[after] = PAD
    return ys
