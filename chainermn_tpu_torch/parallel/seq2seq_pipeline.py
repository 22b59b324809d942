"""The seq2seq encoder|decoder split driven through the pipeline tier.

The port's counterpart of ``benchmarks/pipeline_seq2seq.py::
build_pipeline_seq2seq``: a heterogeneous encoder|decoder pair on the
homogeneous GPipe machinery of :mod:`.pipeline`.

* Every stage holds the union parameter tree (``enc.*`` and ``dec.*``
  keys, stacked over stages); each rank uses its half, so the other
  half gets no gradient and its optimizer leaves it as it is.
* The carried activation is a packed ``(micro_batch, D)`` fp32 row,
  ``D = 2 * n_layers * units + seqlen``: into the first stage ``[source
  tokens | target tokens | 0...]`` (ints exact in fp32 below 2^24); the
  encoder's out ``[flattened (h, c) | target tokens]``; the decoder's
  out per sample ``[masked -log p summed, token count, 0...]``.
* :func:`pipeline_loss` sums those over the microbatches and divides,
  the global token mean of ``models.seq2seq.seq2seq_loss`` over the
  whole batch.

Two ranks run encoder then decoder; one rank runs both in its one
stage (all a single card can show of the schedule).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.func import functional_call

from ..models.seq2seq import (PAD, Decoder, Encoder, seq2seq_loss,
                              teacher_forcing)


def carry_width(units: int, n_layers: int, seqlen: int) -> int:
    """``D``: the packed row's width (it must hold both token rows)."""
    width = 2 * n_layers * units + seqlen
    if 2 * seqlen > width:
        raise ValueError(
            f"carry too narrow: packing src+targets needs 2*seqlen "
            f"({2 * seqlen}) <= 2*n_layers*units + seqlen ({width})")
    return width


def pack_batch(src: torch.Tensor, ys: torch.Tensor, n_micro: int,
               width: int) -> torch.Tensor:
    """``(B, seqlen)`` source and target tokens -> the ``(n_micro, B /
    n_micro, width)`` fp32 microbatch stream."""
    b, s = src.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    h = src.new_zeros((b, width), dtype=torch.float32)
    h[:, :s] = src
    h[:, s:2 * s] = ys
    return h.reshape(n_micro, b // n_micro, width)


def _half(params: Dict[str, torch.Tensor], prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


class Seq2SeqStages:
    """The stage function of the encoder|decoder pipeline on ``comm``
    (one or two ranks), over templates of the two modules on
    ``device`` whose parameters each call takes from the stage's slice
    (``torch.func.functional_call``)."""

    def __init__(self, comm, vocab: int, units: int, n_layers: int,
                 seqlen: int, device=None):
        if comm.size not in (1, 2):
            raise ValueError(f"enc|dec pipeline needs 1 or 2 stages, got "
                             f"{comm.size}")
        device = torch.device(device) if device is not None else comm.device
        self.comm = comm
        self.enc = Encoder(vocab, units, n_layers).to(device)
        self.dec = Decoder(vocab, units, n_layers).to(device)
        self.n_layers, self.units, self.seqlen = n_layers, units, seqlen

    def encode(self, sp, h: torch.Tensor) -> torch.Tensor:
        b, s = h.shape[0], self.seqlen
        (eh, ec), _ = functional_call(self.enc, _half(sp, "enc."),
                                      (h[:, :s].long(),))
        return torch.cat([eh.transpose(0, 1).reshape(b, -1),
                          ec.transpose(0, 1).reshape(b, -1),
                          h[:, s:2 * s]], dim=1)

    def decode(self, sp, h: torch.Tensor) -> torch.Tensor:
        b, half = h.shape[0], self.n_layers * self.units
        shape = (b, self.n_layers, self.units)
        state = (h[:, :half].reshape(shape).transpose(0, 1).contiguous(),
                 h[:, half:2 * half].reshape(shape).transpose(0, 1)
                 .contiguous())
        ys_in, ys_out = teacher_forcing(h[:, 2 * half:].long())
        _, logits = functional_call(self.dec, _half(sp, "dec."),
                                    (state, ys_in))
        mask = (ys_out != PAD).float()
        nll = torch.nn.functional.cross_entropy(
            logits.flatten(0, 1), ys_out.flatten(), reduction="none")
        out = torch.zeros_like(h)
        out[:, 0] = (nll.reshape(mask.shape) * mask).sum(-1)
        out[:, 1] = mask.sum(-1)
        return out

    def __call__(self, sp, h: torch.Tensor) -> torch.Tensor:
        if self.comm.size == 1:
            return self.decode(sp, self.encode(sp, h))
        if self.comm.rank == 0:
            return self.encode(sp, h)
        return self.decode(sp, h)

    def unpipelined_loss(self, params, src: torch.Tensor,
                         ys: torch.Tensor) -> torch.Tensor:
        """The same loss over the whole batch in one pass, on the union
        parameters (the pipeline's equality oracle)."""
        state, _ = functional_call(self.enc, _half(params, "enc."),
                                   (src.long(),))
        ys_in, ys_out = teacher_forcing(ys.long())
        _, logits = functional_call(self.dec, _half(params, "dec."),
                                    (state, ys_in))
        return seq2seq_loss(logits, ys_out)


def pipeline_loss(outputs: torch.Tensor, _targets=None) -> torch.Tensor:
    """The decoder stage's ``(n_micro, mb, D)`` rows -> the global token
    mean of the masked cross entropy."""
    return outputs[..., 0].sum() / outputs[..., 1].sum().clamp_min(1.0)


def union_params(encoder: Encoder, decoder: Decoder, n_stage: int) -> dict:
    """The union tree of an encoder and a decoder, stacked over
    ``n_stage`` identical stages (numpy, the layout
    :func:`~.pipeline.place_stage_params` slices)."""
    out = {}
    for prefix, module in (("enc.", encoder), ("dec.", decoder)):
        for k, v in module.state_dict().items():
            a = v.detach().cpu().numpy()
            out[prefix + k] = np.stack([a] * n_stage)
    return out
