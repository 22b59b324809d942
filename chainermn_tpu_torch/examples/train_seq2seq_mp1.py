#!/usr/bin/env python
"""Model-parallel seq2seq: the twin of the JAX package's
``examples/seq2seq/seq2seq_mp1.py`` (ChainerMN's ``seq2seq_mp1``): the
encoder on rank 0 and the decoder on rank ``min(1, size - 1)``, joined
by ``MultiNodeChainList``; the ``(h, c)`` state streams between the
ranks and the decoder also takes the target tokens from the batch
(``rank_in=[0, None]``).  Every rank sees the same batches through
``create_multi_node_iterator``; each rank's Adam updates its own stage.

    python -m chainermn_tpu_torch.examples.train_seq2seq_mp1 --epoch 3
    python -m chainermn_tpu_torch.examples.train_seq2seq_mp1 --device cpu
    torchrun --nproc_per_node 2 \
        -m chainermn_tpu_torch.examples.train_seq2seq_mp1
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.examples._world import finish_world, init_world
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.link import MultiNodeChainList
from chainermn_tpu_torch.models import (Decoder, Encoder, seq2seq_loss,
                                        seq2seq_metrics,
                                        seq2seq_params_from_flax,
                                        teacher_forcing)
from chainermn_tpu_torch.utils import SyntheticTranslationDataset


class EncoderStage(nn.Module):
    """The encoder's rank: source embedding + LSTM, emitting the
    ``(h, c)`` state that streams to the decoder's rank."""

    def __init__(self, n_vocab: int, n_units: int, n_layers: int = 2):
        super().__init__()
        self.encoder = Encoder(n_vocab, n_units, n_layers)

    def forward(self, batch):
        return self.encoder(batch[0])[0]


class DecoderStage(nn.Module):
    """The decoder's rank: the streamed state plus the target tokens of
    the batch (``rank_in=[0, None]``) -> logits."""

    def __init__(self, n_vocab: int, n_units: int, n_layers: int = 2):
        super().__init__()
        self.decoder = Decoder(n_vocab, n_units, n_layers)

    def forward(self, state, batch):
        return self.decoder(state, batch[1])[1]


def make_chain(comm, vocab: int, unit: int, layer: int, device=None,
               params=None) -> MultiNodeChainList:
    """The encoder|decoder chain of ``seq2seq_mp1``.  ``params``: the
    two JAX stages' parameter trees (numpy), in place of the seeded
    initialisation."""
    chain = MultiNodeChainList(comm, device=device)
    dec_rank = min(1, comm.size - 1)
    stages = [EncoderStage(vocab, unit, layer),
              DecoderStage(vocab, unit, layer)]
    for stage, p in zip(stages, params or [None, None]):
        if p is not None:
            stage.load_state_dict(seq2seq_params_from_flax(p))
    chain.add_link(stages[0], rank_in=None, rank_out=dec_rank, rank=0)
    chain.add_link(stages[1], rank_in=[0, None], rank_out=None, rank=dec_rank)
    return chain


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch example: model-parallel seq2seq")
    p.add_argument("--batchsize", type=int, default=128)
    p.add_argument("--epoch", type=int, default=3)
    p.add_argument("--unit", type=int, default=128)
    p.add_argument("--layer", type=int, default=2)
    p.add_argument("--vocab", type=int, default=32)
    p.add_argument("--max-len", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--n-train", type=int, default=2048)
    p.add_argument("--n-test", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="cuda (this rank's card) or cpu (gloo)")
    return p


def main(argv=None) -> dict:
    """Train; returns the last epoch's validation metrics, equal on
    every rank."""
    args = parser().parse_args(argv)
    created = init_world(args.device)
    try:
        comm = cmn.create_communicator("pure_nccl")
        device = comm.device
        chief = comm.rank == 0
        if chief:
            print(f"model-parallel over {comm.size} rank(s), device {device}")
        train = SyntheticTranslationDataset(
            args.n_train, vocab=args.vocab, max_len=args.max_len, seed=0)
        test = SyntheticTranslationDataset(
            args.n_test, vocab=args.vocab, max_len=args.max_len, seed=1)
        chain = make_chain(comm, args.vocab, args.unit, args.layer, device)
        opt = chain.optimizer(torch.optim.Adam, lr=args.lr)
        step = chain.value_and_grad(seq2seq_loss)
        last = chain.stage_rank(chain.n_stages - 1)

        # every rank draws the master's batches: the dataset is NOT
        # scattered in model parallelism
        it = cmn.create_multi_node_iterator(
            SerialIterator(train, args.batchsize, shuffle=True, seed=1), comm)

        def batch_of(xs, ys):
            xs = torch.as_tensor(xs, device=device)
            ys_in, ys_out = teacher_forcing(torch.as_tensor(ys, device=device))
            return [xs, ys_in], ys_out

        n_iter = max(args.n_train // args.batchsize, 1)
        m = {}
        for epoch in range(args.epoch):
            losses = []
            for _ in range(n_iter):
                x, ys_out = batch_of(*next(it))
                opt.zero_grad()
                losses.append(float(step(x, ys_out)))
                opt.step()
            x, ys_out = batch_of(*(np.stack([test[i][k] for i in
                                             range(len(test))])
                                   for k in (0, 1)))
            with torch.no_grad():
                logits = chain(x)
            m = ({k: float(v) for k, v in
                  seq2seq_metrics(logits, ys_out).items()}
                 if comm.rank == last else None)
            m = comm.bcast_obj(m, root=last)
            if chief:
                print(f"epoch {epoch + 1}  train/loss {np.mean(losses):.4f}"
                      f"  val/loss {m['loss']:.4f}  val/perp "
                      f"{m['perp']:.3f}  val/acc {m['accuracy']:.3f}")
        return m
    finally:
        finish_world(created)


if __name__ == "__main__":
    cmn.global_except_hook.add_hook()
    main()
