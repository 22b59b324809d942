#!/usr/bin/env python
"""Data-parallel seq2seq training: the twin of the JAX package's
``examples/seq2seq/seq2seq.py`` (ChainerMN's WMT En-Fr encoder-decoder:
scatter_dataset -> multi-node Adam -> Trainer with the multi-node
evaluator reporting loss and perplexity -> greedy translation).

One process per card; ``--batchsize`` is the global batch, split over
the ranks.  The data is the toy translation corpus
(``utils.SyntheticTranslationDataset``): ``--vocab``/``--max-len``
scale it.

    python -m chainermn_tpu_torch.examples.train_seq2seq --epoch 3
    python -m chainermn_tpu_torch.examples.train_seq2seq --device cpu
    torchrun --nproc_per_node 4 -m chainermn_tpu_torch.examples.train_seq2seq
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.examples._world import finish_world, init_world
from chainermn_tpu_torch.extensions import Evaluator
from chainermn_tpu_torch.iterators import EpochIterator, SerialIterator
from chainermn_tpu_torch.models import (Seq2Seq, seq2seq_loss,
                                        seq2seq_metrics,
                                        seq2seq_params_from_flax,
                                        teacher_forcing, translate)
from chainermn_tpu_torch.training import Trainer, Updater
from chainermn_tpu_torch.training import extensions as T
from chainermn_tpu_torch.utils import SyntheticTranslationDataset

REPORT = ["epoch", "iteration", "loss", "val/loss", "val/perp",
          "val/accuracy"]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch example: seq2seq")
    p.add_argument("--communicator", default="tpu")
    p.add_argument("--batchsize", type=int, default=256,
                   help="global batch size (split over the ranks)")
    p.add_argument("--epoch", type=int, default=3)
    p.add_argument("--unit", type=int, default=128)
    p.add_argument("--layer", type=int, default=2)
    p.add_argument("--vocab", type=int, default=32)
    p.add_argument("--max-len", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--n-train", type=int, default=4096)
    p.add_argument("--n-test", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="cuda (this rank's card) or cpu (gloo)")
    return p


def loss_of(model):
    """The train step's ``loss_fn(batch)``: teacher forcing, then the
    masked token mean."""

    def loss_fn(batch):
        xs, ys = batch
        ys_in, ys_out = teacher_forcing(ys)
        return seq2seq_loss(model(xs, ys_in), ys_out)

    return loss_fn


def main(argv=None, *, params=None) -> list:
    """Train and return the log, one entry per epoch.  ``params``: the
    JAX ``Seq2Seq``'s initial ``{'params': ...}`` (numpy arrays), in
    place of the seeded initialisation."""
    args = parser().parse_args(argv)
    created = init_world(args.device)
    try:
        comm = cmn.create_communicator(args.communicator)
        chief = comm.rank == 0
        device = comm.device
        if chief:
            print(f"communicator: {args.communicator}  {comm!r}  "
                  f"device {device}")
        train = SyntheticTranslationDataset(
            args.n_train, vocab=args.vocab, max_len=args.max_len, seed=0)
        test = SyntheticTranslationDataset(
            args.n_test, vocab=args.vocab, max_len=args.max_len, seed=1)
        train = cmn.scatter_dataset(train, comm, shuffle=True, seed=0)
        test = cmn.scatter_dataset(test, comm, shuffle=False, seed=0)
        batch = max(args.batchsize // comm.size, 1)
        train_it = SerialIterator(train, batch, shuffle=True, seed=1)

        model = Seq2Seq(args.vocab, args.vocab, n_units=args.unit,
                        n_layers=args.layer)
        if params is not None:
            model.load_state_dict(seq2seq_params_from_flax(params))
        model.to(device)
        comm.bcast_data(model)
        opt = cmn.create_multi_node_optimizer(
            torch.optim.Adam(model.parameters(), lr=args.lr), comm)
        step = cmn.build_train_step(comm, loss_of(model), opt)
        trainer = Trainer(Updater(train_it, step, model=model),
                          stop_trigger=(args.epoch, "epoch"))

        def metric(b):
            xs, ys = b
            ys_in, ys_out = teacher_forcing(ys)
            return seq2seq_metrics(model(xs, ys_in), ys_out)

        evaluator = Evaluator(lambda: EpochIterator(test, batch), metric,
                              comm, model=model)
        trainer.extend(cmn.create_multi_node_evaluator(evaluator, comm))
        log = T.LogReport(comm=comm)
        trainer.extend(log, trigger=(1, "epoch"))
        trainer.extend(T.PrintReport(REPORT, log, comm=comm),
                       trigger=(1, "epoch"))
        trainer.run()

        # the reference's qualitative check: greedy-translate a few sources
        if chief:
            xs = torch.from_numpy(np.stack([test[i][0] for i in range(4)]))
            model.eval()
            ys = translate(model, xs.to(device), max_length=args.max_len + 1)
            for s, t in zip(xs.numpy(), ys):
                print("src:", s[s != 0].tolist(), "-> hyp:",
                      t[t != 0].tolist())
            if log.log:
                print("final:", {k: round(v, 4) for k, v in
                                 log.log[-1].items() if isinstance(v, float)})
        return log.log
    finally:
        finish_world(created)


if __name__ == "__main__":
    cmn.global_except_hook.add_hook()
    main()
