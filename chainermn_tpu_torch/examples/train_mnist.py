#!/usr/bin/env python
"""Data-parallel MNIST training: the twin of the JAX package's
``examples/mnist/train_mnist.py`` (ChainerMN's canonical script:
create_communicator -> scatter_dataset -> multi-node optimizer ->
Trainer with rank-0 reporting).

One process per card; ``--batchsize`` is the global batch, split over
the ranks.  Without an ``mnist.npz`` (``CHAINERMN_TORCH_MNIST``) it
trains on the synthetic stand-in.  ``--checkpoint NAME`` snapshots every
epoch and resumes from the newest step every rank holds.

    python -m chainermn_tpu_torch.examples.train_mnist --epoch 2
    python -m chainermn_tpu_torch.examples.train_mnist --device cpu
    torchrun --nproc_per_node 4 -m chainermn_tpu_torch.examples.train_mnist
"""

from __future__ import annotations

import argparse

import torch

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.examples._world import finish_world, init_world
from chainermn_tpu_torch.extensions import Evaluator
from chainermn_tpu_torch.iterators import EpochIterator, SerialIterator
from chainermn_tpu_torch.models import (MLP, flax_ordered_parameters,
                                        mlp_params_from_flax)
from chainermn_tpu_torch.ops.losses import accuracy, softmax_cross_entropy
from chainermn_tpu_torch.training import Trainer, Updater
from chainermn_tpu_torch.training import extensions as T
from chainermn_tpu_torch.utils import get_mnist

REPORT = ["epoch", "iteration", "loss", "val/loss", "val/accuracy",
          "samples_per_sec"]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch example: MNIST")
    p.add_argument("--communicator", default="pure_nccl")
    p.add_argument("--batchsize", type=int, default=512,
                   help="global batch size (split over the ranks)")
    p.add_argument("--epoch", type=int, default=2)
    p.add_argument("--unit", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--n-train", type=int, default=8192)
    p.add_argument("--n-test", type=int, default=2048)
    p.add_argument("--allreduce-grad-dtype", default=None,
                   choices=["float16", "bfloat16", "float32"],
                   help="reduced-precision gradient wire")
    p.add_argument("--device", default="cuda",
                   help="cuda (this rank's card) or cpu (gloo)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint every epoch and resume under this name")
    return p


def main(argv=None, *, params=None) -> list:
    """Train and return the log, one entry per epoch (its last entry is
    what the JAX example returns).  ``params``: initial
    ``{'params': ...}`` of the JAX ``MLP`` (numpy arrays), in place of
    the seeded initialisation."""
    args = parser().parse_args(argv)
    created = init_world(args.device)
    try:
        comm = cmn.create_communicator(
            args.communicator, allreduce_grad_dtype=args.allreduce_grad_dtype)
        chief = comm.rank == 0
        device = comm.device
        if chief:
            print(f"communicator: {args.communicator}  {comm!r}  "
                  f"device {device}")
        train, test = get_mnist(n_train=args.n_train, n_test=args.n_test)
        train = cmn.scatter_dataset(train, comm, shuffle=True, seed=0)
        test = cmn.scatter_dataset(test, comm, shuffle=False, seed=0)
        batch = max(args.batchsize // comm.size, 1)
        train_it = SerialIterator(train, batch, shuffle=True, seed=1)

        model = MLP(n_units=args.unit)
        if params is not None:
            model.load_state_dict(mlp_params_from_flax(params))
        model.to(device)
        comm.bcast_data(model)  # initial weight sync (parity)
        opt = cmn.create_multi_node_optimizer(torch.optim.SGD(
            [p for _, p in flax_ordered_parameters(model)], lr=args.lr), comm)
        step = cmn.build_train_step(
            comm, lambda b: softmax_cross_entropy(model(b[0]), b[1]), opt)
        trainer = Trainer(Updater(train_it, step, model=model),
                          stop_trigger=(args.epoch, "epoch"))

        def metric(b):
            logits = model(b[0])
            return {"loss": softmax_cross_entropy(logits, b[1]),
                    "accuracy": accuracy(logits, b[1])}

        evaluator = Evaluator(lambda: EpochIterator(test, batch), metric,
                              comm, model=model)
        trainer.extend(cmn.create_multi_node_evaluator(evaluator, comm))
        log = T.LogReport(comm=comm)
        trainer.extend(T.Throughput(args.batchsize, comm=comm),
                       trigger=(1, "iteration"))
        trainer.extend(log, trigger=(1, "epoch"))
        trainer.extend(T.PrintReport(REPORT, log, comm=comm),
                       trigger=(1, "epoch"))
        if args.checkpoint:
            ckpt = cmn.create_multi_node_checkpointer(args.checkpoint, comm)
            trainer.extend(ckpt, trigger=(1, "epoch"))
            resumed = ckpt.restore_trainer(trainer)
            if resumed is not None and chief:
                print(f"resumed from iteration {resumed}")
        trainer.run()
        if chief and log.log:
            print("final:", {k: round(v, 4) for k, v in log.log[-1].items()
                             if isinstance(v, float)})
        return log.log
    finally:
        finish_world(created)


if __name__ == "__main__":
    cmn.global_except_hook.add_hook()
    main()
