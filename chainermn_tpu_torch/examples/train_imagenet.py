#!/usr/bin/env python
"""Data-parallel ImageNet-style training: the twin of the JAX package's
``examples/imagenet/train_imagenet.py`` (ChainerMN's flagship
data-parallel workload: scatter_dataset -> multi-node optimizer ->
Trainer, with the BatchNorm running statistics mean-reduced over the
ranks after every update; ``--mnbn`` synchronizes the BatchNorms'
batch statistics over the ranks instead).

Without ``--npz`` (a directory of ``train.npz``/``val.npz`` with arrays
``x`` (NHWC) and ``y``) it trains on an in-memory synthetic set of the
same shapes.  Images stay NHWC, as in the JAX example; the model
permutes them once.  Batches reach the card ``--prefetch`` deep
(``iterators.prefetch_to_device``: pinned memory, a side stream), each
with this rank's dropout seed; ``--checkpoint NAME`` snapshots every
epoch and resumes from the newest step every rank holds.

    python -m chainermn_tpu_torch.examples.train_imagenet --arch resnet50
    torchrun --nproc_per_node 4 -m chainermn_tpu_torch.examples.train_imagenet
    python -m chainermn_tpu_torch.examples.train_imagenet --mnbn \
        --communicator hierarchical
    python -m chainermn_tpu_torch.examples.train_imagenet --arch vgg16 \
        --allreduce-grad-dtype bfloat16 --checkpoint run1
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch import models
from chainermn_tpu_torch.examples._world import finish_world, init_world
from chainermn_tpu_torch.extensions import Evaluator
from chainermn_tpu_torch.iterators import (EpochIterator, SerialIterator,
                                           device_placer, prefetch_to_device)
from chainermn_tpu_torch.links import create_mnbn_model
from chainermn_tpu_torch.models import flax_ordered_parameters
from chainermn_tpu_torch.ops.losses import accuracy, softmax_cross_entropy
from chainermn_tpu_torch.training import Trainer, Updater
from chainermn_tpu_torch.training import extensions as T
from chainermn_tpu_torch.utils import SyntheticImageDataset

ARCHS = {"alex": models.AlexNet, "googlenet": models.GoogLeNet,
         "googlenetbn": models.GoogLeNetBN, "nin": models.NIN,
         "resnet18": models.ResNet18, "resnet50": models.ResNet50,
         "resnet101": models.ResNet101, "vgg16": models.VGG16}
# the archs whose first dense layer's width follows the image size
SIZED_ARCHS = ("alex", "vgg16")
# the archs with dropout, which draw it from each rank's generator
DROPOUT_ARCHS = ("alex", "googlenet", "googlenetbn", "nin", "vgg16")
REPORT = ["epoch", "iteration", "loss", "val/loss", "val/accuracy",
          "samples_per_sec"]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch example: ImageNet")
    p.add_argument("--arch", default="resnet50", choices=sorted(ARCHS))
    p.add_argument("--communicator", default="pure_nccl")
    p.add_argument("--batchsize", type=int, default=64,
                   help="global batch size (split over the ranks)")
    p.add_argument("--epoch", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--n-train", type=int, default=512,
                   help="synthetic train set size")
    p.add_argument("--n-val", type=int, default=128)
    p.add_argument("--npz", default=None,
                   help="directory with train.npz/val.npz (x, y arrays)")
    p.add_argument("--allreduce-grad-dtype", default=None,
                   choices=["float16", "bfloat16", "float32"],
                   help="reduced-precision gradient wire")
    p.add_argument("--device", default="cuda",
                   help="cuda (this rank's card) or cpu (gloo)")
    p.add_argument("--mnbn", action="store_true",
                   help="synchronized BatchNorm over the communicator")
    p.add_argument("--native-loader", action="store_true",
                   help="the C++ threaded loader (not ported)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches copied to the device ahead of the step "
                        "(0: none); a checkpoint resumes at the oldest "
                        "unconsumed one")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint every epoch and resume under this name")
    return p


def make_model(arch: str, num_classes: int, image_size: int) -> torch.nn.Module:
    kw = {"image_size": image_size} if arch in SIZED_ARCHS else {}
    return ARCHS[arch](num_classes=num_classes, **kw)


class RngBatchIterator:
    """Appends this rank's dropout seed to each batch: ``rank + count *
    world + base`` at the ``count``-th batch (the JAX example's
    ``_RngBatchIterator`` with one shard a process), so no two ranks and
    no two iterations share one.  The counter is part of ``serialize``:
    a resumed run does not replay the first iterations' masks."""

    def __init__(self, it, rank: int, world: int, base_seed: int = 0):
        self._it = it
        self._rank = rank
        self._world = world
        self._base = base_seed
        self._count = 0

    def __getattr__(self, name):
        it = self.__dict__.get("_it")
        if it is None:
            raise AttributeError(name)
        return getattr(it, name)

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        seed = self._rank + self._count * self._world + self._base
        self._count += 1
        return (*batch, seed)

    def serialize(self) -> dict:
        return {"inner": self._it.serialize(), "count": self._count}

    def restore(self, state: dict) -> None:
        self._it.restore(state["inner"])
        self._count = int(state["count"])


def _datasets(args):
    if args.npz:
        tr = np.load(os.path.join(args.npz, "train.npz"))
        va = np.load(os.path.join(args.npz, "val.npz"))
        return list(zip(tr["x"], tr["y"])), list(zip(va["x"], va["y"]))
    shape = (args.image_size, args.image_size, 3)
    n_classes = min(args.num_classes, 64)
    return (SyntheticImageDataset(args.n_train, shape=shape,
                                  n_classes=n_classes, seed=0),
            SyntheticImageDataset(args.n_val, shape=shape,
                                  n_classes=n_classes, seed=1))


def main(argv=None, *, datasets=None) -> list:
    """Train and return the log, one entry per epoch (its last entry is
    what the JAX example returns).  ``datasets``: ``(train, val)`` in
    place of the synthetic or ``--npz`` sets."""
    args = parser().parse_args(argv)
    if args.native_loader:
        raise NotImplementedError(
            "--native-loader is not ported yet: see ROADMAP Queue 1, "
            "'Native input path'")
    created = init_world(args.device)
    try:
        comm = cmn.create_communicator(
            args.communicator, allreduce_grad_dtype=args.allreduce_grad_dtype)
        chief = comm.rank == 0
        device = comm.device
        if chief:
            print(f"arch={args.arch}  communicator={args.communicator}  "
                  f"{comm!r}  device {device}")
        train, val = datasets or _datasets(args)
        train = cmn.scatter_dataset(train, comm, shuffle=True, seed=0)
        val = cmn.scatter_dataset(val, comm, shuffle=False, seed=0)
        batch = max(args.batchsize // comm.size, 1)
        train_it = RngBatchIterator(
            SerialIterator(train, batch, shuffle=True, seed=1), comm.rank,
            comm.size)
        feed_it = train_it
        if args.prefetch > 0:
            feed_it = prefetch_to_device(train_it, device_placer(device),
                                         depth=args.prefetch)

        model = make_model(args.arch, args.num_classes,
                           args.image_size).to(device)
        if args.mnbn:
            # evaluation reads the running statistics and communicates
            # nothing
            model = create_mnbn_model(model, comm)
        comm.bcast_data(model)
        # the JAX step's tree is {"params", "batch_stats"}: the running
        # statistics ride the wire as zero-gradient leaves, and their
        # rank mean is folded in after each update
        opt = cmn.create_multi_node_optimizer(torch.optim.SGD(
            [p for _, p in flax_ordered_parameters(model)], lr=args.lr,
            momentum=args.momentum), comm)
        dropout_rng = torch.Generator(device=device)

        def loss_fn(b):
            kw = {}
            if args.arch in DROPOUT_ARCHS:
                kw["generator"] = dropout_rng.manual_seed(b[2])
            return softmax_cross_entropy(model(b[0], **kw), b[1])

        step = cmn.build_train_step(comm, loss_fn, opt,
                                    model_state=list(model.buffers()))
        if chief:
            plan = opt.wire_plan()
            print(f"wire {opt.wire.codec}: {plan.describe()}")
        trainer = Trainer(Updater(feed_it, step, model=model),
                          stop_trigger=(args.epoch, "epoch"))

        def metric(b):
            logits = model(b[0])
            return {"loss": softmax_cross_entropy(logits, b[1]),
                    "accuracy": accuracy(logits, b[1])}

        evaluator = Evaluator(lambda: EpochIterator(val, batch), metric, comm,
                              model=model)
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
