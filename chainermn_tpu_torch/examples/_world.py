"""Process-group set-up shared by the examples.

One process per card, as ChainerMN ran one MPI rank per GPU.  Started by
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` in the environment) the example joins that world; run
plainly, it is a world of one.  NCCL on a card, gloo on the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .._device import resolve_device


def init_world(device) -> bool:
    """Join (or make) the world for ``device`` (``"cuda"`` or ``"cpu"``);
    returns whether this call created the process group (and so should
    destroy it).  An existing group is used as it is.  On a card, this
    rank's card (``LOCAL_RANK``) becomes the current device before any
    collective runs."""
    dev = resolve_device(device)
    created = not dist.is_initialized()
    if created:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return created


def finish_world(created: bool) -> None:
    if created:
        dist.destroy_process_group()
