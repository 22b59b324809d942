"""Global exception hook (port of ``chainermn_tpu/global_except_hook.py``;
ChainerMN's ``global_except_hook``): an uncaught exception on one rank
prints its traceback, prefixed with the rank, and ends the process at
once, so the other ranks fail at their next collective (on its
timeout) instead of the job hanging with one rank gone quiet, as
ChainerMN's ``MPI_Abort`` did.
"""

from __future__ import annotations

import os
import sys
import traceback

_hook_installed = False


def _rank() -> str:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return str(dist.get_rank())
    return "?"


def _global_except_hook(exctype, value, tb):
    try:
        sys.stderr.write(f"\n*** chainermn_tpu_torch: uncaught exception on "
                         f"rank {_rank()}; aborting the job ***\n")
        traceback.print_exception(exctype, value, tb)
        sys.stderr.flush()
    finally:
        os._exit(1)


def add_hook() -> None:
    """Install the hook (idempotent)."""
    global _hook_installed
    if not _hook_installed:
        sys.excepthook = _global_except_hook
        _hook_installed = True


def remove_hook() -> None:
    global _hook_installed
    if _hook_installed:
        sys.excepthook = sys.__excepthook__
        _hook_installed = False
