"""Reporting extensions: ``LogReport``, ``PrintReport``, ``Throughput``
(port of ``chainermn_tpu/training/extensions.py``; ``ProgressBar`` and
``Profile`` wait).

ChainerMN's convention that only rank 0 reports is built in: pass
``comm`` and an extension writes nothing on other ranks.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np


def _is_chief(comm) -> bool:
    return comm is None or comm.rank == 0


class LogReport:
    """Each time it fires: one log entry with the iteration, the epoch,
    the elapsed time and the mean of every numeric observation seen
    since the last entry; the log is written as JSON on rank 0
    (``filename=None`` writes nothing)."""

    priority = 150
    trigger = (1, "epoch")
    name = "log_report"

    def __init__(self, comm=None, filename: Optional[str] = "log.json",
                 out: str = "result", trigger=(1, "epoch")):
        self._comm = comm
        self._filename = filename
        self._out = out
        self.trigger = trigger
        self.log: list = []
        self._pending: Dict[str, list] = {}

    def observe(self, observation: Dict[str, Any]) -> None:
        for k, v in observation.items():
            try:
                value = float(v)
            except (TypeError, ValueError):
                continue
            self._pending.setdefault(k, []).append(value)

    def __call__(self, trainer) -> None:
        self.observe(trainer.observation)
        entry = {"iteration": trainer.iteration, "epoch": trainer.epoch,
                 "elapsed_time": trainer.elapsed_time}
        for k, vals in self._pending.items():
            entry[k] = float(np.mean(vals))
        self._pending.clear()
        self.log.append(entry)
        if self._filename and _is_chief(self._comm):
            os.makedirs(self._out, exist_ok=True)
            with open(os.path.join(self._out, self._filename), "w") as f:
                json.dump(self.log, f, indent=1)


class PrintReport:
    """Prints the selected keys of the newest log entry as a table row
    (rank 0 only)."""

    priority = 140
    trigger = (1, "epoch")
    name = "print_report"

    def __init__(self, entries: Sequence[str], log_report: LogReport,
                 comm=None, stream=None):
        self._entries = list(entries)
        self._log_report = log_report
        self._comm = comm
        self._stream = stream or sys.stdout
        self._header_printed = False

    def __call__(self, trainer) -> None:
        if not _is_chief(self._comm) or not self._log_report.log:
            return
        if not self._header_printed:
            self._stream.write("  ".join(f"{e:>14s}" for e in self._entries)
                               + "\n")
            self._header_printed = True
        last = self._log_report.log[-1]
        cells = []
        for e in self._entries:
            v = last.get(e)
            cells.append(f"{v:14.6g}" if isinstance(v, (int, float))
                         else f"{'':>14s}")
        self._stream.write("  ".join(cells) + "\n")
        self._stream.flush()


class Throughput:
    """Puts samples/s over the iterations since the ``warmup``-th, in
    total and per rank, into the observation.  Host clock; the step is
    not waited for, so the rate is of the host's loop, which the card
    paces once its queue is full."""

    priority = 160
    trigger = (1, "iteration")
    name = "throughput"

    def __init__(self, batch_size_global: int, comm=None, warmup: int = 2):
        self._bs = batch_size_global
        self._comm = comm
        self._warmup = warmup
        self._t0: Optional[float] = None
        self._n0 = 0
        self._count = 0

    def __call__(self, trainer) -> None:
        self._count += 1
        if self._count == self._warmup:
            self._t0 = time.monotonic()
            self._n0 = self._count
            return
        if self._t0 is None:
            return
        dt = time.monotonic() - self._t0
        n = self._count - self._n0
        if dt <= 0 or n <= 0:
            return
        sps = n * self._bs / dt
        trainer.observation["samples_per_sec"] = sps
        if self._comm is not None:
            trainer.observation["samples_per_sec_per_chip"] = (
                sps / self._comm.size)
