"""Training loop: ``Updater`` + ``Trainer`` (port of
``chainermn_tpu/training/trainer.py``).

ChainerMN plugs into Chainer's ``Trainer``/``StandardUpdater``
(``trainer.run() -> update_core -> optimizer.update``).  Here the
``Updater`` owns the iterator and the port's stateful train step (from
``optimizers.build_train_step``: ``step(batch) -> metrics``, the model
and optimizer inside it), and moves each numpy batch to the step's
device; the ``Trainer`` owns the iteration and epoch bookkeeping, the
extensions and the reports.  The loop never waits for the card unless
an extension reads a result.

Auto-resume (``run(max_restarts=, adapt=)``), ``run_elastic`` and the
step guard's resilience hooks wait (ROADMAP Queue 1, "Resilience"): the
train step itself applies its non-finite policy.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .triggers import get_trigger

_RESILIENCE = "ROADMAP Queue 1, 'Resilience'"


def to_device(batch, device: torch.device):
    """A numpy batch (an array, or a tuple or dict of them) as tensors on
    ``device``; to a card through pinned host memory, without waiting
    for the copy."""
    if isinstance(batch, tuple):
        return tuple(to_device(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Updater:
    """Applies one train step per iteration to the next batch of
    ``iterator``, moved to the step's communicator's device."""

    def __init__(self, iterator, step_fn):
        self.iterator = iterator
        self.step_fn = step_fn
        self.device = torch.device(step_fn.comm.device)
        self.last_metrics: Dict[str, Any] = {}

    @property
    def epoch(self) -> int:
        return getattr(self.iterator, "epoch", 0)

    @property
    def epoch_detail(self) -> float:
        return getattr(self.iterator, "epoch_detail", 0.0)

    def update(self) -> None:
        batch = to_device(next(self.iterator), self.device)
        self.last_metrics = self.step_fn(batch)


class _ExtensionEntry:
    def __init__(self, ext, trigger, priority: int, name: str):
        self.ext = ext
        self.trigger = get_trigger(trigger)
        self.priority = priority
        self.name = name


class Trainer:
    """Runs the updater until ``stop_trigger=(n, 'epoch'|'iteration')``,
    firing extensions.  An extension is a callable ``ext(trainer)`` with
    optional ``trigger`` (default each epoch), ``priority`` (higher runs
    first), ``initialize(trainer)`` and ``finalize(trainer)``."""

    def __init__(self, updater: Updater, stop_trigger=(1, "epoch"),
                 out: str = "result"):
        self.updater = updater
        self.stop_n, self.stop_unit = stop_trigger
        self.out = out
        self.iteration = 0
        self.observation: Dict[str, Any] = {}
        self._extensions: list = []
        self._start_time: Optional[float] = None

    def extend(self, ext, trigger=None, priority: Optional[int] = None,
               name: Optional[str] = None) -> "Trainer":
        trigger = trigger if trigger is not None else getattr(
            ext, "trigger", (1, "epoch"))
        priority = priority if priority is not None else getattr(
            ext, "priority", 100)
        name = name or getattr(ext, "name", None) or type(ext).__name__
        self._extensions.append(_ExtensionEntry(ext, trigger, priority, name))
        return self

    def get_extension(self, name: str):
        for e in self._extensions:
            if e.name == name:
                return e.ext
        raise KeyError(name)

    @property
    def epoch(self) -> int:
        return self.updater.epoch

    @property
    def elapsed_time(self) -> float:
        now = time.monotonic()
        return now - (self._start_time or now)

    def _stop(self) -> bool:
        if self.stop_unit == "iteration":
            return self.iteration >= self.stop_n
        return self.updater.epoch >= self.stop_n

    def run(self, max_restarts: int = 0, adapt=None) -> None:
        """Run to the stop trigger."""
        if max_restarts or adapt is not None:
            raise NotImplementedError(
                "auto-resume and straggler adaptation are not ported yet: "
                f"see {_RESILIENCE}")
        self._start_time = time.monotonic()
        try:
            for e in self._extensions:
                init = getattr(e.ext, "initialize", None)
                if init:
                    init(self)
            exts = sorted(self._extensions, key=lambda e: -e.priority)
            while not self._stop():
                self.updater.update()
                self.iteration += 1
                self.observation = dict(self.updater.last_metrics or {})
                for e in exts:
                    if e.trigger(self):
                        e.ext(self)
        finally:
            for e in self._extensions:
                fin = getattr(e.ext, "finalize", None)
                if fin:
                    fin(self)

    @classmethod
    def run_elastic(cls, build, **kwargs) -> "Trainer":
        raise NotImplementedError(
            f"elastic restart is not ported yet: see {_RESILIENCE}")

    def state_dict(self) -> Dict[str, Any]:
        """The loop's position: the iteration and the iterator's state
        (the model and optimizer are the caller's to save)."""
        it = self.updater.iterator
        return {"iteration": self.iteration,
                "iterator": it.serialize() if hasattr(it, "serialize")
                else None}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.iteration = state["iteration"]
        if state.get("iterator") and hasattr(self.updater.iterator, "restore"):
            self.updater.iterator.restore(state["iterator"])
