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

from .._tree import tree_map
from .triggers import get_trigger

_RESILIENCE = "ROADMAP Queue 1, 'Resilience'"


def _place(leaf, device: torch.device):
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    elif not isinstance(leaf, torch.Tensor) or leaf.device == device:
        return leaf
    if device.type == "cuda" and leaf.device.type == "cpu":
        return leaf.pin_memory().to(device, non_blocking=True)
    return leaf.to(device)


def to_device(batch, device: torch.device):
    """A batch (a dict, list or tuple of arrays and tensors) with its
    arrays and tensors on ``device``; host memory goes to a card through
    pinned memory, without waiting for the copy (PyTorch's caching host
    allocator holds a pinned block until its copy is done).  A tensor
    already on ``device`` passes through as it is (no second copy: a
    prefetched batch), and other leaves (a seed, a label as an int)
    too."""
    return tree_map(lambda leaf: _place(leaf, device), batch)


class Updater:
    """Applies one train step per iteration to the next batch of
    ``iterator``, moved to the step's communicator's device (a batch
    already there, from ``prefetch_to_device``, is not copied again).
    ``model``: the module the step trains, which a checkpointer saves
    and restores (the step's optimizer is ``step_fn.optimizer``)."""

    def __init__(self, iterator, step_fn, model=None):
        self.iterator = iterator
        self.step_fn = step_fn
        self.model = model
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
        """The loop's position: the iteration, the iterator's state and
        each extension trigger's last firing, by extension name, as
        Chainer's trainer serializes its triggers (the model and
        optimizer are a checkpointer's to save)."""
        it = self.updater.iterator
        return {"iteration": self.iteration,
                "iterator": it.serialize() if hasattr(it, "serialize")
                else None,
                "triggers": {e.name: e.trigger.state()
                             for e in self._extensions}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Put the position back; a resumed run's triggers fire where the
        uninterrupted run's would (not at once, on the restored epoch)."""
        self.iteration = state["iteration"]
        if state.get("iterator") and hasattr(self.updater.iterator, "restore"):
            self.updater.iterator.restore(state["iterator"])
        triggers = state.get("triggers") or {}
        for e in self._extensions:
            if e.name in triggers:
                e.trigger.restore(triggers[e.name])
