"""Triggers deciding when trainer extensions fire (port of
``chainermn_tpu/training/triggers.py``; Chainer's
``trainer.extend(ext, trigger=(1, 'epoch'))``)."""

from __future__ import annotations


class IntervalTrigger:
    """Fires once every ``period`` epochs or iterations."""

    def __init__(self, period: int, unit: str = "epoch"):
        if unit not in ("epoch", "iteration"):
            raise ValueError(f"unit must be epoch|iteration, got {unit!r}")
        self.period = period
        self.unit = unit
        self._last_fired = 0

    def __call__(self, trainer) -> bool:
        count = trainer.iteration if self.unit == "iteration" else trainer.epoch
        if count - self._last_fired >= self.period:
            self._last_fired = count
            return True
        return False

    def state(self) -> dict:
        return {"last_fired": self._last_fired}

    def restore(self, state: dict) -> None:
        self._last_fired = state["last_fired"]


def get_trigger(trigger) -> IntervalTrigger:
    """An :class:`IntervalTrigger` from itself, ``None`` (each epoch) or
    ``(period, unit)``."""
    if isinstance(trigger, IntervalTrigger):
        return trigger
    if trigger is None:
        return IntervalTrigger(1, "epoch")
    period, unit = trigger
    return IntervalTrigger(period, unit)
