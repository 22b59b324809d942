"""Training loop (port of ``chainermn_tpu/training``): ``Updater``,
``Trainer``, triggers and the reporting extensions."""

from . import extensions
from .trainer import Trainer, Updater
from .triggers import IntervalTrigger, get_trigger

__all__ = ["IntervalTrigger", "Trainer", "Updater", "extensions",
           "get_trigger"]
