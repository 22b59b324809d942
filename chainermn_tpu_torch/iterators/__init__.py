"""Iterators (port of ``chainermn_tpu/iterators``' serial iterator).
The multi-node and synchronized iterators and ``prefetch_to_device``
wait (ROADMAP Queue 1, "Checkpoints and the input pipeline")."""

from .serial_iterator import EpochIterator, SerialIterator

__all__ = ["EpochIterator", "SerialIterator"]
