"""Iterators (port of ``chainermn_tpu/iterators``): the serial
iterator, the synchronized and multi-node iterators, and the
device-prefetching wrapper."""

from .device_prefetch import CudaPlacer, device_placer, prefetch_to_device
from .multi_node_iterator import create_multi_node_iterator
from .serial_iterator import EpochIterator, SerialIterator
from .synchronized_iterator import create_synchronized_iterator

__all__ = ["CudaPlacer", "EpochIterator", "SerialIterator",
           "create_multi_node_iterator", "create_synchronized_iterator",
           "device_placer", "prefetch_to_device"]
