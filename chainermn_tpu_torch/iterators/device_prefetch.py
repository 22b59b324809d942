"""Host-to-device overlap for input pipelines (port of
``chainermn_tpu/iterators/device_prefetch.py``).

``prefetch_to_device(it, place_fn, depth)`` keeps ``depth`` placed
batches ahead of the consumer: it tops its buffer up before it pops a
batch and again right after, so batch ``i + 1`` is being copied while
step ``i`` computes.  The JAX package gets the overlap from
asynchronous dispatch; on a card the port gets it from PyTorch's
stream idiom, in :class:`CudaPlacer` (``device_placer("cuda")``):

* each host batch goes through ``training.trainer.to_device`` (pinned
  memory, then ``non_blocking=True``) with a side ``torch.cuda.Stream``
  current, so the copy is issued on that stream, and an event is
  recorded behind it; PyTorch's caching host allocator does not hand a
  pinned block out again before the copy that read it has completed;
* when the batch is popped, the consumer's current stream waits on that
  event, and every tensor of the batch calls ``record_stream`` on the
  consumer's stream, so the caching allocator does not hand its memory
  to the side stream again before the consumer is done with it.

On the CPU ``device_placer("cpu")`` is a plain ``.to(device)``.  There
is no fallback between the two: a card gets the side stream.

Checkpointing through the prefetcher: ``serialize`` returns the wrapped
iterator's state as it was just before the *oldest unconsumed* batch
was drawn (one snapshot per drawn batch, aligned with the buffer), so a
resume replays the buffered batches instead of skipping them;
``restore`` clears the buffer.  ``serialize`` and ``restore`` exist
only where the wrapped iterator has them (and ``serialize`` not at all
with ``snapshot_states=False``), so ``Trainer.state_dict``'s
``hasattr`` check keeps working.  ``epoch``, ``epoch_detail`` and
``is_new_epoch`` are the consumer's: the values the wrapped iterator had
right after it drew the batch last popped (the wrapped iterator itself
is ``depth`` batches ahead, and a trainer stopping on its epoch would
stop early).  Every other attribute is the wrapped iterator's.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator

import torch

from .._device import resolve_device
from .._tree import tree_leaves
from ..training.trainer import to_device

# the bookkeeping that follows the consumer, not the raced-ahead iterator
CONSUMER_FIELDS = ("epoch", "epoch_detail", "is_new_epoch")


class PendingBatch:
    """A batch whose copy to the card was issued on a side stream.
    :meth:`wait` hands it to the consumer's current stream."""

    __slots__ = ("batch", "tensors", "event", "device")

    def __init__(self, batch, tensors, event, device):
        self.batch = batch
        self.tensors = tensors
        self.event = event
        self.device = device

    def wait(self):
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(stream)
        return self.batch


class CudaPlacer:
    """``place_fn`` for a card: a host batch to the card on a side
    stream (see the module docstring).  ``copies`` counts the batches it
    issued."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CudaPlacer needs a CUDA device, got {device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = torch.cuda.Stream(device=self.device)
        self.copies = 0

    def __call__(self, batch) -> PendingBatch:
        with torch.cuda.stream(self.stream):
            placed = to_device(batch, self.device)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.copies += 1
        tensors = [t for t in tree_leaves(placed)
                   if isinstance(t, torch.Tensor)]
        return PendingBatch(placed, tensors, event, self.device)


def device_placer(device) -> Callable:
    """The ``place_fn`` for ``device``: :class:`CudaPlacer` on a card
    (raising when CUDA is absent), a plain ``.to(device)`` on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return CudaPlacer(dev)
    return lambda batch: to_device(batch, dev)


class _DevicePrefetcher:
    def __init__(self, it: Iterator, place_fn: Callable, depth: int,
                 snapshot_states: bool = True):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._it = it
        self._place = place_fn
        self._depth = depth
        self._buf: collections.deque = collections.deque()
        # the wrapped iterator's state just before each buffered batch
        # was drawn, aligned with _buf: a resume starts at the oldest
        # unconsumed batch, not where the iterator has raced ahead to.
        # The wrapped serialize() runs once per batch drawn, so it must
        # be O(1) (SerialIterator's is); snapshot_states=False turns it
        # off and hides serialize() rather than record the raced-ahead
        # position.
        self._states: collections.deque = collections.deque()
        # the consumer's bookkeeping right after each buffered batch was
        # drawn, aligned with _buf; _consumed is the last popped one's
        self._marks: collections.deque = collections.deque()
        self._consumed = None
        self._can_serialize = snapshot_states and hasattr(it, "serialize")
        self._done = False

    def _top_up(self) -> None:
        while len(self._buf) < self._depth and not self._done:
            state = self._it.serialize() if self._can_serialize else None
            try:
                host = next(self._it)
            except StopIteration:
                self._done = True
                return
            self._buf.append(self._place(host))
            self._states.append(state)
            self._marks.append({f: getattr(self._it, f)
                                for f in CONSUMER_FIELDS
                                if hasattr(self._it, f)})

    def __iter__(self):
        return self

    def __next__(self):
        self._top_up()
        if not self._buf:
            raise StopIteration
        out = self._buf.popleft()
        self._states.popleft()
        self._consumed = self._marks.popleft()
        # issue the replacement copy now, while the caller's step with
        # `out` computes
        self._top_up()
        return out.wait() if isinstance(out, PendingBatch) else out

    next = __next__

    # serialize/restore come through __getattr__, so that hasattr()
    # finds them only where the wrapped iterator has them
    def _serialize(self):
        if self._states:
            return self._states[0]
        return self._it.serialize()

    def _restore(self, state):
        self._it.restore(state)
        self._buf.clear()
        self._states.clear()
        self._marks.clear()
        self._consumed = None
        self._done = False

    def __getattr__(self, name):
        it = self.__dict__.get("_it")
        if it is None:  # mid-construction or unpickling
            raise AttributeError(name)
        if name == "serialize":
            if self.__dict__.get("_can_serialize"):
                return self._serialize
            # never the wrapped iterator's: it would record the
            # raced-ahead position and drop the buffered batches
            raise AttributeError(name)
        if name == "restore" and hasattr(it, "restore"):
            return self._restore
        consumed = self.__dict__.get("_consumed")
        if consumed is not None and name in consumed:
            return consumed[name]
        return getattr(it, name)


def prefetch_to_device(iterator: Iterator, place_fn: Callable,
                       depth: int = 2,
                       snapshot_states: bool = True) -> Iterator:
    """Wrap ``iterator`` so that ``depth`` placed batches are always in
    flight.  ``place_fn`` maps one host batch to the device
    (:func:`device_placer`); a :class:`PendingBatch` it returns is
    handed to the consumer's stream when popped.  ``depth=2`` is double
    buffering: one batch in use, one copying behind it.

    ``snapshot_states``: see the module docstring; pass ``False`` for an
    iterator whose ``serialize()`` is not O(1)."""
    return _DevicePrefetcher(iter(iterator), place_fn, depth,
                             snapshot_states=snapshot_states)
