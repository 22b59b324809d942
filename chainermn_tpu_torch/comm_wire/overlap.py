"""Bucket-granularity overlap of the gradient wire with the backward.

Port of the contract of ``chainermn_tpu/comm_wire/overlap.py``
(``overlap.py:40-63``), not of its mechanism.  The JAX package re-sorts
the step's jaxpr so that each bucket's collective is issued the moment
the backward has produced its leaves.  The port has no program to
re-sort: it issues each bucket from the backward itself.

Mechanism (``overlap="bucket"``):

* :class:`BucketOverlap` registers ``Tensor.register_post_accumulate_
  grad_hook`` on every planned parameter.  When the last leaf of a
  bucket has its gradient, the bucket is packed, encoded (K1 on both
  cast legs, as the synchronous wire) and all-reduced with
  ``async_op=True`` inside the backward; the update waits on every
  handle and decodes.
* Issue order is one fixed order on every rank, or NCCL would pair the
  collectives wrongly: reverse plan order (the backward finishes the
  last layers first), and a bucket is issued only once every bucket
  before it in that order has been, as DDP does.
* A parameter that gets no gradient never fires its hook: at the end of
  the backward (:meth:`BucketOverlap.finish_backward`) what is left is
  issued in the same order, its missing leaves as zeros.
* With ``accum_steps > 1`` only the last microbatch's backward is armed
  (:meth:`BucketOverlap.arm`); its buckets are divided by the step count
  as the synchronous path divides ``.grad``.

Where each bucket is issued:

==========================  ==========================================
bucket                      issued
==========================  ==========================================
``flat``, codec none/cast   inside the backward, from the hook of its
                            last leaf (async all-reduce)
``flat``, codec ``int8``    at the end of the backward: its scale needs
                            every bucket's absmax in the one batched MAX
                            all-reduce (``overlap.py:60-63`` of the JAX
                            package says the same)
``hier_rs_ag``              at the end of the backward, its three hops
                            in turn
ZeRO's reduce-scatters      at the update, after the backward (the ZeRO
                            optimizer installs no hook)
==========================  ==========================================

Results are bit-identical to the synchronous wire: the same buckets,
codec, summands and collective count; only the time of issue moves.
:attr:`BucketOverlap.report` is the port's counterpart of
``bucket_issue_report`` (``overlap.py:389``): one :class:`BucketIssue`
per bucket of the last step, in issue order.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .codecs import (_CAST_WIRE, WireConfig, _div, decode_cast, encode_cast,
                     uses_error_feedback)
from .schedules import WirePlan, reduce_wire_items

OVERLAP_MODES = ("none", "bucket")


def resolve_overlap(overlap) -> str:
    """Normalize the ``overlap=`` knob (``"none"``/None/``"bucket"``)."""
    if overlap is None:
        return "none"
    if overlap in OVERLAP_MODES:
        return overlap
    raise ValueError(
        f"overlap must be one of {OVERLAP_MODES}; got {overlap!r}"
    )


class BucketIssue(NamedTuple):
    """When one bucket went on the wire."""

    bucket: int  # plan index
    pending_params: int  # the plan's parameters still without a gradient
    in_backward: bool  # issued from a gradient hook, not after the backward


class _InFlight(NamedTuple):
    payload: torch.Tensor
    work: object
    native: torch.dtype
    residual: Optional[torch.Tensor]


def issues_async(wplan: WirePlan, i: int, config: WireConfig) -> bool:
    """Whether bucket ``i`` can go on the wire alone, with one async
    all-reduce: a ``flat`` bucket of a cast codec (or ``none``)."""
    return wplan.schedules[i] == "flat" and config.codec != "int8"


class AsyncWire:
    """One plan's buckets on their way over the wire.  :meth:`issue`
    puts one bucket in flight (async when :func:`issues_async`);
    :meth:`issue_rest` reduces the others at once, as
    ``schedules.reduce_wire`` does; :meth:`collect` waits and returns
    the means (and new residuals) in plan order."""

    def __init__(self, wplan: WirePlan, config: WireConfig, n: int,
                 group=None, groups=None):
        self.wplan, self.config, self.n = wplan, config, n
        self.group, self.groups = group, groups
        self._flight: Dict[int, _InFlight] = {}
        self._done: Dict[int, tuple] = {}

    def issue(self, i: int, g: torch.Tensor,
              residual: Optional[torch.Tensor] = None) -> None:
        if residual is not None:
            g = g + residual.to(g.dtype)
        w, res = encode_cast(g, _CAST_WIRE.get(self.config.codec),
                             uses_error_feedback(self.config))
        work = dist.all_reduce(w, group=self.group, async_op=True)
        self._flight[i] = _InFlight(w, work, g.dtype, res)

    def issue_rest(self, items: Dict[int, torch.Tensor],
                   residuals: Sequence[torch.Tensor] = ()) -> None:
        if not items:
            return
        means, new_res = reduce_wire_items(
            items, self.wplan, self.n, self.config, list(residuals) or None,
            self.group, self.groups)
        for i in items:
            self._done[i] = (means[i], new_res.get(i))

    def issue_all(self, buckets: Sequence[torch.Tensor]) -> None:
        """Every bucket: the async ones in flight, the rest reduced."""
        rest = {}
        for i, g in enumerate(buckets):
            if issues_async(self.wplan, i, self.config):
                self.issue(i, g)
            else:
                rest[i] = g
        self.issue_rest(rest)

    def collect(self):
        """Wait for every bucket: ``(means, new residuals)`` in plan
        order (the residuals ``[]`` without error feedback)."""
        for i, f in self._flight.items():
            f.work.wait()
            self._done[i] = (decode_cast(f.payload, f.native, self.n),
                             f.residual)
        self._flight.clear()
        nb = self.wplan.n_buckets
        means = [self._done[i][0] for i in range(nb)]
        res = ([self._done[i][1] for i in range(nb)]
               if uses_error_feedback(self.config) else [])
        self._done.clear()
        return means, res


class BucketOverlap:
    """The ``overlap="bucket"`` engine of a multi-node optimizer (see
    the module docstring).  ``residuals()`` gives the error-feedback
    carry the next issue adds in (``[]`` without error feedback)."""

    def __init__(self, params: Sequence[torch.Tensor], wplan: WirePlan,
                 config: WireConfig, n: int, group=None, groups=None,
                 residuals: Callable[[], list] = list):
        self.params = list(params)
        self.wplan, self.config, self.n = wplan, config, n
        self.group, self.groups = group, groups
        self._residuals = residuals
        self._bucket_of = {}
        for b, bucket in enumerate(wplan.buckets):
            for s in bucket.slots:
                self._bucket_of[s.index] = b
        self.order = [b for b in reversed(range(wplan.n_buckets))
                      if issues_async(wplan, b, config)]
        self.report: List[BucketIssue] = []
        self._hooks = [p.register_post_accumulate_grad_hook(
            functools.partial(self._arrived, i))
            for i, p in enumerate(self.params)]
        self._armed, self._divisor = True, 1
        self._reset()

    def _reset(self) -> None:
        self._arrived_at = set()
        self._waiting = [len(b.slots) for b in self.wplan.buckets]
        self._pos = 0
        self._wire = AsyncWire(self.wplan, self.config, self.n, self.group,
                               self.groups)
        self._issued: List[BucketIssue] = []
        self._finished = False

    def remove(self) -> None:
        """Take the hooks off the parameters."""
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def arm(self, on: bool = True, divisor: int = 1) -> None:
        """Let the next backward issue buckets (``on``), each divided by
        ``divisor`` (the accumulation's step count); a disarmed backward
        issues nothing."""
        self._armed, self._divisor = bool(on), int(divisor)

    @torch.no_grad()
    def _bucket(self, b: int) -> torch.Tensor:
        parts = []
        for s in self.wplan.buckets[b].slots:
            p = self.params[s.index]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            parts.append(g.reshape(-1))
        flat = parts[0].clone() if len(parts) == 1 else torch.cat(parts)
        return flat if self._divisor == 1 else _div(flat, self._divisor)

    def _issue(self, b: int, in_backward: bool) -> None:
        res = self._residuals()
        self._wire.issue(b, self._bucket(b), res[b] if res else None)
        self._issued.append(BucketIssue(
            b, len(self.params) - len(self._arrived_at), in_backward))

    @torch.no_grad()
    def _arrived(self, index: int, param) -> None:
        if not self._armed or self._finished:
            return
        self._arrived_at.add(index)
        self._waiting[self._bucket_of[index]] -= 1
        while (self._pos < len(self.order)
               and self._waiting[self.order[self._pos]] == 0):
            self._issue(self.order[self._pos], True)
            self._pos += 1

    @torch.no_grad()
    def finish_backward(self) -> None:
        """Issue what the backward left, in the fixed order: the async
        buckets not yet issued, then the int8 and ``hier_rs_ag`` ones."""
        if self._finished:
            return
        for b in self.order[self._pos:]:
            self._issue(b, False)
        self._pos = len(self.order)
        rest = [b for b in range(self.wplan.n_buckets)
                if not issues_async(self.wplan, b, self.config)]
        pending = len(self.params) - len(self._arrived_at)
        self._wire.issue_rest({b: self._bucket(b) for b in rest},
                              self._residuals())
        self._issued += [BucketIssue(b, pending, False) for b in rest]
        self._finished = True

    @torch.no_grad()
    def collect(self):
        """Finish the backward's issue, wait for every bucket: ``(means,
        new residuals)`` in plan order.  The engine is then ready (and
        armed) for the next step."""
        self.finish_backward()
        out = self._wire.collect()
        self.report = self._issued
        self._reset()
        self.arm()
        return out

    def discard(self) -> None:
        """A step the non-finite guard skips: every rank still issued
        every bucket; wait for them and drop the results."""
        self.finish_backward()
        self._wire.collect()
        self.report = self._issued
        self._reset()
        self.arm()
