"""Multi-node optimizers and the data-parallel train step.

Port of ``chainermn_tpu/optimizers.py``: ``create_multi_node_optimizer``
(optimizers.py:906) with its refusals (:1011-1050), the bucketed
gradient sync ``_sync_grads_wire`` (:101), the double-buffering
optimizer (``_DoubleBufferingOptimizer``, :491), ZeRO stage 1
(``_ZeroRedundancyOptimizer``, :582) and ``build_train_step`` (:1060)
with gradient accumulation, remat (:1220-1292), its non-finite guard
(``_guarded_apply``, :1299) and its model-state form (``has_aux=True,
merge_aux=...``, :1072-1100): running statistics that the forward
updates are mean-reduced over the ranks after the update.

The wrapped object is a ``torch.optim`` optimizer.  The gradient sync
plans the optimizer's parameters, in their order, into the wire's
buckets and a schedule per bucket over the communicator's sync axes
(``comm_wire.schedules.plan_wire``), reduces them
(``comm_wire.schedules.reduce_wire``: one all-reduce per ``flat``
bucket, the intra/inter/intra triple per ``hier_rs_ag`` bucket), then
writes the means back into ``.grad``.  Build the optimizer over a
model's parameters in flax's order
(``models.convert.flax_ordered_parameters``) and its buckets have the
JAX plan's layout.  With error feedback the wire's residual is carried
beside the optimizer (``MultiNodeOptimizer.wire_residual``).
``overlap="bucket"`` issues each bucket from the backward
(``comm_wire.overlap``).

The JAX ZeRO optimizer's ``state_partition_spec`` has no counterpart:
the port runs one process per card, so each rank's state is simply the
block it owns (:class:`ZeroRedundancyOptimizer`).

The autotuner (``tune_trace=``, ``profile=``) waits (ROADMAP Queue 1,
"Optimizer, tier 2").
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Callable, List, Optional, Sequence

import torch

from ._tree import tree_leaves, tree_map
from .comm_wire import (
    flatten_to_buckets,
    make_plan,
    plan_wire,
    reduce_wire,
    resolve_wire,
    unflatten_from_buckets,
    uses_error_feedback,
    zero_residuals_wire,
)
from .comm_wire.codecs import _CAST_WIRE, _div, decode_cast, storage_dtype
from .comm_wire.overlap import AsyncWire, BucketOverlap, resolve_overlap
from .comm_wire.schedules import (
    _WAITING,
    WirePlan,
    _all_gather,
    _reduce_scatter,
    axis_split,
    mesh_axis_sizes,
    schedule_for_bucket,
)
from .extensions.allreduce_persistent import allreduce_mean_
from .ops.fused_cast_scale import fused_cast_scale
from .resilience.errors import StepDivergedError

NONFINITE_POLICIES = (None, "skip", "abort", "warn")


def _params_of(optimizer: torch.optim.Optimizer) -> List[torch.nn.Parameter]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _grads_of(params) -> List[torch.Tensor]:
    """Each parameter's gradient; zeros where there is none (every rank
    must send the same buckets)."""
    return [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]


def _set_grads(params, grads) -> None:
    for p, g in zip(params, grads):
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)


@torch.no_grad()
def _sync_grads(params, comm, wire, residuals=None) -> list:
    """Mean every parameter's gradient over the communicator through the
    scheduled wire, in place: flatten the gradients into the plan's
    buckets, reduce each under its schedule, unflatten into ``.grad``.
    A parameter without a gradient contributes zeros.  Returns the new
    error-feedback residuals (``[]`` without error feedback)."""
    params = list(params)
    grads = _grads_of(params)
    wplan = plan_wire(grads, wire, comm)
    means, new_res = reduce_wire(
        flatten_to_buckets(wplan.plan, grads), wplan, comm.size, wire,
        residuals, group=getattr(comm, "_group", None),
        groups=comm.wire_groups)
    _set_grads(params, unflatten_from_buckets(wplan.plan, means))
    return new_res


def _all_finite(params, comm) -> bool:
    """Whether every rank's every gradient is finite: one min-reduce, so
    all ranks agree to skip or apply (a rank skipping alone would
    deadlock the next collective)."""
    flags = [torch.isfinite(p.grad).all() for p in params
             if p.grad is not None]
    dev = params[0].device if params else torch.device("cpu")
    ok = (torch.stack(flags).all() if flags
          else torch.ones((), dtype=torch.bool, device=dev))
    return bool(comm.allreduce(ok.float(), "min") > 0)


class MultiNodeOptimizer:
    """A ``torch.optim`` optimizer whose ``step`` first means the
    gradients over the communicator (parity: ``_MultiNodeOptimizer``).
    Attributes it does not define (``param_groups``, ``state``,
    ``zero_grad``, ...) are the wrapped optimizer's.

    On its first ``step`` (or the first step of ``build_train_step``) it
    broadcasts rank 0's parameters to every rank, ChainerMN's
    ``bcast_data`` on the first update.

    ``wire_residual``: the error-feedback carry of a wire with
    ``error_feedback`` (``[]`` otherwise), zeros at first, on the
    parameters' device: one tensor per bucket, the full bucket for a
    ``flat`` bucket and the shard for a ``hier_rs_ag`` one
    (``comm_wire.zero_residuals_wire``).  Each sync replaces it; a step
    that the non-finite guard skips does not sync, so it keeps the
    residual it found.  It is part of ``state_dict``.

    ``overlap="bucket"``: the buckets go on the wire from the backward
    (``comm_wire.overlap.BucketOverlap``, hooks on the parameters);
    ``issue_report`` holds the last step's record of each bucket's
    issue.  Between two updates every backward but the last must run
    disarmed (``build_train_step(accum_steps=)`` does this).
    """

    def __init__(self, actual_optimizer: torch.optim.Optimizer, comm,
                 wire="auto", overlap="none"):
        self.actual_optimizer = actual_optimizer
        self.communicator = comm
        self.wire = resolve_wire(wire, comm)
        self.overlap = resolve_overlap(overlap)
        self._needs_bcast = True
        self.wire_residual: List[torch.Tensor] = []
        if uses_error_feedback(self.wire):
            params = self.params
            self.wire_residual = zero_residuals_wire(
                self.wire_plan(), params[0].device if params else None)
        self._engine: Optional[BucketOverlap] = None
        if self.overlap == "bucket" and self._hooks_issue():
            self._engine = BucketOverlap(
                self.params, self.wire_plan(), self.wire, comm.size,
                getattr(comm, "_group", None), comm.wire_groups,
                residuals=lambda: self.wire_residual)

    def _hooks_issue(self) -> bool:
        return not self.communicator.no_exchange

    def __getattr__(self, name):
        # only reached for names this class does not define
        return getattr(self.__dict__["actual_optimizer"], name)

    @property
    def params(self) -> List[torch.nn.Parameter]:
        """The wrapped optimizer's parameters, in the wire's order."""
        return _params_of(self.actual_optimizer)

    @property
    def issue_report(self) -> list:
        """``comm_wire.overlap.BucketIssue`` of each bucket of the last
        overlapped step, in issue order (``[]`` without overlap)."""
        return list(self._engine.report) if self._engine else []

    def wire_plan(self) -> WirePlan:
        """The scheduled plan (``comm_wire.WirePlan``) the sync uses for
        these parameters over the communicator's sync axes."""
        return plan_wire(self.params, self.wire, self.communicator)

    @torch.no_grad()
    def bcast_once(self) -> None:
        """Broadcast rank 0's parameters, the first time only."""
        if self._needs_bcast:
            for p in self.params:
                p.copy_(self.communicator.bcast(p, root=0))
            self._needs_bcast = False

    def arm(self, on: bool = True, divisor: int = 1) -> None:
        """Let the next backward put buckets on the wire (overlap only;
        see :meth:`comm_wire.overlap.BucketOverlap.arm`)."""
        if self._engine is not None:
            self._engine.arm(on, divisor)

    def finish_backward(self) -> None:
        """The backward has ended: issue the buckets it left (overlap
        only)."""
        if self._engine is not None:
            self._engine.finish_backward()

    def discard_pending(self) -> None:
        """A skipped step: drop what the backward put on the wire."""
        if self._engine is not None:
            self._engine.discard()

    @torch.no_grad()
    def sync_grads(self) -> None:
        if self.communicator.no_exchange:
            return
        if self._engine is None:
            self.wire_residual = _sync_grads(
                self.params, self.communicator, self.wire, self.wire_residual)
            return
        means, new_res = self._engine.collect()
        params = self.params
        _set_grads(params, unflatten_from_buckets(self._engine.wplan.plan,
                                                  means))
        self.wire_residual = new_res

    def update(self, closure: Optional[Callable] = None):
        """Sync the gradients, then the wrapped optimizer's step (the
        JAX wrapper's ``update`` and ``apply_updates``)."""
        self.sync_grads()
        return self.actual_optimizer.step(closure)

    def state_dict(self) -> dict:
        """The wrapped optimizer's state, and the wire's residual."""
        state = self.actual_optimizer.state_dict()
        state["wire_residual"] = [r.clone() for r in self.wire_residual]
        return state

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        residual = state.pop("wire_residual", [])
        self.actual_optimizer.load_state_dict(state)
        self.wire_residual = [
            r.to(mine.device, mine.dtype).clone()
            for r, mine in zip(residual, self.wire_residual)]

    def step(self, closure: Optional[Callable] = None):
        """Broadcast (first call), sync the gradients, then the wrapped
        optimizer's step."""
        self.bcast_once()
        return self.update(closure)


class DoubleBufferingOptimizer(MultiNodeOptimizer):
    """Stale-by-one gradients (parity: ``_DoubleBufferingOptimizer``,
    ChainerMN's double-buffering mode).

    ``update`` applies the mean of the *previous* step's gradients and
    stores this step's.  The store (``buffer``) is the wire plan's flat
    buckets cast to the wire's storage dtype
    (``comm_wire.codecs.storage_dtype``: bf16 on a bf16 wire, so the
    stale gradients are rounded to bf16 once, at world 1 too; the cast
    is K1).  The sync casts the buckets back to the plan's dtype and the
    codec re-casts them onto the wire, both legs on K1, as the JAX
    package's ``reduce_wire`` of the stored buckets does.  A bf16 wire
    thus launches K1 3 times a bucket a step: the store, the encode and
    the decode.  The first step applies the mean of zeros through the
    wrapped optimizer (``.grad`` set to zeros, not None, so that Adam's
    step count advances as optax's does).

    The mechanism is ChainerMN's without its thread: step *i*'s buckets
    go on the wire with ``async_op=True`` as soon as they are stored,
    and only step *i+1*'s update waits on them, so the reduction is in
    flight over the wrapped optimizer's step and the next forward and
    backward.  A step that the non-finite guard skips does not call
    ``update``: it keeps the buffer, the parameters and the wrapped
    state, and issues nothing for its own gradients.  ``state_dict``
    carries the buffer; a loaded buffer is put on the wire again by the
    next update.
    """

    def __init__(self, actual_optimizer, comm, wire="auto", overlap="none"):
        super().__init__(actual_optimizer, comm, wire, overlap)
        wplan = self.wire_plan()
        params = self.params
        self.buffer = self._store(wplan, [torch.zeros_like(p)
                                          for p in params])
        self._in_flight: Optional[AsyncWire] = None

    def _store(self, wplan, grads) -> List[torch.Tensor]:
        out = []
        for b, spec in zip(flatten_to_buckets(wplan.plan, grads),
                           wplan.buckets):
            dt = storage_dtype(self.wire, getattr(torch, spec.dtype))
            out.append(b if dt == b.dtype else fused_cast_scale(b, 1.0, dt))
        return out

    def _issue(self, wplan) -> AsyncWire:
        wire = AsyncWire(wplan, self.wire, self.communicator.size,
                         getattr(self.communicator, "_group", None),
                         self.communicator.wire_groups)
        wire.issue_all([b.to(getattr(torch, spec.dtype))
                        for b, spec in zip(self.buffer, wplan.buckets)])
        return wire

    @torch.no_grad()
    def sync_grads(self) -> None:
        """Stale means into ``.grad``, this step's gradients into the
        buffer and on the wire."""
        wplan = self.wire_plan()
        params = self.params
        comm = self.communicator
        if comm.no_exchange:
            means = [b.to(getattr(torch, s.dtype))
                     for b, s in zip(self.buffer, wplan.buckets)]
        else:
            if self._in_flight is None:
                self._in_flight = self._issue(wplan)
            means, _ = self._in_flight.collect()
        self.buffer = self._store(wplan, _grads_of(params))
        _set_grads(params, unflatten_from_buckets(wplan.plan, means))
        self._in_flight = None if comm.no_exchange else self._issue(wplan)

    def state_dict(self) -> dict:
        state = super().state_dict()
        state["buffer"] = [b.clone() for b in self.buffer]
        return state

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        buffer = state.pop("buffer")
        super().load_state_dict(state)
        if self._in_flight is not None:
            self._in_flight.collect()
            self._in_flight = None
        self.buffer = [b.to(mine.device, mine.dtype).clone()
                       for b, mine in zip(buffer, self.buffer)]


def _to_blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """Flatten ``x``, zero-pad to a multiple of ``n``, reshape to
    ``(n, k)`` (parity: ``optimizers._to_blocks``)."""
    flat = x.reshape(-1)
    k = -(-flat.numel() // n)
    pad = n * k - flat.numel()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(n, k)


def _from_blocks(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1)[:like.numel()].reshape(like.shape)


class ZeroRedundancyOptimizer(MultiNodeOptimizer):
    """ZeRO stage 1: the optimizer's state sharded over the communicator
    (parity: ``_ZeroRedundancyOptimizer``).

    Every parameter is viewed as ``comm.size`` blocks (``_to_blocks``:
    flattened, the tail zero-padded, ``(n, k)``); rank *r* keeps a shard
    ``(1, k)`` of each parameter and ``shard_optimizer``, the wrapped
    optimizer's class rebuilt over those shards with the same
    hyperparameters (read from the wrapped optimizer's param groups at
    every step, so a schedule that changes ``lr`` there reaches it).  Its
    state is block *r* of the replicated optimizer's, padding included:
    ``1/n`` of the memory.

    The step: the gradients are reduce-scattered per bucket of blocked
    leaves concatenated column-wise (``_wire_groups``, the JAX package's
    bucketed branch), the codec's cast on the wire through K1, the mean
    after the cast back a true divide (``codecs.decode_cast``); the
    shards take this rank's block of the parameters; the shard
    optimizer steps; the new shards are all-gathered per bucket into the
    full parameters.  The port gathers the new shards, not the updates:
    with an elementwise optimizer each element of a shard is computed by
    the same arithmetic as the replicated optimizer's step on that
    element, so the gathered parameters equal the plain wrapper's bit
    for bit, as the JAX package's ``params + all_gather(updates)``
    equals its plain step's.  (Gathering ``new - old`` and adding it
    back would round once more.)  Shape-coupled optimizers see ``(1,
    k)`` shards and differ, as in the JAX package.

    Schedules: per bucket ``flat`` (one reduce-scatter down, one
    all-gather up, over every rank) or, on the ``hierarchical``
    communicator, ``hier_rs_ag``: the blocks reordered so that a staged
    scatter keeps ownership linear (``_y_order``: rank ``i*K+j`` owns
    block ``i*K+j``), a full-precision reduce-scatter over the intra
    group, the codec's reduce-scatter over the inter group, and the
    gather in reverse (inter, then intra).  ``schedule="hier_rs_ag"``
    without a genuine split warns and collapses to ``flat``.  The
    reduce-scatters run at the update, after the backward, under either
    overlap mode, and with the ``dummy`` communicator too (the JAX
    package's ZeRO path exchanges there as well).  int8 and error
    feedback are refused, as in the JAX package.
    """

    def __init__(self, actual_optimizer, comm, wire="auto", overlap="none"):
        super().__init__(actual_optimizer, comm, wire, overlap)
        self._split = axis_split(comm.axis_names,
                                 mesh_axis_sizes(comm, comm.axis_names))
        if self.wire.schedule == "hier_rs_ag" and self._split is None:
            warnings.warn(
                "zero_redundancy wire schedule 'hier_rs_ag' "
                f"requested but axes {comm.axis_names} carry no genuine "
                "(inter, intra) split (width-1 'mn_inter' ragged "
                "fallback or flat mesh); collapsing to 'flat'.")
        n = comm.size
        groups = []
        self.shards: List[torch.nn.Parameter] = []
        for group in actual_optimizer.param_groups:
            shards = [torch.nn.Parameter(torch.zeros(
                1, -(-p.numel() // n), dtype=p.dtype, device=p.device))
                for p in group["params"]]
            self.shards += shards
            groups.append({**{k: v for k, v in group.items()
                              if k != "params"}, "params": shards})
        self.shard_optimizer = type(actual_optimizer)(groups)

    def _hooks_issue(self) -> bool:
        return False

    def _blocked_specs(self):
        n = self.communicator.size
        return [((n, s.shape[1]), p.dtype)
                for p, s in zip(self.params, self.shards)]

    def wire_plan(self) -> WirePlan:
        """The plan of the blocked ``(n, k)`` leaves (``_wire_groups``)
        and each bucket's schedule."""
        comm = self.communicator
        axes = tuple(comm.axis_names)
        sizes = mesh_axis_sizes(comm, axes)
        plan = make_plan(self._blocked_specs(), self.wire.bucket_bytes,
                         self.wire.max_buckets)
        mapping = dict(zip(axes, sizes))
        scheds = tuple(
            schedule_for_bucket(b, mapping, axes=axes,
                                requested=self.wire.schedule)
            if self._split is not None else "flat"
            for b in plan.buckets)
        return WirePlan(plan=plan, schedules=scheds, axes=axes,
                        axis_sizes=sizes)

    def _y_order(self, g: torch.Tensor) -> torch.Tensor:
        # y[j*I+i] = g[i*K+j]: after the intra-then-inter staged
        # scatters rank (i, j) holds y-row j*I+i, its own block i*K+j
        i_, k_ = self._split.inter_size, self._split.intra_size
        return g.reshape(i_, k_, -1).transpose(0, 1).reshape(g.shape[0], -1)

    def _scatter(self, cat: torch.Tensor, hier: bool) -> torch.Tensor:
        """This rank's block of the bucket's mean, ``(K,)`` in the
        bucket's dtype."""
        n = self.communicator.size
        wire_dtype = _CAST_WIRE.get(self.wire.codec)

        def on_wire(x):
            if wire_dtype is None or wire_dtype == x.dtype:
                return x
            return fused_cast_scale(x, 1.0, wire_dtype)

        if hier:
            intra, inter = self.communicator.wire_groups
            part = _reduce_scatter(self._y_order(cat).reshape(-1), intra)
            local = _reduce_scatter(on_wire(part), inter)
        else:
            local = _reduce_scatter(on_wire(cat).reshape(-1),
                                    getattr(self.communicator, "_group",
                                            None))
        return decode_cast(local, cat.dtype, n)

    def _gather(self, u: torch.Tensor, hier: bool) -> torch.Tensor:
        """Every rank's ``(K,)`` block back as ``(n, K)``."""
        n = self.communicator.size
        if hier:
            intra, inter = self.communicator.wire_groups
            i_, k_ = self._split.inter_size, self._split.intra_size
            z = _all_gather(_all_gather(u, inter), intra)
            return z.reshape(k_, i_, -1).transpose(0, 1).reshape(n, -1)
        return _all_gather(u, getattr(self.communicator, "_group",
                                      None)).reshape(n, -1)

    @torch.no_grad()
    def update(self, closure: Optional[Callable] = None):
        if closure is not None:
            raise ValueError("the zero_redundancy optimizer takes no "
                             "closure")
        comm = self.communicator
        n, r = comm.size, comm.rank
        params = self.params
        blocked = [_to_blocks(g, n) for g in _grads_of(params)]
        wplan = self.wire_plan()
        local = [None] * len(params)
        for bucket, sched in zip(wplan.buckets, wplan.schedules):
            cat = torch.cat([blocked[s.index] for s in bucket.slots], dim=1)
            mine = self._scatter(cat, sched == "hier_rs_ag")
            col = 0
            for s in bucket.slots:
                k = s.shape[1]
                local[s.index] = mine[col:col + k].reshape(1, k)
                col += k
        for p, shard, g in zip(params, self.shards, local):
            shard.copy_(_to_blocks(p.detach(), n)[r:r + 1])
            shard.grad = g
        for mine, group in zip(self.shard_optimizer.param_groups,
                               self.actual_optimizer.param_groups):
            mine.update({k: v for k, v in group.items() if k != "params"})
        self.shard_optimizer.step()
        for bucket, sched in zip(wplan.buckets, wplan.schedules):
            cat = torch.cat([self.shards[s.index] for s in bucket.slots],
                            dim=1).reshape(-1)
            full = self._gather(cat, sched == "hier_rs_ag")
            col = 0
            for s in bucket.slots:
                k = s.shape[1]
                p = params[s.index]
                p.copy_(_from_blocks(full[:, col:col + k], p))
                col += k
        return None

    def state_dict(self) -> dict:
        """This rank's block of the optimizer's state (the shard
        optimizer's ``state_dict``)."""
        return self.shard_optimizer.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.shard_optimizer.load_state_dict(state)

    def hbm_bytes_per_rank(self) -> dict:
        """``{"params": bytes, "opt_state": bytes}`` this rank holds: the
        full parameters (replicated) and every tensor of the shard
        optimizer's state (the moments' blocks and their step counts)."""
        p_bytes = sum(p.numel() * p.element_size() for p in self.params)
        o_bytes = sum(t.numel() * t.element_size()
                      for st in self.shard_optimizer.state.values()
                      for t in st.values() if isinstance(t, torch.Tensor))
        return {"params": p_bytes, "opt_state": o_bytes}

    def reshard_state(self, opt_state, old_world: int, params=None):
        """Re-partition a state saved at ``old_world`` ranks onto this
        world: not ported."""
        from .resilience import elastic

        return elastic.reshard_state(opt_state, None, int(old_world),
                                     self.communicator.size,
                                     label="zero_opt_state")


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator, double_buffering: bool = False,
                                zero_redundancy: bool = False, wire="auto",
                                overlap="none", tune_trace=None,
                                profile=None) -> MultiNodeOptimizer:
    """Wrap a ``torch.optim`` optimizer for data-parallel training
    (parity: ``chainermn.create_multi_node_optimizer``).

    ``wire``: ``"auto"`` (default) is the bucketed wire with the codec
    of the communicator's ``allreduce_grad_dtype`` (None -> ``none``,
    bfloat16 -> ``bf16``, float16 -> ``f16``); a codec name (``int8``
    too) or a ``comm_wire.WireConfig`` (codec, bucket knobs,
    ``error_feedback``, ``schedule``) selects explicitly.  Over the
    ``hierarchical`` communicator each bucket whose inter-node saving
    clears the planner's threshold is reduced in three hops, with the
    codec on the inter-node hop only (``comm_wire.schedules``).

    ``double_buffering``: stale-by-one gradients
    (:class:`DoubleBufferingOptimizer`).  ``zero_redundancy``: ZeRO
    stage 1 (:class:`ZeroRedundancyOptimizer`).  ``overlap``:
    ``"none"`` or ``"bucket"`` (each bucket issued from the backward,
    ``comm_wire.overlap``; bit-identical to ``"none"``).  The JAX
    package's refusals hold: overlap or ZeRO with double buffering,
    error feedback with double buffering or ZeRO, int8 with ZeRO.
    ``tune_trace`` and ``profile`` (the autotuner) raise
    ``NotImplementedError``.
    """
    if tune_trace is not None:
        raise NotImplementedError(
            f"tuning the wire from a collective trace is not ported yet: "
            f"see {_WAITING}")
    if profile is not None:
        raise NotImplementedError(
            f"measured wire profiles are not ported yet: see {_WAITING}")
    if resolve_overlap(overlap) == "bucket" and double_buffering:
        raise ValueError(
            "overlap='bucket' cannot be combined with double_buffering: "
            "double buffering hides sync by applying one-step-stale "
            "gradients, the overlap engine hides it inside the same "
            "step with exact gradients — combining would pay staleness "
            "for nothing"
        )
    if zero_redundancy and double_buffering:
        raise ValueError(
            "zero_redundancy and double_buffering cannot be combined: "
            "double buffering stores full-width stale gradients, which "
            "defeats the sharded-state memory saving"
        )
    cfg = resolve_wire(wire, communicator)
    if cfg.error_feedback:
        if double_buffering:
            raise ValueError(
                "error_feedback cannot be combined with double_buffering: "
                "the residual would correct a gradient that is already "
                "one step stale by the time it ships"
            )
        if zero_redundancy:
            raise ValueError(
                "error_feedback is not supported on the zero_redundancy "
                "path (the residual of a reduce-scattered bucket lives "
                "on no single rank)"
            )
    if zero_redundancy and cfg.codec == "int8":
        raise ValueError(
            "int8 wire is not supported on the zero_redundancy path; "
            "use bf16/f16"
        )
    if zero_redundancy:
        cls = ZeroRedundancyOptimizer
    elif double_buffering:
        cls = DoubleBufferingOptimizer
    else:
        cls = MultiNodeOptimizer
    return cls(actual_optimizer, communicator, wire=cfg, overlap=overlap)


# ----------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------
def _dot_policy(batch_dims: bool):
    """A selective-checkpoint policy that saves the products (``dot_
    general`` in JAX): ``mm``/``addmm``, and with ``batch_dims`` also
    ``bmm``/``baddbmm``; everything else is recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    ops = {aten.mm.default, aten.addmm.default}
    if batch_dims:
        ops |= {aten.bmm.default, aten.baddbmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


#: the JAX ``checkpoint_policies`` names the port accepts for ``remat=``
REMAT_POLICIES = {
    "nothing_saveable": None,
    "dots_saveable": functools.partial(_dot_policy, True),
    "dots_with_no_batch_dims_saveable": functools.partial(_dot_policy, False),
}


def _resolve_remat(remat):
    """``remat=`` as ``(on, policy callable or None)``."""
    if remat is False or remat is None:
        return False, None
    if remat is True:
        return True, None
    if isinstance(remat, str):
        if remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat!r}; one of "
                             f"{sorted(REMAT_POLICIES)} or a PyTorch "
                             "selective-checkpoint policy callable")
        make = REMAT_POLICIES[remat]
        return True, (make() if make else None)
    if callable(remat):
        return True, remat
    raise ValueError(f"remat must be a bool, a policy name or a policy "
                     f"callable; got {remat!r}")


def _generators_in(fn) -> List[torch.Generator]:
    """The ``torch.Generator`` objects ``fn`` closes over (its closure
    cells, default arguments and a ``functools.partial``'s arguments)."""
    found = []
    values = []
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            values.append(cell.cell_contents)
        except ValueError:  # an empty cell
            pass
    values += list(getattr(fn, "__defaults__", None) or ())
    if isinstance(fn, functools.partial):
        values += list(fn.args) + list(fn.keywords.values())
    for v in values:
        if isinstance(v, torch.Generator) and v not in found:
            found.append(v)
    return found


class _Replay:
    """The contexts of one remat'd forward (``checkpoint``'s
    ``context_fn``): the forward records the explicit generators'
    states; the recompute replays them (``preserve_rng_state`` covers
    only the default generators) and puts ``model_state`` back as it
    found it, so running statistics update once."""

    def __init__(self, generators, model_state, policy):
        self.generators = list(generators)
        self.model_state = list(model_state)
        self.policy = policy
        self.states = []

    @contextlib.contextmanager
    def _forward(self, inner):
        self.states = [g.get_state() for g in self.generators]
        with inner:
            yield

    @contextlib.contextmanager
    def _recompute(self, inner):
        now = [g.get_state() for g in self.generators]
        kept = [t.detach().clone() for t in self.model_state]
        for g, s in zip(self.generators, self.states):
            g.set_state(s)
        try:
            with inner:
                yield
        finally:
            for g, s in zip(self.generators, now):
                g.set_state(s)
            with torch.no_grad():
                for t, k in zip(self.model_state, kept):
                    t.copy_(k)

    def __call__(self):
        if self.policy is not None:
            from torch.utils.checkpoint import (
                create_selective_checkpoint_contexts)

            fwd, rec = create_selective_checkpoint_contexts(self.policy)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return self._forward(fwd), self._recompute(rec)


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
def _split_batch(batch, accum_steps: int) -> list:
    """The batch's leaves split along dim 0 into ``accum_steps``
    microbatches (the JAX message for an indivisible batch)."""
    def size(leaf):
        b = leaf.shape[0]
        if b % accum_steps:
            raise ValueError(
                f"per-chip batch {b} not divisible by "
                f"accum_steps={accum_steps}")
        return b // accum_steps

    sizes = [size(leaf) for leaf in tree_leaves(batch)
             if isinstance(leaf, torch.Tensor) and leaf.dim()]
    if not sizes:
        return [batch] * accum_steps
    return [tree_map(lambda leaf: leaf[i * size(leaf):(i + 1) * size(leaf)]
                     if isinstance(leaf, torch.Tensor) and leaf.dim()
                     else leaf, batch)
            for i in range(accum_steps)]


class TrainStep:
    """One data-parallel training step, built by :func:`build_train_step`.

    ``step(batch) -> metrics``: zero the gradients; ``loss_fn`` and its
    backward on each of ``accum_steps`` microbatches of this rank's
    batch; then, under the non-finite guard, the optimizer's update
    (sync and step), then the mean of ``model_state`` over the ranks.
    ``metrics["loss"]`` is the loss averaged over the microbatches and
    the ranks (a 0-dim tensor on the loss's device, so reading it is the
    caller's choice); with a guard, ``metrics["grads_finite"]`` is 1.0 or
    0.0.
    """

    def __init__(self, comm, loss_fn, optimizer: MultiNodeOptimizer,
                 nonfinite, model_state, accum_steps=1, remat=False):
        self.comm = comm
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.nonfinite_policy = nonfinite
        self.model_state = list(model_state)
        self.accum_steps = accum_steps
        self.remat, self._policy = _resolve_remat(remat)
        self.generators = _generators_in(loss_fn)

    def _loss(self, batch):
        if not self.remat:
            return self.loss_fn(batch)
        from torch.utils.checkpoint import checkpoint

        return checkpoint(self.loss_fn, batch, use_reentrant=False,
                          context_fn=_Replay(self.generators,
                                             self.model_state,
                                             self._policy))

    def _zero_grads(self) -> None:
        opt = self.optimizer
        if self.accum_steps == 1:
            opt.zero_grad(set_to_none=True)
            return
        # the sum starts from zeros, as the JAX scan's carry does
        for p in opt.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()

    def _forward_backward(self, batch):
        """The loss (averaged over the microbatches) after every
        microbatch's backward into ``.grad``; ``model_state`` ends as
        the mean of the microbatches' states, each of which started
        from the step's state."""
        opt, a = self.optimizer, self.accum_steps
        if a == 1:
            opt.arm(True)
            loss = self._loss(batch)
            loss.backward()
            return loss.detach()
        start = [t.detach().clone() for t in self.model_state]
        loss_sum, state_sum = None, None
        for i, mb in enumerate(_split_batch(batch, a)):
            if i:
                with torch.no_grad():
                    for t, s in zip(self.model_state, start):
                        t.copy_(s)
            opt.arm(i == a - 1, a)
            loss = self._loss(mb)
            loss.backward()
            loss_sum = (loss.detach() if loss_sum is None
                        else loss_sum + loss.detach())
            if state_sum is None:
                state_sum = [t.detach().clone() for t in self.model_state]
            else:
                state_sum = [s + t if t.is_floating_point() else t.clone()
                             for s, t in zip(state_sum, self.model_state)]
        with torch.no_grad():
            for t, s in zip(self.model_state, state_sum):
                t.copy_(_div(s, a) if t.is_floating_point() else s)
            for p in opt.params:
                if p.grad is not None:
                    p.grad.copy_(_div(p.grad, a))
        return _div(loss_sum, a)

    def __call__(self, batch) -> dict:
        opt = self.optimizer
        opt.bcast_once()
        self._zero_grads()
        # a skipped step must leave the state as the forward found it
        saved = ([t.clone() for t in self.model_state]
                 if self.nonfinite_policy is not None else None)
        loss = self._forward_backward(batch)
        opt.finish_backward()
        extra = {}
        if self.nonfinite_policy is not None:
            finite = _all_finite(opt.params, self.comm)
            extra["grads_finite"] = float(finite)
            if not finite and self.nonfinite_policy != "warn":
                opt.discard_pending()
                with torch.no_grad():
                    for t, s in zip(self.model_state, saved):
                        t.copy_(s)
            if not finite and self.nonfinite_policy == "abort":
                raise StepDivergedError(
                    "non-finite gradients on some rank (nonfinite='abort'); "
                    "the update was not applied")
            if not finite and self.nonfinite_policy == "warn":
                warnings.warn("non-finite gradients: applying the update "
                              "anyway (nonfinite='warn')")
            apply = finite or self.nonfinite_policy == "warn"
        else:
            apply = True
        if apply:
            opt.update()
            if self.model_state:
                allreduce_mean_(self.model_state, self.comm)
        return {"loss": self.comm.allreduce(loss, "mean"), **extra}


def build_train_step(comm, loss_fn: Callable, optimizer: MultiNodeOptimizer,
                     *, nonfinite: Optional[str] = None,
                     model_state: Sequence[torch.Tensor] = (),
                     accum_steps: int = 1, remat=False) -> TrainStep:
    """Build the data-parallel training step (the counterpart of
    ``chainermn_tpu.optimizers.build_train_step``, optimizers.py:1060).

    ``loss_fn(batch) -> scalar loss`` on this rank's batch (it closes
    over the model).  ``optimizer``: from
    :func:`create_multi_node_optimizer`; it broadcasts the parameters on
    the first step and syncs the gradients.  A ``dummy`` communicator
    builds the same step with the gradient exchange left out.

    ``model_state``: tensors the forward updates in place, such as a
    model's BatchNorm running statistics (``[b for _, b in
    model.named_buffers()]``): after each update they are mean-reduced
    over the ranks (one all-reduce), so the carried state stays equal
    on every rank.  This is the JAX step's ``has_aux=True`` with a
    ``merge_aux`` that puts the reduced ``batch_stats`` back: the state
    is folded in after the optimizer's update, never through it.  (The
    JAX step also plans ``batch_stats`` into the wire as zero-gradient
    leaves; build the optimizer over ``models.flax_ordered_parameters``
    for the same buckets.)

    ``accum_steps``: gradient accumulation.  Every batch leaf is split
    along dim 0 into this many microbatches, each microbatch's backward
    adds into ``.grad`` (from zeros, in order, as the JAX scan sums);
    the gradients and the loss are divided by the step count (a true
    divide) and synced once.  ``model_state`` follows the JAX aux rule:
    every microbatch's forward starts from the state the step began
    with, and the step's state is the mean of the microbatches' states.

    ``remat``: the loss recomputed in the backward
    (``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, JAX's
    ``jax.checkpoint``).  ``True`` or ``"nothing_saveable"`` saves
    nothing; ``"dots_saveable"`` and ``"dots_with_no_batch_dims_
    saveable"`` save the matrix products
    (``create_selective_checkpoint_contexts``); a PyTorch
    selective-checkpoint policy callable is passed through.  The
    recompute replays the ``torch.Generator`` objects in ``loss_fn``'s
    closure (``preserve_rng_state`` covers only the default ones), so
    dropout draws the forward's mask again; a generator the loss reaches
    another way, such as a module attribute, is not replayed, so keep it
    in the closure.  The recompute also puts ``model_state`` back as it
    found it, so running statistics update once a microbatch.

    ``nonfinite``: ``None`` (off), ``"skip"`` (an agreed no-op step when
    any rank's gradients are non-finite; ``model_state`` is put back as
    it was before the forward, and the wire's error-feedback residual
    and the double-buffering buffer stay as they were, since the update
    does not run), ``"abort"`` (raise
    :class:`~chainermn_tpu_torch.resilience.StepDivergedError` without
    updating) or ``"warn"`` (apply anyway, with a warning).  The flag is
    agreed by a min-reduce over every rank.
    """
    if nonfinite not in NONFINITE_POLICIES:
        raise ValueError(f"nonfinite must be None, 'skip', 'abort' or "
                         f"'warn'; got {nonfinite!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if not isinstance(optimizer, MultiNodeOptimizer):
        raise TypeError("build_train_step takes the optimizer of "
                        "create_multi_node_optimizer, got "
                        f"{type(optimizer).__name__}")
    _resolve_remat(remat)
    return TrainStep(comm, loss_fn, optimizer, nonfinite, model_state,
                     accum_steps, remat)
