"""Multi-node optimizer and the data-parallel train step.

Port of ``chainermn_tpu/optimizers.py``'s main path:
``create_multi_node_optimizer`` (optimizers.py:906), the bucketed
gradient sync ``_sync_grads`` / ``_sync_grads_wire`` (:134, :101) and
``build_train_step`` (:1060) with its non-finite guard
(``_guarded_apply``, :1299), and its model-state form
(``has_aux=True, merge_aux=...``, :1072-1100): running statistics that
the forward updates are mean-reduced over the ranks after the update.

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

ZeRO, double buffering, overlap, autotuning, ``accum_steps`` and remat
wait (ROADMAP Queue 1, "Optimizer, tier 2").
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Sequence

import torch

from .comm_wire import (
    flatten_to_buckets,
    plan_wire,
    reduce_wire,
    resolve_wire,
    unflatten_from_buckets,
    uses_error_feedback,
    zero_residuals_wire,
)
from .extensions.allreduce_persistent import allreduce_mean_
from .resilience.errors import StepDivergedError

NONFINITE_POLICIES = (None, "skip", "abort", "warn")


def _params_of(optimizer: torch.optim.Optimizer) -> List[torch.nn.Parameter]:
    return [p for group in optimizer.param_groups for p in group["params"]]


@torch.no_grad()
def _sync_grads(params, comm, wire, residuals=None) -> list:
    """Mean every parameter's gradient over the communicator through the
    scheduled wire, in place: flatten the gradients into the plan's
    buckets, reduce each under its schedule, unflatten into ``.grad``.
    A parameter without a gradient contributes zeros (every rank must
    send the same buckets).  Returns the new error-feedback residuals
    (``[]`` without error feedback)."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    wplan = plan_wire(grads, wire, comm)
    means, new_res = reduce_wire(
        flatten_to_buckets(wplan.plan, grads), wplan, comm.size, wire,
        residuals, group=getattr(comm, "_group", None),
        groups=comm.wire_groups)
    for p, g in zip(params, unflatten_from_buckets(wplan.plan, means)):
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
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
    """

    def __init__(self, actual_optimizer: torch.optim.Optimizer, comm,
                 wire="auto"):
        self.actual_optimizer = actual_optimizer
        self.communicator = comm
        self.wire = resolve_wire(wire, comm)
        self._needs_bcast = True
        self.wire_residual: List[torch.Tensor] = []
        if uses_error_feedback(self.wire):
            params = self.params
            self.wire_residual = zero_residuals_wire(
                self.wire_plan(), params[0].device if params else None)

    def __getattr__(self, name):
        # only reached for names this class does not define
        return getattr(self.__dict__["actual_optimizer"], name)

    @property
    def params(self) -> List[torch.nn.Parameter]:
        """The wrapped optimizer's parameters, in the wire's order."""
        return _params_of(self.actual_optimizer)

    def wire_plan(self):
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

    def sync_grads(self) -> None:
        if not self.communicator.no_exchange:
            self.wire_residual = _sync_grads(
                self.params, self.communicator, self.wire, self.wire_residual)

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
        self.sync_grads()
        return self.actual_optimizer.step(closure)


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator, wire="auto") -> MultiNodeOptimizer:
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
    """
    return MultiNodeOptimizer(actual_optimizer, communicator, wire=wire)


class TrainStep:
    """One data-parallel training step, built by :func:`build_train_step`.

    ``step(batch) -> metrics``: zero the gradients, ``loss_fn(batch)``
    and its backward on this rank's batch, then, under the non-finite
    guard, the optimizer's gradient sync and update, then the mean of
    ``model_state`` over the ranks.  ``metrics["loss"]`` is the loss
    averaged over the ranks (a 0-dim tensor on the loss's device, so
    reading it is the caller's choice); with a guard,
    ``metrics["grads_finite"]`` is 1.0 or 0.0.
    """

    def __init__(self, comm, loss_fn, optimizer: MultiNodeOptimizer,
                 nonfinite, model_state):
        self.comm = comm
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.nonfinite_policy = nonfinite
        self.model_state = list(model_state)

    def __call__(self, batch) -> dict:
        opt = self.optimizer
        opt.bcast_once()
        opt.zero_grad(set_to_none=True)
        # a skipped step must leave the state as the forward found it
        saved = ([t.clone() for t in self.model_state]
                 if self.nonfinite_policy is not None else None)
        loss = self.loss_fn(batch)
        loss.backward()
        extra = {}
        if self.nonfinite_policy is not None:
            finite = _all_finite(opt.params, self.comm)
            extra["grads_finite"] = float(finite)
            if not finite and self.nonfinite_policy != "warn":
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
            opt.sync_grads()
            opt.actual_optimizer.step()
            if self.model_state:
                allreduce_mean_(self.model_state, self.comm)
        return {"loss": self.comm.allreduce(loss.detach(), "mean"), **extra}


def build_train_step(comm, loss_fn: Callable, optimizer: MultiNodeOptimizer,
                     *, nonfinite: Optional[str] = None,
                     model_state: Sequence[torch.Tensor] = ()) -> TrainStep:
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

    ``nonfinite``: ``None`` (off), ``"skip"`` (an agreed no-op step when
    any rank's gradients are non-finite; ``model_state`` is put back as
    it was before the forward, and the wire's error-feedback residual
    stays as it was, since the sync does not run), ``"abort"`` (raise
    :class:`~chainermn_tpu_torch.resilience.StepDivergedError` without
    updating) or ``"warn"`` (apply anyway, with a warning).  The flag is
    agreed by a min-reduce over every rank.
    """
    if nonfinite not in NONFINITE_POLICIES:
        raise ValueError(f"nonfinite must be None, 'skip', 'abort' or "
                         f"'warn'; got {nonfinite!r}")
    if not isinstance(optimizer, MultiNodeOptimizer):
        raise TypeError("build_train_step takes the optimizer of "
                        "create_multi_node_optimizer, got "
                        f"{type(optimizer).__name__}")
    return TrainStep(comm, loss_fn, optimizer, nonfinite, model_state)
