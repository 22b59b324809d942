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
buckets (``comm_wire.planner``) and reduces each bucket with one
all-reduce (``comm_wire.codecs.reduce_buckets``), then writes the means
back into ``.grad``.  Build the optimizer over a TransformerLM's
parameters in flax's order (``models.convert.flax_ordered_parameters``)
and its buckets have the JAX plan's layout.

ZeRO, double buffering, overlap, autotuning, ``accum_steps`` and remat
wait (ROADMAP Queue 1, "Optimizer, tier 2").
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Sequence

import torch

from .comm_wire import (
    flatten_to_buckets,
    plan_of_tree,
    reduce_buckets,
    resolve_wire,
    unflatten_from_buckets,
)
from .extensions.allreduce_persistent import allreduce_mean_
from .resilience.errors import StepDivergedError

NONFINITE_POLICIES = (None, "skip", "abort", "warn")


def _params_of(optimizer: torch.optim.Optimizer) -> List[torch.nn.Parameter]:
    return [p for group in optimizer.param_groups for p in group["params"]]


@torch.no_grad()
def _sync_grads(params, comm, wire) -> None:
    """Mean every parameter's gradient over the communicator through the
    bucketed wire, in place: flatten the gradients into the plan's
    buckets, one all-reduce per bucket, unflatten into ``.grad``.  A
    parameter without a gradient contributes zeros (every rank must
    send the same buckets)."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    plan = plan_of_tree(grads, wire.bucket_bytes, wire.max_buckets)
    means = reduce_buckets(flatten_to_buckets(plan, grads), comm.size, wire,
                           group=getattr(comm, "_group", None))
    for p, g in zip(params, unflatten_from_buckets(plan, means)):
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)


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
    """

    def __init__(self, actual_optimizer: torch.optim.Optimizer, comm,
                 wire="auto"):
        self.actual_optimizer = actual_optimizer
        self.communicator = comm
        self.wire = resolve_wire(wire, comm)
        self._needs_bcast = True

    def __getattr__(self, name):
        # only reached for names this class does not define
        return getattr(self.__dict__["actual_optimizer"], name)

    @property
    def params(self) -> List[torch.nn.Parameter]:
        """The wrapped optimizer's parameters, in the wire's order."""
        return _params_of(self.actual_optimizer)

    def wire_plan(self):
        """The bucket plan the sync uses for these parameters."""
        return plan_of_tree(self.params, self.wire.bucket_bytes,
                            self.wire.max_buckets)

    @torch.no_grad()
    def bcast_once(self) -> None:
        """Broadcast rank 0's parameters, the first time only."""
        if self._needs_bcast:
            for p in self.params:
                p.copy_(self.communicator.bcast(p, root=0))
            self._needs_bcast = False

    def sync_grads(self) -> None:
        if not self.communicator.no_exchange:
            _sync_grads(self.params, self.communicator, self.wire)

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
    bfloat16 -> ``bf16``, float16 -> ``f16``); a codec name or a
    ``comm_wire.WireConfig`` selects explicitly.
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
    it was before the forward), ``"abort"`` (raise
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
