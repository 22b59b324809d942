"""Multi-node evaluator (port of
``chainermn_tpu/extensions/evaluator.py``; ChainerMN's
``create_multi_node_evaluator``): each rank evaluates its own
validation shard and the metrics are mean-reduced over the ranks, so
every rank reports the global numbers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..training.trainer import to_device


class Evaluator:
    """Runs ``metric_fn(batch) -> {name: scalar}`` over the batches of
    ``iterator_factory()`` (a fresh pass each time, batches moved to the
    communicator's device), without gradients and, if
    ``model`` is given, in its eval mode (restored after).  Reports
    ``prefix + name``: the mean over the batches, then over the ranks
    (one all-reduce).  Ranks with equal shards (``scatter_dataset``)
    evaluate equally many batches, so this is the JAX evaluator's mean
    over the batches of the rank-averaged metrics."""

    trigger = (1, "epoch")
    priority = 300
    name = "validation"

    def __init__(self, iterator_factory: Callable, metric_fn: Callable,
                 comm, *, model: Optional[torch.nn.Module] = None,
                 prefix: str = "val/"):
        self._make_iterator = iterator_factory
        self._metric_fn = metric_fn
        self._comm = comm
        self._model = model
        self._device = torch.device(comm.device)
        self._prefix = prefix

    def evaluate(self) -> Dict[str, float]:
        keys, total, count = None, None, 0
        training = self._model.training if self._model is not None else None
        if self._model is not None:
            self._model.eval()
        try:
            with torch.no_grad():
                for batch in self._make_iterator():
                    out = self._metric_fn(to_device(batch, self._device))
                    keys = keys or list(out)
                    vals = torch.stack([torch.as_tensor(out[k]).to(
                        self._device, torch.float64) for k in keys])
                    total = vals if total is None else total + vals
                    count += 1
        finally:
            if self._model is not None:
                self._model.train(training)
        if keys is None:
            return {}
        means = self._comm.allreduce(total / count, "mean")
        return {self._prefix + k: float(v)
                for k, v in zip(keys, means.tolist())}

    def __call__(self, trainer) -> Dict[str, float]:
        result = self.evaluate()
        trainer.observation.update(result)
        return result


def create_multi_node_evaluator(actual_evaluator, communicator):
    """Make an evaluator report rank-averaged metrics (parity:
    ``chainermn.create_multi_node_evaluator(evaluator, comm)``).  This
    module's :class:`Evaluator` already is, and is returned as is; any
    other object with ``evaluate() -> dict`` is wrapped so that its
    dict is averaged over the ranks."""
    if isinstance(actual_evaluator, Evaluator):
        return actual_evaluator
    return _MultiNodeEvaluator(actual_evaluator, communicator)


class _MultiNodeEvaluator:
    def __init__(self, evaluator, comm):
        self._ev = evaluator
        self._comm = comm

    def evaluate(self, *args, **kwargs) -> Dict[str, float]:
        gathered = self._comm.allgather_obj(self._ev.evaluate(*args, **kwargs))
        return {k: float(np.mean([g[k] for g in gathered]))
                for k in gathered[0]}

    def __call__(self, trainer) -> Dict[str, float]:
        result = self.evaluate()
        trainer.observation.update(result)
        return result

    def __getattr__(self, name):
        return getattr(self._ev, name)
