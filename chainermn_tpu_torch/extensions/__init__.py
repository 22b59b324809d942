"""Trainer extensions of the multi-node kind (port of
``chainermn_tpu/extensions``): the multi-node evaluator, the all-reduce
of persistent state and the multi-node checkpointer."""

from .allreduce_persistent import AllreducePersistent, allreduce_mean_
from .checkpoint import create_multi_node_checkpointer
from .evaluator import Evaluator, create_multi_node_evaluator

__all__ = ["AllreducePersistent", "Evaluator", "allreduce_mean_",
           "create_multi_node_checkpointer", "create_multi_node_evaluator"]
