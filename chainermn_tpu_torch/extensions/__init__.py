"""Trainer extensions of the multi-node kind (port of
``chainermn_tpu/extensions``): the multi-node evaluator and the
all-reduce of persistent state.  The checkpointer waits (ROADMAP Queue
1, "Checkpoints and the input pipeline")."""

from .allreduce_persistent import AllreducePersistent, allreduce_mean_
from .evaluator import Evaluator, create_multi_node_evaluator

__all__ = ["AllreducePersistent", "Evaluator", "allreduce_mean_",
           "create_multi_node_evaluator"]
