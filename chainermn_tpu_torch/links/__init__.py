"""Links (port of ``chainermn_tpu/links``): synchronized BatchNorm and
the model converter.  ``MultiNodeNStepRNN`` waits for ROADMAP Queue 1
'Model parallelism'."""

from .create_mnbn_model import create_mnbn_model, mnbn_factory
from .multi_node_batch_normalization import MultiNodeBatchNormalization

__all__ = ["MultiNodeBatchNormalization", "create_mnbn_model",
           "mnbn_factory"]
