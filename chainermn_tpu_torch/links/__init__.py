"""Links (port of ``chainermn_tpu/links``): synchronized BatchNorm and
its model converter, and the multi-node N-step RNN of the model-parallel
seq2seq."""

from .create_mnbn_model import create_mnbn_model, mnbn_factory
from .multi_node_batch_normalization import MultiNodeBatchNormalization
from .n_step_rnn import (LSTMStack, MultiNodeNStepRNN,
                         create_multi_node_n_step_rnn)

__all__ = ["LSTMStack", "MultiNodeBatchNormalization", "MultiNodeNStepRNN",
           "create_mnbn_model", "create_multi_node_n_step_rnn",
           "mnbn_factory"]
