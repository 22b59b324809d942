"""Models: the TransformerLM, the MNIST MLP, the ResNet family, and their
flax weight carriers."""

from .convert import (
    flax_leaf_specs,
    flax_ordered_parameters,
    lm_params_from_flax,
    mlp_params_from_flax,
    resnet_params_from_flax,
)
from .mlp import MLP
from .resnet import (
    BasicBlock,
    BatchNorm,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet50,
    ResNet101,
    default_norm,
)
from .transformer import MlpBlock, TransformerLM, lm_loss

__all__ = ["BasicBlock", "BatchNorm", "Bottleneck", "MLP", "MlpBlock",
           "ResNet", "ResNet18", "ResNet50", "ResNet101", "TransformerLM",
           "default_norm", "flax_leaf_specs", "flax_ordered_parameters",
           "lm_loss", "lm_params_from_flax", "mlp_params_from_flax",
           "resnet_params_from_flax"]
