"""Models: the TransformerLM, the MNIST MLP, the ImageNet example's
architectures (the ResNet family, VGG16, AlexNet, NIN, GoogLeNet and
GoogLeNetBN), the seq2seq encoder-decoder, and their flax weight
carriers."""

from .alexnet import AlexNet
from .convert import (
    alexnet_params_from_flax,
    flax_leaf_specs,
    flax_ordered_parameters,
    googlenet_params_from_flax,
    lm_params_from_flax,
    mlp_params_from_flax,
    nin_params_from_flax,
    resnet_params_from_flax,
    seq2seq_params_from_flax,
    vgg16_params_from_flax,
)
from .googlenet import GoogLeNet, GoogLeNetBN, Inception
from .mlp import MLP
from .nin import NIN
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
from .seq2seq import (Decoder, Encoder, Seq2Seq, seq2seq_loss,
                      seq2seq_metrics, teacher_forcing, translate)
from .vgg import VGG16

__all__ = ["AlexNet", "BasicBlock", "BatchNorm", "Bottleneck", "Decoder",
           "Encoder", "GoogLeNet", "GoogLeNetBN", "Inception", "MLP",
           "MlpBlock", "NIN", "ResNet", "ResNet18", "ResNet50", "ResNet101",
           "Seq2Seq", "TransformerLM", "VGG16", "alexnet_params_from_flax",
           "default_norm", "flax_leaf_specs", "flax_ordered_parameters",
           "googlenet_params_from_flax", "lm_loss", "lm_params_from_flax",
           "mlp_params_from_flax", "nin_params_from_flax",
           "resnet_params_from_flax", "seq2seq_loss", "seq2seq_metrics",
           "seq2seq_params_from_flax", "teacher_forcing", "translate",
           "vgg16_params_from_flax"]
