"""Models: the TransformerLM and its flax weight carrier."""

from .convert import flax_ordered_parameters, lm_params_from_flax
from .transformer import MlpBlock, TransformerLM, lm_loss

__all__ = ["MlpBlock", "TransformerLM", "flax_ordered_parameters", "lm_loss",
           "lm_params_from_flax"]
