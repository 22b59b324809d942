"""Models: the TransformerLM and its flax weight carrier."""

from .convert import lm_params_from_flax
from .transformer import MlpBlock, TransformerLM

__all__ = ["MlpBlock", "TransformerLM", "lm_params_from_flax"]
