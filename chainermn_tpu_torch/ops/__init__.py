"""Ops: attention cores, losses and the hand-written CUDA kernels.

Kernels build at first launch (``_build``), never at import.  The
function ``flash_attention`` is ``ops.flash_attention.flash_attention``:
here ``ops.flash_attention`` names its module, as ``ops.fused_cast_scale``
and ``ops.losses`` name theirs.
"""

from .attention import multi_head_attention
from .flash_attention import (
    block_census,
    dense_attention_with_lse,
    flash_attention_fn,
    flash_attention_with_lse,
)
from .flash_decode import flash_decode, paged_decode_reference

__all__ = ["block_census", "dense_attention_with_lse", "flash_attention_fn",
           "flash_attention_with_lse", "flash_decode", "multi_head_attention",
           "paged_decode_reference"]
