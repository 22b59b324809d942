"""Ops: attention cores and the hand-written CUDA kernels.

Kernels build at first launch (``_build``), never at import.
"""

from .attention import multi_head_attention
from .flash_decode import flash_decode, paged_decode_reference

__all__ = ["flash_decode", "multi_head_attention", "paged_decode_reference"]
