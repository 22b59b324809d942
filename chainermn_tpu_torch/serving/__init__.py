"""Serving tier: paged KV cache, decode engine, continuous batching."""

from .batcher import ContinuousBatcher, Request
from .decode import DecodeEngine, PagedLM
from .kv_cache import (
    NULL_PAGE,
    CacheAdmissionError,
    PagedKVCache,
    PrefixMatch,
    pages_needed,
)

__all__ = [
    "CacheAdmissionError", "ContinuousBatcher", "DecodeEngine",
    "NULL_PAGE", "PagedKVCache", "PagedLM", "PrefixMatch", "Request",
    "pages_needed",
]
