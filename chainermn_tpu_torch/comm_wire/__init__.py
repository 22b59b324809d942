"""The gradient wire: bucket planner and cast codecs (port of
``chainermn_tpu/comm_wire``'s planner and codecs)."""

from .codecs import CODECS, WireConfig, codec_of_dtype, reduce_buckets, resolve_wire
from .planner import (
    DEFAULT_BUCKET_BYTES,
    DEFAULT_MAX_BUCKETS,
    Bucket,
    BucketPlan,
    LeafSlot,
    flatten_to_buckets,
    make_plan,
    plan_of_tree,
    unflatten_from_buckets,
)

__all__ = [
    "Bucket", "BucketPlan", "CODECS", "DEFAULT_BUCKET_BYTES",
    "DEFAULT_MAX_BUCKETS", "LeafSlot", "WireConfig", "codec_of_dtype",
    "flatten_to_buckets", "make_plan", "plan_of_tree", "reduce_buckets",
    "resolve_wire", "unflatten_from_buckets",
]
