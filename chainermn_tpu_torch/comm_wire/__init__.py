"""The gradient wire: bucket planner, codecs, collective schedules and
the bucket overlap (port of ``chainermn_tpu/comm_wire``'s planner,
codecs, the analytic half of its schedules and the contract of its
overlap engine)."""

from .codecs import (
    CODECS,
    WireConfig,
    codec_of_dtype,
    reduce_buckets,
    resolve_wire,
    storage_dtype,
    uses_error_feedback,
)
from .overlap import OVERLAP_MODES, BucketIssue, BucketOverlap, resolve_overlap
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
from .schedules import (
    GRAD_SCHEDULES,
    MIN_HIER_INTER_SAVINGS,
    AxisSplit,
    WirePlan,
    axis_split,
    hier_inter_savings,
    mesh_axis_sizes,
    plan_wire,
    reduce_wire,
    schedule_for_bucket,
    zero_residuals_wire,
)

__all__ = [
    "AxisSplit", "Bucket", "BucketIssue", "BucketOverlap", "BucketPlan",
    "CODECS", "DEFAULT_BUCKET_BYTES", "DEFAULT_MAX_BUCKETS",
    "GRAD_SCHEDULES", "LeafSlot", "MIN_HIER_INTER_SAVINGS", "OVERLAP_MODES",
    "WireConfig", "WirePlan", "axis_split", "codec_of_dtype",
    "flatten_to_buckets", "hier_inter_savings", "make_plan",
    "mesh_axis_sizes", "plan_of_tree", "plan_wire", "reduce_buckets",
    "reduce_wire", "resolve_overlap", "resolve_wire", "schedule_for_bucket",
    "storage_dtype", "unflatten_from_buckets", "uses_error_feedback",
    "zero_residuals_wire",
]
