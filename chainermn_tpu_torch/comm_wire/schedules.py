"""Topology-aware collective schedules for the gradient wire.

Port of the analytic half of ``chainermn_tpu/comm_wire/schedules.py``.
A bucket is reduced under one of two schedules:

==========  ===========================================================
schedule    collectives per bucket
==========  ===========================================================
flat        one all-reduce over every rank (``codecs.reduce_buckets``).
hier_rs_ag  a full-precision reduce-scatter over the intra-node group,
            the codec's all-reduce over the inter-node group on the
            1/K shard (the codec, and the error-feedback residual,
            apply to this hop only; int8 adds one MAX all-reduce over
            the inter group for all such buckets), then an all-gather
            over the intra-node group.
==========  ===========================================================

The choice is a pure function of the bucket's bytes, the communicator's
sync axes and their sizes, and the requested schedule: a communicator
states its axes as the JAX package's mesh names them (``("mn",)`` for
the flat communicators, ``("mn_inter", "mn_intra")`` for the
hierarchical one), so the port plans, and hashes, as the reference does
(``WirePlan.plan_hash`` is byte for byte the JAX package's).  ``auto``
stages a bucket when the ring formula's inter-hop saving reaches
:data:`MIN_HIER_INTER_SAVINGS`.  Without a genuine split (flat names, or
either axis of width 1, as on one node or on the ragged fallback) every
bucket plans ``flat``; an explicit ``hier_rs_ag`` then warns once.

Left for ROADMAP Queue 1 'Optimizer, tier 2': the autotuner, that is
decisions from a measured ``BandwidthProfile`` (``profile=``), and the
``bcast_tree`` broadcast.
"""

from __future__ import annotations

import hashlib
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .codecs import (
    _CAST_WIRE,
    WireConfig,
    int8_scales,
    reduce_buckets,
    reduce_cast,
    reduce_int8,
    uses_error_feedback,
)
from .planner import Bucket, BucketPlan, _itemsize, plan_of_tree

#: schedules selectable per gradient bucket (``WireConfig.schedule``)
GRAD_SCHEDULES = ("flat", "hier_rs_ag")

#: inter-hop wire bytes the hier schedule must save for its two extra
#: intra-node launches to pay (the JAX package's threshold)
MIN_HIER_INTER_SAVINGS = 64 * 1024

_WAITING = ("ROADMAP Queue 1 'Optimizer, tier 2' (the autotuner: "
            "BandwidthProfile and the measured schedules and bucket sizes; "
            "the bcast_tree broadcast)")


def _refuse_profile(profile) -> None:
    if profile is not None:
        raise NotImplementedError(
            f"measured wire profiles are not ported yet: see {_WAITING}")


def bcast_tree_stages(axes, axis_sizes):
    """The two-stage broadcast schedule: not ported yet."""
    raise NotImplementedError(
        f"the bcast_tree schedule is not ported yet: see {_WAITING}")


class AxisSplit(NamedTuple):
    """The hierarchical factorization of a sync-axis tuple: exactly one
    inter-named axis and one intra-named axis, both wider than 1."""

    inter: str
    intra: str
    inter_size: int
    intra_size: int

    @property
    def world(self) -> int:
        return self.inter_size * self.intra_size


def _axis_kind(name: str) -> str:
    name = str(name)
    if "inter" in name:
        return "inter"
    if "intra" in name:
        return "intra"
    return "flat"


def axis_split(axes: Sequence[str],
               axis_sizes: Sequence[int]) -> Optional[AxisSplit]:
    """Split ``axes`` into the (inter, intra) pair a multi-hop schedule
    stages over, or ``None`` when there is no genuine split (a flat
    axis name, a missing half, or either axis of width <= 1)."""
    inter = intra = None
    for a, s in zip(axes, axis_sizes):
        kind = _axis_kind(a)
        if kind == "inter":
            if inter is not None:
                return None
            inter = (str(a), int(s))
        elif kind == "intra":
            if intra is not None:
                return None
            intra = (str(a), int(s))
        else:
            return None
    if inter is None or intra is None or inter[1] <= 1 or intra[1] <= 1:
        return None
    return AxisSplit(inter[0], intra[0], inter[1], intra[1])


def mesh_axis_sizes(mesh, axes: Sequence[str]) -> Tuple[int, ...]:
    """Size per axis name from a communicator (its ``mesh_shape``) or an
    axis -> size mapping; unknown axes size 0."""
    shape = dict(getattr(mesh, "mesh_shape", mesh))
    return tuple(int(shape.get(a, 0)) for a in axes)


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(str(a) for a in dict(getattr(mesh, "mesh_shape", mesh)))


def _payload_bytes_of(record) -> int:
    """Payload bytes of a planner :class:`Bucket` or a plain int."""
    if isinstance(record, Bucket):
        return int(record.size) * _itemsize(record.dtype)
    return int(record)


def hier_inter_savings(payload_bytes: int, split: AxisSplit) -> int:
    """Inter-hop wire bytes per rank that the hier schedule saves over
    the flat ring: ``2p(n-1)/n`` against ``2(p/K)(I-1)/I``."""
    p = int(payload_bytes)
    n = split.world
    flat_inter = 2 * p * (n - 1) // n
    shard = -(-p // split.intra_size)
    hier_inter = 2 * shard * (split.inter_size - 1) // split.inter_size
    return flat_inter - hier_inter


def schedule_for_bucket(record, mesh, axes: Optional[Sequence[str]] = None,
                        requested: str = "auto", profile=None) -> str:
    """The schedule of one bucket (a planner :class:`Bucket` or payload
    bytes) over ``mesh``'s ``axes`` (a communicator or an axis -> size
    mapping; every axis by default): ``flat`` without a genuine split
    or when asked for, ``hier_rs_ag`` when asked for, and under
    ``auto`` when the inter-hop saving reaches
    :data:`MIN_HIER_INTER_SAVINGS`."""
    _refuse_profile(profile)
    if requested not in ("auto",) + GRAD_SCHEDULES:
        raise ValueError(
            f"unknown schedule {requested!r}; one of "
            f"{('auto',) + GRAD_SCHEDULES}"
        )
    axes = _axis_names(mesh) if axes is None else tuple(str(a) for a in axes)
    split = axis_split(axes, mesh_axis_sizes(mesh, axes))
    if split is None or requested == "flat":
        return "flat"
    if requested == "hier_rs_ag":
        return "hier_rs_ag"
    if hier_inter_savings(_payload_bytes_of(record),
                          split) >= MIN_HIER_INTER_SAVINGS:
        return "hier_rs_ag"
    return "flat"


class WirePlan(NamedTuple):
    """A :class:`BucketPlan`, the schedule of each bucket, and the sync
    axes and sizes the schedules were decided against.  ``plan_hash()``
    covers all three, byte for byte as the JAX package's does."""

    plan: BucketPlan
    schedules: Tuple[str, ...]
    axes: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def buckets(self):
        return self.plan.buckets

    @property
    def n_buckets(self) -> int:
        return self.plan.n_buckets

    @property
    def n_leaves(self) -> int:
        return self.plan.n_leaves

    def split(self) -> Optional[AxisSplit]:
        return axis_split(self.axes, self.axis_sizes)

    def padded_size(self, i: int) -> int:
        """Bucket ``i``'s element count padded up to the intra width (a
        reduce-scatter needs an even split; the zero tail is sliced off
        after the all-gather)."""
        b = self.plan.buckets[i]
        if self.schedules[i] != "hier_rs_ag":
            return b.size
        k = self.split().intra_size
        return -(-b.size // k) * k

    def shard_size(self, i: int) -> int:
        """Bucket ``i``'s length between the intra reduce-scatter and the
        intra all-gather: the inter hop's payload, and the shape of its
        error-feedback residual."""
        if self.schedules[i] != "hier_rs_ag":
            return self.plan.buckets[i].size
        return self.padded_size(i) // self.split().intra_size

    def schedule_census(self) -> Dict[str, int]:
        """``{schedule: bucket count}``."""
        out: Dict[str, int] = {}
        for s in self.schedules:
            out[s] = out.get(s, 0) + 1
        return out

    def plan_hash(self) -> str:
        h = hashlib.sha256()
        h.update(self.plan.plan_hash().encode())
        h.update(("|sched=" + ",".join(self.schedules)).encode())
        h.update(("|axes=" + ",".join(
            f"{a}:{s}" for a, s in zip(self.axes, self.axis_sizes)
        )).encode())
        return h.hexdigest()

    def describe(self) -> str:
        return " ".join(
            f"[{i}]{b.dtype}x{b.size}:{s}"
            for i, (b, s) in enumerate(zip(self.plan.buckets,
                                           self.schedules))
        )


def plan_wire(leaves, wire: WireConfig, mesh,
              axes: Optional[Sequence[str]] = None,
              profile=None) -> WirePlan:
    """Plan the buckets of ``leaves`` (ordered tensors or ``(shape,
    dtype)`` pairs) and each bucket's schedule over ``mesh``'s ``axes``
    (a communicator or an axis -> size mapping).  An explicit
    ``wire.schedule="hier_rs_ag"`` without a genuine split plans every
    bucket ``flat`` with one warning."""
    _refuse_profile(profile)
    axes = _axis_names(mesh) if axes is None else tuple(str(a) for a in axes)
    sizes = mesh_axis_sizes(mesh, axes)
    plan = plan_of_tree(leaves, wire.bucket_bytes, wire.max_buckets)
    requested = getattr(wire, "schedule", "auto") or "auto"
    if requested == "hier_rs_ag" and axis_split(axes, sizes) is None:
        warnings.warn(
            "wire schedule 'hier_rs_ag' requested but the sync axes "
            f"{axes} (sizes {sizes}) carry no genuine (inter, intra) "
            "split — a width-1 'mn_inter' axis (ragged-topology "
            "fallback) or a flat mesh cannot stage; collapsing every "
            "bucket to the 'flat' schedule."
        )
    mapping = dict(zip(axes, sizes))
    scheds = tuple(schedule_for_bucket(b, mapping, axes=axes,
                                       requested=requested)
                   for b in plan.buckets)
    return WirePlan(plan=plan, schedules=scheds, axes=axes, axis_sizes=sizes)


def zero_residuals_wire(wplan: WirePlan, device=None) -> List[torch.Tensor]:
    """Zero error-feedback carry for ``wplan``: the full bucket for a
    flat bucket, the shard for a ``hier_rs_ag`` one (the residual lives
    where the codec rounds, on the inter hop's payload)."""
    return [torch.zeros(wplan.shard_size(i), dtype=getattr(torch, b.dtype),
                        device=device)
            for i, b in enumerate(wplan.buckets)]


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the sum of ``x`` over ``group``, at full
    precision.  gloo has no reduce-scatter: there it is an all-reduce
    and a chunk, as ``CommunicatorBase.reduce_scatter`` does."""
    k = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        out = torch.empty(x.numel() // k, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    w = x.clone()
    dist.all_reduce(w, group=group)
    return w.chunk(k)[dist.get_rank(group)].clone()


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def _reduce_hier(items, wplan: WirePlan, n: int, config: WireConfig,
                 residuals, groups) -> Tuple[dict, dict]:
    """The ``hier_rs_ag`` buckets (``items``: ``(plan index, bucket)``)
    in three hops: a zero-padded full-precision reduce-scatter over the
    intra group, plus the carried residual; the codec's all-reduce over
    the inter group, decoded and mean-divided in the native dtype (int8:
    one MAX all-reduce over the inter group for all of them first); an
    all-gather over the intra group, the pad sliced off."""
    intra, inter = groups
    codec = config.codec
    ef = uses_error_feedback(config)

    locals_ = []
    for i, g in items:
        pad = wplan.padded_size(i) - g.shape[0]
        gp = torch.nn.functional.pad(g, (0, pad)) if pad else g
        local = _reduce_scatter(gp, intra)
        if residuals is not None:
            local = local + residuals[i].to(local.dtype)
        locals_.append(local)

    if codec == "int8":
        scales = int8_scales(locals_, inter)
        pairs = [reduce_int8(local, scales[k], n, ef, inter)
                 for k, local in enumerate(locals_)]
    else:
        pairs = [reduce_cast(local, _CAST_WIRE.get(codec), n, ef, inter)
                 for local in locals_]
    means, new_res = {}, {}
    for (i, g), (shard_mean, res) in zip(items, pairs):
        means[i] = _all_gather(shard_mean, intra)[:g.shape[0]]
        if res is not None:
            new_res[i] = res
    return means, new_res


def reduce_wire_items(items: Dict[int, torch.Tensor], wplan: WirePlan, n: int,
                      config: WireConfig,
                      residuals: Optional[Sequence[torch.Tensor]] = None,
                      group=None, groups=None) -> Tuple[dict, dict]:
    """:func:`reduce_wire` of some of the plan's buckets: ``items`` maps
    a plan index to its flat bucket.  Returns ``({index: mean},
    {index: new residual})``."""
    flat = [(i, g) for i, g in sorted(items.items())
            if wplan.schedules[i] != "hier_rs_ag"]
    hier = [(i, g) for i, g in sorted(items.items())
            if wplan.schedules[i] == "hier_rs_ag"]
    means: dict = {}
    new_res: dict = {}
    if flat:
        sub_res = [residuals[i] for i, _ in flat] if residuals else None
        m, r = reduce_buckets([g for _, g in flat], n, config, sub_res,
                              group=group)
        means.update((i, mi) for (i, _), mi in zip(flat, m))
        new_res.update((i, ri) for (i, _), ri in zip(flat, r))
    if hier:
        if groups is None:
            raise ValueError("a hier_rs_ag bucket needs the communicator's "
                             "(intra, inter) process groups")
        m, r = _reduce_hier(hier, wplan, n, config,
                            residuals if residuals else None, groups)
        means.update(m)
        new_res.update(r)
    return means, new_res


def reduce_wire(buckets: Sequence[torch.Tensor], wplan: WirePlan, n: int,
                config: WireConfig,
                residuals: Optional[Sequence[torch.Tensor]] = None,
                group=None, groups=None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Mean-reduce flat wire buckets under ``wplan``'s schedules:
    the ``flat`` ones through :func:`~.codecs.reduce_buckets` over
    ``group`` (arithmetic for arithmetic, so an all-flat plan is the
    flat wire), then the ``hier_rs_ag`` ones over ``groups``, the
    communicator's ``(intra, inter)`` process groups.  Returns
    ``(means, new_residuals)`` in plan order; a hier bucket's residual
    is shard-shaped."""
    buckets = list(buckets)
    if not buckets:
        return [], []
    means, new_res = reduce_wire_items(dict(enumerate(buckets)), wplan, n,
                                       config, residuals, group, groups)
    out_means = [means[i] for i in range(len(buckets))]
    out_res = ([new_res[i] for i in range(len(buckets))]
               if uses_error_feedback(config) else [])
    return out_means, out_res
