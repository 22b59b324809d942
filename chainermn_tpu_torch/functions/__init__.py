"""Differentiable collectives (port of ``chainermn_tpu/functions``):
for now only the mean all-reduce that synchronized BatchNorm needs."""

from .collectives import allreduce_mean

__all__ = ["allreduce_mean"]
