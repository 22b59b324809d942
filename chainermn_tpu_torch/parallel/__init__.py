"""Parallelism tiers beyond data parallelism (port of
``chainermn_tpu/parallel``): the microbatched GPipe pipeline, and the
seq2seq encoder|decoder split on it."""

from .pipeline import build_pipeline_train_step, gpipe, place_stage_params

__all__ = ["build_pipeline_train_step", "gpipe", "place_stage_params"]
