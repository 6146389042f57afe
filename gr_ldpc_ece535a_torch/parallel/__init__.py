"""Batch-parallel Monte-Carlo: the sweep step (one device for now)."""

from .sweep import SweepStats, make_sweep_step

__all__ = ["SweepStats", "make_sweep_step"]
