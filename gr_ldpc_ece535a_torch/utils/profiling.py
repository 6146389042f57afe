"""Profiling and throughput metrics.

The counterpart of ``gr_ldpc_ece535a_tpu/utils/profiling.py``.
``Timer``/``ThroughputMeter`` give wall-clock and bits-per-second counters
for pipeline stages; ``device_sync`` waits for a CUDA tensor's device;
``trace`` records a ``torch.profiler`` trace (CPU and CUDA activity) to a
Chrome-trace JSON file in ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

__all__ = ["Timer", "ThroughputMeter", "device_sync", "trace"]


def device_sync(x):
    """Wait until the work queued on the device of ``x`` is done, when ``x``
    (or the first tensor of a list, tuple or dict of them) is a CUDA tensor.
    Returns ``x`` unchanged."""
    import torch

    leaf = x
    while isinstance(leaf, (list, tuple, dict)) and leaf:
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return x


class Timer:
    """Context-manager stopwatch: ``with Timer() as t: ...; t.elapsed``."""

    def __init__(self) -> None:
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0


class ThroughputMeter:
    """Accumulate (items, seconds) across steps; report rates.

    The decoded-info-bits/s counter: ``meter.add(frames * K, t)``;
    ``meter.rate`` in items/s.
    """

    def __init__(self, unit: str = "bits") -> None:
        self.unit = unit
        self.items = 0.0
        self.seconds = 0.0
        self.steps = 0

    def add(self, items: float, seconds: float) -> None:
        self.items += items
        self.seconds += seconds
        self.steps += 1

    @contextlib.contextmanager
    def step(self, items: float) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.add(items, time.perf_counter() - t0)

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    def __repr__(self) -> str:
        return (f"<ThroughputMeter {self.rate:.3e} {self.unit}/s "
                f"over {self.steps} steps>")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[object]:
    """Record a ``torch.profiler`` trace of the body (CPU activity, and CUDA
    activity when a card is present) and write it to ``log_dir/trace.json``,
    viewable in Perfetto or chrome://tracing. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
