"""Profiling: spans and counters on the profiler's clock, and traces.

The counterpart of ``gr_ldpc_ece535a_tpu/utils/profiling.py``, rebuilt
around ``torch.profiler``:

  span(name, **args)   a range of the host's time, named ``name``, that lands
                       in a ``torch.profiler`` trace on the clock of the
                       device's activity (CUPTI), with ``args`` in its event;
                       nested spans on one thread are its children
  count(name, n)       adds n, an int or a device tensor, to a named counter
  counters()           the counters as plain ints
  accumulator(names)   the device tensor that a kernel adds counts into
  device_sync          waits for a CUDA tensor's device
  trace(log_dir)       records a trace of the body to a Chrome-trace file

Spans and counters move only while a profiler records: without one a span
costs one test of the profiler's flag (no torch op, no string built) and a
count costs the same test. Warm-up before a traced window and checks after
it therefore never count.

The spans of the sweep path (``sim/waterfall.py``, ``parallel/sweep.py``,
``ops/cuda_bp.py``): ``ldpc.sweep.run`` (a ``run_waterfall`` call),
``ldpc.sweep.step`` (a step, args ``key`` and ``method``) and its children
``ldpc.sweep.draw``, ``ldpc.decode.<method>``, ``ldpc.sweep.counts``,
``ldpc.sweep.allreduce`` (on a mesh), ``ldpc.sweep.fetch``; and
``ldpc.bp.launch`` (the BP kernels' library call). The receiver's spans are
``ldpc.rx.*``, the receive chain's ``ldpc.dsp.*``. The BP kernels add their
lane-passes and frame-passes into ``bp.lane_passes`` and
``bp.frame_passes`` (``ops/cuda_bp.py``); a sweep step adds one to
``sweep.steps_graphed`` or ``sweep.steps_eager``, and a capture of its CUDA
graphs one to ``sweep.graph_captures`` (``parallel/sweep.py``).
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Iterator, Sequence

import torch

__all__ = ["span", "count", "counters", "accumulator", "recording",
           "device_sync", "trace"]

# whether a profiler records: the one test a span or count makes
_recording = torch._C._autograd._profiler_enabled

# a profiler range with keyword args, about 2 us under a profiler where
# record_function takes 15 (torch 2.x)
_range = torch._C._profiler._RecordFunctionFast
_INT64 = (-(1 << 63), (1 << 63) - 1)


def _arg(v):
    """A span argument as the trace takes it: a bool, an int of 64 bits, a
    float or a string as it is; anything else, a key tuple say, as its
    text. Type tests only: no ABC check, which a cold cache makes slow."""
    t = type(v)
    if t is str or t is float or t is bool or (
            t is int and _INT64[0] <= v <= _INT64[1]):
        return v
    return str(v)


def recording() -> bool:
    """Whether a ``torch.profiler`` session records on this process: the
    test every span and count makes first."""
    return _recording()


class span:
    """A range of the host's time named ``name``, with ``args``, while a
    ``torch.profiler`` session records; nothing but the flag test otherwise.

    ``with span("ldpc.sweep.step", key=(seed, point, step), method="minsum"):``
    or as a decorator of a function: ``@span("ldpc.sweep.draw")``. The
    range is a profiler event (a cpu_op) on the host thread that opened it,
    on the clock of the device's activity; ``args`` appear in its event
    (``kwinputs``) and in the exported Chrome trace where the profiler
    records inputs (``record_shapes=True``, as ``trace`` has it)."""

    __slots__ = ("name", "args", "_rf")

    def __init__(self, name: str, **args) -> None:
        self.name = name
        self.args = args
        self._rf = None

    def __enter__(self) -> "span":
        if _recording():
            rf = _range(self.name, [],
                        {k: _arg(v) for k, v in self.args.items()})
            rf.__enter__()
            self._rf = rf
        return self

    def __exit__(self, *exc) -> None:
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)

    def __call__(self, fn):
        name, args = self.name, self.args

        @functools.wraps(fn)
        def spanned(*a, **k):
            if not _recording():
                return fn(*a, **k)
            with span(name, **args):
                return fn(*a, **k)

        return spanned


# counters: host ints by name, and device accumulators, each an int64
# (len(names),) tensor whose entries add into the counters ``names``
_HOST: dict[str, int] = {}
_DEVICE: dict[tuple[tuple[str, ...], torch.device], torch.Tensor] = {}


def accumulator(names: Sequence[str], device) -> torch.Tensor:
    """The int64 tensor of ``len(names)`` entries on ``device`` that the
    counters ``names`` sum in ``counters()``: a kernel adds into it directly
    (its data as ``unsigned long long*``), with no synchronise. Made zero
    at first use."""
    key = (tuple(names), torch.device(device))
    acc = _DEVICE.get(key)
    if acc is None:
        acc = _DEVICE[key] = torch.zeros(len(key[0]), dtype=torch.int64,
                                         device=key[1])
        if acc.is_cuda:     # zero before a launch on any stream adds to it
            torch.cuda.synchronize(acc.device)
    return acc


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records. ``n`` is
    an int, or a tensor whose elements are summed: on a device, into an
    int64 accumulator on that device, with no synchronise."""
    if not _recording():
        return
    if isinstance(n, torch.Tensor):
        if n.device.type != "cpu":
            accumulator((name,), n.device).add_(n.sum(dtype=torch.int64))
            return
        n = int(n.sum(dtype=torch.int64))
    _HOST[name] = _HOST.get(name, 0) + int(n)


def counters(reset: bool = False) -> dict[str, int]:
    """Every counter as a plain int: the host counts plus each device
    accumulator, fetched once (after its device's queued work). With
    ``reset`` every counter is set back to 0 after it is read."""
    out = dict(_HOST)
    for (names, device), acc in _DEVICE.items():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for name, v in zip(names, acc.tolist()):
            out[name] = out.get(name, 0) + int(v)
        if reset:
            acc.zero_()
    if reset:
        _HOST.clear()
    return out


def device_sync(x):
    """Wait until the work queued on the device of ``x`` is done, when ``x``
    (or the first tensor of a list, tuple or dict of them) is a CUDA tensor.
    Returns ``x`` unchanged."""
    leaf = x
    while isinstance(leaf, (list, tuple, dict)) and leaf:
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return x


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[object]:
    """Record a ``torch.profiler`` trace of the body (CPU activity, and CUDA
    activity when a card is present), spans and their args included (the
    profiler records a span's args where it records inputs' shapes), and
    write it to ``log_dir/trace.json``, viewable in Perfetto or
    chrome://tracing. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
