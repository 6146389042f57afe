"""The traced run: a ``torch.profiler`` trace of the measured window, and
what the per-layer metrics read from it.

The window is the host span ``port_bench.window``, which the harness opens
around the driver's window inside the profiler. Busy time is the union of
the device's activity (kernels, copies, sets) inside it. The readers of
``port_bench/metrics/`` each get one ``Observation``.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from collections import defaultdict


__all__ = ["Observation", "traced", "observe", "breakdown", "busy_union",
           "WINDOW_SPAN"]

WINDOW_SPAN = "port_bench.window"
_TOP = 10


@dataclasses.dataclass
class Observation:
    """What one traced run saw, the times in seconds from the window's
    start. ``device_ops`` and ``host_ops``: (name, start, duration) inside
    the window; ``counters``, ``spans`` and ``events`` the driver's own:
    counts, host-clock spans and CUDA-event times (seconds) by name."""

    window_s: float
    device_ops: list
    host_ops: list
    counters: dict
    spans: dict
    events: dict

    def device_time(self, match) -> float:
        """Seconds of the device ops whose name ``match`` accepts."""
        return sum(d for n, _, d in self.device_ops if match(n))

    def busy_s(self) -> float:
        return busy_union(self.device_ops)


def busy_union(ops) -> float:
    """Length of the union of the ops' intervals."""
    if not ops:
        return 0.0
    iv = sorted((s, s + d) for _, s, d in ops)
    total, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + cur_e - cur_s


@contextlib.contextmanager
def traced(device_sync):
    """Profile the block on the host and the device, inside the window
    span; yields a list that holds the profiler once the block closes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield holder
            device_sync()
    holder.append(prof)


def _raw_events(prof):
    """(name, is_device, start_ns, duration_ns) of every event."""
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        for e in res.events():
            yield (e.name(), str(e.device_type()).endswith("CUDA"),
                   e.start_ns(), e.duration_ns())
        return
    for e in prof.events():            # older profilers: FunctionEvents
        yield (e.name, str(e.device_type).endswith("CUDA"),
               int(e.time_range.start * 1000), int(e.time_range.elapsed_us()
                                                    * 1000))


def observe(prof, counters=None, spans=None, events=None) -> Observation:
    """The Observation of a finished profiler."""
    raw = list(_raw_events(prof))
    win = [(s, d) for n, dev, s, d in raw if not dev and n == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, wd = win[0]
    w1 = w0 + wd
    dev_ops, host_ops = [], []
    for n, dev, s, d in raw:
        if n == WINDOW_SPAN or s + d <= w0 or s >= w1:
            continue
        s2, e2 = max(s, w0), min(s + d, w1)
        (dev_ops if dev else host_ops).append(
            (n, (s2 - w0) * 1e-9, (e2 - s2) * 1e-9))
    return Observation(window_s=wd * 1e-9, device_ops=dev_ops,
                       host_ops=host_ops, counters=counters or {},
                       spans=spans or {}, events=events or {})


def _host_label(host_ops, starts, t: float) -> str:
    """The innermost host op running at ``t``, or "host (no op)"."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 200, -1), -1):
        n, s, d = host_ops[j]
        if s + d >= t:
            return n
    return "host (no op)"


def breakdown(obs: Observation) -> dict:
    """The device ops that took most time, and the idle gaps of the device
    summed by what the host was doing at their middle (``_TOP`` each)."""
    by_op = defaultdict(float)
    for n, _, d in obs.device_ops:
        by_op[n] += d
    host = sorted(obs.host_ops, key=lambda o: o[1])
    starts = [o[1] for o in host]
    iv = sorted((s, s + d) for _, s, d in obs.device_ops)
    gaps = defaultdict(float)
    edge = 0.0
    for s, e in iv + [(obs.window_s, obs.window_s)]:
        if s > edge:
            gaps[_host_label(host, starts, 0.5 * (s + edge))] += s - edge
        edge = max(edge, e)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                     [:_TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(gaps)}
