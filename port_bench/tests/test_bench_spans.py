"""The readers of the program's spans and counters on a hand-built
observation: one sweep of two steps, each step's spans and the card's
activity at known times (seconds from the window's start)."""

import pytest

from port_bench.harness.manifest import Manifest
from port_bench.harness.trace import Observation

# the sweep [0.10, 0.70]; its steps [0.15, 0.35] and [0.40, 0.65]
HOST = [("ldpc.sweep.run", 0.10, 0.60),
        ("ldpc.sweep.step", 0.15, 0.20),
        ("ldpc.sweep.draw", 0.16, 0.05),
        ("aten::randint", 0.17, 0.01),
        ("ldpc.decode.minsum", 0.22, 0.04),
        ("ldpc.bp.launch", 0.23, 0.01),
        ("ldpc.sweep.counts", 0.27, 0.02),
        ("ldpc.sweep.fetch", 0.30, 0.04),
        ("ldpc.sweep.step", 0.40, 0.25),
        ("ldpc.sweep.draw", 0.41, 0.04),
        ("ldpc.decode.hard", 0.46, 0.06),
        ("ldpc.sweep.counts", 0.53, 0.02),
        ("ldpc.sweep.fetch", 0.56, 0.08)]
DEVICE = [("k1", 0.18, 0.02), ("k2", 0.20, 0.03),    # draw 1 and decode 1
          ("k3", 0.40, 0.02), ("k4", 0.43, 0.01),    # draw 2
          ("k5", 0.435, 0.01),
          ("k6", 0.50, 0.10)]                        # decode 2


def _obs(host=HOST, device=DEVICE, window=1.0):
    return Observation(window_s=window, device_ops=list(device),
                       host_ops=list(host), counters={}, spans={}, events={})


def _reader(name):
    return Manifest().cell("sim_50_100.bp").metric_reader(name)


def test_step_enqueue_and_wait():
    enqueue, wait = _reader("step_enqueue_ms.sim"), _reader("step_wait_ms.sim")
    # steps start 0.15 and 0.40, their fetches 0.30 and 0.56
    assert enqueue.read(_obs()) == pytest.approx(1e3 * (0.15 + 0.16) / 2)
    assert wait.read(_obs()) == pytest.approx(1e3 * (0.04 + 0.08) / 2)
    # a step the window cuts is left out
    cut = [("ldpc.sweep.step", 0.0, 0.05), ("ldpc.sweep.fetch", 0.0, 0.01)]
    assert enqueue.read(_obs(cut + HOST)) == pytest.approx(155.0)
    assert wait.read(_obs(cut + HOST)) == pytest.approx(60.0)


def test_sweep_self():
    # 0.60 s of sweep less its steps' 0.20 and 0.25
    assert _reader("sweep_self_ms.sim").read(_obs()) == pytest.approx(150.0)
    two = HOST + [("ldpc.sweep.run", 0.75, 0.10)]
    assert _reader("sweep_self_ms.sim").read(_obs(two)) == pytest.approx(
        1e3 * (0.15 + 0.10) / 2)


def test_idle_inside_the_draw_and_the_decoders():
    # draw 1 [0.16, 0.21]: busy [0.18, 0.21], idle 0.02; draw 2 [0.41, 0.45]:
    # busy [0.41, 0.42] and [0.43, 0.445], idle 0.015
    assert _reader("draw_idle_ms.sim").read(_obs()) == pytest.approx(
        1e3 * (0.02 + 0.015) / 2)
    # decode 1 [0.22, 0.26]: busy [0.22, 0.23], idle 0.03; decode 2
    # [0.46, 0.52]: busy [0.50, 0.52], idle 0.04
    assert _reader("decode_idle_ms.sim").read(_obs()) == pytest.approx(
        1e3 * (0.03 + 0.04) / 2)
    # a span the card never leaves idle reads 0
    busy = [("k", 0.0, 1.0)]
    assert _reader("draw_idle_ms.sim").read(_obs(device=busy)) == \
        pytest.approx(0.0, abs=1e-9)
    assert _reader("decode_idle_ms.sim").read(_obs(device=[])) == \
        pytest.approx(1e3 * (0.04 + 0.06) / 2)


def test_lane_use_reads_the_program_counters(monkeypatch):
    from gr_ldpc_ece535a_torch.utils import profiling

    lane = _reader("bp_lane_use_pct.sim")
    monkeypatch.setattr(profiling, "counters", lambda: {
        "bp.lane_passes": 3200, "bp.frame_passes": 2400})
    assert lane.read(_obs()) == pytest.approx(75.0)
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert lane.read(_obs()) is None
    monkeypatch.delattr(profiling, "counters")     # a program without them
    assert lane.read(_obs()) is None


@pytest.mark.parametrize("name", ["step_enqueue_ms.sim", "step_wait_ms.sim",
                                  "sweep_self_ms.sim", "draw_idle_ms.sim",
                                  "decode_idle_ms.sim"])
def test_no_spans_no_number(name):
    """A program without the spans (or a window that cut them) gives
    nothing to read."""
    assert _reader(name).read(_obs(host=[("aten::mm", 0.1, 0.2)])) is None
    assert _reader(name).read(_obs(host=[])) is None
