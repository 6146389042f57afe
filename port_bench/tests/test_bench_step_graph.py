"""The reader of ``step_graph_pct.sim`` on the program's step counters."""

import pytest

from port_bench.harness.manifest import Manifest
from port_bench.harness.trace import Observation


def _obs():
    return Observation(window_s=1.0, device_ops=[], host_ops=[], counters={},
                       spans={}, events={})


@pytest.mark.parametrize("cell", ["sim_50_100.bp", "sim_50_100.ref4"])
def test_step_graph_share_reads_the_program_counters(monkeypatch, cell):
    from gr_ldpc_ece535a_torch.utils import profiling

    share = Manifest().cell(cell).metric_reader("step_graph_pct.sim")
    monkeypatch.setattr(profiling, "counters", lambda: {
        "sweep.steps_graphed": 140, "sweep.steps_eager": 0,
        "sweep.graph_captures": 2})
    assert share.read(_obs()) == 100.0
    monkeypatch.setattr(profiling, "counters", lambda: {
        "sweep.steps_graphed": 396, "sweep.steps_eager": 4,
        "bp.lane_passes": 10})
    assert share.read(_obs()) == pytest.approx(99.0)
    monkeypatch.setattr(profiling, "counters", lambda: {
        "sweep.steps_eager": 7})
    assert share.read(_obs()) == 0.0
    # no step, as in a program without the counters
    monkeypatch.setattr(profiling, "counters", lambda: {"bp.lane_passes": 3})
    assert share.read(_obs()) is None
    monkeypatch.delattr(profiling, "counters")
    assert share.read(_obs()) is None


def test_step_graph_share_is_reported_where_the_steps_run():
    metric = {m["name"]: m for m in Manifest().data["per_layer"]}[
        "step_graph_pct.sim"]
    assert metric["workloads"] == ["sim_50_100.bp", "sim_50_100.ref4"]
    assert (metric["layer"], metric["moves"]) == ("sweep step",
                                                  "sim_frames_per_s")
