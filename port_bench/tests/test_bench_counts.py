"""The frozen counts against hand-worked values, and the trace reduction
and the readers on synthetic observations."""

import math

import pytest

from port_bench.harness import counts
from port_bench.harness.manifest import Manifest
from port_bench.harness.trace import Observation, breakdown, busy_union
from port_bench.reference.code import load_code


def test_sim_50_100_shape():
    code = load_code("sim_50_100")
    assert (code.M, code.N, code.K, code.edges) == (50, 100, 50, 266)


def test_bp_bound_by_hand():
    # min-sum, 131,072 frames x 5 passes of the (100,50) code's 266 edges:
    # 10 x 266 x 655,360 = 1,743,257,600 operations over 67e12 a second,
    # against 131,072 x 100 x 5 bytes = 65,536,000 over 3.35e12
    t = counts.bp_bound_s("minsum", 131072, 131072 * 5, 100, 266)
    assert t == pytest.approx(1_743_257_600 / 67e12, rel=1e-12)
    assert t == pytest.approx(2.601877e-5, rel=1e-6)
    # one pass a frame: 14 x 266 x 131,072 = 488,112,128 operations take
    # 7.29 us, under the bytes' 19.56 us
    t = counts.bp_bound_s("sumproduct", 131072, 131072, 100, 266)
    assert t == pytest.approx(65_536_000 / 3.35e12, rel=1e-12)


def test_composed_tracker_bound_by_hand():
    # 2^24 samples at 2 a symbol, blocks of 8,192 symbols, rate clip
    # 2.5e-4: 1,022 blocks, 23 taps a polyphase row. 8,372,224 symbols x
    # (2 x 12 x 23 + 28) = 4,855,889,920 operations; bytes 8,372,224 x 24
    t = counts.track_bound_s(1022, 8192, 23, 2)
    assert t == pytest.approx(4_855_889_920 / 67e12, rel=1e-12)
    assert t * 1e3 == pytest.approx(0.0724759, rel=1e-5)
    assert 8_372_224 * 24 / 3.35e12 < t


def _obs(device_ops, host_ops=(), window=1.0, counters=None):
    return Observation(window_s=window, device_ops=list(device_ops),
                       host_ops=list(host_ops), counters=counters or {},
                       spans={}, events={})


def test_busy_union_merges_overlaps():
    ops = [("a", 0.0, 0.2), ("b", 0.1, 0.2), ("c", 0.5, 0.1)]
    assert busy_union(ops) == pytest.approx(0.4)
    assert busy_union([]) == 0.0


def test_breakdown_names_the_host_in_each_gap():
    dev = [("void bp_kernel<6, true, 32, 8>(...)", 0.0, 0.3),
           ("randn", 0.5, 0.2)]
    host = [("cudaStreamSynchronize", 0.25, 0.3), ("aten::randn", 0.42, 0.1)]
    b = breakdown(_obs(dev, host))
    assert b["device_ops"][0] == ["void bp_kernel<6, true, 32, 8>(...)", 0.3]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.2)
    assert gaps["host (no op)"] == pytest.approx(0.3)


def test_readers_of_the_sim_metrics():
    man = Manifest()
    cell = man.cell("sim_50_100.bp")
    idle = cell.metric_reader("device_idle_pct.sim")
    roof = cell.metric_reader("bp_roofline.sim")
    work = [{"method": "minsum", "N": 100, "edges": 266, "frames": 131072,
             "passes": 131072 * 5, "decodes": 10}]
    obs = _obs([("void bp_minsum_pairs<6>(float const*)", 0.0, 0.026),
                ("void at::native::normal_kernel", 0.1, 0.5)],
               counters={"bp": work})
    assert idle.read(obs) == pytest.approx(100 * (1 - 0.526))
    bound = 10 * 1_743_257_600 / 67e12
    assert roof.read(obs) == pytest.approx(100 * bound / 0.026)
    assert roof.read(_obs([("randn", 0.0, 1.0)], counters={"bp": work})) is None
    assert roof.read(_obs([("void bp_kernel<5, false, 32, 8>", 0, 1.0)])) is None
    assert idle.read(_obs([])) is None
    assert not math.isnan(idle.read(obs))
