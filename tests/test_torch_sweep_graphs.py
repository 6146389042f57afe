"""The sweep step's CUDA graphs (``parallel/sweep.py``): which steps replay
them, and that a replay is the eager step.

On the CPU every step runs eagerly and counts ``sweep.steps_eager`` under a
profiler; ``seed_of`` is the draw's seed; ``encode_bits`` keeps P.T on the
device. The ``gpu`` tests hold each graphed step to the eager draw, bit for
bit, and to ``count_errors`` of the step's own decoder, for every method
with early exit on and off. No JAX here, so on a card:

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_sweep_graphs.py -m gpu
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.ops import cuda_bp, encode_bits
from gr_ldpc_ece535a_torch.ops import encode as pencode
from gr_ldpc_ece535a_torch.parallel import make_mesh, make_sweep_step
from gr_ldpc_ece535a_torch.parallel import sweep
from gr_ldpc_ece535a_torch.parallel.sweep import (count_errors, draw_frames,
                                                  seed_of)
from gr_ldpc_ece535a_torch.sim.waterfall import run_waterfall
from gr_ldpc_ece535a_torch.utils import profiling

METHODS = ("hard", "bitflip", "minsum", "sumproduct")
STEP_COUNTERS = ("sweep.steps_graphed", "sweep.steps_eager",
                 "sweep.graph_captures")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Each test starts with no counter and no graph set."""
    monkeypatch.setattr(profiling, "_HOST", {})
    monkeypatch.setattr(profiling, "_DEVICE", {})
    monkeypatch.setattr(sweep, "_GRAPHS", collections.OrderedDict())


def _step_counters() -> dict:
    c = profiling.counters()
    return {k: c.get(k, 0) for k in STEP_COUNTERS}


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, _step_counters()


@pytest.mark.parametrize("method", METHODS)
def test_cpu_step_runs_eagerly_and_counts_as_before(method):
    code = get_code("sim_50_100")
    step = make_sweep_step(code, "cpu", method=method, iterations=5,
                           frames_per_device=300)
    key, e = (7, 3, 1), 1.5
    got, c = _traced(lambda: [step(key, e), step(key, e)])
    assert c == {"sweep.steps_graphed": 0, "sweep.steps_eager": 2,
                 "sweep.graph_captures": 0}
    assert not sweep._GRAPHS
    u, rx = draw_frames(code, 300, key, e, "cpu")
    want = count_errors(step.decode(rx), u, code)
    assert got == [want, want]
    assert want.n_frames == 300 and want.n_bits == 300 * code.N


def test_cpu_mesh_step_counts_once_a_step():
    code = get_code("sim_8_16")
    mesh = make_mesh(("batch",), devices=["cpu"] * 2)
    step = make_sweep_step(code, mesh, method="minsum", iterations=3,
                           frames_per_device=40)
    got, c = _traced(lambda: step((4, 0, 0), 2.0))
    assert c["sweep.steps_eager"] == 1 and c["sweep.steps_graphed"] == 0
    want = np.zeros(4, np.int64)
    for i in range(2):
        u, rx = draw_frames(code, 40, [4, 0, 0, i], 2.0, "cpu")
        want += count_errors(step.decode(rx), u, code)[:4]
    assert list(got[:4]) == want.tolist() and got.n_frames == 80


@pytest.mark.parametrize("key", [(0, 0, 0), (12345678901, 34, 3), 5, 2**40 + 3,
                                 [9, 1]])
def test_seed_of_is_the_draw_generators_seed(key):
    words = np.random.SeedSequence(list(np.atleast_1d(key).tolist())
                                   ).generate_state(2, np.uint32)
    assert seed_of(key) == (int(words[0]) << 31) ^ int(words[1])
    assert sweep._generator(key, "cpu").initial_seed() == seed_of(key)
    g = torch.Generator().manual_seed(seed_of(key))
    u, _ = draw_frames(get_code("sim_8_16"), 16, key, 0.0, "cpu")
    d = torch.randint(0, 2, (16, 8), generator=g, dtype=torch.int8)
    assert torch.equal(u[:, 8:], d)


def test_encode_keeps_p_transposed_on_the_device():
    code = get_code("sim_50_100")
    d = torch.randint(0, 2, (64, code.K), dtype=torch.int8)
    want = np.concatenate([(d.numpy().astype(np.int64) @ code.P.T) % 2,
                           d.numpy()], axis=1)
    before = pencode._p_transposed.cache_info()
    for _ in range(3):
        np.testing.assert_array_equal(encode_bits(d, code).numpy(), want)
    after = pencode._p_transposed.cache_info()
    assert after.hits >= before.hits + 2
    assert after.misses <= before.misses + 1


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

GRAPH_CASES = ([(m, ee, "auto") for m in METHODS for ee in (True, False)]
               + [(m, ee, "torch") for m in ("minsum", "sumproduct")
                  for ee in (True, False)])


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("method,early_exit,backend", GRAPH_CASES)
def test_graphed_step_is_the_eager_step(method, early_exit, backend):
    """Every step after the first replays the graphs: its frames are the
    eager draw's, bit for bit, at every key and Eb/N0, never the previous
    step's; its counts are ``count_errors`` of the step's own decoder on
    them; each replay adds the launches its capture made."""
    dev = _cuda()
    code = get_code("sim_50_100")
    frames = 32 * 129 + 5                    # a partial last block
    step = make_sweep_step(code, dev, method=method, iterations=5,
                           frames_per_device=frames, early_exit=early_exit,
                           backend=backend)
    first = step((1, 0, 0), 2.0)             # eager, then the capture
    (graphs,) = sweep._GRAPHS.values()
    u0, rx0 = draw_frames(code, frames, (1, 0, 0), 2.0, dev)
    assert first == count_errors(step.decode(rx0), u0, code)
    kernel = backend == "auto" and method in ("minsum", "sumproduct")
    assert bool(graphs.launches) == kernel
    prev = rx0
    for e in (-7.0, 0.0, 10.0):                # keys change within a point
        for key in ((1, 0, 0), (2**40 + 17, 34, 3), 6):
            launches = dict(cuda_bp.LAUNCHES)
            got = step(key, e)
            torch.cuda.synchronize()
            u, rx = draw_frames(code, frames, key, e, dev)
            assert torch.equal(graphs.u, u) and torch.equal(graphs.rx, rx)
            assert not torch.equal(graphs.rx, prev)
            prev = rx
            assert got == count_errors(step.decode(rx), u, code)
            added = {k: cuda_bp.LAUNCHES[k] - n for k, n in launches.items()
                     if cuda_bp.LAUNCHES[k] != n}
            # the replay's launches, and the eager check's one
            assert added == {k: n + 1 for k, n in graphs.launches.items()}
    assert len(sweep._GRAPHS) == 1


@pytest.mark.gpu
def test_sweeps_of_one_shape_capture_once():
    """Two ``run_waterfall`` calls of one shape build new steps but share the
    graphs: one capture a method, every later step a replay; the results
    are the same at the same seed."""
    dev = _cuda()
    kw = dict(code="sim_50_100", ebn0_db=[-1.0, 2.0], frames_per_point=2000,
              frames_per_step=1000, iterations=5, device=dev, seed=3)
    (a, b), c = _traced(lambda: (run_waterfall(**kw), run_waterfall(**kw)))
    n_methods = len(a.methods)
    assert c == {"sweep.graph_captures": n_methods,
                 "sweep.steps_eager": n_methods,
                 "sweep.steps_graphed": 2 * 2 * 2 * n_methods - n_methods}
    for m in a.methods:
        for field in ("ber", "info_ber", "fer", "fer_detected"):
            np.testing.assert_array_equal(getattr(a, field)[m],
                                          getattr(b, field)[m])
    # untraced, the kernels get no counters' pointer: other graphs
    run_waterfall(**kw)
    assert len(sweep._GRAPHS) == 2 * n_methods


@pytest.mark.gpu
def test_callers_decoder_runs_eagerly():
    dev = _cuda()
    code = get_code("sim_50_100")
    dec = cuda_bp.cuda_decode_minsum
    step = make_sweep_step(code, dev, method="minsum", frames_per_device=512,
                           decode_fn=lambda rx: dec(rx, code, 5, mode="precise",
                                                    early_exit=True))
    got, c = _traced(lambda: [step((2, 1), 0.5) for _ in range(3)])
    assert c == {"sweep.steps_graphed": 0, "sweep.steps_eager": 3,
                 "sweep.graph_captures": 0}
    assert not sweep._GRAPHS
    u, rx = draw_frames(code, 512, (2, 1), 0.5, dev)
    assert got == [count_errors(step.decode(rx), u, code)] * 3


@pytest.mark.gpu
def test_mesh_shards_on_one_card_share_a_graph_set():
    """Two shards on one card replay one graph set in turn; the step's
    counts are the sum of each shard's eager counts."""
    dev = _cuda()
    code = get_code("sim_50_100")
    mesh = make_mesh(("batch",), devices=[dev, dev])
    step = make_sweep_step(code, mesh, method="sumproduct", iterations=5,
                           frames_per_device=3000)
    for key, e in (((5, 0, 0), 1.0), ((5, 0, 1), 1.0), ((5, 1, 0), 2.5)):
        want = np.zeros(4, np.int64)
        for i in range(2):
            u, rx = draw_frames(code, 3000, [*key, i], e, dev)
            want += count_errors(step.decode(rx), u, code)[:4]
        got = step(key, e)
        assert list(got[:4]) == want.tolist() and got.n_frames == 6000
    assert len(sweep._GRAPHS) == 1
