"""Spans and counters of ``gr_ldpc_ece535a_torch/utils/profiling.py``.

On the CPU: a span without a profiler runs its body and nothing else; under
``torch.profiler`` the sweep path's spans nest as the metrics of
``port_bench/metrics/`` read them, with the step key in their args; counts
move only while a profiler records; ``trace`` writes the spans. The
``gpu`` test holds the BP kernels' pass counters to the plain early-exit
decoder. No JAX here, so on a card:

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_profiling.py -m gpu
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.ops import cuda_bp
from gr_ldpc_ece535a_torch.parallel.sweep import draw_frames
from gr_ldpc_ece535a_torch.sim.waterfall import run_waterfall
from gr_ldpc_ece535a_torch.utils import profiling
from gr_ldpc_ece535a_torch.utils.profiling import (count, counters, span,
                                                   trace)

STEP_CHILDREN = ("ldpc.sweep.draw", "ldpc.decode.", "ldpc.sweep.counts",
                 "ldpc.sweep.fetch")


@pytest.fixture(autouse=True)
def _fresh_counters(monkeypatch):
    """Each test starts with no counter."""
    monkeypatch.setattr(profiling, "_HOST", {})
    monkeypatch.setattr(profiling, "_DEVICE", {})


def _events(prof, prefix="ldpc."):
    """(name, start ns, end ns, args) of the profiler's events named
    ``prefix``..., by start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                    e.kwinputs())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefix)), key=lambda e: e[1])


def test_span_without_profiler_runs_its_body_and_counts_nothing(monkeypatch):
    assert not profiling.recording()
    ran = []
    with span("ldpc.test", key=(1, 2, 3)) as s:
        ran.append(1)
    assert ran == [1] and s._rf is None

    @span("ldpc.test.fn")
    def double(x):
        """Twice x."""
        return 2 * x

    assert double(21) == 42
    assert double.__name__ == "double" and double.__doc__ == "Twice x."
    # no torch op and no string: the args are never formatted
    monkeypatch.setattr(profiling, "_arg", None)
    with span("ldpc.test", key=object()):
        pass
    count("ldpc.test.n", 5)
    count("ldpc.test.n", torch.ones(3))
    assert counters() == {}


def test_counts_move_only_under_a_profiler():
    count("t.n", 1)
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        count("t.n", 2)
        count("t.n", torch.tensor([1, 2], dtype=torch.int32))
        count("t.flags", torch.tensor([True, False, True]))
    count("t.n", 100)
    got = counters()
    assert got == {"t.n": 5, "t.flags": 2}
    assert all(type(v) is int for v in got.values())
    assert counters(reset=True) == got
    assert counters() == {}


def test_a_device_count_adds_on_its_device_with_no_synchronise(monkeypatch):
    """The device path, on the meta device (no data, no card): the count
    lands in an int64 accumulator on the tensor's own device and nothing
    waits for the device."""
    def no_sync(*a, **k):
        raise AssertionError("count must not synchronise")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    n = torch.ones(4, dtype=torch.int32, device="meta")
    with profile(activities=[ProfilerActivity.CPU]):
        count("t.dev", n)
        count("t.dev", n)
    (names, device), acc = next(iter(profiling._DEVICE.items()))
    assert names == ("t.dev",) and device.type == "meta"
    assert acc.dtype == torch.int64 and acc.shape == (1,)
    assert profiling._HOST == {}


def test_accumulator_is_one_tensor_a_name_group_and_device():
    a = profiling.accumulator(("a.x", "a.y"), "cpu")
    assert a is profiling.accumulator(["a.x", "a.y"], torch.device("cpu"))
    a += torch.tensor([3, 4])
    profiling.accumulator(("a.x",), "cpu").add_(1)
    assert counters() == {"a.x": 4, "a.y": 4}


def test_sweep_spans_nest_as_the_metrics_read_them():
    points, methods, steps, seed = [0.0, 3.0], ("hard", "minsum"), 2, 11
    kw = dict(code="sim_8_16", ebn0_db=points, frames_per_point=64,
              frames_per_step=32, iterations=3, methods=methods,
              device="cpu", seed=seed)
    run_waterfall(**kw)                  # warm, untraced: no span anywhere
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        res = run_waterfall(**kw)
        run_waterfall(**kw)
    ev = _events(prof)
    runs = [e for e in ev if e[0] == "ldpc.sweep.run"]
    assert len(runs) == 2
    first = [e for e in ev if runs[0][1] <= e[1] and e[2] <= runs[0][2]]
    step_spans = [e for e in first if e[0] == "ldpc.sweep.step"]
    assert len(step_spans) == len(points) * len(methods) * steps
    want = [(seed, p, si, m) for p in range(len(points)) for m in methods
            for si in range(steps)]
    for (_, s0, s1, args), (sd, p, si, m) in zip(step_spans, want):
        assert args == {"key": str((sd, p, si)), "method": m}
        kids = [e[0] for e in first if s0 <= e[1] and e[2] <= s1
                and e[0] != "ldpc.sweep.step"]
        assert kids == ["ldpc.sweep.draw", f"ldpc.decode.{m}",
                        "ldpc.sweep.counts", "ldpc.sweep.fetch"], kids
    # every span of the sweep path lies in a step but the run itself, and
    # the steps follow one another
    assert all(any(s[1] <= e[1] and e[2] <= s[2] for s in step_spans)
               for e in first if e[0].startswith(STEP_CHILDREN))
    assert {e[0] for e in first} == {
        "ldpc.sweep.run", "ldpc.sweep.step", "ldpc.sweep.draw",
        "ldpc.sweep.counts", "ldpc.sweep.fetch",
        *(f"ldpc.decode.{m}" for m in methods)}
    assert all(a[2] <= b[1] for a, b in zip(step_spans, step_spans[1:]))
    assert res.ber["minsum"].shape == (2,)


def test_trace_writes_the_spans_and_their_args(tmp_path):
    with trace(str(tmp_path)):
        with span("ldpc.test.outer", key=(7, 1, 0), method="minsum"):
            with span("ldpc.test.inner"):
                torch.ones(64).sum()
    doc = json.loads((tmp_path / "trace.json").read_text())
    by_name = {e["name"]: e for e in doc["traceEvents"]
               if e.get("name", "").startswith("ldpc.test.")}
    outer, inner = by_name["ldpc.test.outer"], by_name["ldpc.test.inner"]
    assert outer["args"]["key"] == "(7, 1, 0)"
    assert outer["args"]["method"] == "minsum"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("on_device", [False, True])
def test_receive_spans(on_device):
    """A receive under the profiler: ``ldpc.rx.receive`` holds its stages in
    order, with no synchronise of their own; a tensor with
    fetch_weights=False takes the device-resident path (dispatch, then
    fetch and host)."""
    from gr_ldpc_ece535a_torch.ops import bpsk_map, encode_bits
    from gr_ldpc_ece535a_torch.parallel import StreamReceiver, make_mesh

    code = get_code("block_32_64")
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.integers(0, 2, (24, code.K)).astype(np.int8))
    tx = bpsk_map(encode_bits(d, code)).reshape(-1).numpy()
    stream = np.concatenate([rng.normal(0, 0.1, 5), tx]).astype(np.float32)
    rx = StreamReceiver(code=code, method=0, iterations=5,
                        mesh=make_mesh(("stream",), devices=["cpu"]))
    arg = torch.from_numpy(stream) if on_device else stream
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = rx.receive(arg, fetch_weights=not on_device)
    assert got.acquisition.offset == 5
    names = [e[0] for e in _events(prof, "ldpc.rx.")]
    stages = (["ldpc.rx.receive", "ldpc.rx.dispatch", "ldpc.rx.acquire",
               "ldpc.rx.decode", "ldpc.rx.host"] if on_device else
              ["ldpc.rx.receive", "ldpc.rx.acquire", "ldpc.rx.decode",
               "ldpc.rx.fetch", "ldpc.rx.host"])
    assert names == stages, names


def test_receive_chain_spans():
    """``rx_chain_pairs`` is ``ldpc.dsp.chain`` holding its four stages."""
    from gr_ldpc_ece535a_torch.ops.dsp import rx_chain_pairs

    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 2048)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rx_chain_pairs(x, timing="track", timing_block_syms=64)
    ev = _events(prof, "ldpc.dsp.")
    assert [e[0] for e in ev] == ["ldpc.dsp.chain", "ldpc.dsp.agc",
                                  "ldpc.dsp.cfo", "ldpc.dsp.timing",
                                  "ldpc.dsp.carrier"]
    assert all(ev[0][1] <= e[1] and e[2] <= ev[0][2] for e in ev[1:])


def test_span_args_take_what_the_trace_holds():
    assert profiling._arg(5) == 5 and profiling._arg("a") == "a"
    assert profiling._arg(1 << 70) == str(1 << 70)
    assert profiling._arg((1, 2, 3)) == "(1, 2, 3)"
    assert profiling._arg([4, 5]) == "[4, 5]"
    assert profiling._arg(np.int64(5)) == "5"
    assert profiling._arg(None) == "None"


@pytest.mark.gpu
@pytest.mark.parametrize("kind,impl", [("minsum", "gram"),
                                       ("sumproduct", "gram"),
                                       ("minsum", "split"),
                                       ("sumproduct", "split")])
def test_pass_counters_match_the_plain_decoder(kind, impl):
    """One early-exit launch's frame-passes against the plain early-exit
    decoder's, counted from its per-pass live masks: equal but for the
    frames whose decisions differ. Its lane-passes against each block's
    slowest frame: at least that many passes a block, and in the tile
    kernels at most one pass more (their stop test reads the done flags
    before the barrier that orders the last pass's writes to them, so a
    block may run one pass with no frame live); a multiple of the block's
    frames. Untraced, the launch counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    code = get_code("sim_50_100")
    B, iters = 32 * 257 + 5, 5
    _, rx = draw_frames(code, B, (23, 1), 1.5, "cuda")
    fn = (cuda_bp.cuda_decode_minsum if kind == "minsum"
          else cuda_bp.cuda_decode_sumproduct)
    fn(rx, code, iters, mode="precise", early_exit=True, impl=impl)
    torch.cuda.synchronize()
    assert counters() == {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = fn(rx, code, iters, mode="precise", early_exit=True, impl=impl)
    c = counters()
    live = []
    d = cuda_bp._dev_tables(code, rx.device)
    check = ((lambda m: cuda_bp._check_minsum(m, d, 0.0, 1.0))
             if kind == "minsum" else (lambda m: cuda_bp._check_sumproduct(m, d)))
    want = cuda_bp._decode_plain(rx, code, iters, True, kind == "sumproduct",
                                 check, live=live)
    per_frame = torch.stack(live).sum(0)
    frames = 32 if impl == "gram" else 16
    blocks = -(-B // frames)
    padded = torch.zeros(blocks * frames, dtype=per_frame.dtype,
                         device=per_frame.device)
    padded[:B] = per_frame
    slowest = padded.reshape(blocks, frames).max(1).values
    differ = (got != want).any(1)
    hit = torch.zeros(blocks * frames, dtype=torch.bool, device=differ.device)
    hit[:B] = differ
    n_hit = int(hit.reshape(blocks, frames).any(1).sum())
    assert int(differ.sum()) <= B // 100
    assert abs(c["bp.frame_passes"] - int(per_frame.sum())) \
        <= iters * int(differ.sum())
    need = int(slowest.sum()) * frames
    extra = blocks * frames if impl == "gram" else 0
    assert need - iters * frames * n_hit <= c["bp.lane_passes"] \
        <= need + extra + iters * frames * n_hit
    assert c["bp.lane_passes"] % frames == 0
    assert c["bp.lane_passes"] >= c["bp.frame_passes"] > 0
