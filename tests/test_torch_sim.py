"""The port's Monte-Carlo sweep: counters, statistics against the committed
JAX curve, outputs, checkpoint/resume and the app, on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu.codes import get_code
from gr_ldpc_ece535a_tpu.sim.waterfall import WaterfallResult as JaxResult

from gr_ldpc_ece535a_torch.apps import ldpc_ber_sweep
from gr_ldpc_ece535a_torch.parallel import make_sweep_step
from gr_ldpc_ece535a_torch.parallel.sweep import count_errors, draw_frames
from gr_ldpc_ece535a_torch.sim import WaterfallResult, band_check, run_waterfall

ROOT = Path(__file__).resolve().parents[1]
REF_8_16 = ROOT / "results" / "waterfall_sim_8_16_4dec_1e6.json"


def _recount(vhat, u, code):
    """The reference simulator's counters, in numpy."""
    vhat, u = np.asarray(vhat, np.int64), np.asarray(u, np.int64)
    wrong = vhat != u
    syn = (vhat @ code.H.T.astype(np.int64)) % 2
    return (int(wrong.sum()), int(wrong[:, code.M:].sum()),
            int(wrong.any(1).sum()), int(syn.any(1).sum()))


@pytest.mark.parametrize("method", ["hard", "bitflip", "minsum", "sumproduct"])
def test_counters_match_a_numpy_recount(method):
    code = get_code("block_32_64")
    seen = {}

    def decode(rx):
        from gr_ldpc_ece535a_torch.ops import make_decoder
        seen["vhat"] = make_decoder(code, method, 5, backend="torch")(rx)
        return seen["vhat"]

    step = make_sweep_step(code, "cpu", method=method, frames_per_device=3000,
                           decode_fn=decode)
    stats = step((0, 3, 1), 2.0)
    u, _ = draw_frames(code, 3000, (0, 3, 1), 2.0, "cpu")
    assert tuple(stats[:4]) == _recount(seen["vhat"], u, code)
    assert (stats.n_frames, stats.n_bits) == (3000, 3000 * code.N)
    assert stats.frame_errors > 0 and all(isinstance(x, int) for x in stats)


def test_draw_is_deterministic_per_key():
    code = get_code("sim_8_16")
    u1, rx1 = draw_frames(code, 64, (0, 1, 0), 3.0, "cpu")
    u2, rx2 = draw_frames(code, 64, (0, 1, 0), 3.0, "cpu")
    assert torch.equal(u1, u2) and torch.equal(rx1, rx2)
    for other in ((0, 1, 1), (0, 2, 0), (1, 1, 0)):
        assert not torch.equal(draw_frames(code, 64, other, 3.0, "cpu")[1], rx1)
    # codewords satisfy H, and the channel is the simulator's N0 convention
    assert not ((u1.numpy().astype(np.int64) @ code.H.T) % 2).any()
    noise = rx1 - (2.0 * u1 - 1.0)
    assert abs(float(noise.std()) - 10 ** (-3.0 / 20)) < 0.1


def test_counts_are_int64_past_two_to_the_24():
    """2^24 + 63 wrong bits: float32 (the JAX step's type) cannot hold it."""
    code = get_code("block_32_64")
    B = 2**24 // code.N + 1
    u = torch.zeros((B, code.N), dtype=torch.int8)
    vhat = torch.ones_like(u)
    vhat[0, 0] = 0
    stats = count_errors(vhat, u, code)
    assert stats.bit_errors == 2**24 + 63
    assert int(np.float32(stats.bit_errors)) != stats.bit_errors


def test_sweep_backends():
    code = get_code("block_32_64")
    with pytest.raises(ValueError, match="unknown backend"):
        make_sweep_step(code, "cpu", backend="xla")
    with pytest.raises(ValueError, match="CUDA device"):
        make_sweep_step(code, "cpu", method="minsum", backend="cuda")
    with pytest.raises(ValueError, match="minsum/sumproduct"):
        make_sweep_step(code, "cuda", method="hard", backend="cuda")
    # "auto" on the CPU and "torch" draw and decode the same frames alike
    a = make_sweep_step(code, "cpu", method="minsum", frames_per_device=500)
    t = make_sweep_step(code, "cpu", method="minsum", frames_per_device=500,
                        backend="torch")
    assert a(7, 3.0) == t(7, 3.0)


def test_step_decode_is_the_decoder_the_step_runs():
    code = get_code("sim_8_16")
    seen = []

    def decode(rx):
        seen.append(rx)
        return (rx > 0).to(torch.int8)

    step = make_sweep_step(code, "cpu", frames_per_device=200, decode_fn=decode)
    assert step.decode is decode
    stats = step((0, 4, 0), 1.0)
    u, rx = draw_frames(code, 200, (0, 4, 0), 1.0, "cpu")
    assert torch.equal(seen[0], rx)
    assert stats == count_errors(step.decode(rx), u, code)


def test_waterfall_within_the_band_of_the_jax_curve():
    """sim_8_16 (the ldpc_umfpack experiment's code and four decoders) at
    50,000 frames a point, held within the binomial bands of the committed
    JAX curve at 10^6 frames a point."""
    ref = json.loads(REF_8_16.read_text())
    res = run_waterfall("sim_8_16", [-3.0, 1.0, 5.0], frames_per_point=50_000,
                        iterations=ref["iterations"], methods=tuple(ref["methods"]),
                        device="cpu", seed=3)
    assert res.frames_per_point == 50_000
    assert band_check(res, ref) == []
    # the check can fail: a curve shifted by 1 dB leaves its band
    shifted = run_waterfall("sim_8_16", [0.0, 4.0], frames_per_point=50_000,
                            methods=("minsum",), device="cpu", seed=3)
    shifted.ebn0_db = np.array([1.0, 5.0])
    assert band_check(shifted, ref)


def _arrays(seed, methods, points):
    rng = np.random.default_rng(seed)
    return {k: {m: rng.random(points) for m in methods}
            for k in ("ber", "info_ber", "fer", "fer_detected")}


def test_outputs_are_byte_identical_to_jax():
    methods = ("hard", "bitflip", "minsum", "sumproduct")
    kw = dict(code_name="sim_50_100", ebn0_db=np.arange(-7.0, 10.25, 0.5),
              frames_per_point=1_000_000, iterations=5, methods=methods,
              wall_s=12.5, **_arrays(0, methods, 35))
    mine, want = WaterfallResult(**kw), JaxResult(**kw)
    assert mine.to_octave() == want.to_octave()
    assert mine.to_table() == want.to_table()
    assert mine.to_json() == want.to_json()


def test_plot(tmp_path):
    res = run_waterfall("sim_8_16", [0.0, 6.0], frames_per_point=160,
                        iterations=3, methods=("hard",), device="cpu")
    out = tmp_path / "w.png"
    res.plot(str(out))
    assert out.stat().st_size > 1000
    assert len(res.point_wall_s) == 2


def test_waterfall_checkpoint_resume(tmp_path):
    """As test_sim.py: a rerun with the same configuration skips completed
    points; another configuration does not reuse them; corrupt lines are
    ignored."""
    ck = tmp_path / "sweep.ckpt"
    kw = dict(code="block_32_64", ebn0_db=[2.0, 4.0], frames_per_point=256,
              iterations=3, methods=("minsum",), device="cpu",
              checkpoint=str(ck))
    r1 = run_waterfall(**kw)
    lines1 = ck.read_text().splitlines()
    assert len(lines1) == 2
    r2 = run_waterfall(**kw)  # resumes: nothing appended, same numbers
    assert ck.read_text().splitlines() == lines1
    assert np.array_equal(r1.ber["minsum"], r2.ber["minsum"])
    run_waterfall(**{**kw, "seed": 7})
    assert len(ck.read_text().splitlines()) == 4
    run_waterfall(**{**kw, "backend": "torch"})   # the backend is signed too
    assert len(ck.read_text().splitlines()) == 6
    ck.write_text("not json\n" + "\n".join(lines1) + "\n")
    r4 = run_waterfall(**kw)
    assert np.array_equal(r4.ber["minsum"], r1.ber["minsum"])
    assert len(ck.read_text().splitlines()) == 3


def test_same_frames_for_every_method():
    """Every method sees the same frames at a point: the slicer and the
    bit-flip decoder with zero iterations count the same errors."""
    res = run_waterfall("sim_8_16", [2.0], frames_per_point=4000,
                        iterations=0, methods=("hard", "bitflip"), device="cpu")
    assert res.ber["hard"][0] == res.ber["bitflip"][0]


def test_app_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "w.json"
    ldpc_ber_sweep.main(["--device", "cpu", "--code", "sim_8_16",
                         "--points", "3", "--frames-per-point", "500",
                         "--methods", "hard,minsum", "--octave",
                         "--json", str(out)])
    text = capsys.readouterr().out
    assert "BER(minsum)" in text and "semilogy" in text
    doc = json.loads(out.read_text())
    assert doc["code"] == "sim_8_16" and doc["frames_per_point"] == 500
    assert len(doc["ber"]["hard"]) == 3


def test_app_runs_as_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "gr_ldpc_ece535a_torch.apps.ldpc_ber_sweep",
         "--device", "cpu", "--code", "sim_5_10", "--points", "2",
         "--frames-per-point", "100", "--methods", "hard"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "100 frames/point" in proc.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "gr_ldpc_ece535a_torch.apps.ldpc_ber_sweep",
         "--cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "--cpu" in bad.stderr
