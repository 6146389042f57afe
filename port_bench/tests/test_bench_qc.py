"""The quasi-cyclic reference (``reference/qc.py``) against the port on the
CPU, for the 802.11n (1944, 972) code of ``configs/sim_80211n_1944.json``:
the same H and parity operator, the same draws, the same plain-decoder
decisions, and the counts of a small ``run_waterfall``. This test imports
both; the reference itself imports nothing of the port."""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.codes._qc_data import QC_DATA, expand_qc
from gr_ldpc_ece535a_torch.ops import cuda_bp, syndrome_ok
from gr_ldpc_ece535a_torch.parallel.sweep import draw_frames
from gr_ldpc_ece535a_torch.sim.waterfall import run_waterfall
from port_bench.harness import sweep as common
from port_bench.reference import qc
from port_bench.reference import sweep as ref

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "port_bench" / "configs"
                     / "sim_80211n_1944.json").read_text())
CELL = "sim_80211n_1944.bp"
PLAIN = {"minsum": cuda_bp.decode_minsum_plain,
         "sumproduct": cuda_bp.decode_sumproduct_plain}


@pytest.fixture(scope="module")
def codes():
    """(the reference's code, the port's), each built once (about 6 s and
    0.4 s here)."""
    return qc.load_config_code(CONFIG), get_code(CONFIG["code"])


def test_the_expanders_agree_bit_for_bit():
    Z, proto, order = QC_DATA[CONFIG["code"]]
    assert (CONFIG["Z"], CONFIG["prototype"], CONFIG["column_order"]) == (
        Z, [list(r) for r in proto], list(order))
    mine = qc.expand(CONFIG["prototype"], CONFIG["Z"], CONFIG["column_order"])
    port = expand_qc(proto, Z, order)
    assert mine.dtype == np.uint8 and port.dtype == np.int8
    assert np.array_equal(mine, port)
    small = np.where(np.array(proto) < 0, -1, np.array(proto) % 7)
    assert np.array_equal(qc.expand(small, 7, range(24)), expand_qc(small, 7))


def test_the_codes_match_the_port(codes):
    mine, port = codes
    assert (mine.M, mine.N, mine.K, mine.edges) == (972, 1944, 972, 6966)
    assert np.array_equal(mine.H, port.H)
    assert np.array_equal(mine.G, port.P)
    assert qc.load_config_code(CONFIG) is mine


@pytest.mark.parametrize("key", [(3, 0, 0), (2**40 + 5, 10, 1)])
def test_draws_match_the_port(codes, key):
    mine = ref.draw(codes[0], 64, key, 1.25, "cpu")
    port = draw_frames(codes[1], 64, list(key), 1.25, "cpu")
    assert torch.equal(mine[0], port[0])
    assert torch.equal(mine[1], port[1])


@pytest.mark.parametrize("method", ["minsum", "sumproduct"])
@pytest.mark.parametrize("ebn0", [1.5, 3.0])
def test_decisions_match_the_port_plain_decoders(codes, method, ebn0):
    """The reference's decoders against the plain versions of the port's
    kernels, 20 iterations with early exit, 96 frames. Where every frame
    converges (3 dB) and for the sum-product (whose failed frames saturate)
    the decisions are equal. The min-sum's frames that converge in neither
    decoder may differ (1.5 dB): the reference adds a variable's messages
    in ascending check order, the port in ascending w-major slot order, and
    over 20 iterations a frame that does not converge carries those
    roundings into other wrong bits. Such frames fail in both, so the frame
    and detected error counts agree."""
    mine_code, port_code = codes
    u, rx = ref.draw(mine_code, 96, (11, int(ebn0 * 4), 0), ebn0, "cpu")
    mine, passes = ref.decode(method, rx, mine_code, 20, True)
    port = PLAIN[method](rx, port_code, 20, True)
    differ = (mine != port).any(1)
    if method == "sumproduct" or ebn0 >= 3.0:
        assert not differ.any()
    ok_m, ok_p = syndrome_ok(mine, port_code.H), syndrome_ok(port, port_code.H)
    assert not (differ & (ok_m | ok_p)).any()
    assert torch.equal(ok_m, ok_p)
    assert int(passes.max()) <= 20


def _decoder_case(code, method, early_exit, dtype, ebn0, frames, device):
    _, rx = ref.draw(code, frames, (17, int(ebn0 * 4), 0), ebn0, device)
    want = ref.decode(method, rx, code, 20, early_exit, dtype)
    got = qc.decode(method, rx, code, 20, early_exit, dtype)
    assert torch.equal(got[0], want[0]), (method, early_exit, dtype, ebn0)
    assert torch.equal(got[1], want[1]), (method, early_exit, dtype, ebn0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("method", ["minsum", "sumproduct"])
@pytest.mark.parametrize("name", ["sim_50_100", "ieee80211n_1944_r12"])
def test_the_fast_decoders_are_the_sweep_decoders_bit_for_bit(
        codes, name, method, early_exit, dtype):
    """``qc.decode`` against ``sweep.decode``: the same decisions and passes,
    bit for bit, in float32 and in the control's bfloat16, on the 802.11n
    code (column weights 2 to 11) and on a codes.json code, at an Eb/N0
    where most frames fail (their messages run all 20 passes) and one where
    they converge."""
    from port_bench.reference.code import load_code

    code = codes[0] if name == CONFIG["code"] else load_code(name)
    for ebn0 in (1.0, 2.5):
        _decoder_case(code, method, early_exit, dtype, ebn0, 48, "cpu")


def test_the_fast_decoders_pass_the_other_methods_on(codes):
    from port_bench.reference.code import load_code

    code = load_code("sim_50_100")
    _, rx = ref.draw(code, 32, (1, 0, 0), 2.0, "cpu")
    for method in ("hard", "bitflip"):
        got, want = (qc.decode(method, rx, code, 20),
                     ref.decode(method, rx, code, 20))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["minsum", "sumproduct"])
def test_the_fast_decoders_are_the_sweep_decoders_on_gpu(codes, method):
    """As on the CPU, on the card at 4,096 frames: float32 and bfloat16,
    early exit on and off, where frames fail and where they converge."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for early_exit in (True, False):
        for dtype in (torch.float32, torch.bfloat16):
            for ebn0 in (1.0, 2.5):
                _decoder_case(codes[0], method, early_exit, dtype, ebn0, 4096,
                              "cuda")


def test_counts_match_a_port_sweep(tiny_cell, codes):
    """A CPU ``run_waterfall`` of 2 points x 512 frames (where the min-sum
    converges, so every count is exact) against the reference counts of
    ``drivers/sweep_qc.py``."""
    cell = tiny_cell(CELL)
    cell.config = {**cell.config, "frames_per_point": 512,
                   "ebn0_db": {"start": 2.5, "stop": 3.0, "step": 0.5}}
    cell.traffic = {**cell.traffic, "frames_per_step": 512, "check_points": 2}
    load = common.load_of(cell.config, cell.traffic)
    assert (load.grid, load.steps) == ((2.5, 3.0), 1)
    drv = cell.driver()
    res = run_waterfall(load.code, ebn0_db=list(load.grid),
                        frames_per_point=load.frames_per_point,
                        iterations=load.iterations, methods=load.methods,
                        device="cpu", seed=99,
                        frames_per_step=load.frames_per_step)
    got = drv.counts_of(res, load, codes[0].N, codes[0].K)
    for p in range(len(load.grid)):
        want = drv.reference_counts(load, codes[0], 99, p, "cpu")
        for j, m in enumerate(load.methods):
            assert got[p, j].tolist() == want[m].tolist(), (p, m)


def test_the_cell_names_the_code_and_its_files(tiny_cell):
    cell = tiny_cell(CELL)
    assert cell.config["code"] == "ieee80211n_1944_r12"
    assert cell.traffic["driver"] == "sweep_qc"
    assert set(cell.limits) == {"gap.minsum", "gap.sumproduct"}
    names = {m["name"] for m in cell.per_layer}
    assert {"bp_wide_roofline.sim", "bp_wide_busy_pct.sim",
            "bp_lane_use_pct.sim", "step_enqueue_ms.sim", "step_wait_ms.sim",
            "sweep_self_ms.sim", "draw_idle_ms.sim"} <= names
    assert "bp_roofline.sim" not in names
    assert [m["name"] for m in cell.end_to_end] == ["sim_frames_per_s",
                                                    "setup_s"]


def _tiny(tiny_cell):
    """The cell at 2 points x 128 frames, where the min-sum converges."""
    cell = tiny_cell(CELL)
    cell.config = {**cell.config, "frames_per_point": 128,
                   "ebn0_db": {"start": 2.5, "stop": 3.0, "step": 0.5}}
    cell.traffic = {**cell.traffic, "frames_per_step": 128}
    return cell


def _run(cell, trace):
    spec = importlib.util.spec_from_file_location(
        "port_bench_run_py_qc", ROOT / "port_bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run(cell, 2**33 + 7, 0.05, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(tiny_cell, trace):
    """``drivers/sweep_qc.py``'s set-up, window and check on the CPU: correct,
    both gaps 0 where every frame converges."""
    out = _run(_tiny(tiny_cell), trace)
    assert out["correct"] and out["failed"] == 0
    assert {n: c["value"] for n, c in out["checks"].items()} == {
        "gap.minsum": 0.0, "gap.sumproduct": 0.0}
    if not trace:
        assert set(out["metrics"]) == {"sim_frames_per_s", "setup_s"}


def test_a_decision_altered_where_it_is_made_fails(tiny_cell, monkeypatch):
    from gr_ldpc_ece535a_torch.parallel import sweep

    counts = sweep._counts

    def altered(vhat, u, code):
        vhat = vhat.clone()
        vhat[:, 0] ^= 1
        return counts(vhat, u, code)

    monkeypatch.setattr(sweep, "_counts", altered)
    assert not _run(_tiny(tiny_cell), False)["correct"]


def test_the_traced_work_counts_the_reference_passes(tiny_cell):
    cell = _tiny(tiny_cell)
    drv = cell.driver().Driver(cell, 5, torch.device("cpu"))
    drv.window(0.0)
    work = drv.counters()["bp"]
    assert [(w["method"], w["frames"], w["decodes"]) for w in work] == [
        (m, 128, 1) for _ in range(2) for m in ("minsum", "sumproduct")]
    assert all(w["N"] == 1944 and w["edges"] == 6966 for w in work)
    assert all(128 <= w["passes"] <= 128 * 20 for w in work)
