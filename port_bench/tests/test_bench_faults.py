"""A run driven without the look for a card, at a tiny size on the CPU:
sound, it comes out correct; with the timed path broken underneath, or
with the control in the program's place, it does not."""

import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
SIM_CELLS = ("sim_50_100.bp", "sim_50_100.ref4")


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "port_bench_run_py", ROOT / "port_bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cell, trace=False, seed=12345678901):
    return _run_module().run(cell, seed, 0.05, trace, "cpu",
                             time.perf_counter())


@pytest.mark.parametrize("name", SIM_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(tiny_cell, name, trace):
    out = _run(tiny_cell(name), trace)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {f"gap.{m}" for m in
                                  tiny_cell(name).traffic["methods"]}
    if not trace:
        assert set(out["metrics"]) == {"sim_frames_per_s", "setup_s"}
        assert out["metrics"]["sim_frames_per_s"]["value"] > 0


@pytest.mark.parametrize("name", SIM_CELLS)
def test_a_decision_altered_where_it_is_made_fails(tiny_cell, name,
                                                   monkeypatch):
    from gr_ldpc_ece535a_torch.parallel import sweep

    counts = sweep._counts

    def altered(vhat, u, code):
        vhat = vhat.clone()
        vhat[:, 0] ^= 1
        return counts(vhat, u, code)

    monkeypatch.setattr(sweep, "_counts", altered)
    assert not _run(tiny_cell(name))["correct"]


@pytest.mark.parametrize("name", SIM_CELLS)
def test_half_the_batch_left_out_fails(tiny_cell, name, monkeypatch):
    from gr_ldpc_ece535a_torch.parallel import sweep

    draw = sweep.draw_frames

    def half(code, frames, key, ebn0_db, device):
        u, rx = draw(code, frames // 2, key, ebn0_db, device)
        return torch.cat([u, u]), torch.cat([rx, rx])

    monkeypatch.setattr(sweep, "draw_frames", half)
    assert not _run(tiny_cell(name))["correct"]


@pytest.mark.parametrize("name", SIM_CELLS + ("sim_50_100.bp.x4",))
def test_the_control_in_the_program_place_fails(tiny_cell, name):
    """The driver module's Control, as checks/control.py --control runs it:
    the reference's sweep in bfloat16 where the program's was."""
    cell = _x4_cell() if name.endswith(".x4") else tiny_cell(name)
    drv = cell.driver().Control(cell, 7, torch.device("cpu"))
    drv.window(0.01)
    checks, failed = drv.check()
    assert failed and any(v > lim for _, v, lim in checks)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "sim_50_100.bp",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    _card()
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "sim_50_100.bp",
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_a_tree_of_only_the_benchmark_gives_no_result(tmp_path):
    _card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "sim_50_100.bp",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


# the receive cell at 4,096 frames a capture (32 timing blocks), two captures
RX_TINY = {"frames_per_capture": 4096, "captures": 2}


def _rx_cell():
    """The receive cell, built from its files (its workloads entry is not
    in BENCHMARK.json yet)."""
    from port_bench.harness.manifest import Manifest

    e2e = [{"name": n, "unit": u} for n, u in (
        ("rx_samples_per_s", "sample/s"), ("rx_capture_p95_ms", "ms"),
        ("setup_s", "s"))]
    per_layer = [{"name": n, "unit": u} for n, u in (
        ("device_idle_pct.rx", "%"), ("chain_ms.rx", "ms"),
        ("tracker_roofline.rx", "%"), ("receive_ms.rx", "ms"))]
    cell = Manifest(ROOT).build(
        {"name": "rx_block_32_64.chain", "config": "rx_block_32_64",
         "traffic": "rx_chain", "chips": 1},
        "port_bench/configs/rx_block_32_64.json", e2e, per_layer)
    cell.traffic = {**cell.traffic, **RX_TINY}
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_receive_is_correct(trace):
    out = _run(_rx_cell(), trace, seed=2**31 + 11)
    assert out["correct"], out["checks"]
    assert out["checks"]["wrong_frames"]["value"] == 0
    if trace:
        assert out["metrics"]["receive_ms.rx"]["value"] > 0
    else:
        assert set(out["metrics"]) == {"rx_samples_per_s",
                                       "rx_capture_p95_ms", "setup_s"}


def test_a_decoded_bit_altered_where_it_is_made_fails(monkeypatch):
    """The first data bit of every frame the receiver emits flipped."""
    from gr_ldpc_ece535a_torch.parallel.receiver import StreamReceiver

    receive = StreamReceiver.receive

    def altered(self, symbols, **kw):
        res = receive(self, symbols, **kw)
        data = np.frombuffer(res.data, np.uint8).reshape(-1, 4).copy()
        data[:, 0] ^= 0x80
        res.data = data.tobytes()
        return res

    monkeypatch.setattr(StreamReceiver, "receive", altered)
    out = _run(_rx_cell(), seed=5)
    assert not out["correct"] and out["checks"]["wrong_frames"]["value"] > 0


def test_half_the_capture_left_out_fails(monkeypatch):
    cell = _rx_cell()
    mod = cell.driver()
    chain = mod.program_chain

    def half(xp, config):
        return chain(xp[:, :xp.shape[1] // 2].contiguous(), config)

    monkeypatch.setattr(mod.Driver, "chain", staticmethod(half))
    out = _run(cell, seed=6)
    assert not out["correct"] and out["checks"]["wrong_frames"]["value"] == 0


def _x4_cell():
    """The four-card cell at the tiny size, built from its files (its
    workloads entry is not in BENCHMARK.json yet)."""
    from port_bench.harness.manifest import Manifest

    from conftest import TINY_CONFIG, TINY_TRAFFIC

    cell = Manifest(ROOT).build(
        {"name": "sim_50_100.bp.x4", "config": "sim_50_100",
         "traffic": "sim_bp_x4", "chips": 4},
        "port_bench/configs/sim_50_100.json",
        [{"name": "sim_frames_per_s", "unit": "frame/s"},
         {"name": "setup_s", "unit": "s"}],
        [{"name": n, "unit": u} for n, u in (
            ("device_idle_pct.sim", "%"), ("bp_roofline.sim", "%"),
            ("allreduce_ms.sim", "ms"))])
    cell.config = {**cell.config, **TINY_CONFIG}
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC}
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_mesh_sweep_is_correct(trace):
    """Four gloo processes, one shard each, on the CPU."""
    out = _run(_x4_cell(), trace, seed=2**31 + 3)
    assert out["correct"] and out["device"]["count"] == 4


SKIP_EXCHANGE = """
import gr_ldpc_ece535a_torch.parallel.sweep as sweep
sweep._all_reduce = lambda counts, group: counts
"""


def test_the_exchange_left_out_fails(tmp_path, monkeypatch):
    """Every process's step skips the all-reduce (the workers through a
    sitecustomize on their path): each holds only its own shard's counts."""
    from gr_ldpc_ece535a_torch.parallel import sweep

    (tmp_path / "sitecustomize.py").write_text(SKIP_EXCHANGE)
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{ROOT}")
    monkeypatch.setattr(sweep, "_all_reduce", lambda counts, group: counts)
    out = _run(_x4_cell(), seed=4)
    assert not out["correct"]
