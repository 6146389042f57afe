"""The worker's weak-scaling bench modes and their launchers, on gloo.

``python -m gr_ldpc_ece535a_torch.tools.multihost_worker --bench [frames]
--device cpu`` and ``--bench-stream`` (the counterparts of
``tools/multihost_worker.py``'s) spawn 1 process x 2 shards and 2 x 2,
time the sweep step and the halo stream decode at the same frames a shard,
and print one JSON line with JAX's keys. Mode "bench"'s step is mode
"sweep"'s: its counters equal a sweep run's at the same shape. The NCCL
launcher needs four cards, one a process, and raises with fewer; the
worker refuses more NCCL processes than cards.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from gr_ldpc_ece535a_torch.tools import multihost_worker
from gr_ldpc_ece535a_torch.tools.multicard_check import run_layout

ROOT = Path(__file__).resolve().parents[1]
JAX_KEYS = {"mode", "frames_per_device", "step_wall_s", "steps_per_s",
            "frames_per_s_global"}
LAUNCHES = {"bench": ("--bench", 256), "bench_stream": ("--bench-stream", 64)}


@pytest.fixture(scope="module")
def launched():
    """mode -> the launcher's JSON line on gloo."""
    out = {}
    for mode, (flag, frames) in LAUNCHES.items():
        run = subprocess.run(
            [sys.executable, "-m",
             "gr_ldpc_ece535a_torch.tools.multihost_worker", flag,
             str(frames), "--device", "cpu"],
            capture_output=True, text=True, cwd=ROOT, timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
        assert len(lines) == 1, run.stdout
        out[mode] = json.loads(lines[0])
    return out


@pytest.mark.parametrize("mode", list(LAUNCHES))
def test_launcher_prints_jax_keys(launched, mode):
    rec = launched[mode]
    frames = LAUNCHES[mode][1]
    assert rec["metric"] == f"weak_scaling_efficiency_1to2proc_{mode}"
    assert rec["value"] > 0
    assert rec["value"] == (rec["one_proc"]["step_wall_s"]
                            / rec["two_proc"]["step_wall_s"])
    assert "gloo" in rec["fabric"]
    assert rec["layouts"] == {"one_proc": [1, 2], "two_proc": [2, 2]}
    for side, shards in (("one_proc", 2), ("two_proc", 4)):
        r = rec[side]
        assert JAX_KEYS <= set(r), side
        assert r["mode"] == mode and r["frames_per_device"] == frames
        assert r["n_global_shards"] == shards and r["n_local_shards"] == 2
        assert (r["step_wall_s_min"] <= r["step_wall_s"]
                <= r["step_wall_s_max"])
        assert rec["spread_s"][side] == [r["step_wall_s_min"],
                                         r["step_wall_s_max"]]
        assert r["timed_steps"] == {"bench": 20, "bench_stream": 10}[mode]
        assert r["frames_per_s_global"] == pytest.approx(
            frames * shards / r["step_wall_s"])


def test_bench_step_counts_as_the_sweep(launched):
    """The two-process layout against a sweep run of that layout; the
    one-process counters are the first half of its frames' draw, so they
    differ, and the sweep's own tests hold layouts to each other."""
    rec = launched["bench"]
    sweep = run_layout(2, 2, "sweep", "cpu", 256)
    stats = rec["two_proc"]["stats"]
    assert stats["n_frames"] == 256 * 4 and stats["bit_errors"] > 0
    assert stats == {k: sweep[k] for k in stats}
    one = rec["one_proc"]["stats"]
    assert one["n_frames"] == 256 * 2 and 0 < one["bit_errors"]


def test_bench_stream_weights_equal_across_layouts(launched):
    """The same stream a shard, so process 0 decodes the same frames in
    both layouts: the one process's two shards and the first process's."""
    rec = launched["bench_stream"]
    assert rec["one_proc"]["weight_sum"] == rec["two_proc"]["weight_sum"] > 0


@pytest.mark.parametrize("cards", [0, 1, 3])
def test_nccl_launcher_needs_four_cards(monkeypatch, cards):
    monkeypatch.setattr(multihost_worker, "_visible_cards", lambda: cards)
    with pytest.raises(RuntimeError, match=f"needs 4 cards; {cards} visible"):
        multihost_worker.bench_launcher(stream=cards == 1)


def test_worker_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(multihost_worker, "_visible_cards", lambda: 1)
    with pytest.raises(RuntimeError, match="need a card each; 1 visible"):
        multihost_worker.main(["0", "2", "29500", "1", "64", "bench", "cuda"])


def test_launcher_rejects_an_unknown_device():
    with pytest.raises(ValueError, match="--device must be cpu or cuda"):
        multihost_worker.main(["--bench", "64", "--device", "tpu"])
