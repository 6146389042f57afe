"""The port's parallel layer across processes: gloo on the CPU.

Two worker processes of one shard each (``python -m
gr_ldpc_ece535a_torch.tools.multihost_worker``, launched by
``tools/multicard_check.py::run_layout``) against one process of two
shards: the sweep's all-reduced int64 counters and the stream decode's
digests (its halo crossing the process boundary in one batch_isend_irecv
ring exchange) must be equal, and the one-process stream run equal to the
unsharded oracle.
"""

import subprocess

import pytest

from gr_ldpc_ece535a_torch.tools.multicard_check import TIMEOUT, run_layout

FRAMES = 64


def _run_workers(n_proc: int, shards: int, mode: str) -> dict:
    """Process 0's JSON line; a worker past its own timeout fails the test,
    and the test skips only when gloo cannot initialise."""
    try:
        return run_layout(n_proc, shards, mode, "cpu", FRAMES)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {mode} worker did not finish in {TIMEOUT} s")
    except RuntimeError as e:
        if "init_process_group" in str(e) and "gloo" in str(e).lower():
            pytest.skip(f"gloo cannot initialise here: {str(e)[-200:]}")
        raise


def test_two_process_sweep_matches_one_process():
    dist = _run_workers(2, 1, "sweep")
    single = _run_workers(1, 2, "sweep")
    assert dist["n_global_shards"] == single["n_global_shards"] == 2
    assert dist["n_local_shards"] == 1
    for k in ("bit_errors", "info_bit_errors", "frame_errors",
              "detected_errors", "n_frames", "n_bits"):
        assert type(dist[k]) is int and dist[k] == single[k], k
    assert dist["n_frames"] == 2 * FRAMES and dist["bit_errors"] > 0


def test_two_process_stream_halo_matches_one_process():
    dist = _run_workers(2, 1, "stream")
    single = _run_workers(1, 2, "stream")
    assert single.get("oracle_checked") is True
    assert dist["n_frames"] == single["n_frames"] == 2 * FRAMES - 1
    assert dist["digest_vhat"] == single["digest_vhat"]
    assert dist["digest_w"] == single["digest_w"] != 0
