"""The port's main path as a whole, against the JAX package's, on the CPU.

The same bytes and the same numpy noise go through both packages' slice
(encode -> BPSK -> AWGN at 5 dB -> 20-iteration sum-product -> pack).
"""

import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu import ops as jops
from gr_ldpc_ece535a_tpu.codes import get_code

from gr_ldpc_ece535a_torch.entry import (CODE_NAME, EBN0_DB, ITERATIONS,
                                         entry, receive)
from gr_ldpc_ece535a_torch.ops import cuda_bp, encode_to_symbols

ROOT = Path(__file__).resolve().parents[1]


def test_slice_matches_jax_with_shared_noise():
    code = get_code(CODE_NAME)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (1024, code.K // 8), dtype=np.uint8)
    tx = encode_to_symbols(torch.from_numpy(data), code).numpy()
    np.testing.assert_array_equal(
        tx, np.asarray(jops.encode_to_symbols(jnp.asarray(data), code)))
    n0 = np.float32(10 ** (-EBN0_DB / 10))
    rx = (tx + np.sqrt(n0) * rng.standard_normal(tx.shape).astype(np.float32))
    rx = rx.astype(np.float32)

    # the JAX package's flagship step (__graft_entry__.entry) after its awgn
    vhat = jops.decode_sumproduct(jnp.asarray(rx), code, iterations=ITERATIONS,
                                  early_exit=False)
    want = np.asarray(jops.pack_bits(vhat[:, code.M:]))
    got = receive(torch.from_numpy(rx), code).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got == want).all(axis=1).mean() >= 0.99
    # and both decode the payload about equally well
    fer_got = (got != data).any(axis=1).mean()
    fer_want = (want != data).any(axis=1).mean()
    assert abs(fer_got - fer_want) <= 0.01, (fer_got, fer_want)


def test_entry_runs_on_cpu():
    forward, (generator, data) = entry(device="cpu")
    code = get_code(CODE_NAME)
    assert data.shape == (256, code.K // 8) and data.dtype == torch.uint8
    before = dict(cuda_bp.LAUNCHES)
    out = forward(generator, data)
    assert out.shape == data.shape and out.dtype == torch.uint8
    assert (out != data).any(1).float().mean() <= 0.1
    assert cuda_bp.LAUNCHES == before  # plain version
    again = entry(device="cpu")
    assert torch.equal(again[0](*again[1]), out)   # seeded generator


def test_entry_defaults_to_the_card():
    """entry() with no argument builds on cuda; without a card it raises
    instead of falling back to the CPU."""
    assert inspect.signature(entry).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            entry()


def _run_smoke(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    """No CPU fallback: without a card the smoke run exits non-zero and
    prints no result line."""
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
