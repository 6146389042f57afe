"""The parity of the port's decoders against the float64 oracles, and the
two-valid diagnosis.

``gr_ldpc_ece535a_torch/tools/parity_f64.py`` is the counterpart of
``tools/parity_f64_r5.py`` and ``tools/twovalid.py`` of
``tools/minsum_twovalid_r5.py``. Here, on the CPU: the port's f32 path
decides as JAX's on 2,048 frames at 4 dB (numpy seed, early exit, 20
iterations); the port's bins equal JAX's ``_decomp`` on the same arrays;
the port's C++ oracle decides as JAX's; a one-batch parity run holds its
bars (the kernels run their plain versions on the CPU); the bars catch a
record that misses them; the run refuses a missing card or oracle; and the
diagnosis of ``results/minsum_twovalid_r5.json``'s two frames reproduces
JAX's record: the float64 word is the f32 path's (JAX's XLA word), the C++
oracle agrees, 51 and 52 of the 64 perturbations land on it and 13 and 12
elsewhere, so both are boundary frames, converged at iterations 15 and 5.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ldpc_ece535a_tpu.codes import get_code as jax_get_code
from gr_ldpc_ece535a_tpu.ops import decode_minsum as jax_decode_minsum
from gr_ldpc_ece535a_tpu.ops import decode_sumproduct as jax_decode_sumproduct
from gr_ldpc_ece535a_tpu.runtime import decode_batch as jax_decode_batch

from gr_ldpc_ece535a_torch import runtime
from gr_ldpc_ece535a_torch.codes import get_code
from gr_ldpc_ece535a_torch.ops import bpsk_map, encode_bits, make_decoder
from gr_ldpc_ece535a_torch.tools import parity_f64, twovalid
from gr_ldpc_ece535a_torch.tools._timing import decomp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import parity_f64_r5 as jparity  # noqa: E402

FRAMES = 2048
JAX_F32 = {"minsum": jax_decode_minsum, "sumproduct": jax_decode_sumproduct}
RECORD = ROOT / "results" / "minsum_twovalid_r5.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one
    machine's cores, and thread pools that each span them all spin against
    each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """(code, rx (FRAMES, N) f32 numpy): block_32_64 at 4 dB from a numpy
    seed."""
    code = get_code("block_32_64")
    rng = np.random.default_rng(15)
    d = torch.from_numpy(rng.integers(0, 2, (FRAMES, code.K)).astype(np.int8))
    tx = bpsk_map(encode_bits(d, code)).numpy()
    sigma = np.sqrt(1.0 / (2 * code.K / code.N * 10 ** (4.0 / 10)))
    rx = (tx + sigma * rng.standard_normal(tx.shape)).astype(np.float32)
    return code, rx


@pytest.fixture(scope="module")
def decisions(frames):
    """method -> {"f32", "kernel", "f64"} decisions of the frames."""
    code, rx = frames
    H = code.H.astype(np.int8)
    t = torch.from_numpy(rx)
    return {m: {**twovalid.words(code, t, m),
                "f64": parity_f64.oracle_decode(rx.astype(np.float64), H, m,
                                                workers=4)}
            for m in parity_f64.METHODS}


@pytest.mark.parametrize("method", ["minsum", "sumproduct"])
def test_f32_path_decides_as_jax(frames, decisions, method):
    code, rx = frames
    want = np.asarray(JAX_F32[method](jnp.asarray(rx), jax_get_code(code.name),
                                      iterations=20, early_exit=True))
    np.testing.assert_array_equal(decisions[method]["f32"], want)


@pytest.mark.parametrize("method", ["minsum", "sumproduct"])
@pytest.mark.parametrize("pair", [("f32", "f64"), ("kernel", "f64"),
                                  ("kernel", "f32")])
def test_bins_equal_jax_decomp(frames, decisions, method, pair):
    code, _ = frames
    H = code.H.astype(np.int8)
    a, b = (decisions[method][k] for k in pair)
    assert decomp(a, b, H) == jparity._decomp(a, b, H)
    # and on decisions that differ in many frames, every bin filled
    flip = a.copy()
    flip[::3, ::5] ^= 1
    assert decomp(flip, b, H) == jparity._decomp(flip, b, H)


@pytest.mark.parametrize("method", [0, 1])
def test_native_oracle_decides_as_jax(frames, method):
    code, rx = frames
    rx64 = rx[:512].astype(np.float64)
    np.testing.assert_array_equal(
        runtime.decode_batch(rx64, code.H, iterations=20, method=method),
        jax_decode_batch(rx64, code.H, iterations=20, method=method))


def test_oracle_threads_decide_as_one_call(frames):
    code, rx = frames
    rx64 = rx[:300].astype(np.float64)
    for m, n in twovalid.NATIVE_METHOD.items():
        np.testing.assert_array_equal(
            parity_f64.oracle_decode(rx64, code.H, m, workers=3),
            runtime.decode_batch(rx64, code.H, iterations=20, method=n))


def test_one_batch_holds_its_bars():
    rec = parity_f64.run_parity(1, "cpu", batch=4096, log=lambda *a: None)
    assert parity_f64.check(rec) == []
    assert rec["frames"] == {"minsum": 4096, "sumproduct": 4096}
    for m, r in rec["results"].items():
        # JAX's bin names under JAX's pair names, and the port's pairs
        for p in ("torch_vs_f64", "kernel_vs_f64"):
            assert set(r[p]) == set(jparity._decomp(
                np.zeros((1, 2)), np.zeros((1, 2)), np.zeros((1, 2))))
        for p in ("kernel_vs_torch", "kernel_vs_plain"):
            assert r[p]["frames"] == 4096
        assert r["kernel_vs_plain"]["mismatch"] == 0    # the plain version
        assert 0 < r["valid"]["f64"] <= 4096
    json.dumps(rec)


def _record(**over):
    bins = {"mismatch": 0, "both_syndrome_fail": 0, "both_valid_different": 0,
            "only_f64_valid": 0, "only_ours_valid": 0}
    pbins = {"frames": 1000, "mismatch": 0, "both_syndrome_fail": 0,
             "both_valid_different": 0, "only_plain_valid": 0,
             "only_kernel_valid": 0}
    r = {"frames": 1000, "torch_vs_f64": dict(bins),
         "kernel_vs_f64": dict(bins), "kernel_vs_torch": dict(pbins),
         "kernel_vs_plain": dict(pbins)}
    rec = {"results": {"minsum": json.loads(json.dumps(r)),
                       "sumproduct": json.loads(json.dumps(r))},
           "cases": []}
    for path, v in over.items():
        *keys, last = path.split("/")
        d = rec
        for k in keys:
            d = d[k]
        d[last] = v
    return rec


@pytest.mark.parametrize("over, miss", [
    ({}, None),
    ({"results/minsum/torch_vs_f64/mismatch": 2}, "minsum torch_vs_f64"),
    ({"results/sumproduct/kernel_vs_f64/mismatch": 2},
     "sumproduct kernel_vs_f64"),
    ({"results/sumproduct/kernel_vs_torch/mismatch": 2},
     "sumproduct kernel_vs_torch"),
    ({"results/minsum/kernel_vs_plain/mismatch": 1}, "than its plain"),
    ({"results/sumproduct/kernel_vs_plain/both_valid_different": 1},
     "two valid codewords"),
    ({"cases": [{"method": "minsum", "batch": 0, "frame": 5,
                 "pairs": ["kernel_vs_f64"], "boundary": False}]},
     "not a boundary frame"),
])
def test_check_catches_each_bar(over, miss):
    got = parity_f64.check(_record(**over))
    if miss is None:
        assert got == []
    else:
        assert len(got) == 1 and miss in got[0], got


def test_run_refuses_a_missing_card_or_oracle(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity_f64.run_parity(1, "cuda", batch=64)
    monkeypatch.setattr(parity_f64, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="oracle did not build"):
        parity_f64.run_parity(1, "cpu", batch=64)


def test_twovalid_reproduces_jax_record(tmp_path):
    jax_rec = json.loads(RECORD.read_text())
    out = tmp_path / "tv.json"
    twovalid.main(["--device", "cpu", "--from-record", str(RECORD),
                   "--out", str(out)])
    doc = json.loads(out.read_text())
    assert doc["n_cases"] == doc["n_boundary"] == 2
    for got, want in zip(doc["cases"], jax_rec["cases"]):
        assert (got["batch"], got["frame"]) == (want["batch"], want["frame"])
        assert got["method"] == "minsum"
        assert got["rx"] == want["rx"]
        # JAX's "xla": the float64 word is the f32 path's
        assert want["f64_oracle_matches"] == "xla"
        assert got["f64_oracle_matches"] in ("f32", "both")
        assert got["hamming"]["f32_vs_f64"] == 0
        assert got["f64_valid"] is want["f64_valid"] is True
        assert got["cpp_matches_f64"] is want["cpp_matches_f64"] is True
        assert got["conv_iter_f32"] == want["conv_iter_xla"]
        land, jland = got["perturb_1e6_landing"], want["perturb_1e6_landing"]
        assert land["trials"] == jland["trials"] == 64
        assert land["on_f32_word"] == jland["on_xla_word"]
        assert land["on_f64_word"] == jland["on_xla_word"]
        assert (land["trials"] - land["on_f32_word"]
                == jland["on_pallas_word"] + jland["elsewhere"])
        assert land["distinct_words"] >= 2 and got["boundary"] is True
    assert [c["perturb_1e6_landing"]["on_f32_word"]
            for c in doc["cases"]] == [51, 52]


def test_diagnose_a_decided_frame(frames):
    """A frame every decoder decides alike is no boundary frame, and each
    decoder's word is where the perturbations land."""
    code, rx = frames
    d = twovalid.diagnose(code, rx[0], "sumproduct", 0, 0, "cpu")
    assert d["boundary"] is False and d["f64_oracle_matches"] == "both"
    land = d["perturb_1e6_landing"]
    assert land["on_f32_word"] == land["on_f64_word"] == 64
    assert land["distinct_words"] == 1 and land["elsewhere"] == 0
    assert d["conv_iter_f32"] == d["conv_iter_kernel"] is not None
    assert "pairs" not in d
    v = make_decoder(code, "sumproduct", 20, backend="torch")(
        torch.from_numpy(rx[:1]))
    assert d["valid"]["f32"] == bool(
        ((v.numpy().astype(int) @ code.H.T.astype(int)) % 2 == 0).all())
