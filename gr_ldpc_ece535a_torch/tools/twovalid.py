"""Diagnosis of the frames on which two decoders reach different valid
codewords.

    python -m gr_ldpc_ece535a_torch.tools.twovalid [--device cuda|cpu]
        [--batches 8] [--from-record PATH] [--out PATH]

The counterpart of ``tools/minsum_twovalid_r5.py``, for both methods. Its
frames are every frame that ``tools/parity_f64.py`` finds in a
``both_valid_different`` bin of any pair (the f32 path, the kernel, the C++
float64 oracle), or with ``--from-record`` the ``rx`` of each case of a
record such as ``results/minsum_twovalid_r5.json`` (its ``method``, else
min-sum). For each frame ``diagnose`` reports:

  - the decisions of the f32 path (``ops/decode.py``) and of the kernel
    (``make_decoder(backend="auto")``: on a card the tile kernel in precise
    mode, on the CPU its plain version), 20 iterations, early exit, and the
    Hamming distances between them and the float64 word;
  - the convergence iteration of each: the first k at which a decode with
    ``iterations=k`` passes the syndrome (early exit freezes at the first
    valid word, so decode(k) is decode(k') for k' >= k after that);
  - the float64 word (``ops/oracle.py``: ``decode_log_domain_simple`` for
    min-sum, ``decode_sum_product_soft`` for sum-product), which decoders it
    matches ("f32", "kernel", "both" or "neither"; JAX's "xla" is the f32
    path's, its "pallas" the kernel's), and whether the C++ oracle
    (``runtime.decode_batch``) gives it;
  - where 64 perturbations of 1e-6, drawn from
    ``np.random.default_rng(batch * 131072 + frame)`` and decoded by that
    float64 oracle, land: on the f32 word, the kernel's, the float64 word,
    elsewhere, and on how many distinct words.

A frame is a boundary frame when its perturbations land on at least two
distinct words: an arithmetic difference in the last bits then picks the
word, not a fault of either decoder.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..codes import LdpcCode, get_code
from ..ops import make_decoder
from ..ops.oracle import decode_log_domain_simple, decode_sum_product_soft
from ..runtime import decode_batch
from ._timing import valid_rows

__all__ = ["diagnose", "diagnose_record", "words", "conv_iter", "ORACLES",
           "NATIVE_METHOD", "ITERATIONS", "TRIALS", "SIGMA", "SEED_STRIDE"]

ITERATIONS = 20
TRIALS = 64
SIGMA = 1e-6
SEED_STRIDE = 1 << 17    # frame j of batch i draws from i * 131072 + j
CODE = "block_32_64"
ORACLES = {"minsum": decode_log_domain_simple,
           "sumproduct": decode_sum_product_soft}
NATIVE_METHOD = {"minsum": 0, "sumproduct": 1}
DECODERS = ("f32", "kernel")


def _syndrome_ok(v: np.ndarray, H: np.ndarray) -> bool:
    return bool(valid_rows(v[None], H)[0])


def _decoder(code: LdpcCode, method: str, which: str, iterations: int):
    backend = {"f32": "torch", "kernel": "auto"}[which]
    return make_decoder(code, method, iterations, early_exit=True,
                        backend=backend)


def words(code: LdpcCode, rx: torch.Tensor, method: str,
          iterations: int = ITERATIONS) -> dict:
    """{"f32", "kernel"} -> (B, N) int8 numpy decisions of rx (B, N)."""
    return {w: _decoder(code, method, w, iterations)(rx).cpu().numpy()
            for w in DECODERS}


def conv_iter(code: LdpcCode, rx: torch.Tensor, method: str, which: str,
              iterations: int = ITERATIONS):
    """The first k in 1..iterations at which ``which`` decodes the one frame
    rx (1, N) to a word that passes the syndrome; None if none does."""
    for k in range(1, iterations + 1):
        v = _decoder(code, method, which, k)(rx).cpu().numpy()[0]
        if _syndrome_ok(v, code.H):
            return k
    return None


def diagnose(code: LdpcCode, rx, method: str, batch: int, frame: int,
             device="cuda", pairs=None) -> dict:
    """The diagnosis of one frame (see the module's docstring). ``rx`` is
    its (N,) float32 received values; the oracles see them widened to
    float64. ``pairs`` names the bins it was found in (kept as given)."""
    rx32 = np.asarray(rx, np.float32)
    rx64 = rx32.astype(np.float64)
    H = code.H
    t = torch.as_tensor(rx32, device=torch.device(device))[None]
    w = {k: v[0] for k, v in words(code, t, method).items()}
    oracle = ORACLES[method]
    w["f64"] = np.asarray(oracle(rx64, H, iterations=ITERATIONS), np.int8)
    cpp = decode_batch(rx64[None], H, iterations=ITERATIONS,
                       method=NATIVE_METHOD[method])[0]
    on = [name for name in DECODERS if (w["f64"] == w[name]).all()]
    matches = "both" if len(on) == 2 else on[0] if on else "neither"
    rng = np.random.default_rng(batch * SEED_STRIDE + frame)
    land = {f"on_{k}_word": 0 for k in (*DECODERS, "f64")}
    land["elsewhere"] = 0
    seen = set()
    for _ in range(TRIALS):
        rp = rx64 + SIGMA * rng.standard_normal(rx64.shape)
        vv = np.asarray(oracle(rp, H, iterations=ITERATIONS), np.int8)
        seen.add(vv.tobytes())
        hit = [k for k in (*DECODERS, "f64") if (vv == w[k]).all()]
        for k in hit:
            land[f"on_{k}_word"] += 1
        land["elsewhere"] += not hit
    land.update(distinct_words=len(seen), trials=TRIALS)
    return {
        "batch": batch, "frame": frame, "method": method,
        **({"pairs": list(pairs)} if pairs is not None else {}),
        "hamming": {"kernel_vs_f32": int((w["kernel"] != w["f32"]).sum()),
                    "f32_vs_f64": int((w["f32"] != w["f64"]).sum()),
                    "kernel_vs_f64": int((w["kernel"] != w["f64"]).sum())},
        "valid": {k: _syndrome_ok(w[k], H) for k in (*DECODERS, "f64")},
        "conv_iter_f32": conv_iter(code, t, method, "f32"),
        "conv_iter_kernel": conv_iter(code, t, method, "kernel"),
        "kernel_impl": "cuda" if t.is_cuda else "plain version (CPU)",
        "f64_oracle_matches": matches,
        "f64_valid": _syndrome_ok(w["f64"], H),
        "cpp_matches_f64": bool((cpp == w["f64"]).all()),
        "perturb_1e6_landing": land,
        "boundary": len(seen) >= 2,
        "rx": rx64.tolist(),
    }


def diagnose_record(record: dict, device="cuda", log=print) -> list[dict]:
    """``diagnose`` on the rx of every case of a record under the case's
    ``method``; a case that names none is min-sum (JAX's record is the
    min-sum diagnosis)."""
    code = get_code(CODE)
    out = []
    for c in record["cases"]:
        d = diagnose(code, c["rx"], c.get("method", "minsum"), c["batch"],
                     c["frame"], device, c.get("pairs"))
        log(json.dumps({k: v for k, v in d.items() if k != "rx"}))
        out.append(d)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batches", type=int, default=8,
                    help="the parity tool's batches to search")
    ap.add_argument("--from-record", default=None, metavar="PATH",
                    help="diagnose the rx of this record's cases instead")
    ap.add_argument("--out", default=None, help="write the cases here")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is visible")
    if args.from_record:
        source = args.from_record
        cases = diagnose_record(json.loads(Path(source).read_text()),
                                args.device)
    else:
        from . import parity_f64

        source = f"tools/parity_f64.py, {args.batches} batches"
        cases = parity_f64.run_parity(args.batches, args.device)["cases"]
    doc = {"what": ("diagnosis of frames on which two decoders reach "
                    "different valid codewords (early exit, 20 iterations)"),
           "source": source, "device": args.device,
           "n_cases": len(cases),
           "n_boundary": sum(c["boundary"] for c in cases),
           "cases": cases, "wall_s": time.perf_counter() - t0}
    print(json.dumps({k: v for k, v in doc.items() if k != "cases"}))
    if args.out:
        Path(args.out).write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    main()
