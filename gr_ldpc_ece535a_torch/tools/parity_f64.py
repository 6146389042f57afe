"""Hard-decision parity of the f32 path and the kernels against the C++
float64 oracle.

    python -m gr_ldpc_ece535a_torch.tools.parity_f64 [--batches 8]
        [--device cuda|cpu] [--frames 131072] [--out PATH]

The counterpart of ``tools/parity_f64_r5.py``. The workload: block_32_64 at
4 dB, 20 iterations, early exit (the reference's: freeze at the first valid
word), ``--batches`` batches of ``--frames`` frames, batch i drawn by
``make_inputs`` from ``torch.Generator(device).manual_seed(1000 + i)``.
For each method (min-sum, sum-product) four decoders decide every frame:

  - the f32 path, ``make_decoder(backend="torch")`` (``ops/decode.py``);
  - the kernel, ``make_decoder(backend="auto")``: on a card the tile kernel
    in precise mode (PERF.md rows 1-2), on the CPU its plain version;
  - the kernel's plain version (``ops/cuda_bp.py``), on the same device;
  - the oracle, ``runtime.decode_batch`` (C++, float64) on the f32 rx
    widened to float64, on a pool of ``os.cpu_count()`` threads (the ctypes
    call releases the GIL, and threads keep CUDA out of forked processes).

The record keeps the bins of ``tools/parity_f64_r5.py`` under its names
(``torch_vs_f64``, ``kernel_vs_f64``: ``tools/_timing.py::decomp``) and
adds ``kernel_vs_torch`` and ``kernel_vs_plain`` (``_timing.bins``) and
each decoder's count of valid words. The kernels sum a variable's other
messages where the f32 path and the reference take the total less the
edge's own, so the kernel and the f32 path part on a few frames in 10^4
under min-sum too. Every frame in a ``both_valid_different`` bin of any pair is
diagnosed by ``tools/twovalid.py`` (``cases``). ``check`` holds the bars;
``main`` writes the record (default ``results/torch_parity_f64.json``) and
fails if a bar does not hold. The frames are not JAX's (torch's generator
is not JAX's PRNG), so ``results/parity_f64_r5.json`` compares as rates.
On ``cuda`` the run raises when no card is visible, and on any device when
the native oracle did not build.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..codes import LdpcCode, get_code
from ..ops import make_decoder
from ..ops.cuda_bp import decode_minsum_plain, decode_sumproduct_plain
from ..runtime import decode_batch, native_available
from . import twovalid
from ._timing import bins, decomp, make_inputs, valid_rows

__all__ = ["run_parity", "parity_batch", "oracle_decode", "check", "PAIRS",
           "BATCH", "N_BATCHES", "SEED", "ITERATIONS", "EBN0_DB", "METHODS",
           "MAX_MISMATCH", "OUT"]

ROOT = Path(__file__).resolve().parents[2]     # the package's parent
OUT = ROOT / "results" / "torch_parity_f64.json"
CODE = "block_32_64"
BATCH = 1 << 17
N_BATCHES = 8
SEED = 1000
ITERATIONS = twovalid.ITERATIONS
EBN0_DB = 4.0
METHODS = ("minsum", "sumproduct")
MAX_MISMATCH = 1e-3     # each path's mismatched share against the oracle
# the decoders of each pair whose two-valid frames are diagnosed
TWO_VALID = {"torch_vs_f64": ("f32", "f64"), "kernel_vs_f64": ("kernel", "f64"),
             "kernel_vs_torch": ("kernel", "f32")}
PAIRS = (*TWO_VALID, "kernel_vs_plain")
PLAINS = {"minsum": decode_minsum_plain, "sumproduct": decode_sumproduct_plain}


def oracle_decode(rx64: np.ndarray, H: np.ndarray, method: str,
                  workers: int) -> np.ndarray:
    """runtime.decode_batch over ``workers`` threads, 4 chunks each."""
    chunks = np.array_split(rx64, workers * 4)
    m = twovalid.NATIVE_METHOD[method]
    with ThreadPoolExecutor(workers) as pool:
        return np.concatenate(list(pool.map(
            lambda c: decode_batch(c, H, iterations=ITERATIONS, method=m),
            chunks)))


def parity_batch(code: LdpcCode, rx: torch.Tensor, method: str,
                 workers: int) -> tuple[dict, dict, dict, float]:
    """(bins of each pair, valid counts, {frame: [pairs]} of the frames
    two-valid in some pair, the oracle's seconds) for one batch."""
    H = code.H.astype(np.int8)
    vt = make_decoder(code, method, ITERATIONS, early_exit=True,
                      backend="torch")(rx)
    vk = make_decoder(code, method, ITERATIONS, early_exit=True,
                      backend="auto")(rx)
    vp = PLAINS[method](rx, code, ITERATIONS, early_exit=True)
    t0 = time.perf_counter()
    v64 = oracle_decode(rx.cpu().numpy().astype(np.float64), H, method,
                        workers)
    oracle_s = time.perf_counter() - t0
    v = {"f32": vt.cpu().numpy(), "kernel": vk.cpu().numpy(), "f64": v64}
    ok = {k: valid_rows(a, H) for k, a in v.items()}
    out = {"torch_vs_f64": decomp(v["f32"], v64, H),
           "kernel_vs_f64": decomp(v["kernel"], v64, H),
           "kernel_vs_torch": _counts(bins(vk, vt, code)),
           "kernel_vs_plain": _counts(bins(vk, vp, code))}
    found: dict = {}
    for pair, (a, b) in TWO_VALID.items():
        two = (v[a] != v[b]).any(1) & ok[a] & ok[b]
        for j in np.nonzero(two)[0].tolist():
            found.setdefault(j, []).append(pair)
    return out, {k: int(o.sum()) for k, o in ok.items()}, found, oracle_s


def _counts(b: dict) -> dict:
    """``_timing.bins`` without its success shares (they do not add)."""
    return {k: n for k, n in b.items() if not k.startswith("succ")}


def _add(acc: dict, d: dict) -> dict:
    for k, n in d.items():
        acc[k] = acc.get(k, 0) + n
    return acc


def run_parity(batches: int = N_BATCHES, device="cuda", batch: int = BATCH,
               log=print) -> dict:
    """The record of ``batches`` batches of ``batch`` frames (see the
    module's docstring)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the parity run was asked for cuda, but no CUDA "
                           "device is visible")
    if not native_available():
        raise RuntimeError("the C++ float64 oracle did not build (g++?)")
    workers = os.cpu_count() or 1
    code = get_code(CODE)
    res = {m: {"frames": 0, **{p: {} for p in PAIRS}, "valid": {}}
           for m in METHODS}
    cases = []
    oracle_s = 0.0
    t_start = time.perf_counter()
    for i in range(batches):
        rx = make_inputs(code, batch,
                         torch.Generator(device=device).manual_seed(SEED + i),
                         device, EBN0_DB)
        for m in METHODS:
            out, valid, found, dt = parity_batch(code, rx, m, workers)
            oracle_s += dt
            r = res[m]
            r["frames"] += batch
            for p in PAIRS:
                _add(r[p], out[p])
            _add(r["valid"], valid)
            rx_np = rx.cpu().numpy() if found else None
            for j, pairs in sorted(found.items()):
                cases.append(twovalid.diagnose(code, rx_np[j], m, i, j,
                                               device, pairs))
            log(f"[parity] batch {i} (seed {SEED + i}) {m}: oracle {dt:.1f} "
                f"s on {workers} threads; " + "; ".join(
                    f"{p} {json.dumps(out[p])}" for p in PAIRS)
                + f"; two-valid frames {sorted(found)}")
    for c in cases:
        log(f"[parity] two-valid {json.dumps({k: v for k, v in c.items() if k != 'rx'})}")
    return {
        "what": ("hard-decision parity of the port's f32 path and its tile "
                 "kernels (precise mode) against the C++ float64 batch "
                 "oracle (runtime/native/ldpc_native.cc ldpc_decode_batch)"),
        "code": CODE, "ebn0_db": EBN0_DB, "iterations": ITERATIONS,
        "semantics": "early_exit(reference)",
        "inputs": (f"tools/_timing.py make_inputs, batch i from "
                   f"torch.Generator('{device.type}').manual_seed({SEED} + i)"),
        "device": device.type,
        "kernel": ("tile kernels, precise mode" if device.type == "cuda"
                   else "the kernels' plain versions (CPU)"),
        "frames": {m: r["frames"] for m, r in res.items()},
        "results": res,
        "cases": cases,
        "compare_with": ("results/parity_f64_r5.json as rates only: its "
                         "frames come from JAX's PRNG, these from torch's"),
        "oracle_threads": workers,
        "oracle_wall_s": oracle_s,
        "wall_s": time.perf_counter() - t_start,
    }


def check(record: dict) -> list[str]:
    """The bars, as readable lines of what misses; [] when all hold:
    the f32 path's and the kernel's mismatched shares against the oracle,
    and the kernel's against the f32 path, each at most MAX_MISMATCH; the
    kernel against its plain version as ``chip_smoke.py`` holds it (min-sum
    the same decisions on every frame; sum-product the precise early-exit
    contract: at most MAX_MISMATCH mismatched and none two different valid
    codewords); every two-valid frame a boundary frame."""
    misses = []
    for m, r in record["results"].items():
        n = r["frames"]
        for p in PAIRS:
            share = r[p]["mismatch"] / n
            if share > MAX_MISMATCH:
                misses.append(f"{m} {p}: mismatched share {share:.3g} > "
                              f"{MAX_MISMATCH}")
        plain = r["kernel_vs_plain"]
        if m == "minsum" and plain["mismatch"]:
            misses.append(f"minsum: the kernel decides {plain['mismatch']} "
                          f"frames otherwise than its plain version")
        if m == "sumproduct" and plain["both_valid_different"]:
            misses.append(f"sumproduct: the kernel and its plain version on "
                          f"two valid codewords in "
                          f"{plain['both_valid_different']} frames")
    for c in record["cases"]:
        if not c["boundary"]:
            misses.append(f"{c['method']} batch {c['batch']} frame "
                          f"{c['frame']} ({', '.join(c['pairs'])}): not a "
                          f"boundary frame")
    return misses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=N_BATCHES)
    ap.add_argument("--frames", type=int, default=BATCH,
                    help="frames a batch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    rec = run_parity(args.batches, args.device, batch=args.frames)
    if args.device == "cuda":
        rec["card"] = torch.cuda.get_device_name(0)
    rec["misses"] = check(rec)
    Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
    for m, r in rec["results"].items():
        n = r["frames"]
        print(f"[parity] {m}, {n} frames: " + "; ".join(
            f"{p} mismatch {r[p]['mismatch']} ({r[p]['mismatch'] / n:.3g})"
            for p in PAIRS), flush=True)
    print(f"[parity] {len(rec['cases'])} two-valid frames, "
          f"{sum(c['boundary'] for c in rec['cases'])} on a boundary; wall "
          f"{rec['wall_s']:.1f} s (oracle {rec['oracle_wall_s']:.1f} s); "
          f"wrote {args.out}", flush=True)
    for line in rec["misses"]:
        print(f"[parity] MISS {line}", flush=True)
    return 1 if rec["misses"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
