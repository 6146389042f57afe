"""The clock tracker's block-loop kernel (``csrc/pfb_track.cu``) against its
plain version (``ops/dsp.py::_pfb_track_plain``): ``chip_smoke.py``'s
tracker check, and the two timed side by side.

    python -m gr_ldpc_ece535a_torch.tools.pfb_track_check [--device cpu] [--frames 16384] [--blocks 64] [--main-frames 131072]

The stream: ``bench_chain.impaired_stream``'s (block_32_64 frames of seed
5 at 2 samples a symbol, +50 ppm, 0.01 cycles/sample, noise 0.05) through
the chain's stages before the tracker (block AGC, the CFO estimate, mix),
as ``rx_chain_pairs`` hands it to the tracker. For each (block symbols,
rate clip) of CASES, ``steps`` runs ``blocks`` blocks from the
acquisition, one block a call, each from the plain version's state: the
kernel (on the CPU the plain version again) and the plain version on the
same padded stream with the loop cut to one block, so that both read the
windows of a whole-stream run (the clamp at the stream's end included).
Two float32 trackers whose sums are ordered differently part after some
thousands of symbols, so this is how the kernel is held; the bars are
those tests/test_torch_dsp.py holds the plain version to JAX with: symbols
within 1e-5 (NaN exactly where the plain version's are), rate within
1e-6, ibase equal, frac within one float32 step of the block advance
(block_syms*sps). Also held: the stream with a NaN and an inf sample in
its third block at 64-symbol blocks (the kernel's path for a tile with a
non-finite sample: NaN and inf reach the plain version's symbols and
state); a stream with no whole block (no launch, the state returned).

``chained`` holds the launch at the main path's shapes, which one block a
call cannot: one launch over the chain's composed stream (2^24 samples,
1,022 blocks of 8,192 symbols) and over one 16,384-sample segment of the
DSP flowgraph (126 blocks of 64) must equal, bit for bit, the kernel run
one block a call, each call from the state the kernel returned (the same
code in the same order). That holds the state handed from block to block
in shared memory, the reuse of the staged window and the partial sums,
and each block's place in both output planes. Reported with no bar, one
launch over ``blocks`` blocks against the plain version's run: the first
block where the symbols part by more than 1e-5 and the hard decisions
that differ.

``clusters`` holds the kernel at each cluster size it takes (C = 1, 2,
4, 8 and 16, the B of CLUSTER_SHAPES), over at most CLUSTER_BLOCKS blocks
from the acquisition: ``steps``'s bars against the plain version, and
``chained``'s one launch bit for bit the kernel one block a call. On the
CPU every side is the plain version.

``times`` takes the kernel and its plain version by CUDA events at the
chain's composed shape (2^24 samples, 8,192-symbol blocks, rate clip
2.5e-4, 1,022 blocks) and on one 16,384-sample segment in the app's
64-symbol blocks (the DSP flowgraph's tracker block), beside the bound of
``tools/_timing.py::track_bound_ms``.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..codes import get_code
from ..ops import cuda_dsp, dsp
from ._timing import time_decode, track_bound_ms, track_fmas
from .bench_chain import SPS, impaired_stream

__all__ = ["CASES", "FRAMES", "MAIN_FRAMES", "BLOCKS", "SYM_TOL", "RATE_TOL",
           "CLUSTER_SHAPES", "CLUSTER_BLOCKS", "chain_input", "setup",
           "run_kernel", "steps", "chained", "whole_run", "clusters", "check",
           "timed_shapes", "times", "main"]

CASES = ((64, 0.002), (2048, 2.5e-4), (8192, 2.5e-4))
FRAMES = 1 << 14               # 2^21 samples: 127 blocks of 8,192 symbols
MAIN_FRAMES = 1 << 17          # 2^24 samples: the chain's composed stream
BLOCKS = 64
SYM_TOL, RATE_TOL = 1e-5, 1e-6
NAN_AT, INF_AT = 300, 301      # inside the third 64-symbol block
SEGMENT = 16384                # blocks/dsp.py's PfbClockSyncBlock
# (block symbols, rate clip) at each cluster size: C = 1, 2, 4, 8, 16
CLUSTER_SHAPES = ((64, 0.002), (1024, 2.5e-4), (2048, 2.5e-4),
                  (4096, 2.5e-4), (8192, 2.5e-4))
CLUSTER_BLOCKS = 16
TRACK = {"sps": SPS, "nfilts": 32, "excess_bw": 0.35, "ntaps_per": 11,
         "probe_syms": 256}


def chain_input(frames: int = FRAMES, device="cuda") -> torch.Tensor:
    """(2, T) float32: the impaired stream after the chain's block AGC, CFO
    estimate and mix, on ``device``."""
    _, xp = impaired_stream(get_code("block_32_64"), frames, 5, device)
    x1 = dsp.block_agc_pairs(xp)
    return dsp.mix_pairs(x1, dsp.coarse_cfo_estimate_pairs(x1))


def setup(xp: torch.Tensor, block_syms: int, rate_clip: float, state0=None):
    """The tracker's setup (``dsp._pfb_setup``) and the plain version's
    table: (xpp, banks, taps, loop, state)."""
    xpp, banks, loop, state = dsp._pfb_setup(
        xp, TRACK["sps"], TRACK["nfilts"], TRACK["excess_bw"],
        TRACK["ntaps_per"], block_syms, rate_clip, TRACK["probe_syms"],
        state0)
    taps = dsp._pfb_taps(TRACK["sps"], TRACK["nfilts"], TRACK["excess_bw"],
                         TRACK["ntaps_per"], loop)
    return xpp, banks, taps, loop, state


def run_kernel(xpp, banks, taps, state, loop):
    """The kernel on a card; on the CPU the plain version."""
    if xpp.device.type == "cuda":
        return cuda_dsp.pfb_track(xpp, *banks, state, loop)
    return dsp._pfb_track_plain(xpp, taps, state, loop)


def _gap(a, b) -> float:
    """|a - b| of two scalars, 0 where both are NaN (inf if one is)."""
    a, b = float(a), float(b)
    if math.isnan(a) or math.isnan(b):
        return 0.0 if math.isnan(a) and math.isnan(b) else math.inf
    return 0.0 if a == b else abs(a - b)


def _sym_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| of two symbol tensors, NaN-aware: inf unless their NaNs
    sit at the same places; infinities must be equal."""
    if a.shape != b.shape:
        return math.inf
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return math.inf
    a, b = a[~na], b[~nb]
    if a.numel() == 0:
        return 0.0
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not (torch.equal(fa, fb) and torch.equal(a[~fa], b[~fb])):
        return math.inf
    return float((a[fa] - b[fb]).abs().max()) if fa.any() else 0.0


def steps(xp: torch.Tensor, block_syms: int, rate_clip: float,
          blocks: int = BLOCKS) -> dict:
    """``blocks`` blocks one a call from the acquisition, each from the
    plain version's state: the kernel's and the plain version's symbols and
    states; the worst gaps and whether every block held the bars."""
    xpp, banks, taps, loop, state = setup(xp, block_syms, rate_clip)
    one = loop._replace(nblocks=1)
    n = min(blocks, loop.nblocks)
    adv_ulp = float(np.spacing(np.float32(block_syms * loop.sps)))
    rec = {"block_syms": block_syms, "rate_clip": rate_clip,
           "blocks": n, "stream_blocks": loop.nblocks, "max_abs_err": 0.0,
           "max_frac_gap": 0.0, "max_rate_gap": 0.0, "ibase_equal": True,
           "nan_blocks": 0, "frac_step": adv_ulp}
    for _ in range(n):
        yk, sk = run_kernel(xpp, banks, taps, state, one)
        yp, sp = dsp._pfb_track_plain(xpp, taps, state, one)
        rec["max_abs_err"] = max(rec["max_abs_err"], _sym_gap(yk, yp))
        rec["max_frac_gap"] = max(rec["max_frac_gap"], _gap(sk[1], sp[1]))
        rec["max_rate_gap"] = max(rec["max_rate_gap"], _gap(sk[2], sp[2]))
        rec["ibase_equal"] &= int(sk[0]) == int(sp[0])
        rec["nan_blocks"] += bool(torch.isnan(yp).any())
        state = sp
    rec["ok"] = (n > 0 and rec["ibase_equal"]
                 and rec["max_abs_err"] <= SYM_TOL
                 and rec["max_frac_gap"] <= adv_ulp
                 and rec["max_rate_gap"] <= RATE_TOL)
    return rec


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns as integers of its width, flat (so that a
    NaN equals the same NaN)."""
    return t.reshape(-1).view(torch.int64 if t.element_size() == 8
                              else torch.int32)


def chained(xp: torch.Tensor, block_syms: int, rate_clip: float,
            blocks: int | None = None) -> dict:
    """The kernel over ``blocks`` blocks (all the stream's by default) in one
    launch against the kernel one block a call, each call from the state
    the kernel returned last: the first block whose symbols differ in any
    bit, and whether the final states are the same bits."""
    xpp, banks, taps, loop, state = setup(xp, block_syms, rate_clip)
    n = loop.nblocks if blocks is None else min(blocks, loop.nblocks)
    ys, st = run_kernel(xpp, banks, taps, state, loop._replace(nblocks=n))
    one = loop._replace(nblocks=1)
    ys1 = torch.empty_like(ys).view(2, n, block_syms)
    for j in range(n):
        ys1[:, j], state = run_kernel(xpp, banks, taps, state, one)
    unequal = torch.nonzero((_bits(ys).view(2, n, block_syms)
                             != _bits(ys1).view(2, n, block_syms))
                            .any(2).any(0))
    rec = {"block_syms": block_syms, "rate_clip": rate_clip, "blocks": n,
           "first_unequal_block": int(unequal[0]) if len(unequal) else None,
           "state_equal": all(torch.equal(_bits(a), _bits(b))
                              for a, b in zip(st, state))}
    rec["ok"] = (n > 0 and rec["first_unequal_block"] is None
                 and rec["state_equal"])
    return rec


def whole_run(xp: torch.Tensor, block_syms: int, rate_clip: float,
              blocks: int = BLOCKS) -> dict:
    """One call over ``blocks`` blocks, kernel against plain version (no
    bar): the first block whose symbols part by more than SYM_TOL, and the
    symbols whose real part takes another sign."""
    xpp, banks, taps, loop, state = setup(xp, block_syms, rate_clip)
    lp = loop._replace(nblocks=min(blocks, loop.nblocks))
    yk, sk = run_kernel(xpp, banks, taps, state, lp)
    yp, sp = dsp._pfb_track_plain(xpp, taps, state, lp)
    gap = (yk - yp).abs().amax(0).reshape(lp.nblocks, block_syms).amax(1)
    parted = torch.nonzero(gap > SYM_TOL)
    return {"blocks": lp.nblocks,
            "first_parted_block": int(parted[0]) if len(parted) else None,
            "sign_differs": int((torch.sign(yk[0]) != torch.sign(yp[0])).sum()),
            "symbols": int(yk.shape[1]),
            "state": [float(v) for v in sk],
            "plain_state": [float(v) for v in sp]}


def clusters(xp: torch.Tensor, blocks: int = CLUSTER_BLOCKS) -> dict:
    """The kernel at each cluster size (CLUSTER_SHAPES) over at most
    ``blocks`` blocks: ``steps``'s record with ``C`` and ``one_launch``
    (``chained``'s bit-for-bit bar) beside it, ``ok`` where both hold."""
    rec = {}
    for B, rc in CLUSTER_SHAPES:
        n = min(blocks, CLUSTER_BLOCKS)
        r = steps(xp, B, rc, n)
        loop = setup(xp, B, rc)[3]
        r["C"] = cuda_dsp.track_geometry(B, loop.sps, loop.nfilts, loop.ntaps,
                                         loop.width, rc, loop.gain).C
        r["one_launch"] = chained(xp, B, rc, n)["ok"]
        r["ok"] &= r["one_launch"]
        rec[f"B={B}"] = r
    rec["ok"] = all(r["ok"] for r in rec.values())
    return rec


def check(device="cuda", frames: int = FRAMES, blocks: int = BLOCKS,
          main_frames: int = MAIN_FRAMES, log=print) -> dict:
    """Raise unless the kernel holds the bars at every case of CASES, one
    launch equals the kernel a block a call at the main path's shapes
    (``timed_shapes(device, main_frames)``), the kernel holds both at each
    cluster size (``clusters``), and the bars on the non-finite stream and
    on a stream with no whole block; return {case name: record}."""
    device = torch.device(device)
    xp = chain_input(frames, device)
    out = {}
    for B, rc in CASES:
        rec = steps(xp, B, rc, blocks)
        rec["whole"] = whole_run(xp, B, rc, blocks)
        out[f"B={B}"] = rec
    for name, (x, B, rc) in timed_shapes(device, main_frames).items():
        out[f"one launch, {name}"] = chained(x, B, rc)
    out["clusters"] = clusters(xp, blocks)
    bad = xp.clone()
    bad[0, NAN_AT], bad[1, INF_AT] = math.nan, math.inf
    out["non-finite"] = steps(bad, *CASES[0], blocks)
    out["non-finite"]["ok"] &= out["non-finite"]["nan_blocks"] > 0
    before = dict(cuda_dsp.LAUNCHES)
    short = xp[:, :200].contiguous()
    ys, st = dsp.pfb_clock_sync_pairs(short, sps=SPS)
    _, _, _, loop, st0 = setup(short, 64, 0.002)
    out["short"] = {"samples": short.shape[1], "symbols": int(ys.shape[1]),
                    "launched": cuda_dsp.LAUNCHES != before,
                    "state": [float(v) for v in st],
                    "acquired": [float(v) for v in st0]}
    out["short"]["ok"] = (loop.nblocks == 0 and ys.shape == (2, 0)
                          and not out["short"]["launched"]
                          and out["short"]["state"] == out["short"]["acquired"])
    for name, rec in out.items():
        log(f"[pfb_track] {name} on {device}: " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items()))
    if misses := [name for name, rec in out.items() if not rec["ok"]]:
        raise AssertionError(f"pfb_track against its plain version: {misses}: "
                             + "; ".join(str(out[m]) for m in misses))
    return out


def timed_shapes(device, frames: int = MAIN_FRAMES) -> dict:
    """The main path's shapes: the chain's composed setting on ``frames``
    frames (2^24 samples by default) and one app segment at 64-symbol
    blocks."""
    xp = chain_input(frames, device)
    return {"composed": (xp, 8192, 2.5e-4),
            "segment": (xp[:, :SEGMENT].contiguous(), 64, 0.002)}


def times(device="cuda", log=print, shapes=None) -> dict:
    """The kernel and its plain version by CUDA events (card only) at the
    composed shape and on one app segment: {shape: {"ms", "plain_ms",
    "bound_ms", "bound_by", "fmas", "blocks"}}."""
    out = {}
    for name, (xp, B, rc) in (shapes or timed_shapes(device)).items():
        xpp, banks, taps, loop, state = setup(xp, B, rc)
        taps = taps.to(xpp.device)
        bound, by = track_bound_ms(loop.nblocks, B, loop.ntaps, loop.sps)
        plain_reps = 3 if B * loop.nblocks > 1 << 20 else 5
        out[name] = {
            "blocks": loop.nblocks, "block_syms": B,
            "ms": time_decode(lambda: cuda_dsp.pfb_track(
                xpp, *banks, state, loop)),
            "plain_ms": time_decode(lambda: dsp._pfb_track_plain(
                xpp, taps, state, loop), launches=plain_reps, warmup=1),
            "bound_ms": bound, "bound_by": by,
            "fmas": track_fmas(loop.nblocks, B, loop.ntaps)}
        r = out[name]
        log(f"[pfb_track] {name}: {loop.nblocks} blocks of {B} symbols, "
            f"rate clip {rc}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (CUDA events, medians of 20 and "
            f"{plain_reps}), bound {bound:.6f} ms ({by}), {r['fmas']:.4e} "
            f"FMAs")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--blocks", type=int, default=BLOCKS)
    ap.add_argument("--main-frames", type=int, default=MAIN_FRAMES,
                    help="frames of the composed stream the one-launch "
                         "check runs on (2^24 samples by default)")
    a = ap.parse_args(argv)
    res = check(a.device, a.frames, a.blocks, a.main_frames)
    if a.device == "cuda":
        res["times"] = times(a.device)
    return res


if __name__ == "__main__":
    main()
