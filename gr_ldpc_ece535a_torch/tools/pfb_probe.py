"""Where the clock tracker's kernel spends its time; card only.

    python -m gr_ldpc_ece535a_torch.tools.pfb_probe [--against OTHER.cu] [--out F.json]

Builds variants of ``csrc/pfb_track.cu`` (``_build.load_variants``, into the
git-ignored ``_build/``), each with one part of the design undone, and
times each by CUDA events (``tools/_timing.py::time_decode``, two runs in
turn, each a median of 20) at the shapes of SHAPES: 64-symbol blocks on
one 16,384-sample segment (the DSP flowgraph's tracker), 2,048 and 8,192
on a 2^21-sample stream (the chain's composed blocks), each the
``tools/pfb_track_check.py`` stream from its acquisition. Each time is
also given a block and a symbol, beside the one-SM FMA floor at the SM
clock the kernel holds back to back.

  C = 1              one CTA a block, not a cluster (exact)
  C = 8              8 CTAs where the rule gives 16 (exact)
  no prefetch        the window loaded on the chain every block (exact)
  dots stubbed       timing only: one column a symbol
  update stubbed     timing only: the state steps B*sps a block, and the
                     reduction that feeds the update goes with it

Every exact variant must give the kernel's output bit for bit over the
whole run, symbols and state (its sums take one tree whatever C is); the
source must hold each knob's text once, or this raises.

``--against`` builds another version of the source with the same C
interface (an earlier commit's, say) and times it in the same turns, with
its output compared and reported, not held. For the kernel as built and
for that version the probe also takes the host's cost of one library call
(``host_us``: the median of the host clock around the call while the card
is busy, so the call only queues its launch) and one call alone after a
synchronisation (``lone_ms``: CUDA events, so the host's cost before the
launch counts in it).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, cuda_dsp
from . import pfb_track_check as tc

__all__ = ["KNOBS", "VARIANTS", "TIMING_ONLY", "SHAPES", "AGAINST",
           "variant_source", "launcher", "host_costs", "main"]

# variant -> (the text in the source, its replacement)
KNOBS = {
    "C = 1": ("constexpr int kMaxCluster = 16;",
              "constexpr int kMaxCluster = 1;"),
    "C = 8": ("constexpr int kMaxCluster = 16;",
              "constexpr int kMaxCluster = 8;"),
    "no prefetch": ("constexpr bool kPrefetch = true;",
                    "constexpr bool kPrefetch = false;"),
    # the per-symbol loop's bound
    "dots stubbed": ("    for (int c = 0; c < L + 2; ++c) {",
                     "    for (int c = 0; c < 1; ++c) {"),
    # the update's last four lines: the state then steps B*sps a block, and
    # what feeds the update is dead code
    "update stubbed": (
        "  const float stepi = floorf(adv);\n"
        "  ibase = wrap_add(ibase, __float2ll_rz(stepi));\n"
        "  frac = adv - stepi;\n  rate = rate_n;",
        "  ibase = ibase + static_cast<long long>(lp.B) * lp.sps;")}
VARIANTS = ("as built", *KNOBS)
TIMING_ONLY = ("dots stubbed", "update stubbed")
AGAINST = "against"            # the --against source's name in the records
# name -> (block symbols, rate clip, stream samples)
SHAPES = {"B=64": (64, 0.002, tc.SEGMENT),
          "B=2048": (2048, 2.5e-4, None), "B=8192": (8192, 2.5e-4, None)}
STREAM_FRAMES = 1 << 14        # 2^21 samples
HOST_CALLS = 200


def variant_source(src: str, variant: str) -> str:
    """The source ``src`` with ``variant``'s knob turned; ValueError where
    the source does not hold the knob's text once."""
    if variant == "as built":
        return src
    old, new = KNOBS[variant]
    if src.count(old) != 1:
        raise ValueError(f"pfb_track.cu holds {src.count(old)} of {old!r}")
    return src.replace(old, new)


def launcher(lib, xpp, banks, state, loop):
    """A launch of ``lib``'s kernel (a library built from pfb_track.cu or a
    variant) into buffers made once: a callable returning the (2, nblocks
    *B) symbols and the state; no launch count."""
    ys = torch.empty((2, loop.nblocks, loop.block_syms), dtype=torch.float32,
                     device=xpp.device)
    out = [torch.empty_like(t).reshape(()) for t in state]
    args = cuda_dsp.track_args(xpp, *banks, state, loop, ys, out)
    stream = torch.cuda.current_stream(xpp.device).cuda_stream

    def launch():
        err = lib.pfb_track(*args, stream)
        if err:
            raise RuntimeError(lib.pfb_track_error_string(err).decode())
        return ys.reshape(2, -1), out
    return launch


def host_costs(fn, calls: int = HOST_CALLS) -> dict:
    """``fn``'s host microseconds a call (the median over ``calls`` calls
    queued back to back) and one call alone after a synchronisation by CUDA
    events (the median of 20)."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        host.append((time.perf_counter_ns() - t0) / 1e3)
    torch.cuda.synchronize()
    lone = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        lone.append(start.elapsed_time(stop))
    return {"host_us": statistics.median(host),
            "lone_ms": statistics.median(lone)}


def _ptxas(log: str) -> str:
    """ptxas's registers, stack and spills of each kernel instance in a
    build log, one clause each."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
        elif name and ("spill" in line or "Used" in line):
            out.append(line.split(":", 1)[-1].strip())
    return "; ".join(out)


def _bits(ys, out) -> list[torch.Tensor]:
    """The symbols' and the state's bits (a NaN equals the same NaN)."""
    return [tc._bits(ys.clone())] + [tc._bits(t.clone()) for t in out]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None) -> dict:
    """Print and return {shape: {variant: {"ms": [two runs], "us_a_block",
    "ns_a_symbol", "exact", "whole_run_equal"}}, "card", "mhz",
    "floor_ms"}; "as built" and AGAINST also carry host_costs's keys."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None,
                    help="another pfb_track.cu with the same C interface, "
                         "timed in the same turns")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("pfb_probe times kernels on a CUDA device; none "
                           "found")
    from ._timing import SM_FMA_PER_CLOCK, time_decode, track_fmas
    from .issue_model import under_load

    src = _build.SOURCES["pfb_track"].read_text()
    texts = {v: variant_source(src, v) for v in VARIANTS}
    if a.against:
        texts[AGAINST] = Path(a.against).read_text()
    libs = dict(zip(texts, _build.load_variants("pfb_track",
                                                list(texts.values()))))
    for v, text in texts.items():
        log = _build.variant_path("pfb_track", text).with_suffix(".log")
        print(f"[pfb_probe] {v}: {_ptxas(log.read_text())}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    stream = tc.chain_input(STREAM_FRAMES, dev)
    out = {"card": card, "floor_ms": {}}
    for name, (B, rc, samples) in SHAPES.items():
        xp = stream if samples is None else stream[:, :samples].contiguous()
        xpp, banks, _, loop, state = tc.setup(xp, B, rc)
        runs = {v: launcher(lib, xpp, banks, state, loop)
                for v, lib in libs.items()}
        whole = {v: _bits(*fn()) for v, fn in runs.items()}
        if "mhz" not in out:
            _, smp = under_load(runs["as built"], 2.0)
            out["mhz"] = float(np.median([c for c, _, _ in smp]))
        times = {v: [] for v in runs}
        for order in (list(runs), list(runs)[::-1]):
            for v in order:
                times[v].append(time_decode(runs[v]))
        host = {v: host_costs(runs[v]) for v in ("as built", AGAINST)
                if v in runs}
        fmas = track_fmas(loop.nblocks, B, loop.ntaps)
        floor = fmas / (SM_FMA_PER_CLOCK * out["mhz"] * 1e3)
        out["floor_ms"][name] = floor
        print(f"[pfb_probe] {name}: {loop.nblocks} blocks of {B} symbols, "
              f"rate clip {rc}; one-SM FMA floor {floor:.4f} ms ({fmas:.4e} "
              f"FMAs, {SM_FMA_PER_CLOCK} a clock at {out['mhz']:.0f} MHz); "
              f"CUDA events, two runs in turn, each a median of 20 [{card}]",
              flush=True)
        for v, ms in times.items():
            equal = _same(whole[v], whole["as built"])
            exact = None if v in (*TIMING_ONLY, AGAINST) else equal
            rec = {"ms": ms, "us_a_block": float(np.mean(ms)) * 1e3
                   / loop.nblocks,
                   "ns_a_symbol": float(np.mean(ms)) * 1e6
                   / (loop.nblocks * B), "exact": exact,
                   "whole_run_equal": equal, **host.get(v, {})}
            out.setdefault(name, {})[v] = rec
            tag = (", exact" if exact else ", NOT EXACT" if exact is False
                   else f", output {'equal' if equal else 'differs'}"
                   if v == AGAINST else " (timing only)")
            extra = (f"; host {rec['host_us']:.2f} us a call, alone "
                     f"{rec['lone_ms']:.4f} ms" if v in host else "")
            print(f"    {v:16s} " + " / ".join(f"{t:.4f}" for t in ms)
                  + f" ms, {rec['us_a_block']:.3f} us a block, "
                  f"{rec['ns_a_symbol']:.3f} ns a symbol, "
                  f"{np.mean(ms) / floor:.2f}x the floor{tag}{extra}",
                  flush=True)
        del runs, whole
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    bad = [(s, v) for s in SHAPES for v, r in out[s].items()
           if r["exact"] is False]
    if bad:
        raise AssertionError(f"exact variants that part from the kernel: "
                             f"{bad}")
    return out


if __name__ == "__main__":
    main()
