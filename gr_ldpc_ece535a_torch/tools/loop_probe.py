"""Where the loop kernels' serial time goes (csrc/dsp_loops.cu); card only.

    python -m gr_ldpc_ece535a_torch.tools.loop_probe [--samples 16391]

Builds variants of the source (``_build.load_variants``, into the
git-ignored ``_build/``) and times each kernel by CUDA events
(``tools/_timing.py::time_decode``, two runs in turn, each a median of 20)
on tools/dsp_loops_check.py's impaired stream: the serial AGC
(``agc_loop_kernel``, the AGC's edge route and its only kernel before the
scan) on the stream, the Costas loop on the AGC's output. Each time is
also given in cycles a sample at the SM clock the shipped Costas kernel
holds back to back, beside the variant's dependent chain a sample read off
its SASS (``tools/issue_model.py::loop_chain``; "not read" where its paths
pass CHAIN_VISITS instruction visits: a branchy wrap, unrolled).

The serial AGC:
  load hoisted     the next sample read from the tile before the current
                   one's chain (exact)
  hypotf stubbed   timing only: |y| as |Re| + |Im|
  no staging       timing only: the tile staged and stored once, not once
                   a tile
The Costas loop, from the shipped kernel, each part of its design undone
or stubbed, and from the parent form (the parent's per-sample arithmetic,
fmodf and the two calls, in the new ring):
  load ahead       the next pair read from the stage before the current
                   pair's chains (the software pipeline first tried)
  unroll 2         one pair an iteration, not two
  guarded wrap     the wrap's selects behind its range test, a branch
  fmodf wrap       the wrap as fmodf with the sign fix for every phase
  two calls        cosf and sinf in place of sincosf
  wrap stubbed     timing only: no wrap at all
  trig stubbed     timing only: cos and sin as 1 - p^2/2 and p
  no staging       timing only: the ring's four stages loaded once, none
                   stored, the later stages run on what the ring holds
Every variant not marked timing only must give the shipped kernel's output
and state bit for bit. The source must hold each substitution's text, or
this raises.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from ..ops import _build, cuda_dsp, dsp
from .dsp_loops_check import AGC, SAMPLES, impaired_stream, launcher

__all__ = ["SUBSTITUTIONS", "VARIANTS", "SAMPLES_AN_ITERATION",
           "TIMING_ONLY", "variant_source", "main"]

_AGC_LOOP = """#pragma unroll 1
      for (int i = 0; i < m; ++i) {
        const float2 v = tile[i];
        const float yr = v.x * g - v.y * 0.0f;"""
_PAIR_LOOP = """#pragma unroll 2  // kUnroll / 2 pairs an iteration
      for (int j = 0; j < pairs; ++j) {
        const float4 cur = buf[j];"""
_WRAP = "phase = (kFirst ? mod_two_pi(a) : wrap_select(a)) - kPi;"
_TRIG = """  if (kSinCos && !kFirst) {
    sincosf(phase, &s, &c);
  } else {
    c = cosf(phase);
    s = sinf(phase);
  }"""
# name -> [(text in the shipped source, its replacement), ...]
SUBSTITUTIONS = {
    "load hoisted": [(_AGC_LOOP, """float2 next = tile[0];
#pragma unroll 1
      for (int i = 0; i < m; ++i) {
        const float2 v = next;
        next = tile[i + 1 < m ? i + 1 : i];
        const float yr = v.x * g - v.y * 0.0f;""")],
    "hypotf stubbed": [("g = g + rate * (reference - hypotf(yr, yi));",
                        "g = g + rate * (reference - (fabsf(yr) + "
                        "fabsf(yi)));")],
    "agc no staging": [
        ("for (int i = threadIdx.x; i < m; i += kThreads) tile[i] = "
         "x[base + i];",
         "if (base == 0)\n      for (int i = threadIdx.x; i < m; i += "
         "kThreads) tile[i] = x[base + i];"),
        ("for (int i = threadIdx.x; i < m; i += kThreads) y[base + i] = "
         "tile[i];",
         "if (base + kTile >= n)\n      for (int i = threadIdx.x; i < m; "
         "i += kThreads) y[base + i] = tile[i];")],
    "load ahead": [(_PAIR_LOOP, """      float4 next = buf[0];
#pragma unroll 2  // kUnroll / 2 pairs an iteration
      for (int j = 0; j < pairs; ++j) {
        const float4 cur = next;
        next = buf[j + 1 < pairs ? j + 1 : j];""")],
    "guarded wrap": [(_WRAP, "phase = mod_two_pi(a) - kPi;")],
    "fmodf wrap": [(_WRAP, "phase = floored_mod(a, kTwoPi) - kPi;")],
    "unroll 2": [(_PAIR_LOOP, _PAIR_LOOP.replace("unroll 2", "unroll 1"))],
    "two calls": [("constexpr bool kSinCos = true;",
                   "constexpr bool kSinCos = false;")],
    "wrap stubbed": [(_WRAP, "phase = a - kPi;")],
    "trig stubbed": [(_TRIG, "  c = 1.0f - phase * phase * 0.5f;\n"
                             "  s = phase;")],
    "costas no staging": [
        ("for (long long k = 0; k < kAhead && k < stages; ++k) load(k);",
         "for (long long k = 0; k < kStages && k < stages; ++k) load(k);"),
        ("if (k + kAhead < stages) {", "if (false) {"),
        ("bulk_wait(&full[b], ", "if (k < kStages) bulk_wait(&full[b], "),
        ("bulk_store(y + s, buf, static_cast<uint32_t>(pairs) * 16u);", ";")],
}
# the Costas kernel's arithmetic before this design: fmodf and two calls
PARENT = ("fmodf wrap", "two calls")
# kernel -> {variant: its substitutions}
VARIANTS = {
    "agc_loop": {"shipped": (), "load hoisted": ("load hoisted",),
                 "hypotf stubbed": ("hypotf stubbed",),
                 "no staging": ("agc no staging",)},
    "costas_loop": {
        "shipped": (),
        **{f"shipped, {s}": (s,) for s in (
            "load ahead", "unroll 2", "guarded wrap", "fmodf wrap",
            "two calls",
            "wrap stubbed", "trig stubbed")},
        "shipped, no staging": ("costas no staging",),
        "parent form": PARENT,
        "parent form, load ahead": (*PARENT, "load ahead"),
        "parent form, wrap stubbed": ("two calls", "wrap stubbed"),
        "parent form, trig stubbed": ("fmodf wrap", "trig stubbed"),
        "parent form, no staging": (*PARENT, "costas no staging")}}
# the SASS walk's bound a variant: the branchy wraps, unrolled, pass it
CHAIN_VISITS = 1 << 20
# samples an iteration where a variant's loop runs other than the kernel's
SAMPLES_AN_ITERATION = {"unroll 2": 2}
TIMING_ONLY = ("hypotf stubbed", "agc no staging", "wrap stubbed",
               "trig stubbed", "costas no staging")


def variant_source(src: str, subs) -> str:
    """dsp_loops.cu's text ``src`` with the SUBSTITUTIONS named in ``subs``;
    ValueError where the source does not hold one's text once."""
    for name in subs:
        for old, new in SUBSTITUTIONS[name]:
            if src.count(old) != 1:
                raise ValueError(f"dsp_loops.cu holds {src.count(old)} of "
                                 f"{old!r} ({name})")
            src = src.replace(old, new)
    return src


def main(argv=None) -> dict:
    """Print and return {kernel: {variant: {"ms": [two runs], "cycles": a
    sample, "chain": loop_chain's cycles a sample}}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=SAMPLES)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("loop_probe times kernels on a CUDA device; none "
                           "found")
    from ._timing import time_decode
    from .issue_model import (loop_chain, sass_dump, sass_instructions,
                              under_load)

    src = _build.SOURCES["dsp_loops"].read_text()
    names = [(k, v) for k, vs in VARIANTS.items() for v in vs]
    texts = {kv: variant_source(src, VARIANTS[kv[0]][kv[1]]) for kv in names}
    libs = dict(zip(texts, _build.load_variants("dsp_loops",
                                                list(texts.values()))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    x = impaired_stream(a.samples, device=dev)
    x_costas = dsp.agc(x, **AGC)[0]
    inputs = {"agc_loop": (x, (1.0,)), "costas_loop": (x_costas, (0.0, 0.0))}
    runs, ref = {}, {}
    for (kernel, variant), lib in libs.items():
        runs[kernel, variant] = launcher(lib, kernel, *inputs[kernel])
        y, st = (v.clone() for v in runs[kernel, variant]())
        subs = VARIANTS[kernel][variant]
        if variant == "shipped":
            ref[kernel] = (y, st)
        elif not set(subs) & set(TIMING_ONLY):
            yr, sr = ref[kernel]
            if not (torch.equal(torch.view_as_real(y).view(torch.int32),
                                torch.view_as_real(yr).view(torch.int32))
                    and torch.equal(st.view(torch.int32),
                                    sr.view(torch.int32))):
                raise AssertionError(f"{kernel} {variant}: not the shipped "
                                     f"kernel's output and state")
    _, samples = under_load(runs["costas_loop", "shipped"], 2.0)
    mhz = float(np.median([c for c, _, _ in samples]))
    times = {kv: [] for kv in libs}
    for order in (list(libs), list(libs)[::-1]):
        for kv in order:
            times[kv].append(time_decode(runs[kv]))
    out = {}
    print(f"[loop_probe] {a.samples} samples, CUDA events (two runs in turn, "
          f"each a median of 20), cycles a sample at the SM clock "
          f"{mhz:.0f} MHz (the shipped Costas kernel back to back), the "
          f"least dependent chain a sample off the SASS (4 cycles a link) "
          f"[{card}]", flush=True)
    for (kernel, variant), lib in libs.items():
        fns = sass_instructions(sass_dump(
            _build.variant_path("dsp_loops", texts[kernel, variant])))
        ins = next(v for f, v in fns.items() if f"{kernel}_kernel" in f)
        per = next((SAMPLES_AN_ITERATION[v] for v in VARIANTS[kernel][variant]
                    if v in SAMPLES_AN_ITERATION), cuda_dsp.UNROLL[kernel])
        try:
            chain = loop_chain(ins, samples=per, limit=CHAIN_VISITS)
            read = f"{chain['cycles']:.1f} ({chain['paths']} paths)"
        except ValueError:      # a branchy body unrolled: too many paths
            chain = {"cycles": None, "paths": None}
            read = f"not read (over {CHAIN_VISITS} visits)"
        ms = times[kernel, variant]
        cycles = float(np.mean(ms)) * mhz * 1e3 / a.samples
        out.setdefault(kernel, {})[variant] = {
            "ms": ms, "cycles": cycles, "chain": chain["cycles"],
            "paths": chain["paths"]}
        tag = (" (timing only)" if set(VARIANTS[kernel][variant])
               & set(TIMING_ONLY) else "")
        print(f"    {kernel:12s} {variant:30s} "
              + " / ".join(f"{t:.4f}" for t in ms)
              + f" ms, {cycles:.1f} cycles a sample, chain {read}{tag}",
              flush=True)
    return out


if __name__ == "__main__":
    main()
