"""Variants of the tile min-sum kernel (csrc/bp_wmajor.cu); card only.

The tile min-sum is bp_minsum_pairs, two frames a thread. This builds the
source with one substitution at a time (``_build.load_variants``, into the
git-ignored ``_build/``, all at once) and times each library's tile
min-sum against the shipped one, interleaved (CUDA events,
``tools/_timing.py::time_decode``), beside its registers and spills
(ptxas), static SASS (``tools/issue_model.py::kernel_mix``) and blocks an
SM (``cuda_bp.occupancy``), at block_32_64 131,072 frames x 20 iterations,
4 dB, fixed and early exit, at the reference sweep's step (sim_50_100,
125,000 frames, 5 iterations, early exit, the sweep's own draw at 3 dB)
and at gen_200_400 (16,384 x 20, 4 dB, near the tile's size gate):

  skeleton       timing only: the check step writes each loaded message
                 back negated (no minima, signs or products)
  variable step  timing only: no check step in the tile min-sum
  one frame      the parent's tile min-sum, bp_kernel<WR, false, 32, 8>:
                 one frame a thread, 8 rows
  rows 8         two frames a thread with 8 rows of threads (4 warps a
                 block) in place of 16
  min blocks 5, 6  __launch_bounds__' minimum blocks an SM (ptxas's default
                 in the shipped build)
  constant       lever 1(b): the slot tables in the constant bank (a
                 __grid_constant__ kernel parameter) in place of shared
                 memory
  no live        the selects that keep a frame's old messages where it
                 does not decode (done, or past B) dropped: such a frame
                 gets its new messages all the same, and its decision,
                 written only while it decodes, stays; every output holds

so that the check step's arithmetic is the shipped time less the
skeleton's, and its loads and stores the skeleton's less the variable
step's. Every variant not marked timing only must decide as the shipped
kernel on every frame. The source must hold each substitution's text, or
this raises.

    python -m gr_ldpc_ece535a_torch.tools.tile_probe [VARIANT ...]
"""

from __future__ import annotations

import functools
import re
import subprocess

import torch

from ..codes import LdpcCode, get_code, make_ldpc
from ..ops import _build, cuda_bp
from ..parallel.sweep import draw_frames
from ._timing import make_inputs, time_decode

__all__ = ["VARIANTS", "TIMING_ONLY", "TAGS", "variant_source",
           "ptxas_summary", "main"]

# the tile min-sum at WR = 6 in ptxas's and cuobjdump's names (regular
# expressions): two frames a thread, and the parent's one-frame kernel
TAGS = {"pairs": r"bp_minsum_pairsILi6E",
        "one frame": r"bp_kernelILi6ELb0ELi32ELi8E"}
# lever 1(b): the slot tables in the constant bank, a __grid_constant__
# kernel parameter of 16-bit entries (a warp reads one entry at a time, one
# broadcast from the constant cache), copied from the device tables once
# for each table (measurement only: its cache is keyed by the tables'
# device address)
_PARAM = """
constexpr int kParamEntries = 8192;
struct ParamTables {
  short t[kParamEntries];
};
// the entries from `base` on, indexed as the shared-memory table was
struct ParamView {
  const ParamTables& p;
  int base;
  __device__ __forceinline__ int operator[](int i) const {
    return p.t[base + i];
  }
};
}  // namespace
#include <map>
#include <vector>
namespace {
ParamTables param_tables(const int* a, int na, const int* b, int nb) {
  static std::map<const int*, ParamTables> cache;
  auto it = cache.find(a);
  if (it == cache.end()) {
    std::vector<int> h(na + nb);
    cudaMemcpy(h.data(), a, 4 * na, cudaMemcpyDeviceToHost);
    cudaMemcpy(h.data() + na, b, 4 * nb, cudaMemcpyDeviceToHost);
    ParamTables t{};
    for (int i = 0; i < na + nb && i < kParamEntries; ++i) t.t[i] = h[i];
    it = cache.emplace(a, t).first;
  }
  return it->second;
}

"""
# (csrc/sfu.cuh's check_sumproduct takes any table type already)
CONSTANT = [
    ("template <int WR, int F>\n__device__ __forceinline__ CheckRow<WR> "
     "load_check(const float* msg,\n                                        "
     "           const int* sv,",
     _PARAM + "template <int WR, int F, class SV>\n__device__ "
     "__forceinline__ CheckRow<WR> load_check(const float* msg, SV sv,"),
    ("template <int F>\n__device__ __forceinline__ VarRow load_var(const "
     "float* msg, const float* r,\n                                         "
     "  const int* vs,",
     "template <int F, class VS>\n__device__ __forceinline__ VarRow "
     "load_var(const float* msg, const float* r, VS vs,"),
    ("          unsigned long long* __restrict__ passes) {\n"
     "  constexpr int kThreads = F * R;",
     "          unsigned long long* __restrict__ passes,\n"
     "          const __grid_constant__ ParamTables pt) {\n"
     "  constexpr int kThreads = F * R;"),
    ("                unsigned long long* __restrict__ passes) {\n"
     "  constexpr int F = kTileFrames, R = kPairRows, L = F / 2;",
     "                unsigned long long* __restrict__ passes,\n"
     "                const __grid_constant__ ParamTables pt) {\n"
     "  constexpr int F = kTileFrames, R = kPairRows, L = F / 2;"),
    ("  int* sv = reinterpret_cast<int*>(r + N * kRStride);\n"
     "  int* vs = sv + E;\n  int* flags = vs + N * Wc;",
     "  int* sv_smem = reinterpret_cast<int*>(r + N * kRStride);\n"
     "  int* vs_smem = sv_smem + E;\n  const ParamView sv{pt, 0}, vs{pt, E};"
     "\n  int* flags = vs_smem + N * Wc;"),
    ("sv[i] = slot_var[i];", "sv_smem[i] = slot_var[i];"),
    ("vs[i] = var_slots[i];", "vs_smem[i] = var_slots[i];"),
    ("        norm_offset, norm_scale, use_offset, use_scale, passes);",
     "        norm_offset, norm_scale, use_offset, use_scale, passes,\n"
     "        param_tables(slot_var, WR * M, var_slots, N * Wc));"),
]
_BOUNDS = "__launch_bounds__(kTileFrames / 2 * kPairRows)"
# variant -> [(text in the shipped source, its replacement), ...]
VARIANTS = {
    "skeleton": [("make_float2(live[0] ? va[k] : a.t[k], live[1] ? vb[k] : "
                  "b.t[k]);",
                  "make_float2(-a.t[k], -b.t[k]);")],
    "variable step": [("    for (int m = y; m < M; m += R) check(live, m);",
                       "    for (int m = y; m < 0; m += R) check(live, m);")],
    "one frame": [("  static constexpr bool kPairs = !SP && F == kTileFrames;",
                   "  static constexpr bool kPairs = false;")],
    "rows 8": [("constexpr int kPairRows = 16;", "constexpr int kPairRows = 8;")],
    "min blocks 5": [(_BOUNDS, _BOUNDS[:-1] + ", 5)")],
    "min blocks 6": [(_BOUNDS, _BOUNDS[:-1] + ", 6)")],
    "constant": CONSTANT,
    "no live": [("make_float2(live[0] ? va[k] : a.t[k], live[1] ? vb[k] : "
                 "b.t[k]);", "make_float2(va[k], vb[k]);"),
                ("live[0] ? ra + aa : ea[k], live[1] ? rb + ab : eb[k]);",
                 "ra + aa, rb + ab);")],
}
TIMING_ONLY = ("skeleton", "variable step")
FRAMES, ITERATIONS, EBN0_DB = 1 << 17, 20, 4.0


def variant_source(src: str, variant: str) -> str:
    """bp_wmajor.cu's text ``src`` with ``variant``'s substitutions;
    ValueError where the source no longer holds one's text."""
    for old, new in VARIANTS[variant]:
        if old not in src:
            raise ValueError(f"bp_wmajor.cu no longer holds {old!r} "
                             f"({variant})")
        src = src.replace(old, new)
    return src


def ptxas_summary(log: str, tag: str) -> str:
    """ptxas's registers and spills of the kernel whose name matches the
    regular expression ``tag`` in a build log (nvcc -Xptxas -v), "" if the
    log has none."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling" in line and re.search(tag, line):
            notes = []
            for nxt in lines[i + 1:]:
                if "Compiling" in nxt:
                    break
                if "Used" in nxt or "spill" in nxt:
                    notes.append(nxt.split(":", 1)[-1].strip())
            return "; ".join(notes)
    return ""


def main(variants=tuple(VARIANTS)) -> dict:
    """Print and return {"card", "ms": {(library, case): [ms, ms]},
    "ptxas": {library: summary}, "mix": {library: static SASS counts},
    "blocks": {(library, case): (blocks an SM, warps a block)}}."""
    if not torch.cuda.is_available():
        raise RuntimeError("tile_probe times kernels on a CUDA device; none "
                           "found")
    from .issue_model import kernel_mix, sass_dump, sass_functions

    src = _build.SOURCES["bp_wmajor"].read_text()
    texts = {v: variant_source(src, v) for v in variants}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    paths = {"shipped": _build.build()["bp_wmajor"][0]}
    libs = {"shipped": _build.load_library("bp_wmajor")}
    for v, lib in zip(texts, _build.load_variants("bp_wmajor",
                                                  list(texts.values()))):
        libs[v] = lib
        paths[v] = _build.variant_path("bp_wmajor", texts[v])
    code, sim = get_code("block_32_64"), get_code("sim_50_100")
    rx4 = make_inputs(code, FRAMES, torch.Generator(device=dev).manual_seed(
        1000), dev, EBN0_DB)
    # the reference sweep's step at 3 dB (run_waterfall's grid point 20)
    rxs = draw_frames(sim, 125_000, (0, 20, 0), 3.0, dev)[1]
    # a code on the table route in every library (beyond the tiers' counts)
    big = LdpcCode.from_h(make_ldpc(200, 400, seed=1), name="gen_200_400")
    rxb = make_inputs(big, 1 << 14, torch.Generator(device=dev).manual_seed(
        5), dev, EBN0_DB)
    cases = {f"fixed {code.name} {FRAMES}x{ITERATIONS}": (code, rx4,
                                                          ITERATIONS, False),
             f"early_exit {code.name} {FRAMES}x{ITERATIONS}": (
                 code, rx4, ITERATIONS, True),
             f"early_exit {sim.name} 125000x5 @3dB": (sim, rxs, 5, True),
             f"fixed {big.name} 16384x{ITERATIONS}": (big, rxb, ITERATIONS,
                                                       False)}
    blocks, ref, runs = {}, {}, {}
    for name, lib in libs.items():
        for k, (c, rx, iters, ee) in cases.items():
            blocks[name, k] = cuda_bp.occupancy(c, "tile", False, lib=lib)
            runs[name, k] = functools.partial(cuda_bp._launch, "tile", False,
                                              rx, c, iters, ee, lib=lib)
            out = runs[name, k]()
            if (name not in TIMING_ONLY
                    and not torch.equal(out, ref.setdefault(k, out))):
                raise AssertionError(f"the {name} variant decides otherwise: "
                                     f"{k}")
    # each library's tile min-sum: the parent's one-frame kernel in "one
    # frame", the two-frame kernel elsewhere
    tag = {name: TAGS["one frame" if name == "one frame" else "pairs"]
           for name in paths}
    ptxas = {name: ptxas_summary(p.with_suffix(".log").read_text(),
                                 tag[name]) for name, p in paths.items()}
    mix = {name: kernel_mix(sass_functions(sass_dump(p)), tag[name])
           for name, p in paths.items()}
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for k in cases:
                times.setdefault((name, k), []).append(
                    time_decode(runs[name, k]))
    print(f"[tile_probe] tile min-sum (WR = 6), library: ptxas; static SASS "
          f"[{card}]", flush=True)
    for name in ptxas:
        print(f"    {name:14s} {ptxas[name]}; {mix[name]}", flush=True)
    print(f"[tile_probe] library, case: blocks an SM x warps a block, ms (two "
          f"interleaved runs, each a median of 20) [{card}]", flush=True)
    for (name, k), ts in times.items():
        print(f"    {name:14s} {k:36s} {blocks[name, k][0]} x "
              f"{blocks[name, k][1]} warps  " + " / ".join(f"{t:.4f}"
                                                           for t in ts),
              flush=True)
    if {"skeleton", "variable step"} <= set(libs):
        for k in cases:
            ms = {n: sum(times[n, k]) / 2 for n in ("shipped", "skeleton",
                                                    "variable step")}
            print(f"[tile_probe] {k}: check step arithmetic (shipped - "
                  f"skeleton) {ms['shipped'] - ms['skeleton']:.4f} ms; its "
                  f"loads and stores (skeleton - variable step) "
                  f"{ms['skeleton'] - ms['variable step']:.4f} ms; the "
                  f"variable step, barriers and set-up "
                  f"{ms['variable step']:.4f} ms [{card}]", flush=True)
    return {"card": card, "ms": times, "ptxas": ptxas, "mix": mix,
            "blocks": blocks}


if __name__ == "__main__":
    import sys
    main(tuple(sys.argv[1:]) or tuple(VARIANTS))
