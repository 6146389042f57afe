"""Where the exact kernels' time goes (csrc/bp_exact.cu); card only.

Builds variants of the source (``_build.load_variants``, into the
git-ignored ``_build/``) and times them interleaved with the shipped exact
kernel of each method at block_32_64 and sim_50_100, 131,072 frames x 20
iterations, 4 dB (CUDA events, ``tools/_timing.py::time_decode``):

  skeleton       timing only: the check step writes each loaded message
                 back negated (sum-product: no tanhf, products, division or
                 logf; min-sum: no minima, argmin or sign product; a plain
                 copy would be removed as a no-op store): the loads,
                 stores, tables, barriers and the variable step
  variable step  timing only: no check step at all
  tables         every code on the table route (the parent's placement:
                 widths, slot tables and -rx read from shared memory in
                 every iteration)
  opaque         the register tier with its rows passed through an empty
                 asm each iteration, so that the compiler recomputes each
                 address there rather than holding it for the decode
  tier 2         a second register tier for codes of up to 56 checks and 104
                 variables (sim_50_100: 7 checks and 13 variables a thread)
  rows 16        the register tier with 16 rows of threads (16 warps a
                 block) in place of 8
  three passes   the min-sum check step as three passes over the row (min1
                 and the sign product, the first argmin, min2), the
                 parent's form, in place of the one pass
  parent form    tables and three passes together
  ptxas blocks   the register tier without __launch_bounds__' minimum of
                 4 blocks an SM (ptxas's own register count)
  min blocks 5   the register tier held to 5 blocks an SM
  constant       lever 1(b): the table route for every code, its widths and
                 slot table in the constant bank (a __grid_constant__
                 kernel parameter) in place of shared memory

so that the check step's arithmetic is the shipped time less the
skeleton's, and the check step's loads and stores the skeleton's less the
variable step's. Every variant not marked timing only must decide as the
shipped kernel on every frame. Prints each library's registers and spills
(ptxas), its static SASS mix (``tools/issue_model.py::kernel_mix``) and
blocks an SM (``cuda_bp.occupancy``) for the method's kernel at WR = 6,
each tier. The source must hold each substitution's text, or this raises.

    python -m gr_ldpc_ece535a_torch.tools.exact_probe [sumproduct] [minsum]
"""

from __future__ import annotations

import functools
import re
import subprocess

import torch

from ..codes import get_code
from ..ops import _build, cuda_bp
from ._timing import make_inputs, time_decode

__all__ = ["VARIANTS", "METHODS", "TIMING_ONLY", "variant_source",
           "ptxas_summary", "main"]

_ONE_PASS = """    const float b = beta[w];
    if (w == 0) {
      min1 = b;
    } else if (b < min1 || (b != b && min1 == min1)) {
      min2 = nan_min(min2, min1);
      min1 = b;
      arg = w;
    } else {
      min2 = nan_min(min2, b);
    }
  }
"""
# the parent's check step after its first loop (min1 taken beside P there)
_THREE_PASSES = """    min1 = w == 0 ? beta[0] : nan_min(min1, beta[w]);
  }
  // the first argmin (the first NaN when the minimum is NaN)
  const bool min_nan = min1 != min1;
  arg = WR;
#pragma unroll
  for (int w = WR - 1; w >= 0; --w)
    if (min_nan ? beta[w] != beta[w] : beta[w] == min1) arg = w;
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    const float b = w == arg ? FLT_MAX : beta[w];
    min2 = w == 0 ? b : nan_min(min2, b);
  }
"""
_SHAPES = "constexpr Shape kShapes[] = {{32, 64}};"
_TABLES = (_SHAPES, "constexpr Shape kShapes[] = {{0, 0}};")
_OPAQUE = """// An opaque copy: the compiler may not hoist what is computed from it
// out of the iteration loop
__device__ __forceinline__ unsigned opaque(unsigned x) {
  asm volatile("" : "+r"(x));
  return x;
}

template <int R, int T>
struct ThreadRows {"""
# lever 1(b): the table route with each check's width and the variables'
# slots in the constant bank, a __grid_constant__ kernel parameter of 16-bit
# entries (a warp reads one entry at a time, one broadcast from the constant
# cache), taken from the device tables once for each table (measurement
# only: its cache is keyed by the tables' device address)
_PARAM = """constexpr int kParamEntries = 8192;
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
// each check's real width (from chk_var), then var_cslots
ParamTables param_tables(const int* chk_var, int M, int Wr,
                         const int* var_cslots, int nvc) {
  static std::map<const int*, ParamTables> cache;
  auto it = cache.find(chk_var);
  if (it == cache.end()) {
    std::vector<int> cv(M * Wr), vc(nvc);
    cudaMemcpy(cv.data(), chk_var, 4 * M * Wr, cudaMemcpyDeviceToHost);
    cudaMemcpy(vc.data(), var_cslots, 4 * nvc, cudaMemcpyDeviceToHost);
    ParamTables t{};
    for (int m = 0; m < M && m < kParamEntries; ++m)
      for (int w = 0; w < Wr; ++w) t.t[m] += cv[m * Wr + w] >= 0;
    for (int i = 0; i < nvc && M + i < kParamEntries; ++i)
      t.t[M + i] = vc[i];
    it = cache.emplace(chk_var, t).first;
  }
  return it->second;
}

"""
CONSTANT = [
    _TABLES,
    ("template <bool SP>\n__device__ __forceinline__ void var_step(float* "
     "msg, const float* r,\n                                         const "
     "int* vc,",
     _PARAM + "template <bool SP, class VC>\n__device__ __forceinline__ void "
     "var_step(float* msg, const float* r, VC vc,"),
    ("  __device__ __forceinline__ void load(const int* deg, const int* vc,",
     "  template <class DG, class VC>\n  __device__ __forceinline__ void "
     "load(DG deg, VC vc,"),
    ("                int iterations) {\n  constexpr int kThreads",
     "                int iterations, const __grid_constant__ ParamTables pt)"
     " {\n  constexpr int kThreads"),
    ("  int* deg = reinterpret_cast<int*>(r + N * kRStride);   // real slots a"
     " check\n  int* vc = deg + M;\n  int8_t* vh = reinterpret_cast<int8_t*>"
     "(vc + N * Wc);",
     "  int* deg_smem = reinterpret_cast<int*>(r + N * kRStride);\n"
     "  int* vc_smem = deg_smem + M;\n  const ParamView deg{pt, 0}, vc{pt, M};"
     "\n  int8_t* vh = reinterpret_cast<int8_t*>(vc_smem + N * Wc);"),
    ("    deg[m] = d;", "    deg_smem[m] = d;"),
    ("vc[i] = var_cslots[i];", "vc_smem[i] = var_cslots[i];"),
    ("      rx, out, B, chk_var, var_cslots, M, N, Wc, iterations);",
     "      rx, out, B, chk_var, var_cslots, M, N, Wc, iterations,\n"
     "      param_tables(chk_var, M, WR, var_cslots, N * Wc));"),
]
# variant -> [(text in the shipped source, its replacement), ...]
VARIANTS = {
    "skeleton": [("th[w] = tanhf(row[w * kFrames] / 2.f);",
                  "th[w] = row[w * kFrames];"),
                 ("row[w * kFrames] = logf((1.f + T[w]) / (1.f - T[w]));",
                  "row[w * kFrames] = -th[w];")],
    "variable step": [("check_sumproduct<WR>(msg, deg[m], m, f);", ";")],
    "minsum skeleton": [("(P * alpha[w]) * (w == arg ? min2 : min1)",
                         "-(alpha[w] * beta[w])")],
    "minsum variable step": [
        ("check_minsum<WR>(msg, deg[m], m, f);", ";"),
        ("if (m < M) check_minsum<WR>(msg, (rows.width >> (4 * i)) & 15, m, f);",
         ";")],
    "tables": [_TABLES],
    "three passes": [(_ONE_PASS, _THREE_PASSES)],
    "parent form": [_TABLES, (_ONE_PASS, _THREE_PASSES)],
    "ptxas blocks": [("constexpr int kRegMinBlocks = 4;",
                      "constexpr int kRegMinBlocks = 0;")],
    "min blocks 5": [("constexpr int kRegMinBlocks = 4;",
                      "constexpr int kRegMinBlocks = 5;")],
    "rows 16": [("constexpr int kRegRows = 8;", "constexpr int kRegRows = 16;")],
    "tier 2": [
        (_SHAPES, "constexpr Shape kShapes[] = {{32, 64}, {56, 104}};"),
        ("    if (t == 1) return (const void*)bp_exact_kernel<WR, SP, kRegRows, "
         "1>;",
         "    if (t == 1) return (const void*)bp_exact_kernel<WR, SP, kRegRows, "
         "1>;\n    else if (t == 2) return (const void*)bp_exact_kernel<WR, "
         "SP, kRegRows, 2>;"),
        ("static_assert(kTiers == 1,", "static_assert(kTiers == 2,"),
        ("switch (t) { BP_TIER(W, 1) default: break; }",
         "switch (t) { BP_TIER(W, 1) BP_TIER(W, 2) default: break; }")],
    "opaque": [
        ("template <int R, int T>\nstruct ThreadRows {", _OPAQUE),
        ("if (m < M) check_minsum<WR>(msg, (rows.width >> (4 * i)) & 15, m, f);",
         "if (m < M)\n          check_minsum<WR>(msg, (opaque(rows.width) >> "
         "(4 * i)) & 15, m,\n                           "
         "(int)opaque((unsigned)f));"),
        ("      const int v = (slots[i][k / 2] >> (16 * (k & 1))) & 0xffff;",
         "      const int v = (opaque(slots[i][k / 2]) >> (16 * (k & 1))) & "
         "0xffff;"),
        ("        var_step_minsum(msg, vh, rows.rj[i], s, j, Wc, f, last);",
         "        var_step_minsum(msg, vh, rows.rj[i], s, j, Wc,\n"
         "                        (int)opaque((unsigned)f), last);")],
    "constant": CONSTANT,
}
# method -> its (skeleton, variable step) variants, then its levers
METHODS = {"sumproduct": ("skeleton", "variable step"),
           "minsum": ("minsum skeleton", "minsum variable step", "tables",
                      "three passes", "parent form", "constant",
                      "opaque", "rows 16", "tier 2", "ptxas blocks",
                      "min blocks 5")}
TIMING_ONLY = ("skeleton", "variable step", "minsum skeleton",
               "minsum variable step")
CODES = ("block_32_64", "sim_50_100")
FRAMES, ITERATIONS, EBN0_DB = 1 << 17, 20, 4.0


def variant_source(src: str, variant: str) -> str:
    """bp_exact.cu's text ``src`` with ``variant``'s substitutions;
    ValueError where the source no longer holds one's text."""
    for old, new in VARIANTS[variant]:
        if old not in src:
            raise ValueError(f"bp_exact.cu no longer holds {old!r} "
                             f"({variant})")
        src = src.replace(old, new)
    return src


def ptxas_summary(log: str, wr: int, sumproduct: bool = True,
                  tier: int | None = None) -> str:
    """ptxas's registers and spills of bp_exact_kernel<wr, sumproduct> (of
    ``tier``, where given) in a build log (nvcc -Xptxas -v), "" if the log
    has none."""
    tag = f"bp_exact_kernelILi{wr}ELb{int(sumproduct)}E"
    if tier is not None:
        tag += rf"Li\d+ELi{tier}E"
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


def main(methods=tuple(METHODS)) -> dict:
    """Print and return {method: {"card", "ms": {(library, code): [ms,
    ms]}, "ptxas": {(library, tier): summary}, "mix": {(library, tier):
    static SASS counts}, "blocks": {(library, code): (blocks an SM, warps a
    block)}}}."""
    if not torch.cuda.is_available():
        raise RuntimeError("exact_probe times kernels on a CUDA device; none "
                           "found")
    from .issue_model import kernel_mix, sass_dump, sass_functions

    src = _build.SOURCES["bp_exact"].read_text()
    names = list(dict.fromkeys(v for m in methods for v in METHODS[m]))
    texts = {v: variant_source(src, v) for v in names}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    libs = {"shipped": _build.load_library("bp_exact"),
            **dict(zip(texts, _build.load_variants("bp_exact",
                                                   list(texts.values()))))}
    paths = {"shipped": _build.build()["bp_exact"][0],
             **{v: _build.variant_path("bp_exact", t) for v, t in
                texts.items()}}
    sass = {name: sass_functions(sass_dump(p)) for name, p in paths.items()}
    codes = {n: get_code(n) for n in CODES}
    rx = {n: make_inputs(c, FRAMES, torch.Generator(device=dev).manual_seed(
              1000), dev, EBN0_DB) for n, c in codes.items()}
    out = {}
    for method in methods:
        sp = method == "sumproduct"
        lib_names = ("shipped", *METHODS[method])
        runs, blocks, ref = {}, {}, {}
        for name in lib_names:
            for n, c in codes.items():
                runs[name, n] = functools.partial(
                    cuda_bp._launch, "exact", sp, rx[n], c, ITERATIONS, False,
                    lib=libs[name])
                blocks[name, n] = cuda_bp.occupancy(c, "exact", sp,
                                                    lib=libs[name])
                v = runs[name, n]()
                if (name not in TIMING_ONLY
                        and not torch.equal(v, ref.setdefault(n, v))):
                    raise AssertionError(f"the {name} variant decides "
                                         f"otherwise: {method} {n}")
        ptxas, mix = {}, {}
        for name in lib_names:     # each instance the library holds
            log = paths[name].with_suffix(".log").read_text()
            for t in (0, 1, 2):
                if ptxas_summary(log, 6, sp, t):
                    ptxas[name, t] = ptxas_summary(log, 6, sp, t)
                    mix[name, t] = kernel_mix(
                        sass[name],
                        rf"bp_exact_kernelILi6ELb{int(sp)}ELi\d+ELi{t}E")
        times = {}
        for order in (lib_names, lib_names[::-1]):
            for name in order:
                for n in codes:
                    times.setdefault((name, n), []).append(
                        time_decode(runs[name, n]))
        print(f"[exact_probe] exact {method} (WR = 6), library, tier: ptxas; "
              f"static SASS [{card}]", flush=True)
        for (name, t), p in ptxas.items():
            print(f"    {name:20s} {t} {p}; {mix[name, t]}", flush=True)
        print(f"[exact_probe] exact {method} {FRAMES} x {ITERATIONS} "
              f"@{EBN0_DB}dB, library, code: blocks an SM x warps a block, "
              f"ms (two interleaved runs, each a median of 20) [{card}]",
              flush=True)
        for (name, n), ts in times.items():
            print(f"    {name:20s} {n:12s} {blocks[name, n][0]} x "
                  f"{blocks[name, n][1]} warps  "
                  + " / ".join(f"{t:.4f}" for t in ts), flush=True)
        skel, var = METHODS[method][:2]
        for n in codes:
            ms = {name: sum(times[name, n]) / 2 for name in ("shipped", skel,
                                                             var)}
            check = ms["shipped"] - ms[skel]
            print(f"[exact_probe] {method} {n}: check step arithmetic "
                  f"(shipped - skeleton) {check:.4f} ms = "
                  f"{check / ms['shipped']:.3f} of the kernel; the check "
                  f"step's loads and stores (skeleton - variable step) "
                  f"{ms[skel] - ms[var]:.4f} ms; the variable step, tables, "
                  f"barriers and set-up {ms[var]:.4f} ms [{card}]",
                  flush=True)
        out[method] = {"card": card, "ms": times, "ptxas": ptxas, "mix": mix,
                       "blocks": blocks}
    return out


if __name__ == "__main__":
    import sys
    main(tuple(sys.argv[1:]) or tuple(METHODS))
