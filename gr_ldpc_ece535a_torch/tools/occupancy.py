"""Variants of the large-code w-major kernels (csrc/bp_wmajor.cu); card only.

The large-code block's shared memory holds it to one block an SM on the
large codes, so its rows of threads set the warps an SM, and only those
warps hide the latency of its shared-memory loads. This builds the source
with one substitution at a time (``_build.load_variant``, into the
git-ignored ``_build/``) and times each library's large-code kernels
against the shipped ones, interleaved (CUDA events,
``tools/_timing.py::time_decode``), beside their blocks an SM
(``cuda_bp.occupancy``):

  rows 32        32 rows of threads (16 warps) for both kinds, against the
                 shipped 64 (32 warps)
  pairs          the min-sum thread loads two checks (two variables) before
                 it computes either (not shipped: it did not pay)
  conflict-free  measurement only: the variable step reads and writes each
                 message at the slot of its warp's even row's parity, so the
                 warp's two rows never share a bank; its decisions are not a
                 decoder's, and the time is the variable step's without
                 bank conflicts

Every variant but the last must decide as the shipped kernels on every
frame. The source must hold each substitution's text, or this raises.

    python -m gr_ldpc_ece535a_torch.tools.occupancy
"""

from __future__ import annotations

import functools
import subprocess

import torch

from ..codes import LdpcCode, get_code, make_ldpc
from ..ops import _build, cuda_bp
from ..parallel.sweep import draw_frames
from ._timing import make_inputs, time_decode

__all__ = ["ROWS", "VARIANTS", "TIMING_ONLY", "variant_source", "main"]

ROWS = "kLargeFrames = 16, kLargeRows = 64;"         # as shipped
# the thread's checks and variables one at a time (as shipped), and the
# large min-sum's two at a time: both loads issued before either computes
_CHECKS = "    for (int m = y; m < M; m += R) odd |= check(m, syn);\n"
_PAIR_CHECKS = """    if constexpr (!SP && F == kLargeFrames) {
      for (int m = y; m < M; m += 2 * R) {
        const CheckRow<WR> a = load_check<WR, F>(msg, sv, vh, m, M, f);
        if (m + R < M) {
          const CheckRow<WR> b = load_check<WR, F>(msg, sv, vh, m + R, M, f);
          odd |= check_minsum<WR, F>(msg, a, m, M, f, syn, norm_offset,
                                     norm_scale, use_offset, use_scale);
          odd |= check_minsum<WR, F>(msg, b, m + R, M, f, syn, norm_offset,
                                     norm_scale, use_offset, use_scale);
        } else {
          odd |= check_minsum<WR, F>(msg, a, m, M, f, syn, norm_offset,
                                     norm_scale, use_offset, use_scale);
        }
      }
    } else {
      for (int m = y; m < M; m += R) odd |= check(m, syn);
    }
"""
_VARS = """    for (int j = y; j < N; j += R)
      var_step<SP, F>(msg, vh, load_var<F>(msg, r, vs, j, Wc, f), j, Wc, f,
                      write_msgs, write_vh);
"""
_PAIR_VARS = """    if constexpr (!SP && F == kLargeFrames) {
      for (int j = y; j < N; j += 2 * R) {
        const VarRow a = load_var<F>(msg, r, vs, j, Wc, f);
        if (j + R < N) {
          const VarRow b = load_var<F>(msg, r, vs, j + R, Wc, f);
          var_step<SP, F>(msg, vh, a, j, Wc, f, write_msgs, write_vh);
          var_step<SP, F>(msg, vh, b, j + R, Wc, f, write_msgs, write_vh);
        } else {
          var_step<SP, F>(msg, vh, a, j, Wc, f, write_msgs, write_vh);
        }
      }
    } else {
      for (int j = y; j < N; j += R)
        var_step<SP, F>(msg, vh, load_var<F>(msg, r, vs, j, Wc, f), j, Wc, f,
                        write_msgs, write_vh);
    }
"""
# variant -> [(text in the shipped source, its replacement), ...]
VARIANTS = {
    "rows 32": [(ROWS, "kLargeFrames = 16, kLargeRows = 32;")],
    "pairs": [(_CHECKS, _PAIR_CHECKS), (_VARS, _PAIR_VARS)],
    "conflict-free": [("msg[v.s[k] * F + f]",
                       "msg[((v.s[k] & ~1) | (j & 1)) * F + f]")],
}
TIMING_ONLY = ("conflict-free",)


def variant_source(src: str, variant: str) -> str:
    """bp_wmajor.cu's text ``src`` with ``variant``'s substitutions;
    ValueError where the source no longer holds one's text."""
    for old, new in VARIANTS[variant]:
        if old not in src:
            raise ValueError(f"bp_wmajor.cu no longer holds {old!r} "
                             f"({variant})")
        src = src.replace(old, new)
    return src


def main() -> dict:
    """Print and return {"card", "blocks": {(library, case): (blocks an SM,
    warps a block)}, "ms": {(library, case): [ms, ms]}}."""
    if not torch.cuda.is_available():
        raise RuntimeError("occupancy times kernels on a CUDA device; none "
                           "found")
    src = _build.SOURCES["bp_wmajor"].read_text()
    texts = {v: variant_source(src, v) for v in VARIANTS}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    libs = {"shipped": _build.load_library("bp_wmajor"),
            **{v: _build.load_variant("bp_wmajor", t)
               for v, t in texts.items()}}
    code = get_code("block_32_64")
    big = LdpcCode.from_h(make_ldpc(256, 512, seed=1), name="gen_256_512")
    rx4 = make_inputs(code, 1 << 17, torch.Generator(device=dev).manual_seed(
        1000), dev, 4.0)
    rxl = make_inputs(big, 1 << 14, torch.Generator(device=dev).manual_seed(6),
                      dev, 2.0)
    # the gen_256_512 sweep's step at 1.5 dB, as run_waterfall draws it
    rxs = draw_frames(big, 1 << 17, (0, 1, 0), 1.5, dev)[1]
    cases = {f"{'SPA' if sp else 'MS'} {c.name}": (c, rx, sp, False)
             for c, rx in ((code, rx4), (big, rxl)) for sp in (True, False)}
    cases.update({f"{'SPA' if sp else 'MS'} sweep step 1.5dB": (big, rxs, sp,
                                                                True)
                  for sp in (True, False)})
    # the min-sum-only variants time the min-sum cases
    which = {"rows 32": list(cases),
             **{v: [k for k in cases if k.startswith("MS")]
                for v in ("pairs", "conflict-free")}}
    blocks, ref, runs = {}, {}, {}
    for name, lib in libs.items():
        for k in which.get(name, cases):
            c, rx, sp, ee = cases[k]
            blocks[name, k] = cuda_bp.occupancy(c, "large", sp, lib=lib)
            runs[name, k] = functools.partial(cuda_bp._launch, "large", sp, rx,
                                              c, 20, ee, lib=lib)
            out = runs[name, k]()
            if (name not in TIMING_ONLY
                    and not torch.equal(out, ref.setdefault(k, out))):
                raise AssertionError(f"the {name} variant decides otherwise: "
                                     f"{k}")
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for k in which.get(name, cases):
                times.setdefault((name, k), []).append(
                    time_decode(runs[name, k]))
    print(f"[occupancy] large-code kernel, library, case (20 iterations; "
          f"sweep step: 131,072 frames, early exit): blocks an SM x warps a "
          f"block, ms (two interleaved runs, each a median of 20) [{card}]",
          flush=True)
    for (name, k), ts in times.items():
        print(f"    {name:13s} {k:24s} {blocks[name, k][0]} x "
              f"{blocks[name, k][1]:2d} warps  "
              + " / ".join(f"{t:.4f}" for t in ts), flush=True)
    return {"card": card, "blocks": blocks, "ms": times}


if __name__ == "__main__":
    main()
