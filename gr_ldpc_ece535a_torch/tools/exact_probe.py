"""Where the exact sum-product kernel's time goes (csrc/bp_exact.cu); card only.

Builds two variants of the source (``_build.load_variant``, into the
git-ignored ``_build/``) and times them interleaved with the shipped exact
SPA at block_32_64, 131,072 frames x 20 iterations, 4 dB (CUDA events,
``tools/_timing.py::time_decode``):

  skeleton       the check step writes each message back negated (no
                 tanhf, products, division or logf; a plain copy would be
                 removed as a no-op store): the loads, stores, tables,
                 barriers and the variable step
  variable step  no check step at all

so that the check step's arithmetic is the shipped time less the
skeleton's, and the check step's loads and stores the skeleton's less the
variable step's. Prints each library's registers and spills (ptxas) and
blocks an SM (``cuda_bp.occupancy``) for the exact SPA at WR = 6. The
variants' decisions are not a decoder's. The source must hold each
substitution's text, or this raises.

    python -m gr_ldpc_ece535a_torch.tools.exact_probe
"""

from __future__ import annotations

import functools
import subprocess

import torch

from ..codes import get_code
from ..ops import _build, cuda_bp
from ._timing import make_inputs, time_decode

__all__ = ["VARIANTS", "variant_source", "ptxas_summary", "main"]

# variant -> [(text in the shipped source, its replacement), ...]
VARIANTS = {
    "skeleton": [("th[w] = tanhf(row[w * kFrames] / 2.f);",
                  "th[w] = row[w * kFrames];"),
                 ("row[w * kFrames] = logf((1.f + T[w]) / (1.f - T[w]));",
                  "row[w * kFrames] = -th[w];")],
    "variable step": [("check_sumproduct<WR>(msg, deg[m], m, f);", ";")],
}
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


def ptxas_summary(log: str, wr: int, sumproduct: bool = True) -> str:
    """ptxas's registers and spills of bp_exact_kernel<wr, sumproduct> in a
    build log (nvcc -Xptxas -v), "" if the log has none."""
    tag = f"bp_exact_kernelILi{wr}ELb{int(sumproduct)}E"
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling" in line and tag in line:
            notes = []
            for nxt in lines[i + 1:]:
                if "Compiling" in nxt:
                    break
                if "Used" in nxt or "spill" in nxt:
                    notes.append(nxt.split(":", 1)[-1].strip())
            return "; ".join(notes)
    return ""


def main() -> dict:
    """Print and return {"card", "ms": {library: [ms, ms]}, "ptxas":
    {library: summary}, "blocks": {library: (blocks an SM, warps a
    block)}}."""
    if not torch.cuda.is_available():
        raise RuntimeError("exact_probe times kernels on a CUDA device; none "
                           "found")
    src = _build.SOURCES["bp_exact"].read_text()
    texts = {v: variant_source(src, v) for v in VARIANTS}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    libs = {"shipped": _build.load_library("bp_exact"),
            **{v: _build.load_variant("bp_exact", t) for v, t in texts.items()}}
    logs = {"shipped": _build.build()["bp_exact"][1],
            **{v: _build.variant_path("bp_exact", t).with_suffix(".log")
               .read_text() for v, t in texts.items()}}
    code = get_code("block_32_64")
    rx = make_inputs(code, FRAMES, torch.Generator(device=dev).manual_seed(
        1000), dev, EBN0_DB)
    runs = {name: functools.partial(cuda_bp._launch, "exact", True, rx, code,
                                    ITERATIONS, False, lib=lib)
            for name, lib in libs.items()}
    blocks = {name: cuda_bp.occupancy(code, "exact", True, lib=lib)
              for name, lib in libs.items()}
    ptxas = {name: ptxas_summary(log, 6) for name, log in logs.items()}
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            times.setdefault(name, []).append(time_decode(runs[name]))
    ms = {name: sum(ts) / len(ts) for name, ts in times.items()}
    print(f"[exact_probe] exact SPA {code.name} {FRAMES} x {ITERATIONS} "
          f"@{EBN0_DB}dB, WR = 6: ms (two interleaved runs, each a median of "
          f"20), blocks an SM x warps a block, ptxas [{card}]", flush=True)
    for name, ts in times.items():
        print(f"    {name:13s} " + " / ".join(f"{t:.4f}" for t in ts)
              + f"  {blocks[name][0]} x {blocks[name][1]} warps  "
              f"{ptxas[name]}", flush=True)
    check = ms["shipped"] - ms["skeleton"]
    memory = ms["skeleton"] - ms["variable step"]
    print(f"[exact_probe] check step arithmetic (shipped - skeleton) "
          f"{check:.4f} ms = {check / ms['shipped']:.3f} of the kernel; the "
          f"check step's loads and stores (skeleton - variable step) "
          f"{memory:.4f} ms; the variable step, tables, barriers and set-up "
          f"{ms['variable step']:.4f} ms [{card}]", flush=True)
    return {"card": card, "ms": times, "ptxas": ptxas, "blocks": blocks}


if __name__ == "__main__":
    main()
