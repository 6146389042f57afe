"""Rows of threads in the large-code w-major blocks (csrc/bp_wmajor.cu); card only.

The large-code block's shared memory holds it to one block an SM on the
large codes, so its rows of threads set the warps an SM. This builds the
source with the rows swapped (sum-product 32, as before the SFU check step;
min-sum 64) into the git-ignored ``_build/`` and times the large-code
kernels of both libraries, interleaved (CUDA events,
``tools/_timing.py::time_decode``), beside their blocks an SM
(``cuda_bp.occupancy``). Both must decide alike on every frame.

    python -m gr_ldpc_ece535a_torch.tools.occupancy
"""

from __future__ import annotations

import functools
import subprocess

import torch

from ..codes import LdpcCode, get_code, make_ldpc
from ..ops import _build, cuda_bp
from ._timing import make_inputs, time_decode

__all__ = ["ROWS", "SWAPPED", "main"]

ROWS = "kLargeRowsSp = 64, kLargeRowsMs = 32;"       # as shipped
SWAPPED = "kLargeRowsSp = 32, kLargeRowsMs = 64;"


def main() -> dict:
    """Print and return {"card", "blocks": {(library, case): (blocks an SM,
    warps a block)}, "ms": {(library, case): [ms, ms]}}."""
    if not torch.cuda.is_available():
        raise RuntimeError("occupancy times kernels on a CUDA device; none "
                           "found")
    src = _build.SOURCES["bp_wmajor"].read_text()
    if ROWS not in src:
        raise ValueError(f"bp_wmajor.cu no longer sets the rows as {ROWS!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    libs = {"shipped": _build.load_library("bp_wmajor"),
            "swapped": _build.load_variant("bp_wmajor",
                                           src.replace(ROWS, SWAPPED))}
    code = get_code("block_32_64")
    big = LdpcCode.from_h(make_ldpc(256, 512, seed=1), name="gen_256_512")
    rx4 = make_inputs(code, 1 << 17, torch.Generator(device=dev).manual_seed(
        1000), dev, 4.0)
    rxl = make_inputs(big, 1 << 14, torch.Generator(device=dev).manual_seed(6),
                      dev, 2.0)
    cases = {f"{'SPA' if sp else 'MS'} {c.name}": (c, rx, sp)
             for c, rx in ((code, rx4), (big, rxl)) for sp in (True, False)}
    blocks, ref, runs = {}, {}, {}
    for name, lib in libs.items():
        for k, (c, rx, sp) in cases.items():
            blocks[name, k] = cuda_bp.occupancy(c, "large", sp, lib=lib)
            runs[name, k] = functools.partial(cuda_bp._launch, "large", sp, rx,
                                              c, 20, False, lib=lib)
            out = runs[name, k]()
            if not torch.equal(out, ref.setdefault(k, out)):
                raise AssertionError(f"the {name} rows decide otherwise: {k}")
    times = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for k in cases:
                times.setdefault((name, k), []).append(
                    time_decode(runs[name, k]))
    print(f"[occupancy] large-code kernel, library, case: blocks an SM x warps "
          f"a block, ms (two interleaved runs, each a median of 20) [{card}]",
          flush=True)
    for (name, k), ts in times.items():
        print(f"    {name:8s} {k:18s} {blocks[name, k][0]} x "
              f"{blocks[name, k][1]:2d} warps  "
              + " / ".join(f"{t:.4f}" for t in ts), flush=True)
    return {"card": card, "blocks": blocks, "ms": times}


if __name__ == "__main__":
    main()
