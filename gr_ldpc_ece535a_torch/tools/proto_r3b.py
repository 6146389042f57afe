"""The w-major sum-product variants of the round-3b study, on the card.

The counterpart of ``tools/proto_r3b.py``. Each variant is a compile-time
instance of ``csrc/bp_study.cu`` (``ops/cuda_study.py``):

  base      the shipped tile kernel's arithmetic (phi domain, f32 sums, its
            log tanh on the special-function unit), study_phi
  libm      base with libm's logf(tanhf), the shipped check step before it
            moved onto the special-function unit (no JAX variant: the TPU
            had one phi), study_phi_libm
  skew2     base with two independent frames a thread: on the TPU two
            interleaved half-tiles let the MXU and VPU overlap; here the
            second chain is instruction-level parallelism against latency
  explog    phi as log1p(-e^-x) - log1p(e^-x), its exp and logs on the
            special-function unit too
  skewlog   explog with two frames a thread

and the cost ablation of ``kernel_abl``:

  full      base
  nocheck   E = 0.9 M, no transcendental check step
  nomm      no aggregation: M = base + the slot's own E
  nosplit   the aggregation's operands rounded to bf16 (the TPU's single
            bf16 pass), summed in f32

The parity variants report their frame agreement with the shipped precise
kernel, ``cuda_decode_sumproduct(mode="precise")``; so does the ablation.

    python -m gr_ldpc_ece535a_torch.tools.proto_r3b [--device cpu|cuda] [--frames N]
"""

from __future__ import annotations

import torch

from ..ops.cuda_bp import cuda_decode_sumproduct
from ..ops.cuda_study import study_decode, study_plain
from ._timing import STUDY_FRAMES, cli, study_inputs, study_row

VARIANTS = {"base": "study_phi", "skew2": "study_phi_x2",
            "explog": "study_explog", "skewlog": "study_explog_x2",
            "libm": "study_phi_libm"}
ABL_VARIANTS = {"full": "study_phi", "nocheck": "study_stub",
                "nomm": "study_phi_noagg", "nosplit": "study_phi_bf16"}


def run(variant: str, rx: torch.Tensor, code, iterations: int = 20):
    """Decode rx (B, N) with a parity variant for ``iterations`` iterations."""
    return study_decode(VARIANTS[variant], rx, code, iterations)


def run_abl(variant: str, rx: torch.Tensor, code, iterations: int = 20):
    """Decode rx (B, N) with an ablation variant."""
    return study_decode(ABL_VARIANTS[variant], rx, code, iterations)


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    ref = cuda_decode_sumproduct(rx, code, iterations, mode="precise")
    rows = []
    for tag, variants, fn in (("spa-precise", VARIANTS, run),
                              ("abl", ABL_VARIANTS, run_abl)):
        for name, inst in variants.items():
            rows.append(study_row(
                tag, name, inst, fn,
                lambda r, i=inst: study_plain(i, r, code, iterations),
                rx, code, iterations, reference=ref))
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
