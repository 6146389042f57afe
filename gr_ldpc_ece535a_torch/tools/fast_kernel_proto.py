"""The fast-kernel prototypes, sum-product and first-argmin min-sum, on the
card.

The counterpart of ``tools/fast_kernel_proto.py``'s two kernels, each a
compile-time instance of the study libraries; every product the TPU ran at
precision DEFAULT has its operand rounded to bf16:

  sp   ``_sp_fast_kernel``, ``study_sp_split`` of ``csrc/bp_study.cu``
       (``ops/cuda_study.py``): the phi check step; the variable step forms
       L = (sum of the variable's bf16 E) + deg*r once a variable and
       M = bf16(L - r) - own E ("total - own"); the first gather rounds r
  ms   ``_ms_fast_kernel``, ``study_ms_argmin`` of ``csrc/bp_study_ms.cu``
       (``ops/cuda_study_ms.py``): min1, the first argmin and min2; A = Lci +
       (sum of the variable's Lr), Lq = A - own Lr, with every gather
       rounded (the first gather of Lci, the Lr operands, A)

Each reports its frame agreement with the f32 path of its method,
``ops.decode.decode_sumproduct`` or ``decode_minsum`` (fixed iterations), on
the first 4,096 frames, as the JAX script's ``main``.

    python -m gr_ldpc_ece535a_torch.tools.fast_kernel_proto [--device cpu|cuda] [--frames N]
"""

from __future__ import annotations

import torch

from ..ops.decode import decode_minsum, decode_sumproduct
from ._timing import (STUDY_FNS, STUDY_FRAMES, cli, study_inputs,
                      study_kind, study_row)

VARIANTS = {"sp": "study_sp_split", "ms": "study_ms_argmin"}
REFERENCE_FRAMES = 4096
_F32_PATHS = {"sp": decode_sumproduct, "ms": decode_minsum}


def run_fast(kernel: str, rx: torch.Tensor, code, iterations: int = 20):
    """Decode rx (B, N) with the prototype kernel ``kernel`` ("sp" or "ms")."""
    decode = STUDY_FNS[study_kind(kernel)][0]
    return decode(VARIANTS[kernel], rx, code, iterations)


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    rows = []
    for name, inst in VARIANTS.items():
        ref = _F32_PATHS[name](rx[:REFERENCE_FRAMES], code, iterations,
                               early_exit=False)
        plain = STUDY_FNS[study_kind(name)][1]
        rows.append(study_row(
            f"{name}-fast", name, inst, run_fast,
            lambda r, i=inst, p=plain: p(i, r, code, iterations),
            rx, code, iterations, reference=ref))
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
