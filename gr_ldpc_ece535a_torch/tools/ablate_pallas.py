"""Ablation of the check-major sum-product kernel, on the card.

The counterpart of ``tools/ablate_pallas.py``: the same variants, each a
compile-time instance of ``csrc/bp_study.cu`` (``ops/cuda_study.py``),
with pieces stubbed out to attribute the cost of an iteration: the
transcendentals (tanh, log), the exclusion products, the aggregation, and
the aggregation's precision (HIGH computes what HIGHEST does here; DEFAULT
rounds the operands to bf16, as the TPU's single bf16 pass).

    python -m gr_ldpc_ece535a_torch.tools.ablate_pallas [--device cpu|cuda] [--frames N]

On the card each line gives the kernel's and the plain version's time; on
the CPU the plain versions run and no time is measured. A failing variant
raises.
"""

from __future__ import annotations

import torch

from ..ops.cuda_study import study_decode, study_plain
from ._timing import STUDY_FRAMES, cli, study_inputs, study_row

# variant -> instance of bp_study.cu
VARIANTS = {
    "baseline": "study_cm",
    "no_tanh": "study_cm_no_tanh",
    "no_log": "study_cm_no_log",
    "no_tanh_log": "study_cm_no_tanh_log",
    "no_excl": "study_cm_no_excl",
    "no_matmul": "study_cm_no_matmul",
    "prec_high": "study_cm",
    "prec_default": "study_cm_bf16",
    "all_off": "study_cm_all_off",
}


def run_variant(variant: str, rx: torch.Tensor, code, iterations: int = 20):
    """Decode rx (B, N) with one variant for ``iterations`` iterations."""
    return study_decode(VARIANTS[variant], rx, code, iterations)


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    return [study_row("ablate", name, inst, run_variant,
                      lambda r, i=inst: study_plain(i, r, code, iterations),
                      rx, code, iterations)
            for name, inst in VARIANTS.items()]


if __name__ == "__main__":
    cli(main, __doc__)
