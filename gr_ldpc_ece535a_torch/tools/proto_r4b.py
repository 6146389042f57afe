"""Phi-domain vs tanh-product check step of the sum-product, on the card.

The counterpart of ``tools/proto_r4b.py``. Both variants are compile-time
instances of ``csrc/bp_study.cu`` (``ops/cuda_study.py``) with the same f32
aggregation: iterations-1 full steps, then a trailing check step (one even
at zero iterations, as the JAX loop) and the decision.

  phi       the shipped tile SPA's check step: two log tanh(x/2) a slot on
            the special-function unit (study_phi)
  tanhprod  tanh(x/2), exclusive prefix x suffix products, the clip to
            [-1 + 1e-12, 1 - 1e-12] (which is [-1, 1] in f32), and
            log((1+T)/(1-T)), its tanh, divide and log on the
            special-function unit too

Each reports its frame agreement with the shipped fast kernel,
``cuda_decode_sumproduct(mode="fast")``.

    python -m gr_ldpc_ece535a_torch.tools.proto_r4b [--device cpu|cuda] [--frames N]
"""

from __future__ import annotations

import torch

from ..ops.cuda_bp import cuda_decode_sumproduct
from ..ops.cuda_study import study_decode, study_plain
from ._timing import STUDY_FRAMES, cli, study_inputs, study_row

VARIANTS = {"phi": "study_phi", "tanhprod": "study_tanhprod"}


def run(variant: str, rx: torch.Tensor, code, iterations: int = 20):
    """Decode rx (B, N) with one variant for ``iterations`` iterations."""
    return study_decode(VARIANTS[variant], rx, code, max(iterations, 1))


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    ref = cuda_decode_sumproduct(rx, code, iterations, mode="fast")
    steps = max(iterations, 1)
    return [study_row("spa-fast", name, inst, run,
                      lambda r, i=inst: study_plain(i, r, code, steps),
                      rx, code, iterations, reference=ref)
            for name, inst in VARIANTS.items()]


if __name__ == "__main__":
    cli(main, __doc__)
