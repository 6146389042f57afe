"""The round-2 min-sum variants, on the card.

The counterpart of ``tools/proto_r2.py``'s ``minsum_kernel``. Each variant
is a compile-time instance of ``csrc/bp_study_ms.cu``
(``ops/cuda_study_ms.py``); where the TPU's product ran at precision
DEFAULT, its operand is rounded to bf16:

  current     the shipped fast kernel's arithmetic: Lq = Lci + (sum of the
              other edges' bf16 Lr)
  stub_check  the check step replaced by Lr = 0.5 Lq
  stub_mm     no aggregation: Lq = Lci + the slot's own Lr
  bits        the check step on int32 sign/magnitude bit patterns
  bf16        messages held in bf16
  int8        the aggregation on int8 messages (clip 24, 127 levels),
              summed exactly ("int8s" runs the same code)
  split       Lq = bf16(Lci + sum of all edges' bf16 Lr) - own Lr

``main`` times ``study_ms_ref`` (the shipped tile min-sum's f32 arithmetic,
the study's yardstick) first, then each variant of the JAX ``main``; each
reports its frame agreement with the shipped precise kernel,
``cuda_decode_minsum(mode="precise")``. The sum-product kernel of that
script is not ported yet.

    python -m gr_ldpc_ece535a_torch.tools.proto_r2 [--device cpu|cuda] [--frames N]
"""

from __future__ import annotations

import functools

import torch

from ..ops.cuda_bp import cuda_decode_minsum
from ..ops.cuda_study_ms import study_ms_decode, study_ms_plain
from ._timing import STUDY_FRAMES, cli, minsum_kind, study_inputs, study_row

VARIANTS = {"current": "study_ms_current",
            "stub_check": "study_ms_stub_check",
            "stub_mm": "study_ms_stub_mm", "bits": "study_ms_bits",
            "bf16": "study_ms_bf16", "int8": "study_ms_int8",
            "int8s": "study_ms_int8", "split": "study_ms_split"}
MAIN_VARIANTS = ("current", "stub_check", "stub_mm", "bits", "bf16", "int8",
                 "split")          # the JAX main's cases; int8s is not one
REF = "study_ms_ref"


def run(kind: str, variant: str, rx: torch.Tensor, code,
        iterations: int = 20):
    """Decode rx (B, N) with a ``kind`` ("minsum") variant."""
    minsum_kind(kind)
    return study_ms_decode(VARIANTS[variant], rx, code, iterations)


def run_ref(variant: str, rx: torch.Tensor, code, iterations: int = 20):
    """Decode rx (B, N) with the yardstick, study_ms_ref."""
    return study_ms_decode(REF, rx, code, iterations)


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    ref = cuda_decode_minsum(rx, code, iterations, mode="precise")
    rows = [study_row("ms-ref", "shipped", REF, run_ref,
                      lambda r: study_ms_plain(REF, r, code, iterations),
                      rx, code, iterations, reference=ref)]
    for name in MAIN_VARIANTS:
        inst = VARIANTS[name]
        rows.append(study_row(
            "ms-r2", name, inst, functools.partial(run, "minsum"),
            lambda r, i=inst: study_ms_plain(i, r, code, iterations),
            rx, code, iterations, reference=ref))
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
