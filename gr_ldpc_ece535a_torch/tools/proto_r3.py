"""The round-3 hi/lo min-sum aggregation, on the card.

The counterpart of ``tools/proto_r3.py``'s ``minsum_kernel``. Its three
variants split each aggregation operand x into hi = bf16(x) and lo =
bf16(x - hi) (the TPU's DEFAULT products round the lo half too, so the pair
carries about 17 bits, not 24) and differ only in the order of the sum:

  precise2   two products, G hi + G lo
  stacked    one product [G | G] [hi; lo]: the others' hi, then their lo
  stacked16  the same, the halves concatenated in bf16

All three run the compile-time instance ``study_ms_hilo`` of
``csrc/bp_study_ms.cu`` (``ops/cuda_study_ms.py``), in the stacked order;
the final sum is one bf16 pass. Each reports its frame agreement with the
shipped precise kernel, ``cuda_decode_minsum(mode="precise")``. The
sum-product kernels of that script are not ported yet.

    python -m gr_ldpc_ece535a_torch.tools.proto_r3 [--device cpu|cuda] [--frames N]
"""

from __future__ import annotations

import functools

import torch

from ..ops.cuda_bp import cuda_decode_minsum
from ..ops.cuda_study_ms import study_ms_decode, study_ms_plain
from ._timing import STUDY_FRAMES, cli, minsum_kind, study_inputs, study_row

VARIANTS = {v: "study_ms_hilo" for v in ("precise2", "stacked", "stacked16")}


def run(kind: str, variant: str, rx: torch.Tensor, code,
        iterations: int = 20):
    """Decode rx (B, N) with a ``kind`` ("minsum") variant."""
    minsum_kind(kind)
    return study_ms_decode(VARIANTS[variant], rx, code, iterations)


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    ref = cuda_decode_minsum(rx, code, iterations, mode="precise")
    return [study_row("ms-r3", name, inst, functools.partial(run, "minsum"),
                      lambda r, i=inst: study_ms_plain(i, r, code, iterations),
                      rx, code, iterations, reference=ref)
            for name, inst in VARIANTS.items()]


if __name__ == "__main__":
    cli(main, __doc__)
