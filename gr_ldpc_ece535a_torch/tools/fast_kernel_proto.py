"""The first-argmin min-sum prototype, on the card.

The counterpart of ``tools/fast_kernel_proto.py``'s min-sum kernel
(``_ms_fast_kernel``), the compile-time instance ``study_ms_argmin`` of
``csrc/bp_study_ms.cu`` (``ops/cuda_study_ms.py``): the check step takes
min1, the first argmin and min2; the variable step forms A = Lci + (sum of
the variable's Lr) and Lq = A - own Lr, with every gather rounded to bf16 as
the TPU's DEFAULT products rounded it (the first gather of Lci, the Lr
operands, A).

Its frame agreement is reported against the f32 path, ``ops.decode.
decode_minsum``, on the first 4,096 frames, as the JAX script's ``main``.
The sum-product kernel of that script (``_sp_fast_kernel``) is not ported
yet.

    python -m gr_ldpc_ece535a_torch.tools.fast_kernel_proto [--device cpu|cuda] [--frames N]
"""

from __future__ import annotations

import torch

from ..ops.cuda_study_ms import study_ms_decode, study_ms_plain
from ..ops.decode import decode_minsum
from ._timing import STUDY_FRAMES, cli, minsum_kind, study_inputs, study_row

VARIANTS = {"ms": "study_ms_argmin"}
REFERENCE_FRAMES = 4096


def run_fast(kernel: str, rx: torch.Tensor, code, iterations: int = 20):
    """Decode rx (B, N) with the prototype kernel ``kernel`` ("ms")."""
    minsum_kind(kernel)
    return study_ms_decode(VARIANTS[kernel], rx, code, iterations)


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    ref = decode_minsum(rx[:REFERENCE_FRAMES], code, iterations,
                        early_exit=False)
    return [study_row("ms-fast", name, inst, run_fast,
                      lambda r, i=inst: study_ms_plain(i, r, code, iterations),
                      rx, code, iterations, reference=ref)
            for name, inst in VARIANTS.items()]


if __name__ == "__main__":
    cli(main, __doc__)
