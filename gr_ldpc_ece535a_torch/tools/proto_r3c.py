"""The round-3c loop unroll, min-sum and sum-product, on the card.

The counterpart of ``tools/proto_r3c.py``'s ``kernel``: the fast kernels'
iteration loop, ``fori_loop(0, iterations - 1, body, unroll=k)`` and a
trailing check step, at unroll 1, 2 and 4. Each (kind, unroll) is a
compile-time instance, the unroll a template argument: blocks of k steps
with a compile-time trip count, then the rest one at a time. Where the
TPU's product ran at precision DEFAULT, its operand is rounded to bf16 (the
first gather, HIGHEST, is exact):

  minsum   study_ms_current's arithmetic: Lq = Lci + (sum of the other
           edges' bf16 Lr), decision Lci + (sum of bf16 Lr) < 0
           (study_ms_current, _u2, _u4; csrc/bp_study_ms.cu)
  sumprod  the phi check step with the textbook variable step: M = r +
           (sum of the other edges' bf16 E), so r enters once, and the
           decision r + (sum of bf16 E) < 0 (study_phi_textbook, _u2, _u4;
           csrc/bp_study.cu). Not the reference's SPA, which takes
           (deg - 1) r in the loop and deg r + sum E <= 0: its agreement
           with the shipped SPA is low by the prototype's design

Every row reports its frame agreement with the JAX main's reference, the
shipped fast kernel of its kind, ``cuda_decode_minsum`` or
``cuda_decode_sumproduct`` with ``mode="fast"``. ``block_b`` (4096 frames)
was a TPU VMEM tile; each instance has one tile, 32 frames a block.

    python -m gr_ldpc_ece535a_torch.tools.proto_r3c [--device cpu|cuda] [--frames N]
"""

from __future__ import annotations

import torch

from ..ops.cuda_bp import cuda_decode_minsum, cuda_decode_sumproduct
from ._timing import (STUDY_FNS, STUDY_FRAMES, cli, study_inputs,
                      study_kind, study_row)

UNROLLS = (1, 2, 4)                 # the JAX main's unrolls
VARIANTS = {"minsum": {1: "study_ms_current", 2: "study_ms_current_u2",
                       4: "study_ms_current_u4"},
            "sumprod": {1: "study_phi_textbook", 2: "study_phi_textbook_u2",
                        4: "study_phi_textbook_u4"}}
_SHIPPED = {"minsum": cuda_decode_minsum, "sumprod": cuda_decode_sumproduct}
_TAGS = {"minsum": "ms-r3c", "sumprod": "sp-r3c"}


def run(kind: str, unroll: int, rx: torch.Tensor, code,
        iterations: int = 20):
    """Decode rx (B, N) with a ``kind`` ("minsum" or "sumprod") kernel at
    ``unroll``."""
    kind = study_kind(kind)
    return STUDY_FNS[kind][0](VARIANTS[kind][unroll], rx, code, iterations)


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    rows = []
    for kind in ("minsum", "sumprod"):          # the JAX main's order
        ref = _SHIPPED[kind](rx, code, iterations, mode="fast")
        plain = STUDY_FNS[kind][1]
        for unroll, inst in VARIANTS[kind].items():
            rows.append(study_row(
                _TAGS[kind], f"unroll={unroll}", inst,
                lambda _v, r, c, it, k=kind, u=unroll: run(k, u, r, c, it),
                lambda r, i=inst, p=plain: p(i, r, code, iterations),
                rx, code, iterations, reference=ref))
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
