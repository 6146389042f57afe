"""The round-3 hi/lo aggregation, sum-product and min-sum, on the card.

The counterpart of ``tools/proto_r3.py``'s ``sumprod_kernel``,
``minsum_kernel`` and ``sumprod_kernel_v2``. The TPU split each aggregation
operand x into hi = bf16(x) and lo = x - hi and multiplied both at precision
DEFAULT, which rounds lo to bf16 too: the pair carries about 17 significant
bits, not 24. The three variants of ``run`` differ only in the order of the
sum:

  precise2   two products, G hi + G lo
  stacked    one product [G | G] [hi; lo]: the others' hi, then their lo
  stacked16  the same, the halves concatenated in bf16

All three run one compile-time instance a kind, in the stacked order, with
the decision's sum one bf16 pass: ``study_phi_hilo`` of ``csrc/bp_study.cu``
(``ops/cuda_study.py``; the phi check step) and ``study_ms_hilo`` of
``csrc/bp_study_ms.cu`` (``ops/cuda_study_ms.py``). ``run_v2`` runs the
round-3b sum-product variants, hi/lo in the loop and in the decision:

  phi        the phi check step (study_phi_hilo2)
  psprod1p   tanh(M/2), exclusive prefix x suffix products, T clipped to
             +-(1 - 2^-23), E = log1p(T) - log1p(-T), no divide
             (study_psprod1p)

Every row reports its frame agreement with the shipped precise kernel of
its kind, ``cuda_decode_sumproduct`` or ``cuda_decode_minsum`` with
``mode="precise"``.

    python -m gr_ldpc_ece535a_torch.tools.proto_r3 [--device cpu|cuda] [--frames N] [--v2]
"""

from __future__ import annotations

import functools

import torch

from ..ops.cuda_bp import cuda_decode_minsum, cuda_decode_sumproduct
from ..ops.cuda_study import study_decode, study_plain
from ._timing import (STUDY_FNS, STUDY_FRAMES, cli, study_inputs,
                      study_kind, study_row)

VARIANTS = {kind: dict.fromkeys(("precise2", "stacked", "stacked16"), inst)
            for kind, inst in (("sumprod", "study_phi_hilo"),
                               ("minsum", "study_ms_hilo"))}
V2_VARIANTS = {"phi": "study_phi_hilo2", "psprod1p": "study_psprod1p"}
_SHIPPED = {"minsum": cuda_decode_minsum, "sumprod": cuda_decode_sumproduct}
_TAGS = {"minsum": "ms-r3", "sumprod": "sp-r3"}


def run(kind: str, variant: str, rx: torch.Tensor, code,
        iterations: int = 20):
    """Decode rx (B, N) with a ``kind`` ("sumprod" or "minsum") variant."""
    kind = study_kind(kind)
    return STUDY_FNS[kind][0](VARIANTS[kind][variant], rx, code, iterations)


def run_v2(variant: str, rx: torch.Tensor, code, iterations: int = 20):
    """Decode rx (B, N) with a round-3b sum-product variant."""
    return study_decode(V2_VARIANTS[variant], rx, code, iterations)


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    rows = []
    for kind in ("sumprod", "minsum"):          # the JAX main's order
        ref = _SHIPPED[kind](rx, code, iterations, mode="precise")
        plain = STUDY_FNS[kind][1]
        rows += [study_row(_TAGS[kind], name, inst,
                           functools.partial(run, kind),
                           lambda r, i=inst, p=plain: p(i, r, code, iterations),
                           rx, code, iterations, reference=ref)
                 for name, inst in VARIANTS[kind].items()]
    return rows


def main_v2(device: str = "cuda", frames: int = STUDY_FRAMES,
            iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    ref = cuda_decode_sumproduct(rx, code, iterations, mode="precise")
    return [study_row("sp-r3v2", name, inst, run_v2,
                      lambda r, i=inst: study_plain(i, r, code, iterations),
                      rx, code, iterations, reference=ref)
            for name, inst in V2_VARIANTS.items()]


if __name__ == "__main__":
    cli(main, __doc__, v2=main_v2)
