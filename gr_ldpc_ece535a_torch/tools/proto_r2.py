"""The round-2 min-sum and sum-product variants, on the card.

The counterpart of ``tools/proto_r2.py``'s ``minsum_kernel`` and
``sumprod_kernel``. Each variant is a compile-time instance of
``csrc/bp_study_ms.cu`` (``ops/cuda_study_ms.py``) or ``csrc/bp_study.cu``
(``ops/cuda_study.py``); where the TPU's product ran at precision DEFAULT,
its operand is rounded to bf16 (HIGHEST, the first gathers, is exact):

  minsum  current     the shipped fast kernel's arithmetic: Lq = Lci + (sum
                      of the other edges' bf16 Lr)
          stub_check  the check step replaced by Lr = 0.5 Lq
          stub_mm     no aggregation: Lq = Lci + the slot's own Lr
          bits        the check step on int32 sign/magnitude bit patterns
          bf16        messages held in bf16
          int8        the aggregation on int8 messages (clip 24, 127 levels),
                      summed exactly ("int8s" runs the same code)
          split       Lq = bf16(Lci + sum of all edges' bf16 Lr) - own Lr
  sumprod current     the phi check step; M = base + (sum of the other
                      edges' bf16 E), and the decision's sum of bf16 E
                      (study_phi_bf16all)
          psprod      tanh(M/2), exclusive prefix x suffix products (signs
                      ride along), T clipped to +-(1 - 2^-23), E =
                      log((1+T)/(1-T)); bf16 products as current
                      (study_psprod)

``main`` runs each kind's yardstick first, the tile kernel's f32
arithmetic (``study_ms_ref``; ``study_phi``, the shipped tile SPA itself),
then each variant of the JAX ``main``; every row reports its frame agreement with the shipped precise
kernel of its kind, ``cuda_decode_minsum`` or ``cuda_decode_sumproduct``
with ``mode="precise"``.

    python -m gr_ldpc_ece535a_torch.tools.proto_r2 [--device cpu|cuda] [--frames N]
"""

from __future__ import annotations

import functools

import torch

from ..ops.cuda_bp import cuda_decode_minsum, cuda_decode_sumproduct
from ._timing import (STUDY_FNS, STUDY_FRAMES, cli, study_inputs,
                      study_kind, study_row)

VARIANTS = {
    "minsum": {"current": "study_ms_current",
               "stub_check": "study_ms_stub_check",
               "stub_mm": "study_ms_stub_mm", "bits": "study_ms_bits",
               "bf16": "study_ms_bf16", "int8": "study_ms_int8",
               "int8s": "study_ms_int8", "split": "study_ms_split"},
    "sumprod": {"current": "study_phi_bf16all", "psprod": "study_psprod"}}
# the JAX main's cases, in its order; int8s is not one
MAIN_VARIANTS = {"minsum": ("current", "stub_check", "stub_mm", "bits", "bf16",
                            "int8", "split"),
                 "sumprod": ("current", "psprod")}
# each kind's yardstick: the tile kernel's arithmetic
REF = {"minsum": "study_ms_ref", "sumprod": "study_phi"}
_SHIPPED = {"minsum": cuda_decode_minsum, "sumprod": cuda_decode_sumproduct}
_TAGS = {"minsum": "ms", "sumprod": "sp"}


def run(kind: str, variant: str, rx: torch.Tensor, code,
        iterations: int = 20):
    """Decode rx (B, N) with a ``kind`` ("minsum" or "sumprod") variant."""
    kind = study_kind(kind)
    return STUDY_FNS[kind][0](VARIANTS[kind][variant], rx, code, iterations)


def run_ref(kind: str, variant: str, rx: torch.Tensor, code,
            iterations: int = 20):
    """Decode rx (B, N) with the yardstick of ``kind``; ``variant`` is the
    row's name and is not read."""
    kind = study_kind(kind)
    return STUDY_FNS[kind][0](REF[kind], rx, code, iterations)


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20) -> list[dict]:
    code, rx = study_inputs(device, frames)
    rows = []
    for kind in ("minsum", "sumprod"):
        ref = _SHIPPED[kind](rx, code, iterations, mode="precise")
        plain, tag = STUDY_FNS[kind][1], _TAGS[kind]
        rows.append(study_row(
            f"{tag}-ref", "shipped", REF[kind],
            functools.partial(run_ref, kind),
            lambda r, i=REF[kind], p=plain: p(i, r, code, iterations),
            rx, code, iterations, reference=ref))
        for name in MAIN_VARIANTS[kind]:
            inst = VARIANTS[kind][name]
            rows.append(study_row(
                f"{tag}-r2", name, inst, functools.partial(run, kind),
                lambda r, i=inst, p=plain: p(i, r, code, iterations),
                rx, code, iterations, reference=ref))
    return rows


if __name__ == "__main__":
    cli(main, __doc__)
