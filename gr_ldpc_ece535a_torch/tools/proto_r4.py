"""The round-4 loop unroll on the shipped arithmetic, on the card.

The counterpart of ``tools/proto_r4.py``'s ``kernel``: the shipped fast and
precise kernels' arithmetic (``pallas_bp._make_split_mm``) with the
iteration loop unrolled 1 or 19 times, the two unrolls Mosaic took (19 is
the whole trip count at 20 iterations). Each (spec, unroll) is a
compile-time instance, the unroll a template argument: blocks of 19 steps
with a compile-time trip count, then the rest one at a time.

  sumprod        precise: hi = bf16(x), lo = bf16(x - hi), the others' hi
                 then their lo, in the loop and in the decision
                 (study_phi_hilo2, _u19)
  minsum         precise: the same split (study_ms_hilo2, _u19)
  sumprod_fast   bf16 operands, f32 sums, loop and decision
                 (study_phi_bf16all, _u19)
  minsum_fast    the same (study_ms_current, _u19)

``block_b`` (2048-4096 frames) was a TPU VMEM tile; each instance has one
tile, 32 frames a block. Every row reports its frame agreement with the
JAX main's reference, the shipped kernel of its kind in the spec's mode,
``cuda_decode_minsum`` or ``cuda_decode_sumproduct``.

    python -m gr_ldpc_ece535a_torch.tools.proto_r4 [--device cpu|cuda] [--frames N] [SPEC ...]
"""

from __future__ import annotations

import torch

from ..ops.cuda_bp import cuda_decode_minsum, cuda_decode_sumproduct
from ._timing import (STUDY_FNS, STUDY_FRAMES, cli, study_inputs,
                      study_kind, study_row)

SPECS = ("sumprod", "minsum", "sumprod_fast", "minsum_fast")  # the JAX main's
UNROLLS = (1, 19)
# (kind, precise) -> {unroll: instance}
VARIANTS = {("sumprod", True): {1: "study_phi_hilo2", 19: "study_phi_hilo2_u19"},
            ("minsum", True): {1: "study_ms_hilo2", 19: "study_ms_hilo2_u19"},
            ("sumprod", False): {1: "study_phi_bf16all",
                                 19: "study_phi_bf16all_u19"},
            ("minsum", False): {1: "study_ms_current",
                                19: "study_ms_current_u19"}}
_SHIPPED = {"minsum": cuda_decode_minsum, "sumprod": cuda_decode_sumproduct}
_TAGS = {"minsum": "ms-r4", "sumprod": "sp-r4"}


def run(kind: str, unroll: int, rx: torch.Tensor, code,
        iterations: int = 20, precise: bool = True):
    """Decode rx (B, N) with a ``kind`` ("minsum" or "sumprod") kernel at
    ``unroll``, precise or fast."""
    kind = study_kind(kind)
    return STUDY_FNS[kind][0](VARIANTS[kind, bool(precise)][unroll], rx, code,
                              iterations)


def parse_spec(spec: str) -> tuple[str, bool]:
    """A JAX main's spec ("sumprod", "minsum_fast", ...) -> (kind, precise);
    ValueError on any other."""
    kind, _, fastq = spec.partition("_")
    if spec not in SPECS:
        raise ValueError(f"unknown spec {spec!r}; one of {', '.join(SPECS)}")
    return kind, fastq != "fast"


def main(device: str = "cuda", frames: int = STUDY_FRAMES,
         iterations: int = 20, specs=SPECS) -> list[dict]:
    parsed = [parse_spec(s) for s in specs]
    code, rx = study_inputs(device, frames)
    rows = []
    for kind, precise in parsed:
        mode = "precise" if precise else "fast"
        ref = _SHIPPED[kind](rx, code, iterations, mode=mode)
        plain = STUDY_FNS[kind][1]
        for unroll, inst in VARIANTS[kind, precise].items():
            rows.append(study_row(
                _TAGS[kind], f"{mode} unroll={unroll}", inst,
                lambda _v, r, c, it, k=kind, u=unroll, p=precise:
                    run(k, u, r, c, it, precise=p),
                lambda r, i=inst, p=plain: p(i, r, code, iterations),
                rx, code, iterations, reference=ref))
    return rows


if __name__ == "__main__":
    cli(main, __doc__, specs=SPECS)
