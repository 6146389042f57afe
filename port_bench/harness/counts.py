"""The yardstick: operations and bytes a kernel's work needs, and the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W), frozen here so that no change to the program moves them.

A bound is the least time the card could take: the larger of the f32
operations over ``F32_OPS_S`` and the bytes over ``HBM_BYTES_S``. The
counts follow the algorithm's shape, not an implementation:

- BP decode (a frame, a pass): ``OPS_PER_EDGE[method]`` f32 operations an
  edge, each counted as one (a tanh or a log too, so the bound is
  generous); bytes: rx read once (f32) and the decisions written once
  (int8). Under early exit a frame's passes are those the reference needs.
- The clock tracker's block loop (a symbol): 12 dot products of L taps
  (y and dy on two planes at three rows), two operations an FMA, and 28
  more (u and pw at three rows, their half-block sums, the position);
  bytes: sps complex samples read and one complex symbol written.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_S", "F32_OPS_S", "OPS_PER_EDGE", "bp_bound_s",
           "track_bound_s", "TRACK_DOTS", "TRACK_OPS_PER_SYMBOL"]

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
#   min-sum      |x|, sign, the row's sign product, the running minimum from
#                each end and their combination, two products (check); the
#                variable's sum and the exclusion (variable): 10
#   sum-product  |x|, sign, tanh, log, clamp, the row sum, the sign product,
#                the exclusion, tanh, log, two products (check); 2 (variable)
OPS_PER_EDGE = {"minsum": 10, "sumproduct": 14}
TRACK_DOTS = 12
TRACK_OPS_PER_SYMBOL = 18 + 6 + 4


def bp_bound_s(method: str, frames: int, passes: float, N: int,
               edges: int) -> float:
    """Least seconds of one decode of ``frames`` frames of a code with N
    variables and ``edges`` edges, the frames running ``passes`` passes in
    all."""
    by_bytes = frames * N * (4 + 1) / HBM_BYTES_S
    by_ops = OPS_PER_EDGE[method] * edges * passes / F32_OPS_S
    return max(by_bytes, by_ops)


def track_bound_s(nblocks: int, block_syms: int, ntaps: int,
                  sps: int) -> float:
    """Least seconds of the tracker's block loop over ``nblocks`` blocks of
    ``block_syms`` symbols, ``ntaps`` taps a polyphase row."""
    syms = nblocks * block_syms
    by_bytes = (syms * sps * 8 + syms * 8) / HBM_BYTES_S
    by_ops = (2 * syms * TRACK_DOTS * ntaps
              + syms * TRACK_OPS_PER_SYMBOL) / F32_OPS_S
    return max(by_bytes, by_ops)
