// The min-sum check step: one source for the shipped w-major min-sum
// kernels (bp_wmajor.cu: the tile min-sum bp_minsum_pairs and the
// large-code bp_kernel<WR, false, 16, 64>) and the min-sum kernel study
// (bp_study_ms.cu), so the study measures the check step that ships.
//
// Built with the port's flags (ops/_build.py: no fast math, --fmad=false).
// ops/_build.py hashes every header of csrc/ into each library's name, so a
// change here rebuilds both libraries.

#pragma once

#include <float.h>

namespace {   // internal linkage in each source, as they were there

// NaN-propagating min, as jnp.minimum / torch.minimum (fminf drops NaN)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// The messages of check m, the variables of its slots and the check's
// parity over the decisions vh, loaded apart from the arithmetic (the
// parity's loads beside the messages', where the min-sum step's latency
// hides them; unused, as in the fixed form, they are not issued). Pad
// slots: t = +1e30 (never the minimum of a real row), j = -1.
template <int WR>
struct CheckRow {
  float t[WR];
  int j[WR];
  int par;
};

// Min-sum check step on a loaded row: Lq -> Lr, each result k handed to
// out(k, Lr[k]) as it is formed.
//   Lr = sign * (prod_alpha * min over the other slots of |Lq|), where
//   prod_alpha is the row sign product, or 0 when the row holds a zero.
template <int WR, class Out>
__device__ __forceinline__ void minsum_row(const CheckRow<WR>& row,
                                           float norm_offset, float norm_scale,
                                           int use_offset, int use_scale,
                                           Out out) {
  float beta[WR], sg[WR], pre[WR];
  float P = 1.f;
#pragma unroll
  for (int k = 0; k < WR; ++k) {
    const float t = row.t[k];
    beta[k] = fabsf(t);
    sg[k] = t < 0.f ? -1.f : 1.f;
    P = P * sg[k];
  }
  // exclusive prefix/suffix minima (pallas_bp._excl_min_axis0)
  float acc = beta[0];
  pre[0] = FLT_MAX;
#pragma unroll
  for (int k = 1; k < WR; ++k) {
    pre[k] = acc;
    acc = nan_min(acc, beta[k]);
  }
  const float prod_alpha = acc == 0.f ? 0.f : P;   // acc: min over the row
  float suf = FLT_MAX;
#pragma unroll
  for (int k = WR - 1; k >= 0; --k) {
    float me = nan_min(pre[k], suf);
    suf = k == WR - 1 ? beta[k] : nan_min(suf, beta[k]);
    if (use_offset) {
      me = me - norm_offset;
      me = me < 0.f ? 0.f : me;
    }
    if (use_scale) me = me * norm_scale;
    out(k, sg[k] * (prod_alpha * me));
  }
}

}  // namespace
