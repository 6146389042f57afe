// The sum-product kernels' check step and the special-function unit (MUFU)
// functions it runs on: one source for the shipped w-major SPA
// (bp_wmajor.cu) and the kernel study (bp_study.cu), so the study measures
// the check step that ships.
//
// Built with the port's flags (ops/_build.py: no fast math, --fmad=false),
// so every contraction here is an explicit __fmaf_rn. ops/_build.py hashes
// every header of csrc/ into each library's name, so a change here rebuilds
// both libraries.

#pragma once

#include <stdint.h>

namespace {   // internal linkage in each source, as they were there

// The MUFU, one instruction each: 2^a, 1/a, log2 a, about 22 bits. ftz: a
// subnormal operand or result is 0.
__device__ __forceinline__ float ex2_sfu(float a) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(a));
  return y;
}
__device__ __forceinline__ float rcp_sfu(float a) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(a));
  return y;
}
__device__ __forceinline__ float lg2_sfu(float a) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(a));
  return y;
}
// nan_min as one min.NaN instruction, for log_tanh_half (the min-sum keeps
// nan_min's compare-and-select, and its SASS)
__device__ __forceinline__ float min_nan(float a, float b) {
  float y;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kPhiSmall = 0.0125f;     // below it, log tanh(x/2) ~ log(x/2)

// log tanh(x/2) for x >= 0 on the SFU: with e = 2^(-x log2 e) = e^-x,
// tanh(x/2) = (1 - e) / (1 + e), so log tanh(x/2) = ln2 (log2(2 tanh) - 1).
// Three MUFU (ex2, rcp, lg2) and about eight FMA/ALU instructions, where
// logf(tanhf(.)) is 45 with two MUFU. The reciprocal is a MUFU rather than
// a polynomial for log2(1 + e) on the FMA pipe: with the rest of the check
// step, issue already about meets the three MUFU's time
// (tools/issue_model.py), so more FMA work would cost and one MUFU less
// would not pay. Below kPhiSmall 1 - e cancels, and log2 takes x itself:
// log tanh(x/2) = log(x/2) - x^2/12 + ..., the dropped term under 2^-18 of
// the value there, as is ex2's error carried through 1 - e above it.
// Results above 0 (lg2's absolute error where 2 tanh is near 2) are clamped
// to 0, as logf(tanhf) never exceeds it.
// x = 0 gives -inf, x = +inf (and x above 87, where e flushes to 0) gives 0,
// NaN stays NaN; a subnormal x acts as 0.
__device__ __forceinline__ float log_tanh_half(float x) {
  const float e = ex2_sfu(x * -kLog2e);
  const float tanh2 = __fmaf_rn(-2.f, e, 2.f) * rcp_sfu(1.f + e);
  const float l = lg2_sfu(x < kPhiSmall ? x : tanh2);
  return min_nan(__fmaf_rn(l, kLn2, -kLn2), 0.f);
}

constexpr float kPhiClamp = 1e4f;        // pallas_bp._PHI_CLAMP

struct LogTanhHalf {
  __device__ __forceinline__ float operator()(float x) const {
    return log_tanh_half(x);
  }
};

// pallas_bp._tree: pairwise reduction with an odd element carried over.
template <int W>
struct Tree {
  template <class Op>
  static __device__ __forceinline__ void reduce(float* y, Op op) {
    if constexpr (W > 1) {
      constexpr int h = W / 2;
#pragma unroll
      for (int i = 0; i < h; ++i) y[i] = op(y[i], y[i + h]);
      if constexpr (W % 2) y[h] = y[2 * h];
      Tree<h + W % 2>::reduce(y, op);
    }
  }
};

struct Add { __device__ float operator()(float a, float b) const { return a + b; } };

// Sum-product check step for check m of frame f, in place: M -> E.
//   w = max(log tanh(|t|/2), -1e4), U = tree sum of w over the row,
//   E = (-(row sign product) * own sign) * log tanh((w - U)/2),
// each log tanh by log_tanh_half (the study's phi-domain variants give
// another ``phi``). Every w <= 0, so w - U >= 0; where the other slots all
// have w = 0 it is 0, and E is +-inf. sv is the slot table, a pointer or
// anything indexed like one.
// Pad slots act as t = +1e30: w = 0, sign +1, so they are skipped.
// With syn, returns the parity of check m over the decisions vh (the
// syndrome bit of the previous variable step), else 0.
template <int WR, int F, class SV, class Phi = LogTanhHalf>
__device__ __forceinline__ int check_sumproduct(float* msg, SV sv,
                                                const int8_t* vh, int m,
                                                int M, int f, bool syn,
                                                Phi phi = Phi()) {
  float w[WR], u[WR], sg[WR];
  float P = 1.f;
  int par = 0;
#pragma unroll
  for (int k = 0; k < WR; ++k) {
    const int e = k * M + m;
    const int j = sv[e];
    w[k] = 0.f;
    sg[k] = 1.f;
    if (j >= 0) {
      if (syn) par ^= vh[j * (F + 1) + f];
      const float t = msg[e * F + f];
      sg[k] = t < 0.f ? -1.f : 1.f;
      const float x = phi(fabsf(t));
      w[k] = x < -kPhiClamp ? -kPhiClamp : x;   // keeps NaN, as jnp.maximum
    }
    u[k] = w[k];
    P = P * sg[k];
  }
  Tree<WR>::reduce(u, Add());
  const float U = u[0];
  const float negP = -P;
#pragma unroll
  for (int k = 0; k < WR; ++k) {
    const int e = k * M + m;
    if (sv[e] >= 0) {
      const float v = w[k] - U;
      msg[e * F + f] = (negP * sg[k]) * phi(v);
    }
  }
  return par;
}

}  // namespace
