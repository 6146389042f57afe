// The sum-product kernel study for Hopper (sm_90a): the check-step and
// aggregation variants of the TPU prototype study, as compile-time instances
// of one template, each an ablation of the shipped tile SPA
// (bp_wmajor.cu's bp_kernel<6, true, 32, 8>, fixed iterations).
//
// Replaces the Pallas kernels of:
//   tools/ablate_pallas.py:27  make_sp_kernel(opts)  -> study_cm*
//   tools/proto_r3b.py:85      kernel(variant)       -> study_phi, study_phi_x2,
//                                                       study_explog(_x2)
//   tools/proto_r3b.py:192     kernel_abl(variant)   -> study_phi, study_stub,
//                                                       study_phi_noagg, study_phi_bf16
//   tools/proto_r4b.py:34      kernel(variant)       -> study_phi, study_tanhprod
//   tools/fast_kernel_proto.py:77  _sp_fast_kernel   -> study_sp_split
//   tools/proto_r2.py:238      sumprod_kernel        -> study_phi_bf16all,
//                                                       study_psprod
//   tools/proto_r3.py:110      sumprod_kernel        -> study_phi_hilo
//   tools/proto_r3.py:225      sumprod_kernel_v2     -> study_phi_hilo2,
//                                                       study_psprod1p
//   tools/proto_r3c.py:30      kernel("sumprod", k)  -> study_phi_textbook(_u2, _u4)
//   tools/proto_r4.py:38       kernel("sumprod", ..) -> study_phi_hilo2(_u19),
//                                                       study_phi_bf16all(_u19)
// The variants, their instances and the plain PyTorch versions (same
// rounding order) are in ops/cuda_study.py.
//
// Why it exists. The shipped sum-product tile kernel (bp_wmajor.cu) is about
// 70% of the forward step, and ncu does not run where the card is. These
// instances take the kernel apart at compile time, so a stub removes the
// work it stands for and no runtime branch is left in the loop. The
// yardstick is the shipped kernel itself: study_phi is its fixed form, the
// same check step (log_tanh_half of sfu.cuh, the header both sources
// include), the same min.NaN clamp, launch bounds and rounding order, and
// decides every frame as it does. Every transcendental of every other
// instance but study_phi_libm is built on the same header's MUFU functions
// (ex2_sfu, rcp_sfu, lg2_sfu), so a variant's time is measured against the
// check step that ships, not against libm:
//   CHECK  kPhi         the shipped check step: two log_tanh_half an edge
//          kExplog      the same function as log1p(-e) - log1p(e), e = e^-x
//                       (log_tanh_half_explog: ex2, two lg2)
//          kTanhprodWm  tanh_half (ex2, rcp), prefix x suffix products, the
//                       clip, log_ratio (rcp, lg2) an edge (proto_r4b's
//                       tanhprod)
//          kTanhprodCm  the same on the check-major layout with ablate_pallas's
//                       L-form variable step and stubs (STUBS bits)
//          kStub        E = 0.9 M: no transcendental at all ("nocheck")
//          kPsprod      kTanhprodWm with the clip at +-(1 - 2^-23), so E stays
//                       finite (proto_r2's psprod)
//          kPsprod1p    the same clip, E = log1p_diff(T): two lg2, no divide
//                       (proto_r3's psprod1p)
//          kPhiLibm     kPhi with libm's logf(tanhf), the shipped check step
//                       before it moved onto the MUFU (study_phi_libm; the
//                       only instance that calls libm)
//   AGG    kF32         each message once, f32 sum: the f32 reading of the
//                       TPU's HIGHEST and HIGH products (and of its [hi; lo]
//                       split, which kHilo computes as the TPU did)
//          kBf16        operands rounded to bf16 first, f32 sum (the TPU's one
//                       bf16 MXU pass: precision DEFAULT, "nosplit"); the
//                       decision's sum in f32
//          kNone        no aggregation, with JAX's index arithmetic ("nomm":
//                       M = base + own E; "no_matmul": L[j] = E[j] + deg*r,
//                       slot e reads L[e mod N], so E must be 3N)
//          kSplit       total - own (_sp_fast_kernel): M0 = bf16(r); each step
//                       L = sum of bf16(E) + deg*r, M = bf16(L - r) - own E;
//                       the decision's sum of bf16(E)
//          kBf16All     kBf16 with the decision's sum of bf16(E) too
//          kHilo        hi = bf16(x), lo = bf16(x - hi), about 17 bits: the
//                       others' hi, then their lo; the decision's sum of
//                       bf16(E) (proto_r3's sumprod_kernel)
//          kHilo2       kHilo with the decision's sum in hilo too (v2)
//          kTextbook    proto_r3c's "sumprod": the loop's base is r, not
//                       (deg - 1) * r, so r enters once; bf16 operands, f32
//                       sums; decision r + sum of bf16(E) < 0 (strict)
//   FPT    1 or 2       frames a thread. The TPU's "skew" variants interleaved
//                       two independent half-tiles so the MXU and VPU could
//                       overlap; the Hopper analogue is two independent frames
//                       a thread (ILP against SFU and shared-memory latency),
//                       with the same per-frame arithmetic.
//   UNROLL 1, 2, 4, 19   the w-major step loop unrolled U times: blocks of U
//                       full steps with a compile-time trip count, then the
//                       rest one step at a time (19 steps: 9 x 2 + 1 at U = 2,
//                       4 x 4 + 3 at U = 4, 1 x 19 at U = 19), as JAX's
//                       fori_loop(unroll=U). The steps are a runtime argument;
//                       U changes the code, never the arithmetic.
//
// Work layout as the tile kernel: a block of 32 lanes x 8 rows keeps 32 * FPT
// frames; messages [slot][frame] in shared memory for all iterations; rx read
// once, coalesced; only the int8 decisions written back. Lane f handles frames
// f and f + 32, so both halves of a warp's accesses stay on 32 banks. The
// launch bounds are the tile kernel's (256 threads, no minimum of blocks),
// so ptxas holds each instance to its own register budget as it holds the
// tile SPA's. What bounds it is what the study measures: per edge and
// iteration the w-major SPA evaluates log tanh(x/2) twice, six MUFU, 256 B in
// and 64 B out per frame per decode (no HBM bound). Only row weight 6
// (block_32_64, the code the prototypes run) is instantiated; pad slots as
// in the tile kernel (never read in the w-major form; t = 1 in, E * 0 out in
// the check-major form).
//
// Rounding: no fast math, --fmad=false (the MUFU functions' contractions are
// explicit __fmaf_rn); the row phi sum is pallas_bp._tree's pairwise order; a
// variable's sums run from 0 in ascending slot order; the exclusive products
// run from each end of the row, as _excl_prefix_prod and _excl_suffix_prod. A
// product the TPU ran at precision DEFAULT rounds its f32 operand to bf16
// (__float2bfloat16_rn, nearest even) and sums in f32. Each MUFU function
// below has an IEEE-f32 mirror in ops/cuda_study.py (study_plain's phi
// "mirror"), is held to float64 within its stated bar by bp_study_probe on
// the card (chip_smoke.py's phi phase), and its mirror on the CPU
// (tests/test_torch_study_sfu.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sfu.cuh"   // the shipped check step and its MUFU functions

namespace {

constexpr int kWr = 6;
constexpr int kLanes = 32, kRows = 8, kThreads = kLanes * kRows;
constexpr int kWcMax = 4;
// proto_r2's 0.9999999 and proto_r3's 0.999999881 are this one f32
constexpr float kClip = 1.f - 1.f / (1 << 23);

enum Check { kPhi, kExplog, kTanhprodWm, kTanhprodCm, kStub, kPsprod,
             kPsprod1p, kPhiLibm };
enum Agg { kF32, kBf16, kNone, kSplit, kBf16All, kHilo, kHilo2,
           kTextbook };
enum Stub { kNoTanh = 1, kNoExcl = 2, kNoLog = 4 };

__device__ __forceinline__ float bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_lo(float x) {   // hilo's lo half
  return bf16(x - bf16(x));
}

// An operand of the loop's aggregation as the kernel reads it (hilo: its hi).
template <int AGG>
__device__ __forceinline__ float agg_round(float x) {
  if constexpr (AGG == kF32 || AGG == kNone)
    return x;
  else
    return bf16(x);
}

// An operand of the decision's sum (kHilo2: its hi).
template <int AGG>
__device__ __forceinline__ float final_round(float x) {
  if constexpr (AGG == kF32 || AGG == kNone || AGG == kBf16)
    return x;
  else
    return bf16(x);
}

// T[k] = (t0 * ... * t[k-1]) * (t[W-1] * ... * t[k+1]), each product running
// from its end of the row (a product with 1 first is exact).
__device__ __forceinline__ void excl_products(const float* t, float* T) {
  float pre[kWr];
  float acc = 1.f;
#pragma unroll
  for (int k = 0; k < kWr; ++k) {
    pre[k] = acc;
    acc = acc * t[k];
  }
  float suf = 1.f;
#pragma unroll
  for (int k = kWr - 1; k >= 0; --k) {
    T[k] = pre[k] * suf;
    suf = suf * t[k];
  }
}

// The MUFU functions of the study's check steps beyond log_tanh_half. Each
// states its bar against float64 on f32 inputs, |error| <= max(2^-16 |y|,
// 2^-20), relative where |y| >= 1/16 and absolute below: log_tanh_half's.

// log tanh(x/2) for x >= 0 as proto_r3b's explog writes it, log1p(-e) -
// log1p(e) with e = e^-x: e = 2^(-x log2 e) and each log a log2 times ln 2.
// Three MUFU (ex2, lg2, lg2). Below kPhiSmall 1 - e cancels, so log2(1 - e)
// takes x itself less the series' next term, x log2(e) / 2 (the dropped
// x^2/24 is under 2^-19 of the value there); above it ex2's error carried
// through 1 - e stays under 2^-18 of the value, as in log_tanh_half. Results
// above 0 are clamped to 0. log_tanh_half's special values: x = 0 gives
// -inf, x = +inf and x above 87 give 0, NaN stays NaN; a subnormal x acts
// as 0.
__device__ __forceinline__ float log_tanh_half_explog(float x) {
  const float e = ex2_sfu(x * -kLog2e);
  const bool small = x < kPhiSmall;
  const float a = lg2_sfu(small ? x : 1.f - e);
  const float lm = small ? __fmaf_rn(x, -0.5f * kLog2e, a) : a;
  return min_nan((lm - lg2_sfu(1.f + e)) * kLn2, 0.f);
}

// tanh(x/2) for any x: with e = 2^(-|x| log2 e) = e^-|x|, tanh(|x|/2) =
// (1 - e) * (1 / (1 + e)), and the sign of x copied on. Two MUFU (ex2, rcp).
// ex2's error carried through 1 - e is about 2^-22 absolute, so about 2^-19
// relative at |y| = 1/16 and less above. |x| above about 17.3 gives +-1
// (tanhf's f32 result from about 18), +-inf gives +-1, NaN stays NaN, a
// subnormal x gives +-0.
__device__ __forceinline__ float tanh_half(float x) {
  const float e = ex2_sfu(fabsf(x) * -kLog2e);
  return copysignf((1.f - e) * rcp_sfu(1.f + e), x);
}

// log((1 + T) / (1 - T)) for T in [-1, 1]: the divide as a reciprocal, the
// log a log2 times ln 2. Two MUFU (rcp, lg2); lg2's absolute error and
// rcp's one step carry to about 2^-21 absolute. T = 1 gives +inf, T = -1
// -inf, NaN stays NaN, a subnormal T 0.
__device__ __forceinline__ float log_ratio(float T) {
  return lg2_sfu((1.f + T) * rcp_sfu(1.f - T)) * kLn2;
}

// log1p(T) - log1p(-T), the same function without a divide (psprod1p's
// form): two MUFU (lg2, lg2), the same error and special values.
__device__ __forceinline__ float log1p_diff(float T) {
  return (lg2_sfu(1.f + T) - lg2_sfu(1.f - T)) * kLn2;
}

// libm's log tanh(x/2), study_phi_libm's: the shipped check step's function
// before it moved onto the MUFU (45 instructions, two of them MUFU).
__device__ __forceinline__ float log_tanh_half_libm(float x) {
  return logf(tanhf(x * 0.5f));
}

// The log tanh(x/2) of a phi-domain check step.
template <int CHECK>
struct PhiFn {
  __device__ __forceinline__ float operator()(float x) const {
    if constexpr (CHECK == kExplog)
      return log_tanh_half_explog(x);
    else if constexpr (CHECK == kPhiLibm)
      return log_tanh_half_libm(x);
    else
      return log_tanh_half(x);
  }
};

// W-major check step for check m of frames f + 32q, in place: M -> E.
template <int CHECK, int FPT>
__device__ __forceinline__ void check_wm(float* msg, const int* sv, int m,
                                         int M, int f) {
  constexpr int F = kLanes * FPT;
  bool real[kWr];
#pragma unroll
  for (int k = 0; k < kWr; ++k) real[k] = sv[k * M + m] >= 0;
  if constexpr (CHECK == kStub) {
#pragma unroll
    for (int k = 0; k < kWr; ++k)
#pragma unroll
      for (int q = 0; q < FPT; ++q)
        if (real[k]) {
          float* p = &msg[(k * M + m) * F + f + q * kLanes];
          *p = *p * 0.9f;
        }
  } else if constexpr (CHECK == kTanhprodWm || CHECK == kPsprod ||
                       CHECK == kPsprod1p) {
    // pads read as tanh(1e30 / 2) = 1
    float t[FPT][kWr], T[FPT][kWr];
#pragma unroll
    for (int k = 0; k < kWr; ++k)
#pragma unroll
      for (int q = 0; q < FPT; ++q)
        t[q][k] = real[k] ? tanh_half(msg[(k * M + m) * F + f + q * kLanes])
                          : 1.f;
#pragma unroll
    for (int q = 0; q < FPT; ++q) excl_products(t[q], T[q]);
#pragma unroll
    for (int k = 0; k < kWr; ++k)
#pragma unroll
      for (int q = 0; q < FPT; ++q)
        if (real[k]) {
          // tanhprod: jnp.clip(T, -1 + 1e-12, 1 - 1e-12), whose bounds round
          // to +-1 in f32, so |T| = 1 gives +-inf as in JAX; psprod: +-kClip,
          // E finite. NaN passes through either clip
          constexpr float c = CHECK == kTanhprodWm ? 1.f : kClip;
          float x = T[q][k];
          x = x < -c ? -c : (x > c ? c : x);
          msg[(k * M + m) * F + f + q * kLanes] =
              CHECK == kPsprod1p ? log1p_diff(x) : log_ratio(x);
        }
  } else {
    // phi domain: the shipped kernel's own check step (sfu.cuh), its
    // log tanh the variant's, once a frame
#pragma unroll
    for (int q = 0; q < FPT; ++q)
      check_sumproduct<kWr, F>(msg, sv, nullptr, m, M, f + q * kLanes, false,
                               PhiFn<CHECK>());
  }
}

// Check-major check step (ablate_pallas), in place: M -> E. Pads enter as
// t = 1 and leave as E * 0; they are computed only where no_matmul reads them.
template <int STUBS, int AGG>
__device__ __forceinline__ void check_cm(float* msg, const int* sv, int m,
                                         int f) {
  constexpr int F = kLanes;
  float t[kWr], T[kWr];
  bool real[kWr];
#pragma unroll
  for (int k = 0; k < kWr; ++k) {
    const int e = m * kWr + k;
    real[k] = sv[e] >= 0;
    t[k] = 1.f;
    if (real[k]) {
      const float x = msg[e * F + f];
      t[k] = (STUBS & kNoTanh) ? x * 0.4f : tanh_half(x);
    }
  }
  if constexpr ((STUBS & kNoExcl) != 0) {
#pragma unroll
    for (int k = 0; k < kWr; ++k) T[k] = t[k] * 0.9f;
  } else {
    excl_products(t, T);
  }
#pragma unroll
  for (int k = 0; k < kWr; ++k) {
    if (real[k] || AGG == kNone) {
      const float g = (STUBS & kNoLog) ? T[k] * 1.9f : log_ratio(T[k]);
      msg[(m * kWr + k) * F + f] = real[k] ? g : g * 0.f;   // * cmask
    }
  }
}

// W-major variable step for variable j: next messages base + aggregation,
// base = (deg - 1) * r (kTextbook: r). With kNone, base + the slot's own E;
// with kSplit, bf16(L - r) - own E.
template <int AGG, int FPT>
__device__ __forceinline__ void var_msgs(float* msg, const float* r,
                                         const int* vs, int j, int Wc, int f) {
  constexpr int F = kLanes * FPT;
  int s[kWcMax];
  int d = 0;
#pragma unroll
  for (int k = 0; k < kWcMax; ++k) {
    s[k] = k < Wc ? vs[j * Wc + k] : -1;
    d += s[k] >= 0;
  }
#pragma unroll
  for (int q = 0; q < FPT; ++q) {
    const int fq = f + q * kLanes;
    float e[kWcMax];
#pragma unroll
    for (int k = 0; k < kWcMax; ++k)
      e[k] = s[k] >= 0 ? msg[s[k] * F + fq] : 0.f;
    const float rj = r[j * (F + 1) + fq];
    if constexpr (AGG == kSplit) {
      // one sum a variable: L = AE + deg*r, M = bf16(L - r) - own E
      float AE = 0.f;
#pragma unroll
      for (int k = 0; k < kWcMax; ++k)
        if (s[k] >= 0) AE = AE + bf16(e[k]);
      const float lr = bf16((AE + (float)d * rj) - rj);
#pragma unroll
      for (int k = 0; k < kWcMax; ++k)
        if (s[k] >= 0) msg[s[k] * F + fq] = lr - e[k];
      continue;
    }
    const float base = AGG == kTextbook ? rj : (float)(d - 1) * rj;
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) {
      if (s[k] < 0) continue;
      if constexpr (AGG == kNone) {
        msg[s[k] * F + fq] = base + e[k];
      } else {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kWcMax; ++i)
          if (i != k && i < Wc) acc = acc + agg_round<AGG>(e[i]);
        if constexpr (AGG == kHilo || AGG == kHilo2) {
#pragma unroll
          for (int i = 0; i < kWcMax; ++i)
            if (i != k && i < Wc) acc = acc + bf16_lo(e[i]);
        }
        msg[s[k] * F + fq] = base + acc;
      }
    }
  }
}

// W-major decision: sum of the variable's E (rounded as AGG's final sum) +
// deg * r <= 0 (kTextbook: r + the sum < 0).
template <int AGG, int FPT>
__device__ __forceinline__ void var_decide(const float* msg, const float* r,
                                           const int* vs, int8_t* vh, int j,
                                           int Wc, int f) {
  constexpr int F = kLanes * FPT;
#pragma unroll
  for (int q = 0; q < FPT; ++q) {
    const int fq = f + q * kLanes;
    float tot = 0.f;
    int d = 0;
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) {
      const int s = k < Wc ? vs[j * Wc + k] : -1;
      if (s >= 0) {
        tot = tot + final_round<AGG>(msg[s * F + fq]);
        ++d;
      }
    }
    if constexpr (AGG == kHilo2) {
#pragma unroll
      for (int k = 0; k < kWcMax; ++k) {
        const int s = k < Wc ? vs[j * Wc + k] : -1;
        if (s >= 0) tot = tot + bf16_lo(msg[s * F + fq]);
      }
    }
    const float rj = r[j * (F + 1) + fq];
    vh[j * (F + 1) + fq] =
        AGG == kTextbook ? rj + tot < 0.f : tot + (float)d * rj <= 0.f;
  }
}

// Check-major L = aggregation(E) + deg * r (kNone: E of slot j itself).
template <int AGG>
__device__ __forceinline__ void cm_total(const float* msg, const float* r,
                                         float* L, const int* vs, int j,
                                         int Wc, int f) {
  constexpr int F = kLanes;
  float acc = 0.f;
  int d = 0;
#pragma unroll
  for (int k = 0; k < kWcMax; ++k) {
    const int s = k < Wc ? vs[j * Wc + k] : -1;
    if (s >= 0) {
      ++d;
      if constexpr (AGG != kNone) acc = acc + agg_round<AGG>(msg[s * F + f]);
    }
  }
  if constexpr (AGG == kNone) acc = msg[j * F + f];
  L[j * (F + 1) + f] = acc + (float)d * r[j * (F + 1) + f];
}

template <int CHECK, int AGG, int FPT, int STUBS, int UNROLL>
int smem_of(int M, int N, int Wc) {
  constexpr int F = kLanes * FPT;
  const int E = kWr * M;
  const int L = CHECK == kTanhprodCm ? N * (F + 1) : 0;
  return 4 * (E * F + N * (F + 1) + L + E + N * Wc) + N * (F + 1);
}

// One full w-major step: the check step, then every variable's next messages.
template <int CHECK, int AGG, int FPT>
__device__ __forceinline__ void wm_step(float* msg, const float* r,
                                        const int* sv, const int* vs, int M,
                                        int N, int Wc, int f, int y) {
  for (int m = y; m < M; m += kRows) check_wm<CHECK, FPT>(msg, sv, m, M, f);
  __syncthreads();
  for (int j = y; j < N; j += kRows) var_msgs<AGG, FPT>(msg, r, vs, j, Wc, f);
  __syncthreads();
}

template <int CHECK, int AGG, int FPT, int STUBS, int UNROLL>
__global__ void __launch_bounds__(kThreads)
study_kernel(const float* __restrict__ rx, int8_t* __restrict__ out, int B,
             const int* __restrict__ slot_var,
             const int* __restrict__ var_slots, int M, int N, int Wc,
             int steps) {
  constexpr bool kCm = CHECK == kTanhprodCm;
  static_assert(UNROLL >= 1 && (UNROLL == 1 || !kCm),
                "the unroll is a w-major form");
  constexpr int F = kLanes * FPT, RS = F + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = kWr * M;
  float* msg = reinterpret_cast<float*>(smem);
  float* r = msg + E * F;
  float* L = r + N * RS;                       // check-major form only
  int* sv = reinterpret_cast<int*>(L + (kCm ? N * RS : 0));
  int* vs = sv + E;
  int8_t* vh = reinterpret_cast<int8_t*>(vs + N * Wc);

  const int f = threadIdx.x, y = threadIdx.y;
  const int tid = y * kLanes + f;
  const long long f0 = (long long)blockIdx.x * F;

  for (int i = tid; i < E; i += kThreads) sv[i] = slot_var[i];
  for (int i = tid; i < N * Wc; i += kThreads) vs[i] = var_slots[i];
  for (int i = tid; i < F * N; i += kThreads) {   // coalesced rx rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    r[j * RS + ff] = g < B ? -rx[g * N + j] : 0.f;
  }
  __syncthreads();
  for (int e = y; e < E; e += kRows) {            // M = r[var], rE in CM
    const int j = sv[e];
#pragma unroll
    for (int q = 0; q < FPT; ++q) {
      const int fq = f + q * kLanes;
      if constexpr (kCm)
        msg[e * F + fq] = j >= 0 ? agg_round<AGG>(r[j * RS + fq]) : 0.f;
      else if (j >= 0)   // kSplit's first gather is a DEFAULT product
        msg[e * F + fq] = AGG == kSplit ? bf16(r[j * RS + fq]) : r[j * RS + fq];
    }
  }
  __syncthreads();

  if constexpr (kCm) {
    // each step: check, L = aggregation + deg*r, M = ((LE - E) - rE) * mask
    for (int it = 0; it < steps; ++it) {
      for (int m = y; m < M; m += kRows) check_cm<STUBS, AGG>(msg, sv, m, f);
      __syncthreads();
      for (int j = y; j < N; j += kRows) cm_total<AGG>(msg, r, L, vs, j, Wc, f);
      __syncthreads();
      if (it + 1 < steps) {                       // the last update is dead
        for (int e = y; e < E; e += kRows) {
          const int j = sv[e];
          if (j < 0) continue;
          // no_matmul: slot e reads L[e mod N] (E = 3N), by compares, not
          // by an integer division that the TPU's concatenation never paid
          const int em = e >= 2 * N ? e - 2 * N : (e >= N ? e - N : e);
          const float LE = AGG == kNone ? L[em * RS + f]
                                        : agg_round<AGG>(L[j * RS + f]);
          const float rE = agg_round<AGG>(r[j * RS + f]);
          msg[e * F + f] = (LE - msg[e * F + f]) - rE;
        }
        __syncthreads();
      }
    }
    for (int j = y; j < N; j += kRows)
      vh[j * RS + f] = (steps > 0 ? L[j * RS + f] : r[j * RS + f]) <= 0.f;
  } else {
    // steps-1 full steps, a trailing check step, the decision. UNROLL > 1:
    // the full steps in blocks of UNROLL with a compile-time trip count,
    // which nvcc unrolls, then the rest one at a time, as at UNROLL = 1
    const int full = steps - 1;
    int it = 0;
    if constexpr (UNROLL > 1) {
      for (; it + UNROLL <= full; it += UNROLL) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          wm_step<CHECK, AGG, FPT>(msg, r, sv, vs, M, N, Wc, f, y);
      }
    }
    for (; it < full; ++it)
      wm_step<CHECK, AGG, FPT>(msg, r, sv, vs, M, N, Wc, f, y);
    if (steps > 0) {
      for (int m = y; m < M; m += kRows) check_wm<CHECK, FPT>(msg, sv, m, M, f);
    } else {
      for (int e = y; e < E; e += kRows)
#pragma unroll
        for (int q = 0; q < FPT; ++q) msg[e * F + f + q * kLanes] = 0.f;
    }
    __syncthreads();
    for (int j = y; j < N; j += kRows)
      var_decide<AGG, FPT>(msg, r, vs, vh, j, Wc, f);
  }
  __syncthreads();
  for (int i = tid; i < F * N; i += kThreads) {   // coalesced out rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    if (g < B) out[g * N + j] = vh[j * RS + ff];
  }
}

template <int CHECK, int AGG, int FPT, int STUBS, int UNROLL>
cudaError_t launch(const float* rx, int8_t* out, int B, const int* slot_var,
                   const int* var_slots, int M, int N, int Wc, int steps,
                   cudaStream_t stream) {
  if (CHECK == kTanhprodCm && AGG == kNone && kWr * M != 3 * N)
    return cudaErrorInvalidValue;              // no_matmul: L tiled 3x
  constexpr int F = kLanes * FPT;
  const int smem = smem_of<CHECK, AGG, FPT, STUBS, UNROLL>(M, N, Wc);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        study_kernel<CHECK, AGG, FPT, STUBS, UNROLL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((B + F - 1) / F));
  const dim3 block(kLanes, kRows);
  study_kernel<CHECK, AGG, FPT, STUBS, UNROLL><<<grid, block, smem, stream>>>(
      rx, out, B, slot_var, var_slots, M, N, Wc, steps);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const float*, int8_t*, int, const int*,
                                 const int*, int, int, int, int, cudaStream_t);
using SmemFn = int (*)(int, int, int);
struct Instance {
  int check, agg, fpt, stubs, unroll;
  Launcher launch;
  SmemFn smem;
  const void* kernel;      // for the occupancy query
};

// The instantiated templates. ops/cuda_study.py names them and finds each by
// its five arguments (bp_study_find); the enums' numbering is its CHECKS,
// AGGS and STUB_BITS.
#define STUDY(...)                                                            \
  {__VA_ARGS__, launch<__VA_ARGS__>, smem_of<__VA_ARGS__>,                    \
   (const void*)study_kernel<__VA_ARGS__>}
const Instance kInstances[] = {
    STUDY(kPhi, kF32, 1, 0, 1),
    STUDY(kPhi, kF32, 2, 0, 1),
    STUDY(kExplog, kF32, 1, 0, 1),
    STUDY(kExplog, kF32, 2, 0, 1),
    STUDY(kStub, kF32, 1, 0, 1),
    STUDY(kPhi, kNone, 1, 0, 1),
    STUDY(kPhi, kBf16, 1, 0, 1),
    STUDY(kTanhprodWm, kF32, 1, 0, 1),
    STUDY(kTanhprodCm, kF32, 1, 0, 1),
    STUDY(kTanhprodCm, kF32, 1, kNoTanh, 1),
    STUDY(kTanhprodCm, kF32, 1, kNoLog, 1),
    STUDY(kTanhprodCm, kF32, 1, kNoTanh | kNoLog, 1),
    STUDY(kTanhprodCm, kF32, 1, kNoExcl, 1),
    STUDY(kTanhprodCm, kNone, 1, 0, 1),
    STUDY(kTanhprodCm, kBf16, 1, 0, 1),
    STUDY(kTanhprodCm, kNone, 1, kNoTanh | kNoExcl | kNoLog, 1),
    STUDY(kPhi, kSplit, 1, 0, 1),
    STUDY(kPhi, kBf16All, 1, 0, 1),
    STUDY(kPsprod, kBf16All, 1, 0, 1),
    STUDY(kPhi, kHilo, 1, 0, 1),
    STUDY(kPhi, kHilo2, 1, 0, 1),
    STUDY(kPsprod1p, kHilo2, 1, 0, 1),
    STUDY(kPhi, kTextbook, 1, 0, 1),
    STUDY(kPhi, kTextbook, 1, 0, 2),
    STUDY(kPhi, kTextbook, 1, 0, 4),
    STUDY(kPhi, kHilo2, 1, 0, 19),
    STUDY(kPhi, kBf16All, 1, 0, 19),
    STUDY(kPhiLibm, kF32, 1, 0, 1),
};
#undef STUDY
constexpr int kCount = sizeof(kInstances) / sizeof(kInstances[0]);

// The check steps' functions alone, elementwise, for holding each against
// float64 and for counting its instructions (its SASS between the load and
// the store). The numbering is ops/cuda_study.py's PROBES.
enum Probe { kProbePhi, kProbeExplog, kProbeTanhHalf, kProbeLogRatio,
             kProbeLog1pDiff, kProbeLibm };

template <int FN>
__global__ void probe_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  if constexpr (FN == kProbePhi)
    y[i] = log_tanh_half(v);
  else if constexpr (FN == kProbeExplog)
    y[i] = log_tanh_half_explog(v);
  else if constexpr (FN == kProbeTanhHalf)
    y[i] = tanh_half(v);
  else if constexpr (FN == kProbeLogRatio)
    y[i] = log_ratio(v);
  else if constexpr (FN == kProbeLog1pDiff)
    y[i] = log1p_diff(v);
  else
    y[i] = log_tanh_half_libm(v);
}
const void* const kProbes[] = {
    (const void*)probe_kernel<kProbePhi>,
    (const void*)probe_kernel<kProbeExplog>,
    (const void*)probe_kernel<kProbeTanhHalf>,
    (const void*)probe_kernel<kProbeLogRatio>,
    (const void*)probe_kernel<kProbeLog1pDiff>,
    (const void*)probe_kernel<kProbeLibm>};
constexpr int kProbeCount = sizeof(kProbes) / sizeof(kProbes[0]);

}  // namespace

extern "C" {

// Index of the instance study_kernel<check, agg, fpt, stubs, unroll>, or -1.
int bp_study_find(int check, int agg, int fpt, int stubs, int unroll) {
  for (int i = 0; i < kCount; ++i) {
    const Instance& s = kInstances[i];
    if (s.check == check && s.agg == agg && s.fpt == fpt && s.stubs == stubs &&
        s.unroll == unroll)
      return i;
  }
  return -1;
}

// Shared memory one block of this instance needs, in bytes (-1: no instance).
int bp_study_smem_bytes(int instance, int M, int N, int Wc) {
  return instance >= 0 && instance < kCount ? kInstances[instance].smem(M, N, Wc)
                                            : -1;
}

// Launch study instance `instance` (bp_study_find's index) on `stream`: rx
// (B, N) f32 and out (B, N) int8 row-major device buffers; slot_var (6M,) and
// var_slots (N, Wc) int32, the w-major tables of ops/layout.py, or the
// check-major ones for kTanhprodCm.
// `steps` check steps. Returns the launch's cudaError_t; does not synchronise.
int bp_study_decode(int instance, const float* rx, int8_t* out, int B,
                    const int* slot_var, const int* var_slots, int M, int N,
                    int Wc, int steps, void* stream) {
  if (instance < 0 || instance >= kCount || B <= 0 || steps < 0 || Wc < 1 ||
      Wc > kWcMax)
    return cudaErrorInvalidValue;
  return kInstances[instance].launch(rx, out, B, slot_var, var_slots, M, N, Wc,
                                     steps, static_cast<cudaStream_t>(stream));
}

// y (n,) = the check-step function `fn` (Probe) of x, for device buffers x
// and y on `stream`. Returns the launch's cudaError_t.
int bp_study_probe(int fn, const float* x, float* y, int n, void* stream) {
  if (n <= 0 || fn < 0 || fn >= kProbeCount) return cudaErrorInvalidValue;
  void* args[] = {&x, &y, &n};
  return cudaLaunchKernel(kProbes[fn], dim3((unsigned)((n + 255) / 256)),
                          dim3(256), args, 0,
                          static_cast<cudaStream_t>(stream));
}

// Blocks of study instance `instance` that fit one SM at `smem` bytes of
// dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// into *blocks. Returns the query's cudaError_t.
int bp_study_occupancy(int instance, int smem, int* blocks) {
  if (instance < 0 || instance >= kCount) return cudaErrorInvalidValue;
  const void* fn = kInstances[instance].kernel;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                        smem);
  // a query's error must not surface as the next launch's cudaGetLastError
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

const char* bp_study_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
