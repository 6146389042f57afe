// The min-sum kernel study for Hopper (sm_90a): the check-step and
// aggregation variants of the TPU prototype study, as compile-time instances
// on the skeleton of the shipped tile min-sum (bp_wmajor.cu's
// bp_minsum_pairs, fixed form) and its check step (csrc/minsum.cuh).
//
// Replaces the Pallas kernels of:
//   tools/fast_kernel_proto.py:120  _ms_fast_kernel          -> study_ms_argmin
//   tools/proto_r2.py:80            minsum_kernel(variant)   -> study_ms_current,
//       study_ms_stub_check, study_ms_stub_mm, study_ms_bits, study_ms_bf16,
//       study_ms_int8 (also "int8s", the same code), study_ms_split
//   tools/proto_r3.py:78            minsum_kernel(variant)   -> study_ms_hilo
//   tools/proto_r3c.py:30           kernel("minsum", k)      -> study_ms_current,
//       study_ms_current_u2, study_ms_current_u4
//   tools/proto_r4.py:38            kernel("minsum", ...)    -> study_ms_hilo2,
//       study_ms_hilo2_u19 (precise), study_ms_current(_u19) (fast)
// and study_ms_ref, the shipped tile min-sum's fixed form, as the yardstick.
// Names, specs and the plain PyTorch versions (same rounding order) are in
// ops/cuda_study_ms.py.
//
// What each TPU variant computed, not how: a one-hot product at precision
// DEFAULT rounds its f32 operand to bf16 (one MXU pass) and sums in f32; at
// HIGHEST it is the f32 value. Here every product is a 1-3 term sum read
// through index tables, with the operand rounded where the TPU rounded it:
//   CHECK  kExcl     exclusive prefix/suffix minima: the shipped minsum_row
//                    (csrc/minsum.cuh), normalisation off
//          kArgmin   min1, first argmin, min2 (fast_kernel_proto)
//          kHalf     Lr = 0.5 Lq, no check step ("stub_check")
//          kBits     sign and magnitude as int32 bit patterns: XOR parity of
//                    the sign bits, integer minima of |x| ("bits")
//   VAR    kGram     Lq = Lci + (sum of the other edges' Lr)
//          kOwn      Lq = Lci + the slot's own Lr, no aggregation ("stub_mm")
//          kSplit    A = Lci + (sum of all edges' Lr), Lq = A - own Lr; the
//                    first gather exact (proto_r2 "split")
//          kSplitAll the same, the first gather rounded too (fast_kernel_proto)
//          kInt8     Lq = Lci + int32(sum of the others' q) * dq, q = int8 of
//                    Lr * 127/24 clipped to +-127, truncated ("int8")
//          kGram16   messages held in bf16; Lq = bf16(bf16(Lci) + bf16(sum))
//   RND    kF32      operands as they are (the yardstick)
//          kBf16     each aggregation operand rounded to bf16 (DEFAULT)
//          kHilo     hi = bf16(x), lo = bf16(x - hi): about 17 bits; the sum
//                    takes the others' hi first, then their lo (proto_r3's
//                    "stacked" order); the final sum is one bf16 pass
//          kHilo2    kHilo with the decision's sum in hi/lo too: all edges'
//                    hi, then their lo (proto_r4's precise min-sum)
//   UNROLL 1, 2, 4 or 19: the loop of full steps unrolled U times, in blocks
//                    of U steps with a compile-time trip count, then the rest
//                    one step at a time (19 full steps before the trailing
//                    check step: 9 x 2 + 1 at U = 2, 4 x 4 + 3 at U = 4,
//                    1 x 19 at U = 19), as JAX's fori_loop(unroll=U); the
//                    steps stay a runtime argument and U changes no
//                    arithmetic
// Every instance decides LQ = Lci + (sum of all edges' Lr, rounded as RND;
// hilo: bf16) < 0 after `steps` check steps.
//
// Work layout: bp_minsum_pairs' fixed form. A block of 16 lanes x 16 rows
// keeps 32 frames, two a thread (f2 = 2 * lane and f2 + 1); messages
// [slot][frame] in shared memory for all iterations, each thread's two
// moved as one pair: a float2, an __nv_bfloat162 for kGram16, two int8 for
// kInt8's q. So a warp (two rows) reads one table entry and one address
// for two frames, and its two rows' bf16 or int8 pairs of neighbouring
// checks (128 or 64 bytes) share one shared-memory wavefront where the
// float2 pairs take two. kInt8 keeps q as int8 [slot][frame] in shared
// memory: its check step writes q, one byte a message, and its variable
// step reads q. rx read once, coalesced; only the int8 decisions written
// back. The loop is the shipped fixed form: steps - 1 full steps, a
// trailing check step, then the decision; no early exit. As there, a frame
// that does not decode (past B) keeps its values: each store selects
// between the new and the loaded value (live), and the decision is written
// only for a live frame; frames past B are not written out. Those selects
// are part of the yardstick's time: without them study_ms_ref and the
// shipped kernel each take about 16% less (tools/tile_probe.py "no
// live"), and study_ms_ref no longer times as the kernel that ships. The
// normalisation's parameters are kernel arguments, as the shipped kernel
// takes them (off here), so that kExcl's check step compiles as the
// shipped one does. What bounds
// the min-sum is what the study measures: the check step is compares and
// selects, the variable step 1-3 adds; 256 B in and 64 B out per frame per
// decode (no HBM bound). Only row weight 6 (block_32_64) is instantiated.
// Pad slots are never read; a check step takes them as +1e30 (bf16(1e30)
// in kGram16): what JAX's pad constant gives them, exactly, while |Lr| <
// 3.8e22 (half an ulp of 1e30).
//
// Rounding: no fast math, --fmad=false; a variable's sums run from 0 in
// ascending slot order; a bf16 add is the f32 add rounded to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "minsum.cuh"   // the shipped check step, minsum_row

namespace {

constexpr int kWr = 6;
constexpr int kFrames = 32;                          // frames a block
constexpr int kLanes = 16, kRows = 16, kThreads = kLanes * kRows;
constexpr int kWcMax = 4;
constexpr float kPadBig = 1e30f;                      // pallas_bp._BIG
constexpr float kQs = (float)(127.0 / 24.0);          // proto_r2 int8 grid
constexpr float kDq = (float)(24.0 / 127.0);
constexpr int kSignBit = -2147483647 - 1;           // 0x80000000
constexpr int kMagMask = 0x7FFFFFFF;
constexpr int kFillBits = 0x7F7FFFFF;                 // FLT_MAX's bits

enum Check { kExcl, kArgmin, kHalf, kBits };
enum Var { kGram, kOwn, kSplit, kSplitAll, kInt8, kGram16 };
enum Rnd { kF32, kBf16, kHilo, kHilo2 };

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// an aggregation operand as the TPU's product read it (hilo: its hi half)
template <int RND>
__device__ __forceinline__ float agg_round(float x) {
  if constexpr (RND == kF32)
    return x;
  else
    return bf16r(x);
}

template <int VAR>
using Msg = std::conditional_t<VAR == kGram16, __nv_bfloat16, float>;

// a thread's two messages of one slot, frames f2 and f2 + 1, as one pair
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ signed char quantize(float x) {
  float y = x * kQs;
  y = y < -127.f ? -127.f : (y > 127.f ? 127.f : y);   // jnp.clip
  return (signed char)__float2int_rz(y);                 // astype(int8)
}

// The check step's arithmetic on one frame's row t (pads at the pad
// value) -> Lr, for the CHECKs other than kExcl (which is minsum_row).
template <int CHECK>
__device__ __forceinline__ void check_row(const float (&t)[kWr],
                                          float (&lr)[kWr]) {
  if constexpr (CHECK == kHalf) {
#pragma unroll
    for (int k = 0; k < kWr; ++k) lr[k] = t[k] * 0.5f;
  } else if constexpr (CHECK == kBits) {
    int tb[kWr], mag[kWr], pre[kWr];
    int par = 0;
#pragma unroll
    for (int k = 0; k < kWr; ++k) {
      tb[k] = __float_as_int(t[k]);
      mag[k] = tb[k] & kMagMask;
      par ^= tb[k];
    }
    par &= kSignBit;
    int acc = mag[0];
    pre[0] = kFillBits;
#pragma unroll
    for (int k = 1; k < kWr; ++k) {
      pre[k] = acc;
      acc = min(acc, mag[k]);
    }
    const int min1 = acc;
    int suf = kFillBits;
#pragma unroll
    for (int k = kWr - 1; k >= 0; --k) {
      const int me = min(pre[k], suf);
      suf = k == kWr - 1 ? mag[k] : min(suf, mag[k]);
      const int b = ((tb[k] ^ par) & kSignBit) | me;
      lr[k] = __int_as_float(min1 == 0 ? 0 : b);   // a zero zeroes the row
    }
  } else {                                          // kArgmin
    float beta[kWr], sg[kWr];
    float P = 1.f;
#pragma unroll
    for (int k = 0; k < kWr; ++k) {
      beta[k] = fabsf(t[k]);
      sg[k] = t[k] < 0.f ? -1.f : 1.f;
      P = P * sg[k];
    }
    float min1 = beta[0];
#pragma unroll
    for (int k = 1; k < kWr; ++k) min1 = nan_min(min1, beta[k]);
    int amin = kWr;                                  // first occurrence
#pragma unroll
    for (int k = kWr - 1; k >= 0; --k)
      if (beta[k] == min1) amin = k;
    float min2 = FLT_MAX;
#pragma unroll
    for (int k = 0; k < kWr; ++k)
      if (k != amin) min2 = nan_min(min2, beta[k]);
    const float pa = min1 == 0.f ? 0.f : P;
#pragma unroll
    for (int k = 0; k < kWr; ++k)
      lr[k] = sg[k] * (pa * (k == amin ? min2 : min1));
  }
}

// The normalisation of minsum_row, as the shipped kernel takes it
struct Norm {
  float offset, scale;
  int use_offset, use_scale;
};

// Check step for check m of the thread's two frames, as bp_minsum_pairs'
// check: Lq -> Lr on the real slots, written back as one pair (Q: as q,
// kInt8 before its last step). A frame that does not decode (live false:
// past B) keeps its values, its half of each pair written back unchanged.
// kExcl is the shipped kernel's arithmetic, minsum_row on each frame.
template <int CHECK, bool Q, class T>
__device__ __forceinline__ void check_step(T* msg, int8_t* qb, const int* sv,
                                           const bool (&live)[2], int m,
                                           int M, int f2, float pad,
                                           const Norm& norm) {
  constexpr int F = kFrames;
  CheckRow<kWr> a, b;
  a.par = b.par = 0;
#pragma unroll
  for (int k = 0; k < kWr; ++k) {
    const bool real = sv[k * M + m] >= 0;
    a.j[k] = b.j[k] = real ? 0 : -1;
    const float2 t =
        real ? ld2(&msg[(k * M + m) * F + f2]) : make_float2(pad, pad);
    a.t[k] = t.x;
    b.t[k] = t.y;
  }
  float va[kWr], vb[kWr];
  if constexpr (CHECK == kExcl) {
    minsum_row<kWr>(a, norm.offset, norm.scale, norm.use_offset,
                    norm.use_scale, [&](int k, float v) { va[k] = v; });
    minsum_row<kWr>(b, norm.offset, norm.scale, norm.use_offset,
                    norm.use_scale, [&](int k, float v) { vb[k] = v; });
  } else {
    check_row<CHECK>(a.t, va);
    check_row<CHECK>(b.t, vb);
  }
#pragma unroll
  for (int k = 0; k < kWr; ++k) {
    if (a.j[k] < 0) continue;
    const int e = k * M + m;
    const float x = live[0] ? va[k] : a.t[k], y = live[1] ? vb[k] : b.t[k];
    if constexpr (Q)
      *reinterpret_cast<char2*>(&qb[e * F + f2]) =
          make_char2(quantize(x), quantize(y));
    else
      st2(&msg[e * F + f2], x, y);
  }
}

// A variable's next Lq from Lci and the sum of its other edges
template <int VAR>
__device__ __forceinline__ float next_lq(float lci, float acc) {
  return VAR == kGram16 ? bf16r(lci) + bf16r(acc) : lci + acc;
}

// Variable step for variable j of the thread's two frames, as
// bp_minsum_pairs' var: the check messages of its slots (q for kInt8) ->
// the next Lq on those slots, both frames at once. A frame that does not
// decode keeps its messages (kInt8, which reads q and not the messages,
// writes it Lci).
template <int VAR, int RND, class T>
__device__ __forceinline__ void var_step(T* msg, const int8_t* qb,
                                         const float* r, const int* vs,
                                         const bool (&live)[2], int j, int Wc,
                                         int f2) {
  constexpr int F = kFrames, RS = F + 1;
  int s[kWcMax];
  if constexpr (VAR == kInt8) {
    int qa[kWcMax], qc[kWcMax];
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) {
      s[k] = k < Wc ? vs[j * Wc + k] : -1;
      const char2 q = s[k] >= 0
                          ? *reinterpret_cast<const char2*>(&qb[s[k] * F + f2])
                          : make_char2(0, 0);
      qa[k] = q.x;
      qc[k] = q.y;
    }
    const float ra = r[j * RS + f2], rb = r[j * RS + f2 + 1];
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) {
      if (s[k] < 0) continue;
      int aa = 0, ab = 0;                              // exact
#pragma unroll
      for (int i = 0; i < kWcMax; ++i)
        if (i != k && i < Wc) {
          aa += qa[i];
          ab += qc[i];
        }
      st2(&msg[s[k] * F + f2], live[0] ? ra + (float)aa * kDq : ra,
          live[1] ? rb + (float)ab * kDq : rb);
    }
  } else {
    float ea[kWcMax], eb[kWcMax];
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) {
      s[k] = k < Wc ? vs[j * Wc + k] : -1;
      const float2 e =
          s[k] >= 0 ? ld2(&msg[s[k] * F + f2]) : make_float2(0.f, 0.f);
      ea[k] = e.x;
      eb[k] = e.y;
    }
    const float ra = r[j * RS + f2], rb = r[j * RS + f2 + 1];
    if constexpr (VAR == kSplit || VAR == kSplitAll) {
      float ta = 0.f, tb = 0.f;
#pragma unroll
      for (int k = 0; k < kWcMax; ++k)
        if (k < Wc) {
          ta = ta + agg_round<RND>(ea[k]);
          tb = tb + agg_round<RND>(eb[k]);
        }
      const float A = agg_round<RND>(ra + ta), Ab = agg_round<RND>(rb + tb);
#pragma unroll
      for (int k = 0; k < kWcMax; ++k)
        if (s[k] >= 0)
          st2(&msg[s[k] * F + f2], live[0] ? A - ea[k] : ea[k],
              live[1] ? Ab - eb[k] : eb[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kWcMax; ++k) {
        if (s[k] < 0) continue;
        float aa = 0.f, ab = 0.f;
        if constexpr (VAR == kOwn) {
          aa = ea[k];
          ab = eb[k];
        } else {
#pragma unroll
          for (int i = 0; i < kWcMax; ++i)
            if (i != k && i < Wc) {
              aa = aa + agg_round<RND>(ea[i]);
              ab = ab + agg_round<RND>(eb[i]);
            }
          if constexpr (RND == kHilo || RND == kHilo2) {
#pragma unroll
            for (int i = 0; i < kWcMax; ++i)
              if (i != k && i < Wc) {
                aa = aa + bf16r(ea[i] - bf16r(ea[i]));
                ab = ab + bf16r(eb[i] - bf16r(eb[i]));
              }
          }
        }
        st2(&msg[s[k] * F + f2], live[0] ? next_lq<VAR>(ra, aa) : ea[k],
            live[1] ? next_lq<VAR>(rb, ab) : eb[k]);
      }
    }
  }
}

// Decision of variable j of the thread's two frames, as bp_minsum_pairs'
// var with the decision alone: Lci + (sum of its edges' Lr) < 0; kHilo2:
// every edge's hi, then every edge's lo. A frame that does not decode
// keeps its decision.
template <int RND, class T>
__device__ __forceinline__ void var_decide(const T* msg, const float* r,
                                           const int* vs, int8_t* vh,
                                           const bool (&live)[2], int j,
                                           int Wc, int f2) {
  constexpr int F = kFrames, RS = F + 1;
  float ea[kWcMax], eb[kWcMax];
#pragma unroll
  for (int k = 0; k < kWcMax; ++k) {
    const int s = k < Wc ? vs[j * Wc + k] : -1;
    const float2 e = s >= 0 ? ld2(&msg[s * F + f2]) : make_float2(0.f, 0.f);
    ea[k] = e.x;
    eb[k] = e.y;
  }
  const float ra = r[j * RS + f2], rb = r[j * RS + f2 + 1];
  float ta = 0.f, tb = 0.f;
#pragma unroll
  for (int k = 0; k < kWcMax; ++k)
    if (k < Wc) {
      ta = ta + agg_round<RND>(ea[k]);
      tb = tb + agg_round<RND>(eb[k]);
    }
  if constexpr (RND == kHilo2) {
#pragma unroll
    for (int k = 0; k < kWcMax; ++k)
      if (k < Wc) {
        ta = ta + bf16r(ea[k] - bf16r(ea[k]));
        tb = tb + bf16r(eb[k] - bf16r(eb[k]));
      }
  }
  if (live[0]) vh[j * RS + f2] = ra + ta < 0.f;
  if (live[1]) vh[j * RS + f2 + 1] = rb + tb < 0.f;
}

template <int CHECK, int VAR, int RND, int UNROLL>
int smem_of(int M, int N, int Wc) {
  constexpr int F = kFrames;
  const int E = kWr * M;
  return (int)sizeof(Msg<VAR>) * E * F + 4 * (N * (F + 1) + E + N * Wc) +
         N * (F + 1) + (VAR == kInt8 ? E * F : 0);
}

template <int CHECK, int VAR, int RND, int UNROLL>
__global__ void __launch_bounds__(kThreads)
study_ms_kernel(const float* __restrict__ rx, int8_t* __restrict__ out, int B,
                const int* __restrict__ slot_var,
                const int* __restrict__ var_slots, int M, int N, int Wc,
                int steps, float norm_offset, float norm_scale,
                int use_offset, int use_scale) {
  using T = Msg<VAR>;
  constexpr int F = kFrames, RS = F + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = kWr * M;
  T* msg = reinterpret_cast<T*>(smem);
  float* r = reinterpret_cast<float*>(smem + sizeof(T) * E * F);
  int* sv = reinterpret_cast<int*>(r + N * RS);
  int* vs = sv + E;
  int8_t* vh = reinterpret_cast<int8_t*>(vs + N * Wc);
  int8_t* qb = vh + N * RS;                     // kInt8 only: E x F int8

  const int x = threadIdx.x, y = threadIdx.y, tid = y * kLanes + x;
  const int f2 = 2 * x;                         // this thread's frames f2, f2 + 1
  const long long f0 = (long long)blockIdx.x * F;
  const Norm norm{norm_offset, norm_scale, use_offset, use_scale};
  // live[h]: frame f2 + h decodes; a frame past B keeps its values
  const bool live[2] = {f0 + f2 < B, f0 + f2 + 1 < B};

  for (int i = tid; i < E; i += kThreads) sv[i] = slot_var[i];
  for (int i = tid; i < N * Wc; i += kThreads) vs[i] = var_slots[i];
  for (int i = tid; i < F * N; i += kThreads) {   // coalesced rx rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    r[j * RS + ff] = g < B ? -rx[g * N + j] : 0.f;  // Lci
  }
  __syncthreads();
  for (int e = y; e < E; e += kRows) {            // Lq0 = Lci[var]
    const int j = sv[e];
    if (j >= 0) {
      const float a = r[j * RS + f2], b = r[j * RS + f2 + 1];
      if constexpr (VAR == kSplitAll)
        st2(&msg[e * F + f2], agg_round<RND>(a), agg_round<RND>(b));
      else
        st2(&msg[e * F + f2], a, b);
    }
  }
  __syncthreads();

  const float pad = VAR == kGram16 ? bf16r(kPadBig) : kPadBig;
  // Q: the check step writes q (kInt8 before its last step)
  auto checks = [&](auto q) {
    for (int m = y; m < M; m += kRows)
      check_step<CHECK, decltype(q)::value>(msg, qb, sv, live, m, M, f2, pad,
                                            norm);
  };
  auto step = [&]() {                             // one full step
    checks(std::bool_constant<VAR == kInt8>{});
    __syncthreads();
    for (int j = y; j < N; j += kRows)
      var_step<VAR, RND>(msg, qb, r, vs, live, j, Wc, f2);
    __syncthreads();
  };

  static_assert(UNROLL >= 1, "UNROLL counts steps");
  // steps - 1 full steps, then a trailing check step and the decision. UNROLL
  // > 1: blocks of UNROLL full steps with a compile-time trip count, which
  // nvcc unrolls, then the rest one step at a time, as at UNROLL = 1
  int it = 0;
  if constexpr (UNROLL > 1) {
    for (; it + UNROLL < steps; it += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) step();
    }
  }
  for (; it + 1 < steps; ++it) step();
  if (steps > 0) {
    checks(std::false_type{});
  } else {                                        // Lr = 0: decide on Lci
    for (int e = y; e < E; e += kRows) st2(&msg[e * F + f2], 0.f, 0.f);
  }
  __syncthreads();
  constexpr int kFinal = RND == kHilo ? kBf16 : RND;   // hilo: one bf16 pass
  for (int j = y; j < N; j += kRows)
    var_decide<kFinal>(msg, r, vs, vh, live, j, Wc, f2);
  __syncthreads();
  for (int i = tid; i < F * N; i += kThreads) {   // coalesced out rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    if (g < B) out[g * N + j] = vh[j * RS + ff];
  }
}

template <int CHECK, int VAR, int RND, int UNROLL>
cudaError_t launch(const float* rx, int8_t* out, int B, const int* slot_var,
                   const int* var_slots, int M, int N, int Wc, int steps,
                   cudaStream_t stream) {
  // kInt8's q pairs need q's buffer at an even offset: an even N
  if (VAR == kInt8 && N % 2) return cudaErrorInvalidValue;
  const int smem = smem_of<CHECK, VAR, RND, UNROLL>(M, N, Wc);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        study_ms_kernel<CHECK, VAR, RND, UNROLL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((B + kFrames - 1) / kFrames));
  const dim3 block(kLanes, kRows);
  study_ms_kernel<CHECK, VAR, RND, UNROLL><<<grid, block, smem, stream>>>(
      rx, out, B, slot_var, var_slots, M, N, Wc, steps, 0.f, 1.f, 0, 0);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const float*, int8_t*, int, const int*,
                                 const int*, int, int, int, int, cudaStream_t);
using SmemFn = int (*)(int, int, int);
struct Instance {
  int check, var, rnd, unroll;
  Launcher launch;
  SmemFn smem;
  const void* kernel;      // for the occupancy query
};

// The instantiated templates. ops/cuda_study_ms.py names them and finds each
// by its four arguments (bp_study_ms_find); the enums' numbering is its
// CHECKS, VARS and RNDS.
#define STUDY(...)                                                            \
  {__VA_ARGS__, launch<__VA_ARGS__>, smem_of<__VA_ARGS__>,                    \
   (const void*)study_ms_kernel<__VA_ARGS__>}
const Instance kInstances[] = {
    STUDY(kExcl, kGram, kF32, 1),          // study_ms_ref
    STUDY(kArgmin, kSplitAll, kBf16, 1),   // study_ms_argmin
    STUDY(kExcl, kGram, kBf16, 1),         // study_ms_current
    STUDY(kHalf, kGram, kBf16, 1),         // study_ms_stub_check
    STUDY(kExcl, kOwn, kBf16, 1),          // study_ms_stub_mm
    STUDY(kBits, kGram, kBf16, 1),         // study_ms_bits
    STUDY(kExcl, kGram16, kBf16, 1),       // study_ms_bf16
    STUDY(kExcl, kInt8, kBf16, 1),         // study_ms_int8
    STUDY(kExcl, kSplit, kBf16, 1),        // study_ms_split
    STUDY(kExcl, kGram, kHilo, 1),         // study_ms_hilo
    STUDY(kExcl, kGram, kBf16, 2),         // study_ms_current_u2
    STUDY(kExcl, kGram, kBf16, 4),         // study_ms_current_u4
    STUDY(kExcl, kGram, kBf16, 19),        // study_ms_current_u19
    STUDY(kExcl, kGram, kHilo2, 1),        // study_ms_hilo2
    STUDY(kExcl, kGram, kHilo2, 19),       // study_ms_hilo2_u19
};
#undef STUDY
constexpr int kCount = sizeof(kInstances) / sizeof(kInstances[0]);

}  // namespace

extern "C" {

// Index of the instance study_ms_kernel<check, var, rnd, unroll>, or -1.
int bp_study_ms_find(int check, int var, int rnd, int unroll) {
  for (int i = 0; i < kCount; ++i) {
    const Instance& s = kInstances[i];
    if (s.check == check && s.var == var && s.rnd == rnd && s.unroll == unroll)
      return i;
  }
  return -1;
}

// Shared memory one block of this instance needs, in bytes (-1: no instance).
int bp_study_ms_smem_bytes(int instance, int M, int N, int Wc) {
  return instance >= 0 && instance < kCount
             ? kInstances[instance].smem(M, N, Wc)
             : -1;
}

// Launch study instance `instance` (bp_study_ms_find's index) on `stream`:
// rx (B, N) f32 and out (B, N) int8 row-major device buffers; slot_var (6M,)
// and var_slots (N, Wc) int32, the w-major tables of ops/layout.py (N even
// for the kInt8 instance). `steps` check steps. Returns the launch's
// cudaError_t; does not synchronise.
int bp_study_ms_decode(int instance, const float* rx, int8_t* out, int B,
                       const int* slot_var, const int* var_slots, int M, int N,
                       int Wc, int steps, void* stream) {
  if (instance < 0 || instance >= kCount || B <= 0 || steps < 0 || Wc < 1 ||
      Wc > kWcMax)
    return cudaErrorInvalidValue;
  return kInstances[instance].launch(rx, out, B, slot_var, var_slots, M, N, Wc,
                                     steps, static_cast<cudaStream_t>(stream));
}

// Blocks of study instance `instance` that fit one SM at `smem` bytes of
// dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// into *blocks. Returns the query's cudaError_t.
int bp_study_ms_occupancy(int instance, int smem, int* blocks) {
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

const char* bp_study_ms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
