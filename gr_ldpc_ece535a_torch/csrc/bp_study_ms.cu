// The min-sum kernel study for Hopper (sm_90a): the check-step and
// aggregation variants of the TPU prototype study, as compile-time instances
// on the tile skeleton of csrc/bp_wmajor.cu.
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
// and study_ms_ref, the shipped tile min-sum's arithmetic, as the yardstick.
// Names, specs and the plain PyTorch versions (same rounding order) are in
// ops/cuda_study_ms.py.
//
// What each TPU variant computed, not how: a one-hot product at precision
// DEFAULT rounds its f32 operand to bf16 (one MXU pass) and sums in f32; at
// HIGHEST it is the f32 value. Here every product is a 1-3 term sum read
// through index tables, with the operand rounded where the TPU rounded it:
//   CHECK  kExcl     exclusive prefix/suffix minima (pallas_bp._excl_min_axis0)
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
//   UNROLL 1, 2, 4 or 19: the step loop unrolled U times, in blocks of U full
//                    steps with a compile-time trip count, then the rest one
//                    step at a time (19 check steps: 9 x 2 + 1 at U = 2,
//                    4 x 4 + 3 at U = 4, 1 x 19 at U = 19), as JAX's
//                    fori_loop(unroll=U); the steps stay a runtime argument
//                    and U changes no arithmetic
// Every instance decides LQ = Lci + (sum of all edges' Lr, rounded as RND;
// hilo: bf16) < 0 after `steps` check steps.
//
// Work layout as the tile kernel: a block of 32 lanes x 8 rows keeps 32
// frames; messages [slot][frame] in shared memory for all iterations (bf16
// for kGram16); rx read once, coalesced; only the int8 decisions written
// back. kInt8 keeps q as int8 [slot][frame] in shared memory: its check step
// writes q, one byte a message, and its variable step reads q, so that step
// moves a quarter of the bytes. What bounds the min-sum is what the study
// measures: the check step is compares and selects, the variable step 1-3
// adds; 256 B in and 64 B out per frame per decode (no HBM bound). Only row
// weight 6 (block_32_64) is instantiated. Pad slots are never read; a check
// step takes them as +1e30 (bf16(1e30) in kGram16): what JAX's pad constant
// gives them, exactly, while |Lr| < 3.8e22 (half an ulp of 1e30).
//
// Rounding: no fast math, --fmad=false; a variable's sums run from 0 in
// ascending slot order; a bf16 add is the f32 add rounded to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWr = 6;
constexpr int kLanes = 32, kRows = 8, kThreads = kLanes * kRows;
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

// NaN-propagating min, as jnp.minimum / torch.minimum (fminf drops NaN)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
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

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ int8_t quantize(float x) {
  float y = x * kQs;
  y = y < -127.f ? -127.f : (y > 127.f ? 127.f : y);   // jnp.clip
  return (int8_t)__float2int_rz(y);                      // astype(int8)
}

// Check step for check m of frame f: Lq -> Lr on the real slots, written to
// msg, or as q to qb when qb is given (kInt8 before its last step).
template <int CHECK, class T>
__device__ __forceinline__ void check_step(T* msg, int8_t* qb, const int* sv,
                                           int m, int M, int f, float pad) {
  constexpr int F = kLanes;
  bool real[kWr];
  float t[kWr], lr[kWr];
#pragma unroll
  for (int k = 0; k < kWr; ++k) {
    const int e = k * M + m;
    real[k] = sv[e] >= 0;
    t[k] = real[k] ? ld(&msg[e * F + f]) : pad;
  }
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
  } else {
    float beta[kWr], sg[kWr];
    float P = 1.f;
#pragma unroll
    for (int k = 0; k < kWr; ++k) {
      beta[k] = fabsf(t[k]);
      sg[k] = t[k] < 0.f ? -1.f : 1.f;
      P = P * sg[k];
    }
    if constexpr (CHECK == kArgmin) {
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
    } else {                                          // kExcl
      float pre[kWr];
      float acc = beta[0];
      pre[0] = FLT_MAX;
#pragma unroll
      for (int k = 1; k < kWr; ++k) {
        pre[k] = acc;
        acc = nan_min(acc, beta[k]);
      }
      const float pa = acc == 0.f ? 0.f : P;           // acc: the row's min
      float suf = FLT_MAX;
#pragma unroll
      for (int k = kWr - 1; k >= 0; --k) {
        const float me = nan_min(pre[k], suf);
        suf = k == kWr - 1 ? beta[k] : nan_min(suf, beta[k]);
        lr[k] = sg[k] * (pa * me);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kWr; ++k) {
    if (!real[k]) continue;
    const int e = k * M + m;
    if (qb != nullptr)
      qb[e * F + f] = quantize(lr[k]);
    else
      st(&msg[e * F + f], lr[k]);
  }
}

// Variable step for variable j of frame f: the check messages of its slots
// (q for kInt8) -> the next Lq on those slots.
template <int VAR, int RND, class T>
__device__ __forceinline__ void var_step(T* msg, const int8_t* qb,
                                         const float* r, const int* vs, int j,
                                         int Wc, int f) {
  constexpr int F = kLanes;
  const float lci = r[j * (F + 1) + f];
  int s[kWcMax];
#pragma unroll
  for (int k = 0; k < kWcMax; ++k) s[k] = k < Wc ? vs[j * Wc + k] : -1;
  if constexpr (VAR == kInt8) {
    int q[kWcMax];
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) q[k] = s[k] >= 0 ? qb[s[k] * F + f] : 0;
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) {
      if (s[k] < 0) continue;
      int acc = 0;                                     // exact
#pragma unroll
      for (int i = 0; i < kWcMax; ++i)
        if (i != k && i < Wc) acc += q[i];
      msg[s[k] * F + f] = lci + (float)acc * kDq;
    }
  } else {
    float e[kWcMax];
#pragma unroll
    for (int k = 0; k < kWcMax; ++k)
      e[k] = s[k] >= 0 ? ld(&msg[s[k] * F + f]) : 0.f;
    if constexpr (VAR == kSplit || VAR == kSplitAll) {
      float tot = 0.f;
#pragma unroll
      for (int k = 0; k < kWcMax; ++k)
        if (k < Wc) tot = tot + agg_round<RND>(e[k]);
      const float A = agg_round<RND>(lci + tot);
#pragma unroll
      for (int k = 0; k < kWcMax; ++k)
        if (s[k] >= 0) msg[s[k] * F + f] = A - e[k];
    } else {
#pragma unroll
      for (int k = 0; k < kWcMax; ++k) {
        if (s[k] < 0) continue;
        float acc = 0.f;
        if constexpr (VAR == kOwn) {
          acc = e[k];
        } else {
#pragma unroll
          for (int i = 0; i < kWcMax; ++i)
            if (i != k && i < Wc) acc = acc + agg_round<RND>(e[i]);
          if constexpr (RND == kHilo || RND == kHilo2) {
#pragma unroll
            for (int i = 0; i < kWcMax; ++i)
              if (i != k && i < Wc) acc = acc + bf16r(e[i] - bf16r(e[i]));
          }
        }
        if constexpr (VAR == kGram16)
          st(&msg[s[k] * F + f], bf16r(lci) + bf16r(acc));
        else
          st(&msg[s[k] * F + f], lci + acc);
      }
    }
  }
}

// Decision of variable j of frame f: Lci + (sum of its edges' Lr) < 0;
// kHilo2: every edge's hi, then every edge's lo.
template <int RND, class T>
__device__ __forceinline__ void var_decide(const T* msg, const float* r,
                                           const int* vs, int8_t* vh, int j,
                                           int Wc, int f) {
  constexpr int F = kLanes;
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < kWcMax; ++k) {
    const int s = k < Wc ? vs[j * Wc + k] : -1;
    if (k < Wc) tot = tot + (s >= 0 ? agg_round<RND>(ld(&msg[s * F + f])) : 0.f);
  }
  if constexpr (RND == kHilo2) {
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) {
      const int s = k < Wc ? vs[j * Wc + k] : -1;
      if (k < Wc) {
        const float x = s >= 0 ? ld(&msg[s * F + f]) : 0.f;
        tot = tot + bf16r(x - bf16r(x));
      }
    }
  }
  vh[j * (F + 1) + f] = r[j * (F + 1) + f] + tot < 0.f;
}

template <int CHECK, int VAR, int RND, int UNROLL>
int smem_of(int M, int N, int Wc) {
  constexpr int F = kLanes;
  const int E = kWr * M;
  return (int)sizeof(Msg<VAR>) * E * F + 4 * (N * (F + 1) + E + N * Wc) +
         N * (F + 1) + (VAR == kInt8 ? E * F : 0);
}

// One full step: the check step (kInt8: writing q), then every variable's
// next Lq.
template <int CHECK, int VAR, int RND, class T>
__device__ __forceinline__ void ms_step(T* msg, int8_t* qb, const float* r,
                                       const int* sv, const int* vs, int M,
                                       int N, int Wc, int f, int y, float pad) {
  int8_t* q = VAR == kInt8 ? qb : nullptr;
  for (int m = y; m < M; m += kRows) check_step<CHECK>(msg, q, sv, m, M, f, pad);
  __syncthreads();
  for (int j = y; j < N; j += kRows)
    var_step<VAR, RND>(msg, qb, r, vs, j, Wc, f);
  __syncthreads();
}

template <int CHECK, int VAR, int RND, int UNROLL>
__global__ void __launch_bounds__(kThreads)
study_ms_kernel(const float* __restrict__ rx, int8_t* __restrict__ out, int B,
                const int* __restrict__ slot_var,
                const int* __restrict__ var_slots, int M, int N, int Wc,
                int steps) {
  using T = Msg<VAR>;
  constexpr int F = kLanes, RS = F + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = kWr * M;
  T* msg = reinterpret_cast<T*>(smem);
  float* r = reinterpret_cast<float*>(smem + sizeof(T) * E * F);
  int* sv = reinterpret_cast<int*>(r + N * RS);
  int* vs = sv + E;
  int8_t* vh = reinterpret_cast<int8_t*>(vs + N * Wc);
  int8_t* qb = vh + N * RS;                     // kInt8 only: E x F int8

  const int f = threadIdx.x, y = threadIdx.y;
  const int tid = y * kLanes + f;
  const long long f0 = (long long)blockIdx.x * F;

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
      const float x = r[j * RS + f];
      st(&msg[e * F + f], VAR == kSplitAll ? agg_round<RND>(x) : x);
    }
  }
  __syncthreads();

  static_assert(UNROLL >= 1, "UNROLL counts steps");
  const float pad = VAR == kGram16 ? bf16r(kPadBig) : kPadBig;
  // UNROLL > 1: blocks of UNROLL full steps with a compile-time trip count,
  // which nvcc unrolls, while a whole block ends before the last step; then
  // the rest one step at a time, as at UNROLL = 1
  int it = 0;
  if constexpr (UNROLL > 1) {
    for (; it + UNROLL < steps; it += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        ms_step<CHECK, VAR, RND>(msg, qb, r, sv, vs, M, N, Wc, f, y, pad);
    }
  }
  for (; it < steps; ++it) {
    const bool last = it + 1 == steps;
    int8_t* q = VAR == kInt8 && !last ? qb : nullptr;
    for (int m = y; m < M; m += kRows)
      check_step<CHECK>(msg, q, sv, m, M, f, pad);
    __syncthreads();
    if (!last) {                                  // the last update is dead
      for (int j = y; j < N; j += kRows)
        var_step<VAR, RND>(msg, qb, r, vs, j, Wc, f);
      __syncthreads();
    }
  }
  if (steps == 0) {                               // Lr = 0: decide on Lci
    for (int e = y; e < E; e += kRows) st(&msg[e * F + f], 0.f);
    __syncthreads();
  }
  constexpr int kFinal = RND == kHilo ? kBf16 : RND;   // hilo: one bf16 pass
  for (int j = y; j < N; j += kRows)
    var_decide<kFinal>(msg, r, vs, vh, j, Wc, f);
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
  const int smem = smem_of<CHECK, VAR, RND, UNROLL>(M, N, Wc);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        study_ms_kernel<CHECK, VAR, RND, UNROLL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((B + kLanes - 1) / kLanes));
  const dim3 block(kLanes, kRows);
  study_ms_kernel<CHECK, VAR, RND, UNROLL><<<grid, block, smem, stream>>>(
      rx, out, B, slot_var, var_slots, M, N, Wc, steps);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const float*, int8_t*, int, const int*,
                                 const int*, int, int, int, int, cudaStream_t);
using SmemFn = int (*)(int, int, int);
struct Instance {
  int check, var, rnd, unroll;
  Launcher launch;
  SmemFn smem;
};

// The instantiated templates. ops/cuda_study_ms.py names them and finds each
// by its four arguments (bp_study_ms_find); the enums' numbering is its
// CHECKS, VARS and RNDS.
#define STUDY(...) {__VA_ARGS__, launch<__VA_ARGS__>, smem_of<__VA_ARGS__>}
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
// and var_slots (N, Wc) int32, the w-major tables of ops/layout.py. `steps`
// check steps. Returns the launch's cudaError_t; does not synchronise.
int bp_study_ms_decode(int instance, const float* rx, int8_t* out, int B,
                       const int* slot_var, const int* var_slots, int M, int N,
                       int Wc, int steps, void* stream) {
  if (instance < 0 || instance >= kCount || B <= 0 || steps < 0 || Wc < 1 ||
      Wc > kWcMax)
    return cudaErrorInvalidValue;
  return kInstances[instance].launch(rx, out, B, slot_var, var_slots, M, N, Wc,
                                     steps, static_cast<cudaStream_t>(stream));
}

const char* bp_study_ms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
