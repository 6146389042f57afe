// Exact-mode belief-propagation decoders for Hopper (sm_90a) over the
// check-major edge layout (slot e = m*Wr + w).
//
// Replaces, in gr_ldpc_ece535a_tpu/ops/pallas_bp.py:
//   bp_exact_kernel<WR, false, R, T>  <- _minsum_exact_kernel     (:207)
//   bp_exact_kernel<WR, true, R, T>   <- _sumproduct_exact_kernel (:260)
// fixed iteration count only, as there; T is the instance (0: the table
// route, 8 rows of threads; 1: the min-sum's register tier, below). The
// plain PyTorch versions of the same functions are in ops/cuda_bp.py and
// round in the same order.
//
// What "exact" means. The contract of mode="exact" is the f32 path's hard
// decisions (ops/decode.py, the counterpart of the JAX package's jnp
// decoders). The Pallas kernels reach it with one-hot bcm matmuls at
// HIGHEST precision, a TPU stand-in for a gather; here each is a gather
// through the check-major tables in shared memory, and every sum and
// product runs in the f32 path's own order:
//   sum-product  th = tanh(M/2) (pads 1); T = exclusive prefix product *
//                exclusive suffix product, each a running product from 1;
//                E = log((1+T)/(1-T)). Per variable, x_v = E_v + r in
//                var-major order (pads 0), L = ((x0 + x1) + x2) + ..., and
//                the next message M_v = (cum_v - x_v) + (rcum_v - x_v) with
//                cum/rcum the inclusive running sums from the front / back
//                (ops/decode.py::_excl_sum). Where L is not finite (a
//                saturated x_v = +-inf forms inf - inf in the running sums),
//                every M_v is the sum of the other x from 0 in slot order, so
//                a saturated frame keeps its +-inf messages and decides its
//                codeword at any number of iterations. Decision L <= 0.
//   min-sum      beta = |Lq| (pads FLT_MAX), alpha = sign(Lq) with
//                sign(0) = 0, P = product of alpha; min1, the first argmin
//                and min2 (the minimum with the argmin masked);
//                Lr = (P * alpha) * (argmin ? min2 : min1). Per variable,
//                sum = sequential sum of its Lr, LQ = Lci + sum, next
//                Lq_v = LQ - Lr_v. Decision LQ < 0.
// Pad slots are never read: the Pallas kernels multiply them by a 0 mask,
// which forms 0*inf = NaN once a message saturates; the f32 path selects.
// A check's pad slots follow its real ones (ops/cuda_bp.py checks the
// table), so the kernel keeps only each check's real width.
// With zero iterations the decision is that of r, as the Pallas kernels'
// loop carry gives.
//
// Work layout, as the tile kernel of bp_wmajor.cu: a block decodes 32
// frames (one per lane, x) with 8 rows of threads (y); messages live in
// shared memory [slot][frame], so a warp's 32 lanes (32 frames of one
// check or variable) touch 32 banks:
//   msg  E x 32 f32, r N x 33 f32, vh N x 33 int8, each check's real
//   width (M int32) and each variable's slots (N x Wc int32): 36.0 KB for
//   block_32_64, 144 KB for E = 768 (gen_128_256), the largest code the
//   Pallas exact kernels take. The slot -> variable table is read from
//   global memory once, when the messages start.
//
// What bounds it. Global memory sees rx once and the int8 decisions once;
// the rest is on chip, so issue and shared-memory latency bound both
// kernels. Every time below is block_32_64 131,072 frames x 20
// iterations on an NVIDIA H100 80GB HBM3 at 700 W (tools/exact_probe.py,
// each variant against the shipped kernel in one run).
//   sum-product  one tanhf, one IEEE division and one logf per real edge
//                and iteration (19, 17 and 28 SASS instructions, 3 of them
//                MUFU; tools/issue_model.py). Built with --fmad=false and
//                without fast math, so they are the IEEE-accurate libm
//                versions that torch calls, bit for bit. The check step's
//                arithmetic is about 0.83 ms of the kernel's 1.6, near the
//                issue time of its SASS: bound by libm, which the contract
//                fixes. So the design works around the calls: each check's
//                real width replaces the slot table in shared memory, and
//                a check's pads never reach tanhf or logf (1.65 -> 1.58
//                ms). The register tier below lost 1-3% here (its check
//                step is libm's, not the loop), so the sum-product keeps
//                the table route.
//   min-sum      only compares. The parent's check step took three passes
//                over a row (min1, the first argmin, min2): 0.53 ms of its
//                1.16. Lever 2, one pass (check_minsum), which keeps every
//                rule of the three: 1.16 -> 0.945 ms on the table route.
//                Lever 1, the register tier: codes of at most 32 checks and
//                64 variables keep each thread's rows in registers and the
//                compiler holds every message address for the decode, so
//                the loop is loads, compares and stores: 0.945 -> 0.832 ms
//                at 64 registers and 4 blocks of 8 warps an SM (8 B of
//                spill; ptxas left free took 107 registers, 2 blocks,
//                0.865 ms). What is left: the variable step and barriers
//                0.37 ms, the check step's loads and stores 0.21, its
//                compares 0.25.
// Measured and not shipped (tools/exact_probe.py): the same tier with its
// addresses recomputed each iteration (an opaque copy; 0.886 ms); 16 rows
// of threads (0.888); 5 blocks an SM (0.895); a second tier for
// sim_50_100's 7 checks and 13 variables a thread (1.544 ms there against
// 1.485 on tables); the slot table and widths in the constant bank, a
// __grid_constant__ kernel parameter read by broadcast (0.938 and 1.473
// ms against 0.945 and 1.485 on tables: under 1%, for a host copy of the
// tables each launch).
// Tensor cores do not apply: no product is left, the TPU's one-hot matmuls
// became 1-3 term f32 sums through the tables, and the check step is
// compare and select (min-sum) or libm (sum-product). TMA and asynchronous
// copies do not: rx is read once, 8 KB a block. Clusters do not: blocks
// share nothing.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 32;              // frames per block, threadIdx.x
constexpr int kRows = 8;                 // threadIdx.y of the table route
constexpr int kRStride = kFrames + 1;    // row stride of r and vh
constexpr int kWcMax = 4;                // largest column weight taken
constexpr int kWrMin = 2, kWrMax = 8;    // row weights instantiated

__host__ __device__ inline int smem_bytes(int M, int N, int Wr, int Wc) {
  const int E = Wr * M;
  return 4 * (E * kFrames + N * kRStride + M + N * Wc) + N * kRStride;
}

// NaN-propagating min, as torch.amin
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Sum-product check step for check m of frame f, in place: M -> E. Its d
// real slots come first; the pads' th = 1 leaves every product as it is,
// and the loops over the real slots leave at w = d, a branch that a warp
// (one check, 32 frames) takes as one, so no pad runs tanhf or logf.
template <int WR>
__device__ __forceinline__ void check_sumproduct(float* msg, int d, int m,
                                                 int f) {
  float* row = msg + m * WR * kFrames + f;
  float th[WR];
#pragma unroll
  for (int w = 0; w < WR; ++w) th[w] = 1.f;
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    if (w == d) break;
    th[w] = tanhf(row[w * kFrames] / 2.f);
  }
  float pre[WR];
  float acc = 1.f;
#pragma unroll
  for (int w = 0; w < WR; ++w) {   // cumprod of [1, th0, th1, ...]
    pre[w] = acc;
    acc = acc * th[w];
  }
  float T[WR];
  acc = 1.f;
#pragma unroll
  for (int w = WR - 1; w >= 0; --w) {   // the same from the back
    T[w] = pre[w] * acc;
    acc = acc * th[w];
  }
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    if (w == d) break;
    row[w * kFrames] = logf((1.f + T[w]) / (1.f - T[w]));
  }
}

// Min-sum check step, in place: Lq -> Lr. Its d real slots come first.
// One pass over the row gives the sign product, min1, the first argmin and
// min2 (the minimum with the argmin masked), as the three passes of the
// plain version (torch.amin, argmin, amin) do: a slot takes the argmin when
// it is below min1, or is the first NaN (NaN acts as below every number, and
// a later NaN never displaces the first); min2 then takes the old min1,
// else the slot. So ties keep the first slot, min2 = min1 on a tie, a NaN
// row has min1 = NaN at its first NaN and min2 the NaN-propagating minimum
// of the rest, and the pads' FLT_MAX takes part as in the plain version
// (it is min1 only in a row of +inf). min2 starts at FLT_MAX, the masked
// argmin's value.
template <int WR>
__device__ __forceinline__ void check_minsum(float* msg, int d, int m,
                                             int f) {
  float beta[WR], alpha[WR];
  float P = 1.f, min1 = 0.f, min2 = FLT_MAX;
  int arg = 0;
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    const int e = m * WR + w;
    const bool real = w < d;
    const float t = real ? msg[e * kFrames + f] : 0.f;
    alpha[w] = (float)(t > 0.f) - (float)(t < 0.f);
    beta[w] = real ? fabsf(t) : FLT_MAX;
    P = P * (real ? alpha[w] : 1.f);
    const float b = beta[w];
    if (w == 0) {
      min1 = b;
    } else if (b < min1 || (b != b && min1 == min1)) {
      min2 = nan_min(min2, min1);
      min1 = b;
      arg = w;
    } else {
      min2 = nan_min(min2, b);
    }
  }
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    const int e = m * WR + w;
    if (w < d)
      msg[e * kFrames + f] = (P * alpha[w]) * (w == arg ? min2 : min1);
  }
}

// For each of the Wc slots, the sum of the other slots' x from 0 in slot
// order. Out of line: only a variable with a saturated message calls it,
// and inlined it would be predicated into every variable step.
static_assert(kWcMax == 4, "others_sum carries the slots in a float4");
__device__ __noinline__ float4 others_sum(float4 x4, int Wc) {
  const float x[kWcMax] = {x4.x, x4.y, x4.z, x4.w};
  float o[kWcMax];
#pragma unroll
  for (int v = 0; v < kWcMax; ++v) {
    o[v] = 0.f;
#pragma unroll
    for (int i = 0; i < kWcMax; ++i)
      if (i != v && i < Wc) o[v] = o[v] + x[i];
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

// Variable step for variable j of frame f: reads its check messages (E or
// Lr) in var-major order, writes the decision (last iteration) or the next
// edge messages.
template <bool SP>
__device__ __forceinline__ void var_step(float* msg, const float* r,
                                         const int* vc, int8_t* vh, int j,
                                         int Wc, int f, bool last) {
  const float rj = r[j * kRStride + f];
  float x[kWcMax];
  int s[kWcMax];
  float tot = 0.f;
#pragma unroll
  for (int v = 0; v < kWcMax; ++v) {
    s[v] = v < Wc ? vc[j * Wc + v] : -1;
    const float m = s[v] >= 0 ? msg[s[v] * kFrames + f] : 0.f;
    x[v] = s[v] >= 0 ? (SP ? m + rj : m) : 0.f;
    if (v < Wc) tot = v == 0 ? x[0] : tot + x[v];
  }
  if (last) {
    vh[j * kRStride + f] = SP ? tot <= 0.f : rj + tot < 0.f;
    return;
  }
  if (SP) {
    // (cum_v - x_v) + (rcum_v - x_v), the running sums over all Wc slots
    float cum[kWcMax];
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < kWcMax; ++v) {
      if (v < Wc) acc = v == 0 ? x[0] : acc + x[v];
      cum[v] = acc;
    }
    acc = 0.f;
#pragma unroll
    for (int v = kWcMax - 1; v >= 0; --v) {
      if (v >= Wc) continue;
      acc = v == Wc - 1 ? x[v] : acc + x[v];
      if (s[v] >= 0) msg[s[v] * kFrames + f] = (cum[v] - x[v]) + (acc - x[v]);
    }
    // a saturated slot (x = +-inf) forms inf - inf in the running sums:
    // then every slot takes the others' sum, written over the stores above
    // so that a finite variable runs the running-sum code alone
    if (!isfinite(tot)) {
      const float4 o4 = others_sum(make_float4(x[0], x[1], x[2], x[3]), Wc);
      const float o[kWcMax] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int v = 0; v < kWcMax; ++v)
        if (v < Wc && s[v] >= 0) msg[s[v] * kFrames + f] = o[v];
    }
  } else {
    const float LQ = rj + tot;
#pragma unroll
    for (int v = 0; v < kWcMax; ++v)
      if (s[v] >= 0) msg[s[v] * kFrames + f] = LQ - x[v];
  }
}

// The min-sum's variable step for variable j of frame f, as var_step,
// its -rx rj and slots s (-1 on a pad) given (the register tier).
__device__ __forceinline__ void var_step_minsum(float* msg, int8_t* vh,
                                                float rj,
                                                const int (&s)[kWcMax],
                                                int j, int Wc, int f,
                                                bool last) {
  float x[kWcMax];
  float tot = 0.f;
#pragma unroll
  for (int v = 0; v < kWcMax; ++v) {
    x[v] = s[v] >= 0 ? msg[s[v] * kFrames + f] : 0.f;
    if (v < Wc) tot = v == 0 ? x[0] : tot + x[v];
  }
  if (last) {
    vh[j * kRStride + f] = rj + tot < 0.f;
    return;
  }
  const float LQ = rj + tot;
#pragma unroll
  for (int v = 0; v < kWcMax; ++v)
    if (s[v] >= 0) msg[s[v] * kFrames + f] = LQ - x[v];
}

// Lever 1, the thread's rows in registers. A thread takes checks y, y + 8,
// ... and variables y, y + 8, ... in every iteration, so their widths,
// slots and -rx are loaded once, before the loop, where the table route
// reads them from shared memory in every iteration, each read heading a
// dependent chain (table -> address -> message). The counts are
// compile-time, so the rows' loops unroll, and the compiler keeps every
// row's message addresses in registers for the whole decode: the loop is
// loads, compares and stores. That costs registers (4 blocks of 8 warps an
// SM at block_32_64, where the table route fits 6) and pays there; at
// sim_50_100's 7 checks and 13 variables a thread it did not
// (tools/exact_probe.py), so the tier holds codes of at most 32 checks and
// 64 variables, and any other code takes the table route.
struct Shape {
  int M, N;
};
constexpr Shape kShapes[] = {{32, 64}};   // block_32_64
constexpr int kTiers = sizeof(kShapes) / sizeof(kShapes[0]);
constexpr int kRegRows = 8;        // rows of threads of the register tier
constexpr int kRegMinBlocks = 4;   // ptxas fits 64 registers (8 B of spill)
                                   // for 4 blocks an SM; left free it took
                                   // 107 and 2 blocks, 1.04x the time
constexpr int kPadSlot = 0xffff;   // a pad's 16-bit slot

// The registers a thread holds for tier T with R rows: 4 bits of width a
// check, two 16-bit slots a register, and -rx of each variable.
template <int R, int T>
struct ThreadRows {
  static constexpr int KC = (kShapes[T - 1].M + R - 1) / R;
  static constexpr int KV = (kShapes[T - 1].N + R - 1) / R;
  static_assert(KC * 4 <= 32, "a check's width takes 4 bits of one int");
  unsigned width;
  unsigned slots[KV][kWcMax / 2];
  float rj[KV];

  __device__ __forceinline__ void load(const int* deg, const int* vc,
                                       const float* r, int M, int N, int Wc,
                                       int y, int f) {
    width = 0;
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int m = y + i * R;
      width |= (unsigned)(m < M ? deg[m] : 0) << (4 * i);
    }
#pragma unroll
    for (int i = 0; i < KV; ++i) {
      const int j = y + i * R;
      rj[i] = j < N ? r[j * kRStride + f] : 0.f;
#pragma unroll
      for (int h = 0; h < kWcMax / 2; ++h) {
        unsigned w = 0;
#pragma unroll
        for (int k = 2 * h; k < 2 * h + 2; ++k) {
          const int s = j < N && k < Wc ? vc[j * Wc + k] : -1;
          w |= (unsigned)(s >= 0 ? s : kPadSlot) << (16 * (k & 1));
        }
        slots[i][h] = w;
      }
    }
  }
  // variable y + i*R's slots, -1 on a pad
  __device__ __forceinline__ void var_slots(int i, int (&s)[kWcMax]) const {
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) {
      const int v = (slots[i][k / 2] >> (16 * (k & 1))) & 0xffff;
      s[k] = v == kPadSlot ? -1 : v;
    }
  }
};

// T = 0: the table route, R = kRows; T >= 1 (the min-sum only): tier T of
// kShapes, the rows in registers, R = kRegRows.
template <int WR, bool SP, int R, int T>
__global__ void __launch_bounds__(kFrames * R, T > 0 ? kRegMinBlocks : 0)
bp_exact_kernel(const float* __restrict__ rx, int8_t* __restrict__ out, int B,
                const int* __restrict__ chk_var,
                const int* __restrict__ var_cslots, int M, int N, int Wc,
                int iterations) {
  constexpr int kThreads = kFrames * R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = WR * M;
  float* msg = reinterpret_cast<float*>(smem);
  float* r = msg + E * kFrames;
  int* deg = reinterpret_cast<int*>(r + N * kRStride);   // real slots a check
  int* vc = deg + M;
  int8_t* vh = reinterpret_cast<int8_t*>(vc + N * Wc);

  const int f = threadIdx.x, y = threadIdx.y;
  const int tid = y * kFrames + f;
  const long long f0 = (long long)blockIdx.x * kFrames;

  for (int m = tid; m < M; m += kThreads) {
    int d = 0;
#pragma unroll
    for (int w = 0; w < WR; ++w) d += chk_var[m * WR + w] >= 0;
    deg[m] = d;
  }
  for (int i = tid; i < N * Wc; i += kThreads) vc[i] = var_cslots[i];
  for (int i = tid; i < kFrames * N; i += kThreads) {   // coalesced rx rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    r[j * kRStride + ff] = g < B ? -rx[g * N + j] : 0.f;
  }
  __syncthreads();
  for (int e = y; e < E; e += R) {
    const int j = chk_var[e];
    if (j >= 0) msg[e * kFrames + f] = r[j * kRStride + f];
  }
  for (int j = y; j < N; j += R) {   // decision of r (iterations = 0)
    const float rj = r[j * kRStride + f];
    vh[j * kRStride + f] = SP ? rj <= 0.f : rj < 0.f;
  }
  __syncthreads();

  if constexpr (T == 0) {
    for (int it = 0; it < iterations; ++it) {
      for (int m = y; m < M; m += R) {
        if constexpr (SP)
          check_sumproduct<WR>(msg, deg[m], m, f);
        else
          check_minsum<WR>(msg, deg[m], m, f);
      }
      __syncthreads();
      const bool last = it + 1 == iterations;
      for (int j = y; j < N; j += R)
        var_step<SP>(msg, r, vc, vh, j, Wc, f, last);
      __syncthreads();
    }
  } else {
    static_assert(!SP, "the register tier is the min-sum's");
    using Rows = ThreadRows<R, T>;
    Rows rows;
    rows.load(deg, vc, r, M, N, Wc, y, f);
    for (int it = 0; it < iterations; ++it) {
#pragma unroll
      for (int i = 0; i < Rows::KC; ++i) {
        const int m = y + i * R;
        if (m < M) check_minsum<WR>(msg, (rows.width >> (4 * i)) & 15, m, f);
      }
      __syncthreads();
      const bool last = it + 1 == iterations;
#pragma unroll
      for (int i = 0; i < Rows::KV; ++i) {
        const int j = y + i * R;
        if (j >= N) continue;
        int s[kWcMax];
        rows.var_slots(i, s);
        var_step_minsum(msg, vh, rows.rj[i], s, j, Wc, f, last);
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < kFrames * N; i += kThreads) {   // coalesced out rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    if (g < B) out[g * N + j] = vh[j * kRStride + ff];
  }
}

// The tier a code of this shape takes: for the min-sum, the first of
// kShapes that holds its M and N; 0, the table route, otherwise and for
// the sum-product.
inline int tier(bool sp, int M, int N) {
  if (sp) return 0;
  for (int t = 0; t < kTiers; ++t)
    if (M <= kShapes[t].M && N <= kShapes[t].N) return t + 1;
  return 0;
}

template <int WR, bool SP, int T>
cudaError_t launch(const float* rx, int8_t* out, int B, const int* chk_var,
                   const int* var_cslots, int M, int N, int Wc,
                   int iterations, cudaStream_t stream) {
  constexpr int R = T ? kRegRows : kRows;
  const int smem = smem_bytes(M, N, WR, Wc);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bp_exact_kernel<WR, SP, R, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((B + kFrames - 1) / kFrames));
  const dim3 block(kFrames, R);
  bp_exact_kernel<WR, SP, R, T><<<grid, block, smem, stream>>>(
      rx, out, B, chk_var, var_cslots, M, N, Wc, iterations);
  return cudaGetLastError();
}

// The kernel of row weight WR and tier t, for querying.
template <int WR, bool SP>
const void* kernel_of(int t) {
  if constexpr (!SP)
    if (t == 1) return (const void*)bp_exact_kernel<WR, SP, kRegRows, 1>;
  return t == 0 ? (const void*)bp_exact_kernel<WR, SP, kRows, 0> : nullptr;
}
static_assert(kTiers == 1, "kernel_of and dispatch instantiate tiers 0-1");

template <bool SP>
cudaError_t dispatch(int Wr, const float* rx, int8_t* out, int B,
                     const int* chk_var, const int* var_cslots, int M, int N,
                     int Wc, int iterations, cudaStream_t stream) {
  const int t = tier(SP, M, N);
#define BP_TIER(W, T)                                                         \
  case T:                                                                     \
    return launch<W, SP, T>(rx, out, B, chk_var, var_cslots, M, N, Wc,        \
                            iterations, stream);
#define BP_CASE(W)                                                            \
  case W:                                                                     \
    if constexpr (!SP) {                                                      \
      switch (t) { BP_TIER(W, 1) default: break; }                            \
    }                                                                         \
    switch (t) { BP_TIER(W, 0) default: return cudaErrorInvalidValue; }
  switch (Wr) {
    BP_CASE(2) BP_CASE(3) BP_CASE(4) BP_CASE(5) BP_CASE(6) BP_CASE(7)
    BP_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef BP_CASE
#undef BP_TIER
}

template <bool SP>
int occupancy(int Wr, int t, int smem, int* blocks) {
  const void* fn = nullptr;
#define BP_FN(W)                                                              \
  case W:                                                                     \
    fn = kernel_of<W, SP>(t);                                                 \
    break;
  switch (Wr) {
    BP_FN(2) BP_FN(3) BP_FN(4) BP_FN(5) BP_FN(6) BP_FN(7) BP_FN(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef BP_FN
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fn, kFrames * (t ? kRegRows : kRows), smem);
  // a query's error must not surface as the next launch's cudaGetLastError
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" {

// The instance a code of this shape takes: 0, the table route, or the
// tier t >= 1 of kCounts whose rows stay in registers.
int bp_exact_tier(int sumproduct, int M, int N) {
  return tier(sumproduct != 0, M, N);
}

// Blocks of the exact min-sum (sumproduct = 0) or sum-product (1) kernel of
// tier t that fit one SM at `smem` bytes of dynamic shared memory, into
// *blocks, and the threads of one block, into *threads.
int bp_exact_occupancy(int sumproduct, int Wr, int t, int smem, int* blocks,
                       int* threads) {
  *threads = kFrames * (t ? kRegRows : kRows);
  return sumproduct ? occupancy<true>(Wr, t, smem, blocks)
                    : occupancy<false>(Wr, t, smem, blocks);
}

// Shared memory one block needs for this code shape, in bytes.
int bp_exact_smem_bytes(int M, int N, int Wr, int Wc) {
  return smem_bytes(M, N, Wr, Wc);
}

// Launch the exact min-sum (sumproduct = 0) or sum-product (1) decoder on
// `stream`. rx (B, N) f32 and out (B, N) int8 are row-major device buffers;
// chk_var (M*Wr,) and var_cslots (N, Wc) are the int32 check-major tables
// of ops/layout.py. Returns the launch's cudaError_t; does not synchronise.
int bp_exact_decode(int sumproduct, const float* rx, int8_t* out, int B,
                    const int* chk_var, const int* var_cslots, int M, int N,
                    int Wr, int Wc, int iterations, void* stream) {
  if (B <= 0 || iterations < 0 || Wc < 1 || Wc > kWcMax || Wr < kWrMin ||
      Wr > kWrMax)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sumproduct ? dispatch<true>(Wr, rx, out, B, chk_var, var_cslots, M,
                                     N, Wc, iterations, s)
                    : dispatch<false>(Wr, rx, out, B, chk_var, var_cslots, M,
                                      N, Wc, iterations, s);
}

const char* bp_exact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
