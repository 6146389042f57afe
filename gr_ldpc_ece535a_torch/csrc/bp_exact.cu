// Exact-mode belief-propagation decoders for Hopper (sm_90a) over the
// check-major edge layout (slot e = m*Wr + w).
//
// Replaces, in gr_ldpc_ece535a_tpu/ops/pallas_bp.py:
//   bp_exact_kernel<WR, false>  <- _minsum_exact_kernel     (:207)
//   bp_exact_kernel<WR, true>   <- _sumproduct_exact_kernel (:260)
// fixed iteration count only, as there. The plain PyTorch versions of the
// same functions are in ops/cuda_bp.py and round in the same order.
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
// What bounds it: the sum-product does one tanhf, one IEEE division and one
// logf per real edge and iteration (19, 17 and 28 SASS instructions, 3 of
// them MUFU; tools/issue_model.py); min-sum only compares. Global memory
// sees rx once and the int8 decisions once. Built with --fmad=false and
// without fast math, so tanhf, logf and '/' are the IEEE-accurate libm
// versions that torch calls, bit for bit. On an NVIDIA H100 80GB HBM3 at
// 700 W, block_32_64 131,072 frames x 20 iterations (tools/exact_probe.py):
// the check step's arithmetic takes 0.83 ms of the kernel's 1.58, 1.10x the
// issue time of its SASS at 1980 MHz (0.75 ms; 0.84 for the three calls as
// standalone functions): the check step is bound by instruction issue in
// libm, which the contract fixes. So the design works around the calls:
// each check's real width replaces the slot table in shared memory (one
// load a check, where the table cost two a slot), and a check's pads never
// reach tanhf or logf; 1.65 -> 1.58 ms.
// The rest is the variable step, tables and barriers (0.60 ms) and the check
// step's loads and stores (0.15 ms).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 32;              // frames per block, threadIdx.x
constexpr int kRows = 8;                 // threadIdx.y
constexpr int kThreads = kFrames * kRows;
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
template <int WR>
__device__ __forceinline__ void check_minsum(float* msg, int d, int m,
                                             int f) {
  float beta[WR], alpha[WR];
  float P = 1.f, min1 = FLT_MAX;
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    const int e = m * WR + w;
    const bool real = w < d;
    const float t = real ? msg[e * kFrames + f] : 0.f;
    alpha[w] = (float)(t > 0.f) - (float)(t < 0.f);
    beta[w] = real ? fabsf(t) : FLT_MAX;
    P = P * (real ? alpha[w] : 1.f);
    min1 = w == 0 ? beta[0] : nan_min(min1, beta[w]);
  }
  // the first argmin (the first NaN when the minimum is NaN)
  const bool min_nan = min1 != min1;
  int arg = WR;
#pragma unroll
  for (int w = WR - 1; w >= 0; --w)
    if (min_nan ? beta[w] != beta[w] : beta[w] == min1) arg = w;
  float min2 = FLT_MAX;
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    const float b = w == arg ? FLT_MAX : beta[w];
    min2 = w == 0 ? b : nan_min(min2, b);
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

template <int WR, bool SP>
__global__ void __launch_bounds__(kThreads)
bp_exact_kernel(const float* __restrict__ rx, int8_t* __restrict__ out, int B,
                const int* __restrict__ chk_var,
                const int* __restrict__ var_cslots, int M, int N, int Wc,
                int iterations) {
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
  for (int e = y; e < E; e += kRows) {
    const int j = chk_var[e];
    if (j >= 0) msg[e * kFrames + f] = r[j * kRStride + f];
  }
  for (int j = y; j < N; j += kRows) {   // decision of r (iterations = 0)
    const float rj = r[j * kRStride + f];
    vh[j * kRStride + f] = SP ? rj <= 0.f : rj < 0.f;
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    for (int m = y; m < M; m += kRows) {
      if constexpr (SP)
        check_sumproduct<WR>(msg, deg[m], m, f);
      else
        check_minsum<WR>(msg, deg[m], m, f);
    }
    __syncthreads();
    const bool last = it + 1 == iterations;
    for (int j = y; j < N; j += kRows)
      var_step<SP>(msg, r, vc, vh, j, Wc, f, last);
    __syncthreads();
  }
  for (int i = tid; i < kFrames * N; i += kThreads) {   // coalesced out rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    if (g < B) out[g * N + j] = vh[j * kRStride + ff];
  }
}

template <int WR, bool SP>
cudaError_t launch(const float* rx, int8_t* out, int B, const int* chk_var,
                   const int* var_cslots, int M, int N, int Wc,
                   int iterations, cudaStream_t stream) {
  const int smem = smem_bytes(M, N, WR, Wc);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bp_exact_kernel<WR, SP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((B + kFrames - 1) / kFrames));
  const dim3 block(kFrames, kRows);
  bp_exact_kernel<WR, SP><<<grid, block, smem, stream>>>(
      rx, out, B, chk_var, var_cslots, M, N, Wc, iterations);
  return cudaGetLastError();
}

template <bool SP>
cudaError_t dispatch(int Wr, const float* rx, int8_t* out, int B,
                     const int* chk_var, const int* var_cslots, int M, int N,
                     int Wc, int iterations, cudaStream_t stream) {
#define BP_CASE(W)                                                            \
  case W:                                                                     \
    return launch<W, SP>(rx, out, B, chk_var, var_cslots, M, N, Wc,           \
                         iterations, stream);
  switch (Wr) {
    BP_CASE(2) BP_CASE(3) BP_CASE(4) BP_CASE(5) BP_CASE(6) BP_CASE(7)
    BP_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef BP_CASE
}

template <bool SP>
int occupancy(int Wr, int smem, int* blocks) {
  const void* fn = nullptr;
#define BP_FN(W)                                                              \
  case W:                                                                     \
    fn = (const void*)bp_exact_kernel<W, SP>;                                 \
    break;
  switch (Wr) {
    BP_FN(2) BP_FN(3) BP_FN(4) BP_FN(5) BP_FN(6) BP_FN(7) BP_FN(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef BP_FN
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

}  // namespace

extern "C" {

// Blocks of the exact min-sum (sumproduct = 0) or sum-product (1) kernel
// that fit one SM at `smem` bytes of dynamic shared memory, into *blocks,
// and the threads of one block, into *threads.
int bp_exact_occupancy(int sumproduct, int Wr, int smem, int* blocks,
                       int* threads) {
  *threads = kThreads;
  return sumproduct ? occupancy<true>(Wr, smem, blocks)
                    : occupancy<false>(Wr, smem, blocks);
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
