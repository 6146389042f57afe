// Belief-propagation decoders for codes beyond the shared-memory tile, on
// Hopper (sm_90a), over the w-major edge layout.
//
// Replaces no TPU kernel: the JAX package's Pallas kernels stop at their
// VMEM envelopes, and codes beyond them decode on XLA. The port's tile and
// large-code kernels (bp_wmajor.cu) keep 32 or 16 frames and the slot
// tables in one block's shared memory, with column weights up to 4; a code
// such as IEEE 802.11n's (1944, 972) rate-1/2 code (E = 7,776 w-major
// slots, column weight 11) needs 1.4 MB for a 32-frame tile. These kernels
// decode such codes with the same decoders as bp_wmajor.cu's, the same
// arithmetic in the same rounding order, so their plain versions are the
// same decode_*_plain of ops/cuda_bp.py:
//   bp_wide<WR, true, S>   tanh-rule SPA in the phi domain (csrc/sfu.cuh)
//   bp_wide<WR, false, S>  min-sum, sign(0) zeroes the row (csrc/minsum.cuh)
// each in its fixed-iteration and early-exit form.
//
// Work layout. A block decodes F = 2 frames (one per lane, x) with R = 256
// rows of threads (y): the check step gives a row its checks m = y, y + R,
// ..., the variable step its variables j = y, y + R, .... A warp is 2
// frames x 16 rows, so in the check step it moves 128 contiguous bytes of
// 16 neighbouring checks' messages. The block's state is laid out as the
// large-code kernel's, [slot][frame]:
//   msg  E x F f32       edge messages, rewritten in place by both half-steps
//   r    N x (F+1) f32   -rx, padded stride (transposing loads conflict-free)
//   flags 2F int32       the early-exit form's odd-check flags
//   vh   N x (F+1) int8  hard decisions
// 91.4 KB for the 802.11n code, so two blocks share an SM (S = true: the
// state in shared memory). The slot tables stay in device memory, read
// through the read-only path: slot_var (E) for the check step, and for the
// variable step each variable's slots transposed, var_slots (Wc, N), so a
// warp's 16 neighbouring variables read 64 contiguous bytes, and its degree
// var_deg (N). A code whose state does not fit a block's 227 KB takes the
// same kernel with S = false: the state lives in a workspace in device
// memory that the caller allocates, one stride a block, and a grid of at
// most a few blocks an SM walks over the frame pairs (any code whose
// workspace device memory holds).
//
// The variable step takes a variable's degree D (up to kWcMax = 12) as a
// compile-time constant: a switch over D reaches a step unrolled for it, so
// its D messages stay in registers and no slot is padded. Neighbouring
// variables share their degree in a quasi-cyclic code (81 columns of one
// block column), so a warp takes one case.
//
// What bounds it. The state of two frames is 91 KB, so two blocks an SM
// hold 4 frames and 32 warps; the tables (about 120 KB for 802.11n's code)
// are shared by every block and stay in L1 and L2. Device memory traffic
// is rx read once (4 B a bit) and the decisions written once (1 B). Per
// edge and pass the SPA evaluates log tanh(x/2) twice on the MUFU
// (csrc/sfu.cuh), as the tile kernels do; the min-sum does compares and
// adds. Both are bound by shared-memory wavefronts and the latency of the
// table -> address -> message chains, as the large-code kernels are.
//
// Early exit as the large-code kernel's: the check step of iteration
// it >= 1 also takes each check's parity over the decisions of iteration
// it - 1 (two barriers an iteration); a frame whose checks are all even
// keeps those decisions and stops before this iteration's variable step.
// A block stops when both its frames have. Where a launch is given
// `passes` (while a profiler records), each block adds its passes times F
// into passes[0] and its frames' passes into passes[1] at its end.
//
// Rounding order, shared with the plain versions: the check-row phi sum is
// the pairwise tree of pallas_bp._tree; a variable's sums add its edges in
// ascending slot order starting from 0, then add the base. Built with
// --fmad=false so no product and sum fuse.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "minsum.cuh"   // the min-sum check step, minsum_row
#include "sfu.cuh"      // the SPA check step, its log_tanh_half on the MUFU

namespace {

constexpr int kFrames = 2, kRows = 256;  // frames and rows of threads a block
constexpr int kThreads = kFrames * kRows;
constexpr int kRStride = kFrames + 1;    // row stride of r and vh
constexpr int kWcMax = 12;               // largest column weight taken
constexpr int kWrMin = 2, kWrMax = 8;    // row weights instantiated
constexpr int kGlobalBlocksPerSm = 2;    // grid of the device-memory form
constexpr float kPadBig = 1e30f;         // pallas_bp._BIG on pad slots

// Bytes of one block's state (msg, r, flags, vh), 16-byte aligned.
__host__ __device__ inline long long state_bytes(int M, int N, int Wr) {
  const long long E = (long long)Wr * M;
  const long long b = 4 * (E * kFrames + (long long)N * kRStride + 2 * kFrames)
                      + (long long)N * kRStride;
  return (b + 15) / 16 * 16;
}

// The messages of check m of frame f (CheckRow, csrc/minsum.cuh).
template <int WR>
__device__ __forceinline__ CheckRow<WR> load_check(const float* msg,
                                                   const int* sv,
                                                   const int8_t* vh, int m,
                                                   int M, int f) {
  CheckRow<WR> row;
  row.par = 0;
#pragma unroll
  for (int k = 0; k < WR; ++k) {
    const int e = k * M + m;
    row.j[k] = __ldg(sv + e);
    row.t[k] = row.j[k] >= 0 ? msg[e * kFrames + f] : kPadBig;
    row.par ^= row.j[k] >= 0 ? vh[row.j[k] * kRStride + f] : 0;
  }
  return row;
}

// Variable j of frame f, of degree D: its tentative decision (SPA:
// tot + D*r <= 0; min-sum: r + tot < 0) and/or its next edge messages
// base + (sum over the other edges), base = (D - 1)*r for the SPA and r for
// min-sum; sums in ascending slot order from 0.
template <bool SP, int D>
__device__ __forceinline__ void var_step(float* msg, int8_t* vh,
                                         const float* r, const int* vs,
                                         int j, int N, int f,
                                         bool write_msgs, bool write_vh) {
  float e[D > 0 ? D : 1];
  int s[D > 0 ? D : 1];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    s[k] = __ldg(vs + (long long)k * N + j);
    e[k] = msg[s[k] * kFrames + f];
  }
  const float rj = r[j * kRStride + f];
  if (write_vh) {
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) tot = tot + e[k];
    vh[j * kRStride + f] =
        SP ? (tot + (float)D * rj <= 0.f) : (rj + tot < 0.f);
  }
  if (write_msgs) {
    const float base = SP ? (float)(D - 1) * rj : rj;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i)
        if (i != k) acc = acc + e[i];
      msg[s[k] * kFrames + f] = base + acc;
    }
  }
}

template <bool SP>
__device__ __forceinline__ void var_any(float* msg, int8_t* vh,
                                        const float* r, const int* vs,
                                        const int* deg, int j, int N, int f,
                                        bool write_msgs, bool write_vh) {
#define BPW_CASE(D)                                                          \
  case D:                                                                    \
    var_step<SP, D>(msg, vh, r, vs, j, N, f, write_msgs, write_vh);         \
    break;
  switch (__ldg(deg + j)) {
    BPW_CASE(0) BPW_CASE(1) BPW_CASE(2) BPW_CASE(3) BPW_CASE(4) BPW_CASE(5)
    BPW_CASE(6) BPW_CASE(7) BPW_CASE(8) BPW_CASE(9) BPW_CASE(10)
    BPW_CASE(11) BPW_CASE(12)
  }
#undef BPW_CASE
}

// Adds a block's passes into passes[0] (blk, the passes the block ran,
// times its frames) and passes[1] (its frames' passes, summed). Called by
// the 32 threads of warp 0, lane l giving n, the passes of its frame (0 for
// a thread of row > 0).
__device__ __forceinline__ void add_passes(unsigned long long* passes, int l,
                                           int n, int blk) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  if (l == 0) {
    atomicAdd(passes, (unsigned long long)blk * kFrames);
    atomicAdd(passes + 1, (unsigned long long)n);
  }
}

// S: the state in shared memory (one pair of frames a block), else in
// `work`, a stride of state_bytes a block, the block walking over the pairs
// blockIdx.x, blockIdx.x + gridDim.x, ....
template <int WR, bool SP, bool S>
__global__ void __launch_bounds__(kThreads, 2)
bp_wide(const float* __restrict__ rx, int8_t* __restrict__ out, int B,
        const int* __restrict__ slot_var, const int* __restrict__ var_slots,
        const int* __restrict__ var_deg, int M, int N, int iterations,
        int early_exit, float norm_offset, float norm_scale, int use_offset,
        int use_scale, unsigned char* __restrict__ work,
        unsigned long long* __restrict__ passes) {
  constexpr int F = kFrames, R = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = WR * M;
  unsigned char* base =
      S ? smem : work + (long long)blockIdx.x * state_bytes(M, N, WR);
  float* msg = reinterpret_cast<float*>(base);
  float* r = msg + (long long)E * F;
  int* flags = reinterpret_cast<int*>(r + (long long)N * kRStride);
  int8_t* vh = reinterpret_cast<int8_t*>(flags + 2 * F);

  const int f = threadIdx.x, y = threadIdx.y;
  const int tid = y * F + f;
  const long long pairs = ((long long)B + F - 1) / F;

  for (long long g = blockIdx.x; g < pairs; g += gridDim.x) {
    const long long f0 = g * F;
    for (int i = tid; i < F * N; i += kThreads) {   // coalesced rx rows
      const int ff = i / N, j = i - ff * N;
      const long long fr = f0 + ff;
      r[j * kRStride + ff] = fr < B ? -rx[fr * N + j] : 0.f;
    }
    if (y == 0) flags[f] = flags[F + f] = 0;
    __syncthreads();
    for (int e = y; e < E; e += R) {
      const int j = __ldg(slot_var + e);
      if (j >= 0) msg[e * F + f] = r[j * kRStride + f];
    }
    for (int j = y; j < N; j += R) {   // decision of L = r (iterations = 0)
      const float rj = r[j * kRStride + f];
      vh[j * kRStride + f] = SP ? rj <= 0.f : rj < 0.f;
    }
    __syncthreads();

    // This thread's checks (m = y, y + R, ...) and variables of frame f.
    // With syn, checks() returns whether any of its checks has odd parity
    // over vh.
    auto check = [&](int m, bool syn) {
      if constexpr (SP) {
        return check_sumproduct<WR, F>(msg, slot_var, vh, m, M, f, syn);
      } else {
        const CheckRow<WR> row = load_check<WR>(msg, slot_var, vh, m, M, f);
        minsum_row<WR>(row, norm_offset, norm_scale, use_offset, use_scale,
                       [&](int k, float v) {
                         if (row.j[k] >= 0) msg[(k * M + m) * F + f] = v;
                       });
        return syn ? row.par : 0;
      }
    };
    auto checks = [&](bool syn) {
      int odd = 0;
      for (int m = y; m < M; m += R) odd |= check(m, syn);
      return odd;
    };
    auto vars = [&](bool write_msgs, bool write_vh) {
      for (int j = y; j < N; j += R)
        var_any<SP>(msg, vh, r, var_slots, var_deg, j, N, f, write_msgs,
                    write_vh);
    };

    bool live = f0 + f < B;
    int blk = iterations;   // the passes the block runs
    if (!early_exit) {
      // iterations-1 full steps, then a trailing check step and the decision
      for (int it = 0; it + 1 < iterations; ++it) {
        if (live) checks(false);
        __syncthreads();
        if (live) vars(true, false);
        __syncthreads();
      }
      if (live) {
        if (iterations > 0) {
          checks(false);
        } else {
          for (int e = y; e < E; e += R) msg[e * F + f] = 0.f;
        }
      }
      __syncthreads();
      if (live) vars(false, true);
    } else {
      // The check step of iteration it >= 1 also takes each check's parity
      // over the decisions of iteration it - 1; a frame none of whose
      // checks is odd satisfies H, keeps those decisions and stops before
      // this iteration's variable step. flags[it & 1] gathers a frame's odd
      // checks; the other half is cleared for the next iteration between
      // the two barriers, when no thread reads or writes it. A frame that
      // stops at iteration it ran it passes; its row-0 r, which it no
      // longer reads, keeps that count.
      int it = 0;
      for (; it < iterations; ++it) {
        const bool syn = it > 0;
        const int odd = live ? checks(syn) : 0;
        if (odd) flags[(it & 1) * F + f] = 1;
        if (__syncthreads_and(!live || (syn && !odd))) break;
        if (live && syn && !flags[(it & 1) * F + f]) {
          live = false;
          if (y == 0) r[f] = __int_as_float(it);
        }
        if (y == 0) flags[((it + 1) & 1) * F + f] = 0;
        if (live) vars(true, true);
        __syncthreads();
      }
      blk = it;
    }
    if (passes != nullptr && tid < 32) {   // warp 0: rows 0-15 of lanes
      int ran = 0;                         // frame f's passes
      if (y == 0 && f0 + f < B)
        ran = !early_exit ? iterations : live ? blk : __float_as_int(r[f]);
      add_passes(passes, tid, ran, blk);
    }
    __syncthreads();
    for (int i = tid; i < F * N; i += kThreads) {   // coalesced out rows
      const int ff = i / N, j = i - ff * N;
      const long long fr = f0 + ff;
      if (fr < B) out[fr * N + j] = vh[j * kRStride + ff];
    }
    __syncthreads();   // the next pair rewrites the state
  }
}

template <int WR, bool SP, bool S>
cudaError_t launch(const float* rx, int8_t* out, int B, const int* slot_var,
                   const int* var_slots, const int* var_deg, int M, int N,
                   int iterations, int early_exit, float norm_offset,
                   float norm_scale, int use_offset, int use_scale,
                   unsigned char* work, int grid, cudaStream_t stream,
                   unsigned long long* passes) {
  const long long bytes = state_bytes(M, N, WR);
  int smem = 0;
  if constexpr (S) {
    smem = (int)bytes;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          bp_wide<WR, SP, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return err;
    }
  }
  bp_wide<WR, SP, S><<<grid, dim3(kFrames, kRows), smem, stream>>>(
      rx, out, B, slot_var, var_slots, var_deg, M, N, iterations, early_exit,
      norm_offset, norm_scale, use_offset, use_scale, work, passes);
  return cudaGetLastError();
}

template <bool SP, bool S>
cudaError_t dispatch(int Wr, const float* rx, int8_t* out, int B,
                     const int* slot_var, const int* var_slots,
                     const int* var_deg, int M, int N, int iterations,
                     int early_exit, float norm_offset, float norm_scale,
                     int use_offset, int use_scale, unsigned char* work,
                     int grid, cudaStream_t stream,
                     unsigned long long* passes) {
#define BPW_CASE(W)                                                          \
  case W:                                                                    \
    return launch<W, SP, S>(rx, out, B, slot_var, var_slots, var_deg, M, N, \
                            iterations, early_exit, norm_offset, norm_scale, \
                            use_offset, use_scale, work, grid, stream,       \
                            passes);
  switch (Wr) {
    BPW_CASE(2) BPW_CASE(3) BPW_CASE(4) BPW_CASE(5) BPW_CASE(6) BPW_CASE(7)
    BPW_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef BPW_CASE
}

}  // namespace

extern "C" {

// Bytes of one block's state for this code shape: dynamic shared memory of
// the shared-memory form, the workspace stride a block of the other.
long long bp_wide_state_bytes(int M, int N, int Wr) {
  return state_bytes(M, N, Wr);
}

// Blocks of the device-memory form's grid for B frames on the current
// device: at most kGlobalBlocksPerSm an SM, at most one a pair of frames.
int bp_wide_grid(int B) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const long long pairs = ((long long)B + kFrames - 1) / kFrames;
  const long long most = (long long)sms * kGlobalBlocksPerSm;
  return (int)(pairs < most ? pairs : most);
}

// Launch the min-sum (sumproduct = 0) or sum-product (1) decoder on
// `stream`. rx (B, N) f32 and out (B, N) int8 are row-major device buffers;
// slot_var (E,) int32 is the w-major slot table of ops/layout.py,
// var_slots (Wc, N) int32 each variable's slots ascending (transposed, -1
// pads) and var_deg (N,) int32 their counts. work == NULL: the state in
// shared memory, one block a pair of frames (bp_wide_state_bytes must fit
// a block); else `work` holds grid * bp_wide_state_bytes bytes of device
// memory and `grid` blocks walk over the pairs. passes, where not null, is
// two device counters that each block adds its lane-passes and
// frame-passes into. Returns the launch's cudaError_t; does not synchronise.
int bp_wide_decode(int sumproduct, const float* rx, int8_t* out, int B,
                   const int* slot_var, const int* var_slots,
                   const int* var_deg, int M, int N, int Wr, int Wc,
                   int iterations, int early_exit, float norm_offset,
                   float norm_scale, int use_offset, int use_scale,
                   void* work, int grid, void* stream,
                   unsigned long long* passes) {
  if (B <= 0 || iterations < 0 || Wc < 1 || Wc > kWcMax || Wr < kWrMin ||
      Wr > kWrMax)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(work);
  if (w == nullptr) {
    const long long pairs = ((long long)B + kFrames - 1) / kFrames;
    if (pairs > 0x7fffffffLL) return cudaErrorInvalidValue;
    grid = (int)pairs;
    return sumproduct
               ? dispatch<true, true>(Wr, rx, out, B, slot_var, var_slots,
                                      var_deg, M, N, iterations, early_exit,
                                      norm_offset, norm_scale, use_offset,
                                      use_scale, w, grid, s, passes)
               : dispatch<false, true>(Wr, rx, out, B, slot_var, var_slots,
                                       var_deg, M, N, iterations, early_exit,
                                       norm_offset, norm_scale, use_offset,
                                       use_scale, w, grid, s, passes);
  }
  if (grid <= 0) return cudaErrorInvalidValue;
  return sumproduct
             ? dispatch<true, false>(Wr, rx, out, B, slot_var, var_slots,
                                     var_deg, M, N, iterations, early_exit,
                                     norm_offset, norm_scale, use_offset,
                                     use_scale, w, grid, s, passes)
             : dispatch<false, false>(Wr, rx, out, B, slot_var, var_slots,
                                      var_deg, M, N, iterations, early_exit,
                                      norm_offset, norm_scale, use_offset,
                                      use_scale, w, grid, s, passes);
}

const char* bp_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
