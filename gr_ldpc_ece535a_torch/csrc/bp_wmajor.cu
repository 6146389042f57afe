// Belief-propagation decoders for Hopper (sm_90a) over the w-major edge layout.
//
// Replaces, in gr_ldpc_ece535a_tpu/ops/pallas_bp.py:
//   bp_kernel<WR, true, 32, 8>    <- _sumproduct_fast_kernel  (tanh-rule SPA, phi domain)
//   bp_minsum_pairs<WR>           <- _minsum_fast_kernel      (min-sum, sign(0) zeroes the row)
//   bp_kernel<WR, true, 16, 64>   <- _sumproduct_split_kernel (the same SPA, large codes)
//   bp_kernel<WR, false, 16, 64>  <- _minsum_split_kernel     (the same min-sum, large codes)
// each in its fixed-iteration and early-exit form. The plain PyTorch versions
// of the same functions are in ops/cuda_bp.py and round in the same order.
//
// What the TPU kernels compute, not how: on the TPU the check->variable
// aggregation is a one-hot (E, E) Gram matmul on the bf16 MXU (hence the
// hi/lo "precise" split). Here every aggregation is a 1-3 term f32 sum read
// through index tables, so "precise" and "fast" are the same arithmetic.
//
// Work layout. A block decodes F frames (one per lane, x) with R rows of
// threads (y) sharing the checks and variables of those frames. The block's
// whole BP state stays in shared memory for all iterations, laid out
// [slot][frame] so that the lanes of a warp touch distinct banks:
//   msg  E x F f32       edge messages, rewritten in place by both half-steps
//   r    N x (F+1) f32   -rx, padded stride (transposing loads stay conflict-free)
//   vh   N x (F+1) int8  hard decisions
// plus the slot tables and per-frame flags. rx is read once, coalesced, and
// only the int8 decisions are written back.
//
// Two tiles. The tile kernel (F = 32, R = 8) takes 36.9 KB for block_32_64
// (E = 192, N = 64) and 56 KB for sim_50_100; the tile min-sum keeps its
// layout with 16 lanes of two frames and 16 rows (below). The large-code kernel
// (F = 16) halves the frames so that codes up to E ~ 2000 fit one
// block's 227 KB: 154 KB for gen_256_512 (E = 1536), 192 KB for gen_320_640
// (E = 1920). It runs one block per SM, of 64 rows (1,024 threads, 32
// warps). A warp is 16 frames x 2 rows: in the check step its two rows take
// neighbouring checks, so msg[e*16 + f] hits 32 distinct banks; in the
// variable step the two rows' slots are unrelated and collide in one bank
// pair when their slot indices have equal parity (a 2-way conflict on about
// half the reads; a build without it was no faster, tools/occupancy.py).
// The TPU's split form bcm^T (bcm x) - x existed only because the (E, E)
// Gram did not fit VMEM; the gather form here has no Gram, so the large
// kernel is the same arithmetic as the tile kernel, in a smaller tile.
//
// What bounds it. Global memory traffic is 256 B in and 64 B out per frame
// per decode, so neither kernel is bound by HBM. Per real edge and
// iteration the sum-product evaluates log tanh(x/2) twice. With libm's
// logf(tanhf(.)) that was 45 SASS instructions with 2 on the special-function
// unit (MUFU), and instruction issue bound the check step: 69% of the
// kernel. log_tanh_half (csrc/sfu.cuh, with the check step itself, which
// the kernel study shares) moves the work onto the MUFU, which stood mostly
// idle: 11 instructions, 3 of them MUFU (ex2, rcp, lg2), so the check
// step's issue (phi and the rest of the step) about meets the MUFU's 16
// results a clock an SM, and the check step now costs about the MUFU's
// time. Its error stays under max(2^-16 |phi|, 2^-20); the kernels keep the
// precise contracts against their IEEE plain versions, but for a few frames
// on the large codes at 1-2 dB that the same algorithm in IEEE f32 decides
// as the kernel does (ops/cuda_bp.py).
// Min-sum does only compares (its check step, minsum_row, is in
// csrc/minsum.cuh, which the min-sum kernel study shares); its
// load-compute-store skeleton bounds it, and the latency of its
// shared-memory loads: a table read heads each
// chain (table -> address -> message), and a warp reads one slot table
// entry for 32 frames. The tile min-sum therefore takes two frames a
// thread (bp_minsum_pairs): each message a float2, so one table read,
// address and loop step serve two frames; a warp (two rows of 16 lanes)
// still moves 256 bytes a slot in two wavefronts without a conflict.
// block_32_64 131,072 x 20 at 4 dB on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/kernel_times.py, parent and change in one run): 0.920 -> 0.850 ms
// fixed, 0.677 -> 0.596 early exit, and the sim_50_100 sweep step's decode
// 0.491 -> 0.432 ms; 64 registers, 4 blocks of 8 warps an SM. Measured on
// the same card and not shipped (tools/tile_probe.py): the thread's rows
// (slots, -rx) in registers for the whole decode, one frame a thread: its
// addresses held there took 126 registers and 2 blocks (1.48 ms), made
// opaque each iteration 1.04x the table route's time at block_32_64 and
// 1.14x at sim_50_100; with two frames it won 0.8% fixed and 1.7% early
// exit at block_32_64 and lost 4% at sim_50_100, not worth its code. The
// slot tables in the constant bank (a __grid_constant__ parameter, read by
// broadcast): 1.05-1.24x. 8 rows of two-frame threads: 0.847 ms at
// block_32_64 but 1.19-1.69x on larger codes; ptxas held to 5 or 6 blocks
// an SM (spilling): 1.03-1.13x. Tensor cores do not apply (no
// product is left: the TPU's one-hot matmuls became 1-3 term f32 sums
// through the tables), nor TMA (rx is read once, 8 KB a block), nor
// clusters (blocks share nothing).
// Every operand stays on chip; the tile SPA's 48 registers a thread fit 5
// blocks of 8 warps an SM. The large-code block's shared memory holds it
// to one block an SM, where 16 warps hid too little latency: with 32 rows
// the large SPA took 1.27x and the large min-sum 1.13x as long as with 64
// (tools/occupancy.py).
// The early-exit form takes the syndrome of each iteration's decisions; the
// large-code kernels take it in the next check step, beside the loads that
// step makes anyway, so it costs no barrier of its own (see the kernel).
// On an NVIDIA H100 80GB HBM3 at 700 W: block_32_64 131,072 frames x 20
// iterations 1.367 ms (sum-product; 2.213 with libm's phi) and 0.850 ms
// (min-sum; 0.920 one frame a thread); gen_256_512 16,384 x 20 1.61 ms
// (sum-product; 2.973 with libm's phi and 32 rows) and 1.05 ms (min-sum;
// 1.21 with 32 rows), and a sweep step's decode at 1-2 dB (131,072 frames,
// early exit) 14.0 ms (sum-product; 14.6 with the syndrome's own pass) and
// 9.5 ms (min-sum; 10.8 with 32 rows and the syndrome's own pass). Two
// costs of this design: a code that fits the tile but is sent to the
// large-code kernels (impl="split"; no "auto" route does so) gets one block
// of 32 warps an SM where two of 16 fitted, 2.35 ms against 1.65 on
// block_32_64 (SPA; min-sum 1.56 against 0.86); and ptxas holds the tile
// SPA to 48 registers with a spill, 4 B at WR = 6 and 20 B at WR = 7, where
// the libm form spilled none.
//
// Lane use under early exit. A block runs until its slowest frame stops; a
// frame that stopped earlier leaves its threads idle for the rest. Where a
// launch is given `passes` (while a profiler records), each block adds, with
// one atomic each at its end, the passes it ran times its frames into
// passes[0] and the passes its frames ran while live, summed, into passes[1]
// (frames past B count none). Nothing is counted in the loops: the block's
// passes are the loop's index where it stops, and a frame's the pass its
// stop store records (the tile forms' done flag holds the pass; the
// large-code form writes it into the frame's first r, which a stopped frame
// no longer reads), read once the loops end. So one instance serves the
// traced and untraced launches alike, with one null test at its end.
//
// Rounding order, shared with the plain versions: the check-row phi sum is
// the pairwise tree of pallas_bp._tree (Wr = 6: ((x0+x3)+(x1+x4))+(x2+x5));
// a variable's sums add its edges in ascending slot order starting from 0,
// then add the base. Built with --fmad=false so no product and sum fuse.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "minsum.cuh"   // the min-sum check step, minsum_row
#include "sfu.cuh"      // the SPA check step, its log_tanh_half on the MUFU

namespace {

constexpr int kTileFrames = 32, kTileRows = 8;     // tile kernel
constexpr int kPairRows = 16;    // tile min-sum: rows of two-frame threads
// large-code kernel: 16 frames and 64 rows of threads (32 warps), since its
// one block an SM hid too little latency with 16 warps
constexpr int kLargeFrames = 16, kLargeRows = 64;
constexpr int kWcMax = 4;                // largest column weight taken
constexpr int kWrMin = 2, kWrMax = 8;    // row weights instantiated
constexpr float kPadBig = 1e30f;         // pallas_bp._BIG on pad slots

// The messages of check m (CheckRow, csrc/minsum.cuh).
template <int WR, int F>
__device__ __forceinline__ CheckRow<WR> load_check(const float* msg,
                                                   const int* sv,
                                                   const int8_t* vh, int m,
                                                   int M, int f) {
  CheckRow<WR> row;
  row.par = 0;
#pragma unroll
  for (int k = 0; k < WR; ++k) {
    const int e = k * M + m;
    row.j[k] = sv[e];
    row.t[k] = row.j[k] >= 0 ? msg[e * F + f] : kPadBig;
    row.par ^= row.j[k] >= 0 ? vh[row.j[k] * (F + 1) + f] : 0;
  }
  return row;
}

// Min-sum check step on a loaded row, in place: Lq -> Lr (minsum_row).
// With syn, returns the row's parity over the decisions vh, else 0.
template <int WR, int F>
__device__ __forceinline__ int check_minsum(float* msg,
                                            const CheckRow<WR>& row, int m,
                                            int M, int f, bool syn,
                                            float norm_offset,
                                            float norm_scale, int use_offset,
                                            int use_scale) {
  minsum_row<WR>(row, norm_offset, norm_scale, use_offset, use_scale,
                 [&](int k, float v) {
                   if (row.j[k] >= 0) msg[(k * M + m) * F + f] = v;
                 });
  return syn ? row.par : 0;
}

// The check messages of variable j's edges (pads read 0), their slots and
// -rx, loaded apart from the arithmetic as CheckRow is.
struct VarRow {
  float rj;
  float e[kWcMax];
  int s[kWcMax];
};

template <int F>
__device__ __forceinline__ VarRow load_var(const float* msg, const float* r,
                                           const int* vs, int j, int Wc,
                                           int f) {
  VarRow v;
  v.rj = r[j * (F + 1) + f];
#pragma unroll
  for (int k = 0; k < kWcMax; ++k) {
    v.s[k] = k < Wc ? vs[j * Wc + k] : -1;
    v.e[k] = v.s[k] >= 0 ? msg[v.s[k] * F + f] : 0.f;
  }
  return v;
}

// Variable step for variable j of frame f on its loaded row. Writes the
// tentative decision (SPA: tot + deg*r <= 0; min-sum: r + tot < 0) and/or
// the next edge messages base + (sum over the other edges), base =
// (deg - 1)*r for the SPA and r for min-sum.
template <bool SP, int F>
__device__ __forceinline__ void var_step(float* msg, int8_t* vh,
                                         const VarRow& v, int j, int Wc,
                                         int f, bool write_msgs,
                                         bool write_vh) {
  int d = 0;
#pragma unroll
  for (int k = 0; k < kWcMax; ++k) d += v.s[k] >= 0;
  if (write_vh) {
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < kWcMax; ++k)
      if (k < Wc) tot = tot + v.e[k];
    vh[j * (F + 1) + f] =
        SP ? (tot + (float)d * v.rj <= 0.f) : (v.rj + tot < 0.f);
  }
  if (write_msgs) {
    const float base = SP ? (float)(d - 1) * v.rj : v.rj;
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) {
      if (v.s[k] < 0) continue;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kWcMax; ++i)
        if (i != k && i < Wc) acc = acc + v.e[i];
      msg[v.s[k] * F + f] = base + acc;
    }
  }
}

// Adds a block's passes into passes[0] (blk, the passes the block ran,
// times its F frames) and passes[1] (its frames' passes, summed). Called by
// the 32 threads of warp 0, lane l giving n, the passes of its frames (0 for
// a lane whose frames another lane gives).
template <int F>
__device__ __forceinline__ void add_passes(unsigned long long* passes, int l,
                                           int n, int blk) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  if (l == 0) {
    atomicAdd(passes, (unsigned long long)blk * F);
    atomicAdd(passes + 1, (unsigned long long)n);
  }
}

template <int F>
__host__ __device__ inline int smem_bytes(int M, int N, int Wr, int Wc) {
  const int E = Wr * M;
  return 4 * (E * F + N * (F + 1) + E + N * Wc + 2 * F) + N * (F + 1);
}

// The large-code block fills an SM's shared memory, so it runs one block per
// SM; saying so (min blocks 1) lets ptxas use the registers that frees and
// removes the min-sum WR=5 spill. The tile kernel keeps ptxas's default.
// passes: where not null, add the block's passes (see "Lane use" above).
template <int WR, bool SP, int F, int R>
__global__ void __launch_bounds__(F * R, F == kLargeFrames ? 1 : 0)
bp_kernel(const float* __restrict__ rx, int8_t* __restrict__ out, int B,
          const int* __restrict__ slot_var, const int* __restrict__ var_slots,
          int M, int N, int Wc, int iterations, int early_exit,
          float norm_offset, float norm_scale, int use_offset, int use_scale,
          unsigned long long* __restrict__ passes) {
  constexpr int kThreads = F * R;
  constexpr int kRStride = F + 1;         // row stride of r and vh
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = WR * M;
  float* msg = reinterpret_cast<float*>(smem);
  float* r = msg + E * F;
  int* sv = reinterpret_cast<int*>(r + N * kRStride);
  int* vs = sv + E;
  int* flags = vs + N * Wc;     // 2F per-frame flags of the early-exit form
  int8_t* vh = reinterpret_cast<int8_t*>(flags + 2 * F);

  const int f = threadIdx.x, y = threadIdx.y;
  const int tid = y * F + f;
  const long long f0 = (long long)blockIdx.x * F;

  for (int i = tid; i < E; i += kThreads) sv[i] = slot_var[i];
  for (int i = tid; i < N * Wc; i += kThreads) vs[i] = var_slots[i];
  for (int i = tid; i < F * N; i += kThreads) {   // coalesced rx rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    r[j * kRStride + ff] = g < B ? -rx[g * N + j] : 0.f;
  }
  // the tile loop's unsat and done flags (the large-code loop clears its own);
  // frames past B count as done from the start (pallas_bp._pad_done)
  if (y == 0) {
    flags[f] = 0;
    flags[F + f] = f0 + f >= B;
  }
  __syncthreads();
  for (int e = y; e < E; e += R) {
    const int j = sv[e];
    if (j >= 0) msg[e * F + f] = r[j * kRStride + f];
  }
  for (int j = y; j < N; j += R) {   // decision of L = r (iterations = 0)
    const float rj = r[j * kRStride + f];
    vh[j * kRStride + f] = SP ? rj <= 0.f : rj < 0.f;
  }
  __syncthreads();

  // This thread's checks (m = y, y + R, ...) and variables of frame f. With
  // syn, checks() returns whether any of its checks has odd parity over vh.
  auto check = [&](int m, bool syn) {
    if constexpr (SP) {
      return check_sumproduct<WR, F>(msg, sv, vh, m, M, f, syn);
    } else {
      return check_minsum<WR, F>(msg, load_check<WR, F>(msg, sv, vh, m, M, f),
                                 m, M, f, syn, norm_offset, norm_scale,
                                 use_offset, use_scale);
    }
  };
  auto checks = [&](bool syn) {
    int odd = 0;
    for (int m = y; m < M; m += R) odd |= check(m, syn);
    return odd;
  };
  auto vars = [&](bool write_msgs, bool write_vh) {
    for (int j = y; j < N; j += R)
      var_step<SP, F>(msg, vh, load_var<F>(msg, r, vs, j, Wc, f), j, Wc, f,
                      write_msgs, write_vh);
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
  } else if constexpr (F == kLargeFrames) {
    // The large-code blocks run nearly all their iterations at the sweep's
    // 1-2 dB, so here the syndrome costs no barrier of its own: two barriers
    // an iteration. The check step of iteration it >= 1 also takes each
    // check's parity over the decisions of iteration it - 1; a frame none
    // of whose checks is odd satisfies H, keeps those decisions and stops
    // before this iteration's variable step, which writes the next messages
    // and decisions. flags[it & 1] gathers a frame's odd checks; the other
    // half is cleared for the next iteration between the two barriers, when
    // no thread reads or writes it. The block stops when all its frames
    // have, one check step after the last one satisfied H: where blocks stop
    // early (the tile at 4 dB) that step costs more than the barriers save.
    // A frame that stops at iteration it ran it passes; its row-0 r, which
    // it no longer reads, keeps that count.
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
  } else {
    // each iteration: check step, tentative decision, syndrome over all M
    // checks; a frame that satisfies H keeps that decision and stops. The
    // block stops when all its frames have.
    // done[f]: 0 while frame f runs, then the passes it ran (1 from the
    // start for a frame past B)
    int* unsat = flags;
    int* done = flags + F;
    int it = 0;
    for (; it < iterations; ++it) {
      if (__syncthreads_and(done[f])) break;
      live = !done[f];
      if (y == 0) unsat[f] = 0;
      if (live) checks(false);
      __syncthreads();
      if (live) vars(true, true);
      __syncthreads();
      if (live) {
        for (int m = y; m < M; m += R) {
          int par = 0;
#pragma unroll
          for (int k = 0; k < WR; ++k) {
            const int j = sv[k * M + m];
            if (j >= 0) par ^= vh[j * kRStride + f];
          }
          if (par) unsat[f] = 1;
        }
      }
      __syncthreads();
      if (y == 0 && live && !unsat[f]) done[f] = it + 1;
    }
    blk = it;
  }
  if (passes != nullptr && tid < 32) {   // warp 0: rows 0 (and 1) of lanes
    int ran = 0;                         // frame f's passes
    if (y == 0 && f0 + f < B) {
      if (!early_exit)
        ran = iterations;
      else if constexpr (F == kLargeFrames)
        ran = live ? blk : __float_as_int(r[f]);
      else
        ran = flags[F + f] ? flags[F + f] : blk;
    }
    add_passes<F>(passes, tid, ran, blk);
  }
  __syncthreads();
  for (int i = tid; i < F * N; i += kThreads) {   // coalesced out rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    if (g < B) out[g * N + j] = vh[j * kRStride + ff];
  }
}

// The tile min-sum, two frames a thread: a block of 32 frames has 16 lanes
// of two frames (f2 = 2 * lane, f2 + 1) and kPairRows rows of threads. A
// message moves as one float2, so a warp (two rows of 16 lanes) reads and
// writes 256 contiguous bytes of one slot pair in the check step, or two
// rows' 128 bytes in the variable step: two wavefronts, no conflict, as two
// one-frame warps would take. Each table read, address, loop step and
// barrier is paid once for two frames. The arithmetic is check_minsum's
// and var_step's, frame by frame; a frame that is done (early exit) or past
// B keeps its messages and decision, its half of each float2 written back
// unchanged.
template <int WR>
__global__ void __launch_bounds__(kTileFrames / 2 * kPairRows)
bp_minsum_pairs(const float* __restrict__ rx, int8_t* __restrict__ out,
                int B, const int* __restrict__ slot_var,
                const int* __restrict__ var_slots, int M, int N, int Wc,
                int iterations, int early_exit, float norm_offset,
                float norm_scale, int use_offset, int use_scale,
                unsigned long long* __restrict__ passes) {
  constexpr int F = kTileFrames, R = kPairRows, L = F / 2;
  constexpr int kThreads = L * R, kRStride = F + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = WR * M;
  float* msg = reinterpret_cast<float*>(smem);
  float* r = msg + E * F;
  int* sv = reinterpret_cast<int*>(r + N * kRStride);
  int* vs = sv + E;
  int* flags = vs + N * Wc;     // 2F per-frame flags of the early-exit form
  int8_t* vh = reinterpret_cast<int8_t*>(flags + 2 * F);

  const int x = threadIdx.x, y = threadIdx.y, tid = y * L + x;
  const int f2 = 2 * x;         // this thread's frames f2 and f2 + 1
  const long long f0 = (long long)blockIdx.x * F;

  for (int i = tid; i < E; i += kThreads) sv[i] = slot_var[i];
  for (int i = tid; i < N * Wc; i += kThreads) vs[i] = var_slots[i];
  for (int i = tid; i < F * N; i += kThreads) {   // coalesced rx rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    r[j * kRStride + ff] = g < B ? -rx[g * N + j] : 0.f;
  }
  // unsat and done flags; frames past B count as done from the start
  if (y == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      flags[f2 + h] = 0;
      flags[F + f2 + h] = f0 + f2 + h >= B;
    }
  }
  __syncthreads();
  for (int e = y; e < E; e += R) {
    const int j = sv[e];
    if (j >= 0)
      *reinterpret_cast<float2*>(&msg[e * F + f2]) =
          make_float2(r[j * kRStride + f2], r[j * kRStride + f2 + 1]);
  }
  for (int j = y; j < N; j += R) {   // decision of L = r (iterations = 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      vh[j * kRStride + f2 + h] = r[j * kRStride + f2 + h] < 0.f;
  }
  __syncthreads();

  // live[h]: frame f2 + h decodes; a frame that does not keeps its values
  auto check = [&](const bool (&live)[2], int m) {
    CheckRow<WR> a, b;
    a.par = b.par = 0;
#pragma unroll
    for (int k = 0; k < WR; ++k) {
      const bool real = sv[k * M + m] >= 0;
      a.j[k] = b.j[k] = real ? 0 : -1;
      const float2 t =
          real ? *reinterpret_cast<const float2*>(&msg[(k * M + m) * F + f2])
               : make_float2(kPadBig, kPadBig);
      a.t[k] = t.x;
      b.t[k] = t.y;
    }
    float va[WR], vb[WR];
    minsum_row<WR>(a, norm_offset, norm_scale, use_offset, use_scale,
                   [&](int k, float v) { va[k] = v; });
    minsum_row<WR>(b, norm_offset, norm_scale, use_offset, use_scale,
                   [&](int k, float v) { vb[k] = v; });
#pragma unroll
    for (int k = 0; k < WR; ++k)
      if (a.j[k] >= 0)
        *reinterpret_cast<float2*>(&msg[(k * M + m) * F + f2]) =
            make_float2(live[0] ? va[k] : a.t[k], live[1] ? vb[k] : b.t[k]);
  };
  auto checks = [&](const bool (&live)[2]) {
    for (int m = y; m < M; m += R) check(live, m);
  };
  // variable j: the min-sum's decision r + tot < 0 and next messages
  // r + (sum over the other edges), as var_step, for both frames at once
  auto var = [&](const bool (&live)[2], bool write_msgs, bool write_vh,
                 int j) {
    float ea[kWcMax], eb[kWcMax];
    int s[kWcMax];
#pragma unroll
    for (int k = 0; k < kWcMax; ++k) {
      s[k] = k < Wc ? vs[j * Wc + k] : -1;
      const float2 e =
          s[k] >= 0 ? *reinterpret_cast<const float2*>(&msg[s[k] * F + f2])
                    : make_float2(0.f, 0.f);
      ea[k] = e.x;
      eb[k] = e.y;
    }
    const float ra = r[j * kRStride + f2], rb = r[j * kRStride + f2 + 1];
    if (write_vh) {
      float ta = 0.f, tb = 0.f;
#pragma unroll
      for (int k = 0; k < kWcMax; ++k)
        if (k < Wc) {
          ta = ta + ea[k];
          tb = tb + eb[k];
        }
      if (live[0]) vh[j * kRStride + f2] = ra + ta < 0.f;
      if (live[1]) vh[j * kRStride + f2 + 1] = rb + tb < 0.f;
    }
    if (write_msgs) {
#pragma unroll
      for (int k = 0; k < kWcMax; ++k) {
        if (s[k] < 0) continue;
        float aa = 0.f, ab = 0.f;
#pragma unroll
        for (int q = 0; q < kWcMax; ++q)
          if (q != k && q < Wc) {
            aa = aa + ea[q];
            ab = ab + eb[q];
          }
        *reinterpret_cast<float2*>(&msg[s[k] * F + f2]) = make_float2(
            live[0] ? ra + aa : ea[k], live[1] ? rb + ab : eb[k]);
      }
    }
  };
  auto vars = [&](const bool (&live)[2], bool write_msgs, bool write_vh) {
    for (int j = y; j < N; j += R) var(live, write_msgs, write_vh, j);
  };

  int blk = iterations;   // the passes the block runs
  if (!early_exit) {
    // iterations-1 full steps, then a trailing check step and the decision
    const bool live[2] = {f0 + f2 < B, f0 + f2 + 1 < B};
    for (int it = 0; it + 1 < iterations; ++it) {
      checks(live);
      __syncthreads();
      vars(live, true, false);
      __syncthreads();
    }
    if (iterations > 0) {
      checks(live);
    } else {
      for (int e = y; e < E; e += R)
        *reinterpret_cast<float2*>(&msg[e * F + f2]) = make_float2(0.f, 0.f);
    }
    __syncthreads();
    vars(live, false, true);
  } else {
    // each iteration: check step, tentative decision, syndrome over all M
    // checks; a frame that satisfies H keeps that decision and stops. The
    // block stops when all its frames have.
    // done[f]: 0 while frame f runs, then the passes it ran (1 from the
    // start for a frame past B)
    int* unsat = flags;
    int* done = flags + F;
    int it = 0;
    for (; it < iterations; ++it) {
      if (__syncthreads_and(done[f2] && done[f2 + 1])) break;
      const bool live[2] = {!done[f2], !done[f2 + 1]};
      if (y == 0) unsat[f2] = unsat[f2 + 1] = 0;
      checks(live);
      __syncthreads();
      vars(live, true, true);
      __syncthreads();
      for (int m = y; m < M; m += R) {
        int pa = 0, pb = 0;
#pragma unroll
        for (int k = 0; k < WR; ++k) {
          const int j = sv[k * M + m];
          if (j >= 0) {
            pa ^= vh[j * kRStride + f2];
            pb ^= vh[j * kRStride + f2 + 1];
          }
        }
        if (live[0] && pa) unsat[f2] = 1;
        if (live[1] && pb) unsat[f2 + 1] = 1;
      }
      __syncthreads();
      if (y == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (live[h] && !unsat[f2 + h]) done[f2 + h] = it + 1;
      }
    }
    blk = it;
  }
  if (passes != nullptr && tid < 32) {   // warp 0: rows 0 and 1 of lanes
    int ran = 0;                         // frames f2's and f2 + 1's passes
    if (y == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int done = flags[F + f2 + h];
        if (f0 + f2 + h < B) ran += !early_exit ? iterations
                                    : done ? done : blk;
      }
    }
    add_passes<F>(passes, tid, ran, blk);
  }
  __syncthreads();
  for (int i = tid; i < F * N; i += kThreads) {   // coalesced out rows
    const int ff = i / N, j = i - ff * N;
    const long long g = f0 + ff;
    if (g < B) out[g * N + j] = vh[j * kRStride + ff];
  }
}

// The kernel a launch of (WR, SP, F, R) takes, and its block: the tile
// min-sum is bp_minsum_pairs, 16 lanes of two frames and kPairRows rows;
// every other kernel bp_kernel, F lanes and R rows.
template <int WR, bool SP, int F, int R>
struct Kernel {
  static constexpr bool kPairs = !SP && F == kTileFrames;
  static const void* fn() {
    if constexpr (kPairs)
      return (const void*)bp_minsum_pairs<WR>;
    else
      return (const void*)bp_kernel<WR, SP, F, R>;
  }
  static dim3 block() {
    return kPairs ? dim3(F / 2, kPairRows) : dim3(F, R);
  }
};

template <int WR, bool SP, int F, int R>
cudaError_t launch(const float* rx, int8_t* out, int B, const int* slot_var,
                   const int* var_slots, int M, int N, int Wc, int iterations,
                   int early_exit, float norm_offset, float norm_scale,
                   int use_offset, int use_scale, cudaStream_t stream,
                   unsigned long long* passes) {
  using K = Kernel<WR, SP, F, R>;
  const int smem = smem_bytes<F>(M, N, WR, Wc);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((B + F - 1) / F));
  if constexpr (K::kPairs)
    bp_minsum_pairs<WR><<<grid, K::block(), smem, stream>>>(
        rx, out, B, slot_var, var_slots, M, N, Wc, iterations, early_exit,
        norm_offset, norm_scale, use_offset, use_scale, passes);
  else
    bp_kernel<WR, SP, F, R><<<grid, K::block(), smem, stream>>>(
        rx, out, B, slot_var, var_slots, M, N, Wc, iterations, early_exit,
        norm_offset, norm_scale, use_offset, use_scale, passes);
  return cudaGetLastError();
}

template <bool SP, int F, int R>
cudaError_t dispatch(int Wr, const float* rx, int8_t* out, int B,
                     const int* slot_var, const int* var_slots, int M, int N,
                     int Wc, int iterations, int early_exit, float norm_offset,
                     float norm_scale, int use_offset, int use_scale,
                     cudaStream_t stream, unsigned long long* passes) {
#define BP_CASE(W)                                                            \
  case W:                                                                     \
    return launch<W, SP, F, R>(rx, out, B, slot_var, var_slots, M, N, Wc,     \
                               iterations, early_exit, norm_offset,           \
                               norm_scale, use_offset, use_scale, stream,     \
                               passes);
  switch (Wr) {
    BP_CASE(2) BP_CASE(3) BP_CASE(4) BP_CASE(5) BP_CASE(6) BP_CASE(7)
    BP_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef BP_CASE
}

template <int F, int R>
int decode(int sumproduct, const float* rx, int8_t* out, int B,
           const int* slot_var, const int* var_slots, int M, int N, int Wr,
           int Wc, int iterations, int early_exit, float norm_offset,
           float norm_scale, int use_offset, int use_scale, void* stream,
           unsigned long long* passes) {
  if (B <= 0 || iterations < 0 || Wc < 1 || Wc > kWcMax || Wr < kWrMin ||
      Wr > kWrMax)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sumproduct
             ? dispatch<true, F, R>(Wr, rx, out, B, slot_var, var_slots, M,
                                    N, Wc, iterations, early_exit,
                                    norm_offset, norm_scale, use_offset,
                                    use_scale, s, passes)
             : dispatch<false, F, R>(Wr, rx, out, B, slot_var, var_slots, M,
                                     N, Wc, iterations, early_exit,
                                     norm_offset, norm_scale, use_offset,
                                     use_scale, s, passes);
}

// y = log_tanh_half(x), elementwise: the check step's function alone, for
// holding it against float64 and for counting its instructions.
__global__ void phi_probe_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = log_tanh_half(x[i]);
}

template <int F, int R>
int occupancy(int sumproduct, int Wr, int smem, int* blocks, int* threads) {
  const void* fn = nullptr;
  dim3 block;
#define BP_FN(W)                                                              \
  case W:                                                                     \
    fn = sumproduct ? Kernel<W, true, F, R>::fn()                             \
                    : Kernel<W, false, F, R>::fn();                           \
    block = sumproduct ? Kernel<W, true, F, R>::block()                       \
                       : Kernel<W, false, F, R>::block();                     \
    break;
  switch (Wr) {
    BP_FN(2) BP_FN(3) BP_FN(4) BP_FN(5) BP_FN(6) BP_FN(7) BP_FN(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef BP_FN
  *threads = block.x * block.y;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, *threads,
                                                        smem);
  // a query's error must not surface as the next launch's cudaGetLastError
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" {

// y (n,) = log tanh(x/2) by the check step's log_tanh_half, for device
// buffers x and y on `stream`. Returns the launch's cudaError_t.
int bp_phi_probe(const float* x, float* y, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  phi_probe_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return cudaGetLastError();
}

// Blocks of the tile (large = 0) or large-code (1) kernel that fit one SM
// at `smem` bytes of dynamic shared memory, into *blocks, and the threads
// of one block, into *threads.
int bp_occupancy(int large, int sumproduct, int Wr, int smem, int* blocks,
                 int* threads) {
  return large ? occupancy<kLargeFrames, kLargeRows>(sumproduct, Wr, smem,
                                                     blocks, threads)
               : occupancy<kTileFrames, kTileRows>(sumproduct, Wr, smem,
                                                   blocks, threads);
}

// Shared memory one block of the tile (bp_smem_bytes) or large-code
// (bp_large_smem_bytes) kernel needs for this code shape, in bytes.
int bp_smem_bytes(int M, int N, int Wr, int Wc) {
  return smem_bytes<kTileFrames>(M, N, Wr, Wc);
}
int bp_large_smem_bytes(int M, int N, int Wr, int Wc) {
  return smem_bytes<kLargeFrames>(M, N, Wr, Wc);
}

// Launch the min-sum (sumproduct = 0) or sum-product (1) decoder on
// `stream`, with the tile (bp_decode) or large-code (bp_decode_large)
// kernel. rx (B, N) f32 and out (B, N) int8 are row-major device buffers;
// slot_var (E,) and var_slots (N, Wc) are the int32 w-major tables of
// ops/layout.py. passes, where not null, is two device counters that each
// block adds its lane-passes and frame-passes into (see "Lane use" above).
// Returns the launch's cudaError_t; does not synchronise.
int bp_decode(int sumproduct, const float* rx, int8_t* out, int B,
              const int* slot_var, const int* var_slots, int M, int N, int Wr,
              int Wc, int iterations, int early_exit, float norm_offset,
              float norm_scale, int use_offset, int use_scale, void* stream,
              unsigned long long* passes) {
  return decode<kTileFrames, kTileRows>(
      sumproduct, rx, out, B, slot_var, var_slots, M, N, Wr, Wc, iterations,
      early_exit, norm_offset, norm_scale, use_offset, use_scale, stream,
      passes);
}
int bp_decode_large(int sumproduct, const float* rx, int8_t* out, int B,
                    const int* slot_var, const int* var_slots, int M, int N,
                    int Wr, int Wc, int iterations, int early_exit,
                    float norm_offset, float norm_scale, int use_offset,
                    int use_scale, void* stream, unsigned long long* passes) {
  return decode<kLargeFrames, kLargeRows>(
      sumproduct, rx, out, B, slot_var, var_slots, M, N, Wr, Wc, iterations,
      early_exit, norm_offset, norm_scale, use_offset, use_scale, stream,
      passes);
}

const char* bp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
