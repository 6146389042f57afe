// The streaming receive blocks' two per-sample feedback loops, hand-written
// for Hopper (sm_90a): the AGC, as a parallel affine scan (agc_scan_*) with
// a serial route for the inputs the scan does not take (agc_loop_kernel),
// and the second-order BPSK Costas loop (costas_loop_kernel).
//
// Neither replaces a TPU kernel: the JAX package runs both as lax.scan
// recurrences (gr_ldpc_ece535a_tpu/ops/dsp.py:113 agc, :130 costas_loop).
// No PyTorch call computes a nonlinear per-sample feedback loop, and a
// Python loop over the samples on the card is a launch per operation and
// sample, so a kernel is the only way the blocks run these loops on the
// card.
//
// The AGC. Its step y = x*g; g += r*(ref - |y|) is linear in g while g >= 0:
// |y| = g*|x|, so g' = g*(1 - r|x|) + r*ref. Where g0, r and r*ref are finite
// and >= 0 and every sample is finite with r*|x| <= 1, every step maps g >= 0
// to g' >= 0, and the chunk is one first-order linear recurrence: a scan of
// the affine maps (a_n, c) = (1 - r*hypotf(x_n), r*ref), which the card
// computes at memory speed (16 bytes a sample) instead of one thread's
// chain. Three launches, each in a fixed order, so the same input gives the
// same bits on every run (a decoupled look-back would compose in an order
// that depends on timing):
//  - agc_scan_reduce: a block a tile of kScanTile samples; each thread
//    composes its kScanItems samples (128-bit loads) in order, a warp scan
//    by shuffles and one through shared memory give the tile's map; the
//    block also reduces the route condition over its samples;
//  - agc_scan_tiles: one block scans the tiles' maps from g0 into each
//    tile's starting gain, and writes the route flag;
//  - agc_scan_apply: a block a tile again (the chunk is still in L2): each
//    thread's starting gain from the tile's and the block's exclusive scan,
//    then its samples in order, y = x*g, g = a*g + c; the thread of the last
//    sample writes the final gain. It drops the flag where g*|x| reaches
//    1e38, where the serial |y| could overflow.
// The scan rounds where the serial recurrence does not, so it is held to
// the plain version within bars (y 1e-5 relative, the gain 1e-6), not bit
// for bit. Where the flag is down (a non-finite sample, r*|x| > 1, g0 < 0,
// ...), the wrapper (ops/cuda_dsp.py) runs agc_loop_kernel over the chunk
// from the same gain, bit for bit with the plain version.
//
// The Costas loop is nonlinear (sine and cosine of the phase, the clips),
// so it stays one thread's chain, bit for bit with the plain version. What
// bounds it is that chain's latency; the design shortens it without
// changing a bit:
//  - the samples come from a ring of kStages shared-memory stages, each
//    filled by a cp.async.bulk copy kAhead stages ahead and written back by
//    another, both tracked by mbarriers and bulk groups, so the thread never
//    waits at a block barrier; it runs kUnroll samples an iteration, each
//    pair read from the stage where its chain starts (its latency hides
//    under the sine and cosine; reading a pair ahead gained nothing);
//  - the phase wrap mod(a, 2 pi), a = phase + pi, is on [-2 pi, 4 pi) one
//    compare and one subtract or add, exact by Sterbenz's lemma; -2 pi
//    gives +0 where fmodf gives -0, the same after the - pi. Past the
//    first sample a lies in [-6.0, 12.3] or is NaN (phase in [-pi, pi],
//    |freq| <= 1, |alpha*err| <= kAlphaMax, which every loop_bw gives:
//    |alpha| <= 2 + 2 sqrt 2), so the loop takes it with selects and no
//    branch; the first sample, whose phase the caller gives, takes it where
//    a is in range and fmodf with the sign fix elsewhere (inf, NaN, an
//    unwrapped phase0). shortcut_check_kernel holds the selects to fmodf
//    on every float in [-2 pi, 4 pi) and every NaN;
//  - sine and cosine by one sincosf where kSinCos past the first sample
//    (shortcut_check_kernel holds its bits to sinf's and cosf's on every
//    float in [-pi, pi], every infinity and NaN); the first sample takes
//    the two calls.
//
// Rounding, held bit for bit against the plain PyTorch versions in
// ops/dsp.py (agc_plain, costas_loop_plain) on the card (the serial AGC
// and the Costas loop):
//  - built with --fmad=false (ops/_build.py), so no product and sum are
//    contracted: freq + beta*err and (phase + freq) + alpha*err round as
//    two operations each, as the plain version's separate torch ops do;
//  - |y| is hypotf, which is torch's complex abs on the card
//    (thrust::abs), and exp(-i phase) is cosf and sinf, torch.cos and
//    torch.sin on the card; XLA's complex abs and its sine and cosine
//    differ from these in the last bits, so the port is held to JAX
//    within stated bars;
//  - the AGC's x*g is JAX's complex product with g + 0i, (a*g - b*0,
//    a*0 + b*g), so an infinite component makes the other NaN as in JAX;
//  - the clips are compares that keep NaN (as jnp.clip and torch.clamp
//    do), not fminf/fmaxf, which drop it;
//  - the phase wrap is jnp.mod's floored mod: fmodf with the sign fix,
//    as torch.remainder computes it, not a - b*floor(a/b).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;            // samples a tile: 32 KB of float2
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kFourPi = 2.0f * kTwoPi;   // exact: a power-of-two scaling

// the AGC's scan
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;         // samples a thread: 8 loads of 16 B
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kTilesThreads = 1024;    // agc_scan_tiles' one block
constexpr float kScanMax = 1e38f;      // g*|x| below it: |y| stays finite

// the Costas loop
constexpr int kStage = 1024;           // samples a stage of the ring: 8 KB
constexpr int kStages = 4;
constexpr int kAhead = 2;              // stages loaded ahead of the chain
constexpr int kUnroll = 4;             // samples an iteration: two pairs
constexpr bool kSinCos = true;
constexpr float kAlphaMax = 5.0f;      // |alpha| the loop's wrap takes

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// jnp.mod(a, b) and torch.remainder(a, b) for floats
__device__ __forceinline__ float floored_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// floored_mod(a, 2 pi) for a in [-2 pi, 4 pi) or NaN, less pi after it bit
// for bit (-2 pi gives +0 here and -0 there): one compare and one exact
// subtract or add, by selects
__device__ __forceinline__ float wrap_select(float a) {
  const float hi = a - kTwoPi, lo = a + kTwoPi;
  return a >= kTwoPi ? hi : (a < 0.0f ? lo : a);
}

// floored_mod(a, 2 pi) for any a, less pi after it bit for bit
__device__ __forceinline__ float mod_two_pi(float a) {
  if (a >= -kTwoPi && a < kFourPi) return wrap_select(a);
  return floored_mod(a, kTwoPi);
}

// ---------------------------------------------------------------------------
// the AGC: the serial route
// ---------------------------------------------------------------------------

// out[i] = x[i] * g; g += rate * (reference - |out[i]|)
__global__ void __launch_bounds__(kThreads)
agc_loop_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                long long n, float rate, float reference,
                const float* __restrict__ g0, float* __restrict__ g_out) {
  __shared__ float2 tile[kTile];
  float g = 0.0f;
  if (threadIdx.x == 0) g = *g0;
  for (long long base = 0; base < n; base += kTile) {
    const int m = static_cast<int>(n - base < kTile ? n - base : kTile);
    for (int i = threadIdx.x; i < m; i += kThreads) tile[i] = x[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 1
      for (int i = 0; i < m; ++i) {
        const float2 v = tile[i];
        const float yr = v.x * g - v.y * 0.0f;
        const float yi = v.x * 0.0f + v.y * g;
        tile[i] = make_float2(yr, yi);
        g = g + rate * (reference - hypotf(yr, yi));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads) y[base + i] = tile[i];
    __syncthreads();                   // the tile is free for the next one
  }
  if (threadIdx.x == 0) *g_out = g;
}

// ---------------------------------------------------------------------------
// the AGC: the affine scan
// ---------------------------------------------------------------------------

// g -> a*g + b
struct Affine {
  float a, b;
};

// f, then h
__device__ __forceinline__ Affine then(Affine f, Affine h) {
  return {h.a * f.a, h.a * f.b + h.b};
}

__device__ __forceinline__ Affine shfl_up(Affine v, int d) {
  return {__shfl_up_sync(0xffffffffu, v.a, d),
          __shfl_up_sync(0xffffffffu, v.b, d)};
}

// The block's exclusive scan of v in thread order (the identity for thread
// 0), and in *total the composition of all; kWarps warps, ``warp_maps`` a
// shared array of kWarps. Fixed order: a warp's inclusive scan by shuffles,
// the warps' totals by warp 0 the same way.
template <int kWarps>
__device__ __forceinline__ Affine block_exclusive(Affine v, Affine* warp_maps,
                                                  Affine* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Affine inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Affine o = shfl_up(inc, d);
    if (lane >= d) inc = then(o, inc);
  }
  if (lane == 31) warp_maps[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Affine w = lane < kWarps ? warp_maps[lane] : Affine{1.0f, 0.0f};
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Affine o = shfl_up(w, d);
      if (lane >= d) w = then(o, w);
    }
    if (lane < kWarps) warp_maps[lane] = w;
  }
  __syncthreads();
  const Affine before = shfl_up(inc, 1);   // this warp's lanes before lane
  Affine ex;
  if (warp == 0)
    ex = lane ? before : Affine{1.0f, 0.0f};
  else
    ex = lane ? then(warp_maps[warp - 1], before) : warp_maps[warp - 1];
  *total = warp_maps[kWarps - 1];
  __syncthreads();                     // warp_maps is free again
  return ex;
}

// a thread's run of the scan: up to kScanItems samples from s0, 128-bit
// loads where x is 16-byte aligned and the run whole
__device__ __forceinline__ int load_run(const float2* __restrict__ x,
                                        long long n, long long s0, bool vec,
                                        float2 (&v)[kScanItems]) {
  const long long left = n - s0;
  const int cnt = left <= 0 ? 0 : (left < kScanItems ? int(left)
                                                      : kScanItems);
  if (vec && cnt == kScanItems) {
    const float4* p = reinterpret_cast<const float4*>(x + s0);
#pragma unroll
    for (int k = 0; k < kScanItems / 2; ++k) {
      const float4 q = __ldg(p + k);
      v[2 * k] = make_float2(q.x, q.y);
      v[2 * k + 1] = make_float2(q.z, q.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      v[k] = k < cnt ? x[s0 + k] : make_float2(0.0f, 0.0f);
  }
  return cnt;
}

// the run's map, its samples in order, and whether they meet the condition
__device__ __forceinline__ Affine run_map(const float2 (&v)[kScanItems],
                                          int cnt, float rate, float c,
                                          bool* ok) {
  Affine f{1.0f, 0.0f};
  bool good = true;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (k < cnt) {
      const float rh = rate * hypotf(v[k].x, v[k].y);
      good = good && isfinite(v[k].x) && isfinite(v[k].y) && rh <= 1.0f;
      const float a = 1.0f - rh;
      f = {a * f.a, a * f.b + c};
    }
  }
  *ok = good;
  return f;
}

// each tile's map into maps[tile] and its condition into tile_ok[tile]
__global__ void __launch_bounds__(kScanThreads)
agc_scan_reduce(const float2* __restrict__ x, long long n, float rate,
                float c, bool vec, Affine* __restrict__ maps,
                int* __restrict__ tile_ok) {
  __shared__ Affine warp_maps[kScanThreads / 32];
  float2 v[kScanItems];
  const long long s0 = static_cast<long long>(blockIdx.x) * kScanTile
                       + threadIdx.x * kScanItems;
  const int cnt = load_run(x, n, s0, vec, v);
  bool ok;
  const Affine f = run_map(v, cnt, rate, c, &ok);
  Affine total;
  block_exclusive<kScanThreads / 32>(f, warp_maps, &total);
  const int all_ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) {
    maps[blockIdx.x] = total;
    tile_ok[blockIdx.x] = all_ok;
  }
}

// one block: each tile's starting gain from g0 into g_tile, and the route
// flag (every tile's condition, g0, rate and c finite and >= 0) into *flag
__global__ void __launch_bounds__(kTilesThreads)
agc_scan_tiles(const Affine* __restrict__ maps,
               const int* __restrict__ tile_ok, int tiles,
               const float* __restrict__ g0, float rate, float c,
               float* __restrict__ g_tile, int* __restrict__ flag) {
  __shared__ Affine warp_maps[kTilesThreads / 32];
  const int per = (tiles + kTilesThreads - 1) / kTilesThreads;
  const int t0 = threadIdx.x * per;
  const int t1 = min(t0 + per, tiles);
  Affine f{1.0f, 0.0f};
  bool ok = true;
  for (int t = t0; t < t1; ++t) {
    f = then(f, maps[t]);
    ok = ok && tile_ok[t];
  }
  Affine total;
  const Affine ex = block_exclusive<kTilesThreads / 32>(f, warp_maps, &total);
  const float g_start = *g0;
  float g = ex.a * g_start + ex.b;
  for (int t = t0; t < t1; ++t) {
    g_tile[t] = g;
    g = maps[t].a * g + maps[t].b;
  }
  const int all_ok = __syncthreads_and(ok);
  if (threadIdx.x == 0)
    *flag = all_ok && isfinite(g_start) && g_start >= 0.0f
            && isfinite(rate) && rate >= 0.0f && isfinite(c) && c >= 0.0f;
}

// y from each tile's starting gain; the final gain from the last sample's
// thread; the flag down where g*|x| reaches kScanMax
__global__ void __launch_bounds__(kScanThreads)
agc_scan_apply(const float2* __restrict__ x, float2* __restrict__ y,
               long long n, float rate, float c, bool vec,
               const float* __restrict__ g_tile, float* __restrict__ g_out,
               int* __restrict__ flag) {
  __shared__ Affine warp_maps[kScanThreads / 32];
  float2 v[kScanItems];
  const long long s0 = static_cast<long long>(blockIdx.x) * kScanTile
                       + threadIdx.x * kScanItems;
  const int cnt = load_run(x, n, s0, vec, v);
  bool ok;
  const Affine f = run_map(v, cnt, rate, c, &ok);
  Affine total;
  const Affine ex = block_exclusive<kScanThreads / 32>(f, warp_maps, &total);
  const float gt = g_tile[blockIdx.x];
  float g = threadIdx.x ? ex.a * gt + ex.b : gt;
  bool finite = true;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (k < cnt) {
      const float h = hypotf(v[k].x, v[k].y);
      finite = finite && g * h < kScanMax;
      v[k] = make_float2(v[k].x * g - v[k].y * 0.0f,
                         v[k].x * 0.0f + v[k].y * g);
      g = (1.0f - rate * h) * g + c;
    }
  }
  if (vec && cnt == kScanItems) {
    float4* p = reinterpret_cast<float4*>(y + s0);
#pragma unroll
    for (int k = 0; k < kScanItems / 2; ++k)
      p[k] = make_float4(v[2 * k].x, v[2 * k].y, v[2 * k + 1].x,
                         v[2 * k + 1].y);
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      if (k < cnt) y[s0 + k] = v[k];
  }
  if (cnt > 0 && s0 + cnt == n) *g_out = g;
  if (!__syncthreads_and(finite) && threadIdx.x == 0) atomicAnd(flag, 0);
}

// ---------------------------------------------------------------------------
// the Costas loop
// ---------------------------------------------------------------------------

// one sample: out = x * exp(-i phase); err = clip(Re*Im, +-1);
// freq = clip(freq + beta*err, +-1); phase = (phase + freq) + alpha*err,
// wrapped to [-pi, pi] by the floored mod. kFirst: a call's first sample,
// whose phase may be anything
template <bool kFirst>
__device__ __forceinline__ float2 costas_step(float2 v, float& phase,
                                              float& freq, float alpha,
                                              float beta) {
  float c, s;
  if (kSinCos && !kFirst) {
    sincosf(phase, &s, &c);
  } else {
    c = cosf(phase);
    s = sinf(phase);
  }
  // x * (cos(phase) + i sin(-phase)), JAX's product, with the negation
  // folded in (exact)
  const float yr = v.x * c + v.y * s;
  const float yi = v.y * c - v.x * s;
  const float err = clip_keep_nan(yr * yi, -1.0f, 1.0f);
  freq = clip_keep_nan(freq + beta * err, -1.0f, 1.0f);
  const float a = (phase + freq) + alpha * err + kPi;
  phase = (kFirst ? mod_two_pi(a) : wrap_select(a)) - kPi;
  return make_float2(yr, yi);
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes from global src into shared dst, completing on the mbarrier bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
}

// bytes from shared src to global dst, one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// One thread. Samples 0 and 1 straight from device memory (sample 0 the
// first step: the caller's phase may lie anywhere); the rest in stages of
// kStage through the ring, each an even number of samples by bulk copy (a
// multiple of 16 bytes; x and y 16-byte aligned, |alpha| <= kAlphaMax,
// which the wrapper ensures), an odd last sample straight from device
// memory.
__global__ void __launch_bounds__(32)
costas_loop_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   long long n, float alpha, float beta,
                   const float* __restrict__ state0,
                   float* __restrict__ state_out) {
  __shared__ __align__(128) float4 ring[kStages][kStage / 2];
  __shared__ __align__(8) uint64_t full[kStages];
  if (threadIdx.x != 0) return;
  for (int b = 0; b < kStages; ++b)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem(&full[b])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const long long body = n > 2 ? n - 2 : 0;
  const long long stages = (body + kStage - 1) / kStage;
  auto count = [&](long long k) {
    const long long left = body - k * kStage;
    return static_cast<int>(left < kStage ? left : kStage);
  };
  auto load = [&](long long k) {
    const uint32_t bytes = static_cast<uint32_t>(count(k) & ~1) * 8u;
    if (bytes)
      bulk_load(ring[k % kStages], x + 2 + k * kStage, bytes,
                &full[k % kStages]);
  };
  for (long long k = 0; k < kAhead && k < stages; ++k) load(k);
  float phase = state0[0], freq = state0[1];
  if (n > 0) y[0] = costas_step<true>(x[0], phase, freq, alpha, beta);
  if (n > 1) y[1] = costas_step<false>(x[1], phase, freq, alpha, beta);
  for (long long k = 0; k < stages; ++k) {
    const int b = static_cast<int>(k % kStages);
    const int cnt = count(k), pairs = cnt / 2;
    if (k + kAhead < stages) {
      // the buffer of stage k + kAhead held stage k + kAhead - kStages,
      // whose store is the older of the two bulk groups in flight
      asm volatile("cp.async.bulk.wait_group.read %0;"
                   :: "n"(kStages - kAhead - 1) : "memory");
      load(k + kAhead);
    }
    float4* buf = ring[b];
    const long long s = 2 + k * kStage;
    if (pairs) {
      bulk_wait(&full[b], static_cast<uint32_t>((k / kStages) & 1));
#pragma unroll 2  // kUnroll / 2 pairs an iteration
      for (int j = 0; j < pairs; ++j) {
        const float4 cur = buf[j];
        const float2 o0 = costas_step<false>(make_float2(cur.x, cur.y),
                                             phase, freq, alpha, beta);
        const float2 o1 = costas_step<false>(make_float2(cur.z, cur.w),
                                             phase, freq, alpha, beta);
        buf[j] = make_float4(o0.x, o0.y, o1.x, o1.y);
      }
      bulk_store(y + s, buf, static_cast<uint32_t>(pairs) * 16u);
    }
    if (cnt & 1)
      y[s + cnt - 1] = costas_step<false>(x[s + cnt - 1], phase, freq,
                                          alpha, beta);
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  state_out[0] = phase;
  state_out[1] = freq;
}

// ---------------------------------------------------------------------------
// the exhaustive checks of the Costas loop's shortcuts
// ---------------------------------------------------------------------------

// An opaque copy: the compiler may not see that two calls share an argument
// (it could fold sinf and cosf of one value into its sincos)
__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// kind 0: wrap_select(a) - pi against floored_mod(a, 2 pi) - pi; kind 1:
// sincosf(a) against sinf(a) and cosf(a); over the float32 bit patterns
// first .. first + count - 1; mismatches added to *out
__global__ void shortcut_check_kernel(int kind, uint32_t first,
                                      unsigned long long count,
                                      unsigned long long* out) {
  unsigned long long bad = 0;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x
           + threadIdx.x;
       i < count; i += stride) {
    const float a = __uint_as_float(first + static_cast<uint32_t>(i));
    if (kind == 0) {
      bad += !same_bits(wrap_select(a) - kPi,
                        floored_mod(opaque(a), kTwoPi) - kPi);
    } else {
      float s, c;
      sincosf(a, &s, &c);
      bad += !(same_bits(s, sinf(opaque(a)))
               && same_bits(c, cosf(opaque(a))));
    }
  }
  for (int o = 16; o > 0; o >>= 1) bad += __shfl_xor_sync(0xffffffffu, bad, o);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(out, bad);
}

}  // namespace

extern "C" {

// Each launch on ``stream``; returns cudaGetLastError() (0 on success). x
// and y are n complex64 samples; the state is read from and written to
// device memory, so no host sync is needed between chunks.
int dsp_agc_loop(const void* x, void* y, long long n, float rate,
                 float reference, const void* g0, void* g_out, void* stream) {
  agc_loop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), n, rate,
      reference, static_cast<const float*>(g0), static_cast<float*>(g_out));
  return static_cast<int>(cudaGetLastError());
}

// bytes of scratch dsp_agc_scan takes for n samples: each tile's map, its
// starting gain and its condition, then the route flag (an int)
long long dsp_agc_scan_scratch_bytes(long long n) {
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  return tiles * (sizeof(Affine) + sizeof(float) + sizeof(int)) + sizeof(int);
}

// The three launches of the scan over n >= 1 samples; the route flag (1:
// the scan's y and final gain hold) is the last int of ``scratch``
int dsp_agc_scan(const void* x, void* y, long long n, float rate,
                 float reference, const void* g0, void* g_out, void* scratch,
                 void* stream) {
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  if (n < 1 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto* maps = static_cast<Affine*>(scratch);
  auto* g_tile = reinterpret_cast<float*>(maps + tiles);
  auto* tile_ok = reinterpret_cast<int*>(g_tile + tiles);
  int* flag = tile_ok + tiles;
  const auto* xs = static_cast<const float2*>(x);
  auto* ys = static_cast<float2*>(y);
  const bool vec = ((reinterpret_cast<uintptr_t>(x)
                     | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const float c = rate * reference;
  const auto s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(tiles);
  agc_scan_reduce<<<grid, kScanThreads, 0, s>>>(xs, n, rate, c, vec, maps,
                                                tile_ok);
  agc_scan_tiles<<<1, kTilesThreads, 0, s>>>(
      maps, tile_ok, grid, static_cast<const float*>(g0), rate, c, g_tile,
      flag);
  agc_scan_apply<<<grid, kScanThreads, 0, s>>>(
      xs, ys, n, rate, c, vec, g_tile, static_cast<float*>(g_out), flag);
  return static_cast<int>(cudaGetLastError());
}

// x and y 16-byte aligned, |alpha| <= kAlphaMax
int dsp_costas_loop(const void* x, void* y, long long n, float alpha,
                    float beta, const void* state0, void* state_out,
                    void* stream) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15)
    return cudaErrorMisalignedAddress;
  if (!(fabsf(alpha) <= kAlphaMax)) return cudaErrorInvalidValue;
  costas_loop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), n, alpha, beta,
      static_cast<const float*>(state0), static_cast<float*>(state_out));
  return static_cast<int>(cudaGetLastError());
}

// kind 0 (the wrap) or 1 (sincosf) over the bit patterns first .. first +
// count - 1, mismatches added to *out (an unsigned long long on the card)
int dsp_shortcut_check(int kind, unsigned int first, long long count,
                       void* out, void* stream) {
  shortcut_check_kernel<<<1056, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      kind, first, static_cast<unsigned long long>(count),
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* dsp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
