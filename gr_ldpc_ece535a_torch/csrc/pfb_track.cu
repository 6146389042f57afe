// The polyphase clock tracker's block loop, hand-written for Hopper
// (sm_90a): pfb_track_kernel, one cluster of C CTAs that walks every
// tracking block of a stream in order, each CTA a slice of each block's
// symbols, the loop state in every thread's registers.
//
// It replaces no Pallas kernel: the JAX package runs this loop as the
// lax.scan of _pfb_core (gr_ldpc_ece535a_tpu/ops/dsp.py:348, the scan at
// :533, its step at :469 and filter_block at :417). The plain version is
// ops/dsp.py::_pfb_track_plain, about 50 torch calls a block from the host.
//
// A block of B symbols: symbol k samples at frac + k*(sps + rate); its row
// r = clamp(rint((frac + k*rate)*nfilts) + d0*nfilts, 1, rows - 2) = d*nfilts
// + p picks bank[p] (and dbank[p]) at column d of its window, which starts at
// clamp(ibase, 0, last) + k*sps. The S-curve probes are rows r - 1 and r + 1,
// which cross into column d -+ 1 where p is 0 or nfilts - 1 (the reference's
// np.roll of its extended table by one row); the table itself is not built.
// Each symbol takes 12 dot products of L taps (y and dy at three rows, two
// planes); the block sums u = y.dy and pw = |y|^2 over each half at the
// three rows, and the six half-block means give the next state (atan2f,
// the rate clip, floorf, the int64 ibase step).
//
// What bounds it: the blocks form one serial chain. At the chain's composed
// shape, 1,022 blocks of 8,192 symbols and L = 23, the dot products are
// 2.3e9 FMAs, 9.1 ms on one SM at 128 FMAs a clock and 1.98 GHz, 0.57 ms on
// 16; the card's f32 rate would take 0.07 ms and the bytes 0.06 ms. Between
// blocks every block pays a fixed latency: its sums' reduction, the update
// and the next window's loads (tools/pfb_probe.py measures each part). The
// design:
// - a cluster of C CTAs a block (cluster_for: C from B alone, 16 at 8,192,
//   1 at 64). CTA c takes symbols [c*B/C, (c + 1)*B/C), inside one half,
//   and stages and writes only those. Warp 0 of each CTA pushes the CTA's
//   partial sums into every CTA's shared memory (st.async through mapa
//   addresses, counted on the receiver's mbarrier: no cluster barrier a
//   block), waits for the C partials of the block on its own barrier,
//   sums them in rank order and takes the update; one CTA barrier hands
//   the state to the other warps. The partials' buffer and barrier
//   alternate with the block's parity, and a rank's next push waits on
//   every rank's last, so neither is overwritten while it is read. With C
//   = 1 every thread takes the update itself, from its CTA's slot.
// - a thread a symbol, a CTA at most kTileSyms of them at a time. (Several
//   symbols a thread over one shared tap row measured slower at every shape
//   the paths take: fewer warps are left to hide the loads; PERF.md.)
// - the half sums are one balanced binary tree over each half's symbols in
//   index order (the lanes of a warp by xor 1, 2, 4, 8, 16, then the warps,
//   then the ranks; a missing term is -0, the exact identity): the same bits
//   whatever C, where B is a power of two (every B that takes a cluster).
// - the update's six divisions and two atan2f on six and two lanes of the
//   warp that takes it, shuffled to every lane: the same scalars, fewer of
//   them on the chain.
// - the next block's window staged by cp.async while this block's dot
//   products run: its start lies within margin = ceil(B*rate_clip +
//   a*sps) + 2 samples of ibase + B*sps for a finite state (|tau| <= sps/2,
//   |tau_end| <= sps), so the superset is staged; the real start is checked
//   against it, and on a miss (a NaN state, the clamp) the exact window is
//   loaded on the chain. The kernel never reads a wrong window. Whether a
//   tile takes its all-columns path is decided from the exact window.
// - each block's outputs are stored after its sums are published, and
//   integer division by sps and nfilts is a shift where they are powers of
//   two.
// - the kernel's attributes and the cluster's fit are settled once for each
//   device and launch shape (``fit``), not before every launch.

// Rounding, held against the plain version on the card (tools/
// pfb_track_check.py): built with --fmad=false (ops/_build.py), so every
// scalar of the position and the update rounds as the plain version's torch
// ops on the card do, in their order: a Python scalar is taken as float32
// (the wrapper passes them so), a division by a Python scalar is torch's
// product with its float32 reciprocal, round is rintf (half to even), the
// clip keeps NaN as torch.clamp does, and float to int64 is cvt.rzi
// (__float2ll_rz), which saturates and takes NaN to 0 as torch's cast on
// the card does; the int64 sums wrap as torch's. The dot products take
// fmaf and the half-block sums a tree: those two are held by bars, not bit
// for bit. A tile whose exact window holds a non-finite sample takes every
// column of each symbol's window with its zero taps, as the plain
// version's table row does, so NaN and inf spread to the same symbols;
// since an accumulator that starts at +0 never holds -0, those columns add
// nothing to a finite symbol, whose bits do not depend on the path.

#include <cuda_runtime.h>

#include <cmath>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kTileSyms = 512;         // symbols (threads) a tile at most
constexpr int kSums = 12;              // (u, pw) x three rows x two halves
constexpr int kPad = 2;                // zero tap columns at each end
constexpr int kMaxCluster = 16;        // CTAs a block at most (non-portable)
constexpr int kCtaSyms = 512;          // symbols a CTA at least, where C > 1
constexpr bool kPrefetch = true;       // the next window staged off the chain
constexpr int kNoFit = 100000;         // error: the cluster does not fit

__host__ __device__ constexpr bool pow2(int v) {
  return v > 0 && (v & (v - 1)) == 0;
}

// CTAs a block: the most, up to kMaxCluster, that split B into power-of-two
// slices of kCtaSyms or more (each inside one half), else 1
__host__ __device__ int cluster_for(int B) {
  for (int c = kMaxCluster; c > 1; c /= 2)
    if (B % c == 0 && pow2(B / c) && B / c >= kCtaSyms) return c;
  return 1;
}

struct Geometry {
  int C, slice, tile, ntiles, threads, margin, planes, smem;
};

// one launch's shape: planes is the words of a staged phase plane, pads
// included; smem the dynamic shared memory (two barriers, the slots, the
// state, the pushed partials, the taps, two window buffers and the warps'
// partial sums)
__host__ __device__ Geometry geometry(int B, int sps, int nfilts, int L,
                                      int width, float bf, float rate_clip,
                                      float a) {
  Geometry g;
  g.C = cluster_for(B);
  g.slice = B / g.C;
  g.tile = g.slice < kTileSyms ? g.slice : kTileSyms;
  g.ntiles = (g.slice + g.tile - 1) / g.tile;
  g.threads = (g.tile + 31) / 32 * 32;
  g.margin = kPrefetch
                 ? static_cast<int>(ceilf(bf * rate_clip +
                                          a * static_cast<float>(sps))) + 2
                 : 0;
  const int words =
      g.tile + 1 + width / sps + (2 * g.margin + sps - 1) / sps + 1;
  g.planes = words + 1;
  g.smem = 16 + 2 * kSums * 4 + 16 + 2 * kMaxCluster * kSums * 4 +
           nfilts * (L + 2 * kPad) * 8 + 2 * sps * g.planes * 8 +
           g.ntiles * (g.threads / 32) * kSums * 4;
  return g;
}

struct Loop {
  long long n;        // samples a plane of the padded stream
  long long last;     // the greatest window start
  int nblocks, B, sps, nfilts, L, d0, rows, width;
  float nf, bsps, bf, a, aa, inv_h, inv_2delta, qs, rate_clip;
  int C, slice, tile, ntiles, margin, planes;
  int sps_shift, nf_shift;   // log2 of sps and nfilts, or -1: not powers of 2
};

// v / d (v >= 0) and its remainder, by a shift where d = 2^shift
__device__ __forceinline__ int div_rem(int v, int d, int shift, int& rem) {
  if (shift >= 0) {
    rem = v & (d - 1);
    return v >> shift;
  }
  rem = v % d;
  return v / d;
}

// -- the PTX this kernel needs: cluster rank and barrier, DSM, cp.async ----
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the shared-memory address of p; its counterpart in the cluster's CTA
// ``rank`` (a shared::cluster address)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned map_shared(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the barrier's one arrival of this phase, expecting ``bytes`` of pushes
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for the barrier's phase of parity ``parity`` to complete; a push
// that never lands traps rather than hangs
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  for (unsigned i = 0;; ++i) {
    unsigned done;
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (i == (1u << 26)) __trap();
  }
}

// 16 bytes into a cluster CTA's shared memory at ``dst``, counted on its
// barrier ``bar`` (both shared::cluster addresses)
__device__ __forceinline__ void push16(unsigned dst, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros where bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// ---------------------------------------------------------------------------

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long clamp_start(long long i, long long last) {
  return i < 0 ? 0 : (i > last ? last : i);
}

// tap pair i of a padded row, zero outside [0, L)
__device__ __forceinline__ float2 tap_at(const float2* row, int i, int L) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(L)
             ? row[i + kPad] : make_float2(0.0f, 0.0f);
}

struct Acc {                            // y and dy on both planes
  float yr = 0.0f, yi = 0.0f, dr = 0.0f, di = 0.0f;
  __device__ __forceinline__ void add(float2 w, float2 t) {
    yr = fmaf(w.x, t.x, yr);
    yi = fmaf(w.y, t.x, yi);
    dr = fmaf(w.x, t.y, dr);
    di = fmaf(w.y, t.y, di);
  }
  // the plain version's y[0]*dy[0] + y[1]*dy[1] and y[0]^2 + y[1]^2
  __device__ __forceinline__ float u() const { return yr * dr + yi * di; }
  __device__ __forceinline__ float pw() const { return yr * yr + yi * yi; }
};

// symbol k's row r = d*nfilts + p of the extended table
__device__ __forceinline__ int row_of(float frac, float rate, int k,
                                      const Loop& lp) {
  const float pos = (frac + static_cast<float>(k) * rate) * lp.nf;
  long long rr = wrap_add(__float2ll_rz(rintf(pos)),
                          static_cast<long long>(lp.d0) * lp.nfilts);
  rr = rr < 1 ? 1 : (rr > lp.rows - 2 ? lp.rows - 2 : rr);
  return static_cast<int>(rr);
}

struct Probes {                         // rows r, r - 1, r + 1 of a column
  const float2 *tc, *tm, *tp;           // tap pair of window column d - 1 + c
  int d, p, pm, em, pp, ep;
  __device__ __forceinline__ Probes(const float2* taps, int r,
                                    const Loop& lp) {
    const int Lp = lp.L + 2 * kPad;
    d = div_rem(r, lp.nfilts, lp.nf_shift, p);
    // rows r - 1 and r + 1: (phase, column shift from d)
    pm = p > 0 ? p - 1 : lp.nfilts - 1;
    em = p > 0 ? 0 : -1;
    pp = p < lp.nfilts - 1 ? p + 1 : 0;
    ep = p < lp.nfilts - 1 ? 0 : 1;
    tc = taps + p * Lp + kPad - 1;
    tm = taps + pm * Lp + kPad - 1 - em;
    tp = taps + pp * Lp + kPad - 1 - ep;
  }
};

// tile symbol kk's dot products at row r, staged q = delta + (kk + 1)*sps +
// window column
__device__ __forceinline__ void one(int kk, int r, bool slow, int delta,
                                    const float2* taps, const float2* win,
                                    const Loop& lp, Acc& c0, Acc& cm,
                                    Acc& cp) {
  const int sps = lp.sps, L = lp.L;
  const Probes pr(taps, r, lp);
  if (!slow) {
    // columns d - 1 .. d + L of the window; tap i = column - (d + e)
    int ph, off = div_rem(delta + (kk + 1) * sps + pr.d - 1, sps,
                          lp.sps_shift, ph);
#pragma unroll 5
    for (int c = 0; c < L + 2; ++c) {
      const float2 w = win[ph * lp.planes + off];
      c0.add(w, pr.tc[c]);
      cm.add(w, pr.tm[c]);
      cp.add(w, pr.tp[c]);
      if (++ph == sps) {
        ph = 0;
        ++off;
      }
    }
  } else {
    // every column, zero taps included: x*0 is NaN for x non-finite
    const int Lp = L + 2 * kPad;
    const float2* rc = taps + pr.p * Lp;
    const float2* rm = taps + pr.pm * Lp;
    const float2* rp = taps + pr.pp * Lp;
    int ph, off = div_rem(delta + (kk + 1) * sps, sps, lp.sps_shift, ph);
    for (int t = 0; t < lp.width; ++t) {
      const float2 w = win[ph * lp.planes + off];
      c0.add(w, tap_at(rc, t - pr.d, L));
      cm.add(w, tap_at(rm, t - pr.d - pr.em, L));
      cp.add(w, tap_at(rp, t - pr.d - pr.ep, L));
      if (++ph == sps) {
        ph = 0;
        ++off;
      }
    }
  }
}

// the six products of a symbol's accumulators that its block sums
__device__ __forceinline__ void products(const Acc& c0, const Acc& cm,
                                         const Acc& cp, float (&v)[6]) {
  v[0] = c0.u();
  v[1] = c0.pw();
  v[2] = cm.u();
  v[3] = cm.pw();
  v[4] = cp.u();
  v[5] = cp.pw();
}

// tile symbol g's output y and its six products v, -0 where g >= ts. Kept a
// function of its own, its guards included: written inline in the kernel,
// nvcc gives the column loop fewer registers and the kernel runs slower
// (PERF.md).
__device__ __forceinline__ void dots(int g, int ts, int r, int delta,
                                     bool slow, const float2* taps,
                                     const float2* win, const Loop& lp,
                                     float2& y, float (&v)[6]) {
  Acc c0, cm, cp;
  if (g < ts) one(g, r, slow, delta, taps, win, lp, c0, cm, cp);
  y = make_float2(c0.yr, c0.yi);
  if (g < ts) {
    products(c0, cm, cp, v);
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = -0.0f;
  }
}

// tile symbol g's output (where g < ts) of block j
__device__ __forceinline__ void store(float2 y, int g, int ts, int k0, int j,
                                      const Loop& lp, float* ys) {
  if (g < ts) {
    const size_t at = static_cast<size_t>(j) * lp.B + k0 + g;
    ys[at] = y.x;
    ys[static_cast<size_t>(lp.nblocks) * lp.B + at] = y.y;
  }
}

// a thread's staged positions q = lo + threadIdx.x + i*blockDim.x as
// (phase plane, word), stepped without a division
struct Cursor {
  int q, plane, word, dp, dw;
  __device__ __forceinline__ Cursor(int lo, const Loop& lp)
      : q(lo + static_cast<int>(threadIdx.x)) {
    word = div_rem(q, lp.sps, lp.sps_shift, plane);
    dw = div_rem(static_cast<int>(blockDim.x), lp.sps, lp.sps_shift, dp);
  }
  __device__ __forceinline__ void next(int sps) {
    q += blockDim.x;
    word += dw;
    plane += dp;
    if (plane >= sps) {
      plane -= sps;
      ++word;
    }
  }
  __device__ __forceinline__ float2& in(float2* win, int planes) const {
    return win[plane * planes + word];
  }
};

// stage samples base .. base + count - 1 of the stream as staged q = 0 ..
// count - 1, zeros outside it; whether the thread's samples hold a
// non-finite one
__device__ __forceinline__ bool stage(float2* win, const float* x,
                                      const Loop& lp, long long base,
                                      int count) {
  bool bad = false;
  for (Cursor c(0, lp); c.q < count; c.next(lp.sps)) {
    const long long g = base + c.q;
    float2 v = make_float2(0.0f, 0.0f);
    if (g >= 0 && g < lp.n) {
      v = make_float2(x[g], x[lp.n + g]);
      bad |= !(isfinite(v.x) && isfinite(v.y));
    }
    c.in(win, lp.planes) = v;
  }
  return bad;
}

// stage's copy by cp.async, not waited for
__device__ __forceinline__ void prefetch(float2* win, const float* x,
                                         const Loop& lp, long long base,
                                         int count) {
  for (Cursor c(0, lp); c.q < count; c.next(lp.sps)) {
    const long long g = base + c.q;
    const bool in = g >= 0 && g < lp.n;
    float2& v = c.in(win, lp.planes);
    cp_async4(&v.x, in ? x + g : x, in ? 4 : 0);
    cp_async4(&v.y, in ? x + lp.n + g : x, in ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// whether the staged q in [lo, hi) that this thread copies hold a
// non-finite sample
__device__ __forceinline__ bool scan(float2* win, const Loop& lp, int lo,
                                     int hi) {
  bool bad = false;
  for (Cursor c(lo, lp); c.q < hi; c.next(lp.sps)) {
    const float2 v = c.in(win, lp.planes);
    bad |= !(isfinite(v.x) && isfinite(v.y));
  }
  return bad;
}

// the next state from the block's twelve half sums: ops/dsp.py::
// _pfb_track_plain's update, scalar for scalar, by a whole warp: lane k < 6
// takes e[k / 3][k % 3] (a division), lane h < 2 takes tau[h] (an atan2f),
// and the shuffles hand each to every lane, which ends with the same state
__device__ __forceinline__ void update(const float (&sum)[kSums],
                                       const Loop& lp, long long& ibase,
                                       float& frac, float& rate) {
  const int lane = threadIdx.x & 31;
  // e = mean(u)/(mean(pw) + 1e-12) a half and row: u of e[hh][rw] is
  // sum[2k], pw sum[2k + 1], k = 3*hh + rw
  float u = sum[0], pw = sum[1];
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    if (lane == k) {
      u = sum[2 * k];
      pw = sum[2 * k + 1];
    }
  }
  const float ek = (u * lp.inv_h) / ((pw * lp.inv_h) + 1e-12f);
  float e[6], tau[2];
#pragma unroll
  for (int k = 0; k < 6; ++k) e[k] = __shfl_sync(0xffffffffu, ek, k);
  const bool second = lane & 1;
  const float g = ((second ? e[5] : e[2]) - (second ? e[4] : e[1])) *
                  lp.inv_2delta;
  const float th = lp.qs * atan2f(second ? e[3] : e[0], g * lp.qs);
  tau[0] = __shfl_sync(0xffffffffu, th, 0);
  tau[1] = __shfl_sync(0xffffffffu, th, 1);
  const float rate_n = clip_keep_nan(
      rate - (lp.aa * (tau[1] - tau[0])) * lp.inv_h, -lp.rate_clip,
      lp.rate_clip);
  const float tau_end = tau[1] + 0.5f * (tau[1] - tau[0]);
  const float adv = ((frac + lp.bsps) + lp.bf * rate_n) - lp.a * tau_end;
  const float stepi = floorf(adv);
  ibase = wrap_add(ibase, __float2ll_rz(stepi));
  frac = adv - stepi;
  rate = rate_n;
}

__global__ void __launch_bounds__(kTileSyms, 1)
pfb_track_kernel(const float* __restrict__ x, const float* __restrict__ bank,
                 const float* __restrict__ dbank,
                 const long long* __restrict__ ibase0,
                 const float* __restrict__ frac0,
                 const float* __restrict__ rate0, float* __restrict__ ys,
                 long long* __restrict__ ibase_out,
                 float* __restrict__ frac_out, float* __restrict__ rate_out,
                 Loop lp) {
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sps = lp.sps, nfilts = lp.nfilts, L = lp.L, B = lp.B;
  const int Lp = L + 2 * kPad;
  const unsigned rank = cluster_rank();
  // two barriers, the slots (C = 1), the state, the pushed partials (C > 1)
  auto* mbar = reinterpret_cast<unsigned long long*>(smem);
  float4* slots = smem + 1;                                // 2 x kSums floats
  float* s_state = reinterpret_cast<float*>(slots + 2 * kSums / 4);
  long long* s_ibase = reinterpret_cast<long long*>(s_state);  // frac, rate
  float4* recv = slots + 2 * kSums / 4 + 1;     // 2 x kMaxCluster x kSums
  float2* taps = reinterpret_cast<float2*>(recv + 2 * kMaxCluster * kSums / 4);
  float2* wins = taps + nfilts * Lp;                       // 2 x sps x planes
  float* red = reinterpret_cast<float*>(wins + 2 * sps * lp.planes);

  for (int i = tid; i < nfilts * Lp; i += blockDim.x) {
    const int row = i / Lp, c = i % Lp - kPad;
    taps[i] = (c >= 0 && c < L)
                  ? make_float2(bank[row * L + c], dbank[row * L + c])
                  : make_float2(0.0f, 0.0f);
  }
  long long ibase = *ibase0;
  float frac = *frac0, rate = *rate0;
  if (lp.C > 1) {
    if (tid == 0) {
      mbar_init(&mbar[0]);
      mbar_init(&mbar[1]);
    }
    cluster_sync();          // every CTA's barriers before any push to them
  } else {
    __syncthreads();
  }

  const int kc = static_cast<int>(rank) * lp.slice;   // the CTA's first symbol
  const bool warp_one_half = (B / 2) % 32 == 0;
  bool pf = false, pf_bad = false;                    // the prefetched span
  long long pf_lo = 0, pf_hi = 0;
  int pf_count = 0;
  for (int j = 0; j < lp.nblocks; ++j) {
    // this block's barrier takes one arrival and every rank's partial
    if (lp.C > 1 && tid == 0) mbar_expect(&mbar[j & 1], lp.C * kSums * 4);
    const long long start = clamp_start(ibase, lp.last);
    float2* cur = wins + (j & 1) * sps * lp.planes;
    float thread_sum[kSums];
    float2 y = make_float2(0.0f, 0.0f);   // tile symbol tid's output
    int y_k0 = 0, y_ts = 0;
    for (int t = 0; t < lp.ntiles; ++t) {
      const int k0 = kc + t * lp.tile;
      const int rest = kc + lp.slice - k0;
      const int ts = lp.tile < rest ? lp.tile : rest;
      // tile q = stream sample base + q; symbol kk's window column c is
      // q = delta + (kk + 1)*sps + c
      const long long base = start + static_cast<long long>(k0 - 1) * sps;
      const int count = (ts + 1) * sps + lp.width;
      int delta = 0;
      bool slow;
      if (t > 0) {
        __syncthreads();               // the window is free for this tile
        slow = __syncthreads_or(stage(cur, x, lp, base, count));
      } else if (pf && start >= pf_lo && start <= pf_hi) {
        delta = static_cast<int>(start - pf_lo);
        slow = pf_bad &&
               __syncthreads_or(scan(cur, lp, delta, delta + count));
      } else {
        slow = __syncthreads_or(stage(cur, x, lp, base, count));
      }
      if (t == 0) {
        // the next block's start lies within margin of ibase + B*sps
        pf = kPrefetch && j + 1 < lp.nblocks;
        if (pf) {
          const long long lim = 1ll << 61;
          const long long nb =
              (ibase < -lim ? -lim : (ibase > lim ? lim : ibase)) +
              static_cast<long long>(B) * sps;
          pf_lo = clamp_start(nb - lp.margin, lp.last);
          pf_hi = clamp_start(nb + lp.margin, lp.last);
          pf_count = static_cast<int>(pf_hi - pf_lo) + count;
          prefetch(wins + ((j + 1) & 1) * sps * lp.planes, x, lp,
                   pf_lo + static_cast<long long>(k0 - 1) * sps, pf_count);
        }
      }
      int r = 0;
      if (tid < ts) r = row_of(frac, rate, k0 + tid, lp);
      float v[6];
      if (tid < ts) {
        dots(tid, ts, r, delta, slow, taps, cur, lp, y, v);
      } else {
#pragma unroll
        for (int i = 0; i < 6; ++i) v[i] = -0.0f;
      }
      // the last tile's outputs wait until the block's barrier is passed,
      // so that its release does not wait on their stores
      if (t + 1 < lp.ntiles) store(y, tid, ts, k0, j, lp, ys);
      y_k0 = k0;
      y_ts = ts;
      const int hg = k0 + tid >= B / 2 ? 1 : 0;    // the symbol's half
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        thread_sum[i] = hg == 0 ? v[i] : -0.0f;
        thread_sum[6 + i] = hg == 1 ? v[i] : -0.0f;
      }
      // a warp whose symbols lie in one half leaves the other's -0 alone
      const int hw = k0 + warp * 32 >= B / 2 ? 1 : 0;
#pragma unroll
      for (int i = 0; i < kSums; ++i)
        if (!warp_one_half || i / 6 == hw)
#pragma unroll
          for (int o = 1; o < 32; o <<= 1)
            thread_sum[i] = thread_sum[i] +
                            __shfl_xor_sync(0xffffffffu, thread_sum[i], o);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kSums; ++i)
          red[(t * nwarps + warp) * kSums + i] = thread_sum[i];
      }
    }
    bool bad_next = false;
    if (pf) {
      cp_async_wait_all();
      bad_next = scan(wins + ((j + 1) & 1) * sps * lp.planes, lp, 0,
                         pf_count);
    }
    pf_bad = __syncthreads_or(bad_next);
    float* slot = reinterpret_cast<float*>(slots) + (j & 1) * kSums;
    if (tid < kSums) {
      // the tree over the CTA's warps (tile-major) into red[0 .. 11], and
      // (one CTA) into the slot
      const int n = lp.ntiles * nwarps;
      for (int w = 1; w < n; w <<= 1)
        for (int a = 0; a + w < n; a += 2 * w)
          red[a * kSums + tid] =
              red[a * kSums + tid] + red[(a + w) * kSums + tid];
      if (lp.C == 1) slot[tid] = red[tid];
    }
    if (lp.C == 1) {
      // one CTA: every thread reads its slot and takes the same update,
      // so the state needs no broadcast
      __syncthreads();
      store(y, tid, y_ts, y_k0, j, lp, ys);
      const float4* p = slots + (j & 1) * kSums / 4;
      float sum[kSums];
#pragma unroll
      for (int i = 0; i < kSums / 4; ++i) {
        const float4 f = p[i];
        sum[4 * i] = f.x;
        sum[4 * i + 1] = f.y;
        sum[4 * i + 2] = f.z;
        sum[4 * i + 3] = f.w;
      }
      update(sum, lp, ibase, frac, rate);
      continue;
    }
    store(y, tid, y_ts, y_k0, j, lp, ys);
    if (warp == 0) {
      // a cluster: lane r pushes this CTA's partial into rank r's
      // recv[parity][this rank] and, when every rank's has landed, reads
      // rank r's; the tree over the ranks in order pairs lanes by xor 1,
      // 2, 4, ... (a lane past C holds -0, and adds nothing), so every lane
      // ends with the same sums and takes the update; lane 0 hands it on
      __syncwarp();                    // lanes 0 .. 11 wrote red[0 .. 11]
      const float4* box = recv + (j & 1) * kMaxCluster * kSums / 4;
      if (lane < lp.C) {
        const unsigned dst =
            map_shared(smem_addr(box + rank * kSums / 4), lane);
        const unsigned bar = map_shared(smem_addr(&mbar[j & 1]), lane);
#pragma unroll
        for (int i = 0; i < kSums / 4; ++i)
          push16(dst + 16 * i, make_float4(red[4 * i], red[4 * i + 1],
                                           red[4 * i + 2], red[4 * i + 3]),
                 bar);
      }
      mbar_wait(&mbar[j & 1], (j >> 1) & 1);
      float sum[kSums];
      if (lane < lp.C) {
        const float4* p = box + lane * kSums / 4;
#pragma unroll
        for (int i = 0; i < kSums / 4; ++i) {
          const float4 f = p[i];
          sum[4 * i] = f.x;
          sum[4 * i + 1] = f.y;
          sum[4 * i + 2] = f.z;
          sum[4 * i + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kSums; ++i) sum[i] = -0.0f;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int i = 0; i < kSums; ++i)
          sum[i] = sum[i] + __shfl_xor_sync(0xffffffffu, sum[i], o);
      update(sum, lp, ibase, frac, rate);
      if (lane == 0) {
        *s_ibase = ibase;
        s_state[2] = frac;
        s_state[3] = rate;
      }
    }
    __syncthreads();
    ibase = *s_ibase;
    frac = s_state[2];
    rate = s_state[3];
  }
  if (lp.C > 1) cluster_sync();   // no CTA leaves while a push may reach it
  if (rank == 0 && tid == 0) {
    *ibase_out = ibase;
    *frac_out = frac;
    *rate_out = rate;
  }
}

int log2_or(int v) {         // log2 v where v is a power of two, else -1
  if (!pow2(v)) return -1;
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

// a launch's configuration on ``stream``; ``attr`` takes its cluster size
void configure(const Geometry& g, cudaStream_t stream, cudaLaunchConfig_t& cfg,
               cudaLaunchAttribute& attr) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = g.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(g.C);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// what is settled once for each device: the shared memory the kernel may
// take (it only grows), the non-portable cluster size, and, for each launch
// shape (C, threads, shared memory), cudaOccupancyMaxActiveClusters
struct Settled {
  int smem = 0;
  bool nonportable = false;
  std::map<std::tuple<int, int, int>, int> clusters;
};
std::mutex settled_mutex;
std::map<int, Settled> settled;

// the kernel's attributes set for ``g`` on the current device, and the
// cluster held to the card, once a device and shape: 0, an error of setting
// them or of the occupancy query (not kept: the next call asks again), or
// kNoFit where no such cluster fits; ``clusters``, where not null, takes
// cudaOccupancyMaxActiveClusters
int fit(const Geometry& g, int* clusters) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const std::lock_guard<std::mutex> lock(settled_mutex);
  Settled& s = settled[dev];
  const auto key = std::make_tuple(g.C, g.threads, g.smem);
  auto it = s.clusters.find(key);
  if (it == s.clusters.end()) {
    if (g.smem > s.smem) {
      err = cudaFuncSetAttribute(pfb_track_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 g.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      s.smem = g.smem;
    }
    if (g.C > 8 && !s.nonportable) {
      err = cudaFuncSetAttribute(
          pfb_track_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
      s.nonportable = true;
    }
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    configure(g, nullptr, cfg, attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, pfb_track_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    it = s.clusters.emplace(key, n).first;
  }
  if (clusters != nullptr) *clusters = it->second;
  return it->second < 1 ? kNoFit : 0;
}

}  // namespace

extern "C" {

// The launch's shape at these parameters, into out[8]: C, slice, tile,
// tiles, threads, margin, plane words, dynamic shared memory bytes.
void pfb_track_geometry(int B, int sps, int nfilts, int L, int width,
                        float rate_clip, float a, int* out) {
  const Geometry g = geometry(B, sps, nfilts, L, width,
                              static_cast<float>(B), rate_clip, a);
  const int v[8] = {g.C,       g.slice,  g.tile,   g.ntiles,
                    g.threads, g.margin, g.planes, g.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// Whether the cluster of the launch at these parameters fits the current
// device, as pfb_track checks it (once a device and shape): 0 (and
// cudaOccupancyMaxActiveClusters into *clusters), or the error.
int pfb_track_clusters(int B, int sps, int nfilts, int L, int width,
                       float rate_clip, float a, int* clusters) {
  const Geometry g = geometry(B, sps, nfilts, L, width,
                              static_cast<float>(B), rate_clip, a);
  return fit(g, clusters);
}

// One launch: one cluster on ``stream`` over ``nblocks`` tracking blocks;
// returns 0 on success, else the error of setting the kernel's attributes
// (its shared memory, a non-portable cluster size), of the occupancy query,
// kNoFit where no such cluster fits the card (both settled once a device and
// shape), or the launch's error. x is
// the (2, n) float32 padded stream, bank and dbank (nfilts, L) float32, the
// state (ibase int64, frac, rate float32) one element each in and out, ys
// (2, nblocks, B) float32.
int pfb_track(const void* x, long long n, const void* bank, const void* dbank,
              const void* ibase0, const void* frac0, const void* rate0,
              void* ys, void* ibase_out, void* frac_out, void* rate_out,
              int nblocks, int B, int sps, int nfilts, int L, int d0,
              int rows, int width, long long last, float nf, float bsps,
              float bf, float a, float aa, float inv_h, float inv_2delta,
              float qs, float rate_clip, void* stream) {
  const Geometry g = geometry(B, sps, nfilts, L, width, bf, rate_clip, a);
  const Loop lp{n,  last, nblocks, B,     sps,        nfilts, L,
                d0, rows, width,   nf,    bsps,       bf,     a,
                aa, inv_h, inv_2delta, qs, rate_clip, g.C,    g.slice,
                g.tile, g.ntiles, g.margin, g.planes, log2_or(sps),
                log2_or(nfilts)};
  if (const int err = fit(g, nullptr)) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(g, static_cast<cudaStream_t>(stream), cfg, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pfb_track_kernel, static_cast<const float*>(x),
      static_cast<const float*>(bank), static_cast<const float*>(dbank),
      static_cast<const long long*>(ibase0), static_cast<const float*>(frac0),
      static_cast<const float*>(rate0), static_cast<float*>(ys),
      static_cast<long long*>(ibase_out), static_cast<float*>(frac_out),
      static_cast<float*>(rate_out), lp);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* pfb_track_error_string(int err) {
  if (err == kNoFit) return "no cluster of the tracker's shape fits the card";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
