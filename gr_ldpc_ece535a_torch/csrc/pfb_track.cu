// The polyphase clock tracker's block loop, hand-written for Hopper
// (sm_90a): pfb_track_kernel, one persistent thread block that walks every
// tracking block of a stream in order with the loop state in shared memory.
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
// three rows, and one thread turns the six half-block means into the next
// state (atan2f, the rate clip, floorf, the int64 ibase step).
//
// What bounds it: the blocks form one serial chain, so one SM does all the
// work (the card's other 131 stay idle). At the chain's composed shape,
// 1,022 blocks of 8,192 symbols and L = 23, that is 2.3e9 FMAs, 9.1 ms at
// 128 FMAs a clock and 1.98 GHz, while the card's f32 rate would take 0.07
// ms and the bytes (the stream read once, the symbols written once) 0.06 ms.
// The dot products' shared-memory loads (a window sample and three tap
// pairs a column) cost about as much as their FMAs. At 64-symbol blocks a
// block is a few microseconds of latency: two barriers and the one thread's
// update. The design is the simple one: the window is staged in tiles of
// kTileSyms symbols into shared memory, each sample at (q % sps)*P + q/sps
// so that neighbouring symbols read neighbouring words; the taps sit in
// shared memory as (bank, dbank) pairs with two zero columns at each end, so
// one loop over L + 2 window columns serves all three rows. A cluster of
// blocks sharing the half-block sums through distributed shared memory, and
// double-buffered staging, are later work.
//
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
// for bit. A tile that holds a non-finite sample takes every column of each
// symbol's window with its zero taps, as the plain version's table row
// does, so NaN and inf spread to the same symbols.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTileSyms = 2048;        // symbols a staged window tile
constexpr int kSums = 12;              // (u, pw) x three rows x two halves
constexpr int kPad = 2;                // zero tap columns at each end

struct Loop {
  long long n;        // samples a plane of the padded stream
  long long last;     // the greatest window start
  int nblocks, B, sps, nfilts, L, d0, rows, width;
  float nf, bsps, bf, a, aa, inv_h, inv_2delta, qs, rate_clip;
};

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

__global__ void __launch_bounds__(kMaxThreads, 1)
pfb_track_kernel(const float* __restrict__ x, const float* __restrict__ bank,
                 const float* __restrict__ dbank,
                 const long long* __restrict__ ibase0,
                 const float* __restrict__ frac0,
                 const float* __restrict__ rate0, float* __restrict__ ys,
                 long long* __restrict__ ibase_out,
                 float* __restrict__ frac_out, float* __restrict__ rate_out,
                 Loop lp) {
  extern __shared__ float4 smem[];
  __shared__ long long s_ibase;
  __shared__ float s_frac, s_rate;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int sps = lp.sps, nfilts = lp.nfilts, L = lp.L, B = lp.B;
  const int Lp = L + 2 * kPad;
  const int tile_max = B < kTileSyms ? B : kTileSyms;
  // a phase plane of the staged window: the tile's symbols, one symbol
  // before them (the column left of column 0) and the window's width
  const int P = tile_max + lp.width / sps + 1;
  float2* taps = reinterpret_cast<float2*>(smem);          // nfilts x Lp
  float2* win = taps + nfilts * Lp;                        // sps x P
  float* red = reinterpret_cast<float*>(win + sps * P);    // 32 x kSums

  for (int i = tid; i < nfilts * Lp; i += nthreads) {
    const int row = i / Lp, c = i % Lp - kPad;
    taps[i] = (c >= 0 && c < L)
                  ? make_float2(bank[row * L + c], dbank[row * L + c])
                  : make_float2(0.0f, 0.0f);
  }
  if (tid == 0) {
    s_ibase = *ibase0;
    s_frac = *frac0;
    s_rate = *rate0;
  }
  __syncthreads();

  const int h = B / 2;
  for (int j = 0; j < lp.nblocks; ++j) {
    const long long ibase = s_ibase;
    const float frac = s_frac, rate = s_rate;
    // the reference's dynamic_slice clamp, before any load
    const long long start = ibase < 0 ? 0 : (ibase > lp.last ? lp.last : ibase);
    float sum[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) sum[i] = 0.0f;

    for (int k0 = 0; k0 < B; k0 += kTileSyms) {
      const int ts = B - k0 < kTileSyms ? B - k0 : kTileSyms;
      // tile sample q' = stream sample base + q'; symbol kk's window
      // column c is q' = (kk + 1)*sps + c
      const long long base = start + static_cast<long long>(k0 - 1) * sps;
      const int q_end = (ts + 1) * sps + lp.width;
      bool bad = false;
      for (int q = tid; q < q_end; q += nthreads) {
        const long long g = base + q;
        float2 v = make_float2(0.0f, 0.0f);
        if (g >= 0 && g < lp.n) {
          v = make_float2(x[g], x[lp.n + g]);
          bad |= !(isfinite(v.x) && isfinite(v.y));
        }
        win[(q % sps) * P + q / sps] = v;
      }
      const bool slow = __syncthreads_or(bad);

      for (int kk = tid; kk < ts; kk += nthreads) {
        const int k = k0 + kk;
        const float pos = (frac + static_cast<float>(k) * rate) * lp.nf;
        long long rr = wrap_add(__float2ll_rz(rintf(pos)),
                                static_cast<long long>(lp.d0) * nfilts);
        rr = rr < 1 ? 1 : (rr > lp.rows - 2 ? lp.rows - 2 : rr);
        const int r = static_cast<int>(rr), d = r / nfilts, p = r - d * nfilts;
        // rows r - 1 and r + 1: (phase, column shift from d)
        const int pm = p > 0 ? p - 1 : nfilts - 1, em = p > 0 ? 0 : -1;
        const int pp = p < nfilts - 1 ? p + 1 : 0, ep = p < nfilts - 1 ? 0 : 1;
        Acc c0, cm, cp;
        if (!slow) {
          // columns d - 1 .. d + L of the window; tap i = column - (d + e)
          const float2* tc = taps + p * Lp + kPad - 1;
          const float2* tm = taps + pm * Lp + kPad - 1 - em;
          const float2* tp = taps + pp * Lp + kPad - 1 - ep;
          const int q = (kk + 1) * sps + d - 1;
          int ph = q % sps, off = q / sps;
#pragma unroll 5
          for (int c = 0; c < L + 2; ++c) {
            const float2 w = win[ph * P + off];
            c0.add(w, tc[c]);
            cm.add(w, tm[c]);
            cp.add(w, tp[c]);
            if (++ph == sps) {
              ph = 0;
              ++off;
            }
          }
        } else {
          // every column, zero taps included: x*0 is NaN for x non-finite
          const float2* rc = taps + p * Lp;
          const float2* rm = taps + pm * Lp;
          const float2* rp = taps + pp * Lp;
          int ph = 0, off = kk + 1;
          for (int t = 0; t < lp.width; ++t) {
            const float2 w = win[ph * P + off];
            c0.add(w, tap_at(rc, t - d, L));
            cm.add(w, tap_at(rm, t - d - em, L));
            cp.add(w, tap_at(rp, t - d - ep, L));
            if (++ph == sps) {
              ph = 0;
              ++off;
            }
          }
        }
        const size_t at = static_cast<size_t>(j) * B + k;
        ys[at] = c0.yr;
        ys[static_cast<size_t>(lp.nblocks) * B + at] = c0.yi;
        const float v[6] = {c0.u(), c0.pw(), cm.u(), cm.pw(), cp.u(), cp.pw()};
        if (k < h) {
#pragma unroll
          for (int i = 0; i < 6; ++i) sum[i] += v[i];
        } else {
#pragma unroll
          for (int i = 0; i < 6; ++i) sum[6 + i] += v[i];
        }
      }
      __syncthreads();                 // the window is free for the next tile
    }

#pragma unroll
    for (int i = 0; i < kSums; ++i) sum[i] = warp_sum(sum[i]);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kSums; ++i) red[warp * kSums + i] = sum[i];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < kSums; ++i)
        sum[i] = warp_sum(lane < nwarps ? red[lane * kSums + i] : 0.0f);
      if (lane == 0) {
        // e = mean(u)/(mean(pw) + 1e-12) a half and row; then the update
        // of ops/dsp.py::_pfb_track_plain, scalar for scalar
        float e[2][3], tau[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int rw = 0; rw < 3; ++rw) {
            const float mu = sum[hh * 6 + rw * 2] * lp.inv_h;
            const float mp = sum[hh * 6 + rw * 2 + 1] * lp.inv_h;
            e[hh][rw] = mu / (mp + 1e-12f);
          }
          const float g = (e[hh][2] - e[hh][1]) * lp.inv_2delta;
          tau[hh] = lp.qs * atan2f(e[hh][0], g * lp.qs);
        }
        const float rate_n = clip_keep_nan(
            rate - (lp.aa * (tau[1] - tau[0])) * lp.inv_h, -lp.rate_clip,
            lp.rate_clip);
        const float tau_end = tau[1] + 0.5f * (tau[1] - tau[0]);
        const float adv = ((frac + lp.bsps) + lp.bf * rate_n) - lp.a * tau_end;
        const float stepi = floorf(adv);
        s_ibase = wrap_add(ibase, __float2ll_rz(stepi));
        s_frac = adv - stepi;
        s_rate = rate_n;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    *ibase_out = s_ibase;
    *frac_out = s_frac;
    *rate_out = s_rate;
  }
}

int threads_for(int B) {
  const int syms = B < kTileSyms ? B : kTileSyms;
  const int t = (syms + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one launch: the taps, the staged window and the
// warps' partial sums.
int pfb_track_smem_bytes(int B, int sps, int nfilts, int L, int width) {
  const int tile_max = B < kTileSyms ? B : kTileSyms;
  const int P = tile_max + width / sps + 1;
  return nfilts * (L + 2 * kPad) * 8 + sps * P * 8 + 32 * kSums * 4;
}

int pfb_track_threads(int B) { return threads_for(B); }

// One launch: one block on ``stream`` over ``nblocks`` tracking blocks;
// returns cudaGetLastError() (0 on success), or the error of raising the
// block's shared-memory limit. x is the (2, n) float32 padded stream, bank
// and dbank (nfilts, L) float32, the state (ibase int64, frac, rate float32)
// one element each in and out, ys (2, nblocks, B) float32.
int pfb_track(const void* x, long long n, const void* bank, const void* dbank,
              const void* ibase0, const void* frac0, const void* rate0,
              void* ys, void* ibase_out, void* frac_out, void* rate_out,
              int nblocks, int B, int sps, int nfilts, int L, int d0,
              int rows, int width, long long last, float nf, float bsps,
              float bf, float a, float aa, float inv_h, float inv_2delta,
              float qs, float rate_clip, void* stream) {
  const int smem = pfb_track_smem_bytes(B, sps, nfilts, L, width);
  cudaError_t err = cudaFuncSetAttribute(
      pfb_track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Loop lp{n, last, nblocks, B, sps, nfilts, L, d0, rows, width,
                nf, bsps, bf, a, aa, inv_h, inv_2delta, qs, rate_clip};
  pfb_track_kernel<<<1, threads_for(B), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(bank),
      static_cast<const float*>(dbank),
      static_cast<const long long*>(ibase0), static_cast<const float*>(frac0),
      static_cast<const float*>(rate0), static_cast<float*>(ys),
      static_cast<long long*>(ibase_out), static_cast<float*>(frac_out),
      static_cast<float*>(rate_out), lp);
  return static_cast<int>(cudaGetLastError());
}

const char* pfb_track_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
