// The streaming receive blocks' two per-sample feedback loops, hand-written
// for Hopper (sm_90a): the AGC (agc_loop_kernel) and the second-order BPSK
// Costas loop (costas_loop_kernel).
//
// Neither replaces a TPU kernel: the JAX package runs both as lax.scan
// recurrences (gr_ldpc_ece535a_tpu/ops/dsp.py:113 agc, :130 costas_loop).
// No PyTorch call computes a nonlinear per-sample feedback loop, and a
// Python loop over the samples on the card is a launch per operation and
// sample, so a kernel is the only way the blocks run these loops on the
// card.
//
// What bounds them: each sample's state (the gain; the phase and frequency)
// depends on the previous sample's, so the loop is one serial chain of
// dependent instructions, sinf/cosf/fmodf or hypotf included. 16 bytes a
// sample of device memory (a complex64 read and written) is far below
// that chain's time. The design is the simple one: one block stages a tile
// of the stream into shared memory with coalesced loads by all its
// threads; one thread runs the recurrence over the tile with the state in
// registers (#pragma unroll 1: one sample an iteration, so the chain can
// be read off the SASS); the block stores the tile; the next tile follows.
// A parallel affine scan for the AGC (it is linear in g, but it would
// change where rounding falls) and double-buffered staging are later work.
//
// Rounding, held bit for bit against the plain PyTorch versions in
// ops/dsp.py (agc_plain, costas_loop_plain) on the card:
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

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;            // samples a tile: 32 KB of float2
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// jnp.mod(a, b) and torch.remainder(a, b) for floats
__device__ __forceinline__ float floored_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

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

// out[i] = x[i] * exp(-i phase); err = clip(Re*Im, +-1);
// freq = clip(freq + beta*err, +-1); phase = (phase + freq) + alpha*err,
// wrapped to [-pi, pi) by the floored mod
__global__ void __launch_bounds__(kThreads)
costas_loop_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   long long n, float alpha, float beta,
                   const float* __restrict__ state0,
                   float* __restrict__ state_out) {
  __shared__ float2 tile[kTile];
  float phase = 0.0f, freq = 0.0f;
  if (threadIdx.x == 0) {
    phase = state0[0];
    freq = state0[1];
  }
  for (long long base = 0; base < n; base += kTile) {
    const int m = static_cast<int>(n - base < kTile ? n - base : kTile);
    for (int i = threadIdx.x; i < m; i += kThreads) tile[i] = x[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 1
      for (int i = 0; i < m; ++i) {
        const float2 v = tile[i];
        const float c = cosf(phase);
        const float s = sinf(phase);
        // x * (cos(phase) + i sin(-phase)), JAX's product, with the
        // negation folded in (exact)
        const float yr = v.x * c + v.y * s;
        const float yi = v.y * c - v.x * s;
        tile[i] = make_float2(yr, yi);
        const float err = clip_keep_nan(yr * yi, -1.0f, 1.0f);
        freq = clip_keep_nan(freq + beta * err, -1.0f, 1.0f);
        phase = (phase + freq) + alpha * err;
        phase = floored_mod(phase + kPi, kTwoPi) - kPi;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads) y[base + i] = tile[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    state_out[0] = phase;
    state_out[1] = freq;
  }
}

}  // namespace

extern "C" {

// Each launch: one block on ``stream``; returns cudaGetLastError() (0 on
// success). x and y are n complex64 samples; the state is read from and
// written to device memory, so no host sync is needed between chunks.
int dsp_agc_loop(const void* x, void* y, long long n, float rate,
                 float reference, const void* g0, void* g_out, void* stream) {
  agc_loop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), n, rate,
      reference, static_cast<const float*>(g0), static_cast<float*>(g_out));
  return static_cast<int>(cudaGetLastError());
}

int dsp_costas_loop(const void* x, void* y, long long n, float alpha,
                    float beta, const void* state0, void* state_out,
                    void* stream) {
  costas_loop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), n, alpha, beta,
      static_cast<const float*>(state0), static_cast<float*>(state_out));
  return static_cast<int>(cudaGetLastError());
}

const char* dsp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
