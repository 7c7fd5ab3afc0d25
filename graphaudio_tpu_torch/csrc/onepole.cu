// K9: static-pole one-pole lowpass y[n] = a y[n-1] + (1-a) x[n], blocked.
//
// Replaces graphaudio_tpu/ops/onepole.py onepole_lowpass (:62), which
// writes the recurrence as a per-block decay matmul plus a carry matmul over
// the superblock axis (_matrices :33). It serves the spatial panner's
// occlusion band split (two crossovers, nodes/spatial.py:350-367).
//
// One block per row (a (voice, channel) pair), one thread per 128-frame
// block b:
//   1. each thread runs its block's recurrence from 0 and keeps the tail;
//   2. one thread scans the carries over the S blocks:
//      carry[b] = a^128 carry[b-1] + tail[b-1], carry[0] = y0;
//   3. each thread runs its block's recurrence again from carry[b], which
//      by linearity is the block's part plus a^(n+1) carry[b], and writes y.
// The state is f64 (rounded to f32 on output), so the result is the exact
// recurrence to one f32 rounding; the plain version's f32 matmuls round
// their products (ops/onepole.py). No single sequential sweep over the
// superblock (P2's ~68 ns per sample on this card, PERF.md): S threads
// each walk 128 samples twice.
//
// Bound on the H100: latency. A row is 2 x 128 dependent f64 fmas plus the
// S-step carry scan; an occluded group of V voices, C channels runs V*C
// blocks. Bytes: x read twice (the second time from L1/L2), y written once.
#include "common.cuh"

namespace {

constexpr int kF = 128;

__global__ void onepole_kernel(const float* __restrict__ x, const float* __restrict__ y0,
                               double a, int S, float* __restrict__ y, float* __restrict__ carry_out) {
  extern __shared__ double sh[];  // tail[S], then carry[S]
  double* tail = sh;
  double* carry = sh + S;
  const int64_t row = blockIdx.x;
  const int b = threadIdx.x;
  const double oma = 1.0 - a;
  const float* xb = x + (row * S + b) * kF;
  if (b < S) {
    double p = 0.0;
    for (int n = 0; n < kF; ++n) p = fma(a, p, oma * xb[n]);
    tail[b] = p;
  }
  __syncthreads();
  if (b == 0) {
    double a128 = 1.0;
    for (int n = 0; n < kF; ++n) a128 *= a;
    double c = y0[row];
    for (int k = 0; k < S; ++k) {
      carry[k] = c;
      c = fma(a128, c, tail[k]);
    }
  }
  __syncthreads();
  if (b < S) {
    double p = carry[b];
    float* yb = y + (row * S + b) * kF;
    for (int n = 0; n < kF; ++n) {
      p = fma(a, p, oma * xb[n]);
      yb[n] = static_cast<float>(p);
    }
    if (b == S - 1) carry_out[row] = static_cast<float>(p);
  }
}

}  // namespace

GA_EXPORT int ga_onepole(const float* x, const float* y0, double a, int rows, int S, float* y,
                         float* carry, void* stream) {
  if (S < 1 || S > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (S + 31) / 32 * 32;
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(double);
  onepole_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(x, y0, a, S, y,
                                                                             carry);
  return ga_launch_status();
}
