// K15: the decoder stream node's read of its per-call feed, a whole render
// call in one launch.
//
// Replaces graphaudio_tpu/io/stream.py AudioDecoderStreamNode.process
// (:304-325), which the JAX package computes inside its jitted step (no
// Pallas kernel): the feed f32[C, N] holds the call's upcoming source
// samples, staged by the host (io/stream.py prepare_feed), and step k reads
// its T = S*128 frames from frame k*T of it. Every input of that read is
// fixed once the call starts, so one launch reads all n_steps steps before
// the step loop into out f32[n_steps, C, T] (row k step k's output). With
// j = k*T + i the frame within the call and q = j / 128 its quantum:
//   unity:    out[k, c, i] = feed[c, j];
//   resample: quantum q starts at x = x0 + (128 q) * rate (f64; x0 and rate
//             the stage's state, passed by value), expanded per sample as
//             ops/resample.py split_positions does (an f64 anchor every 16
//             samples, the f32 offset within the chunk, floors), four taps
//             at base - 1 .. base + 2 clamped to [0, N - 1] (the padded
//             feed: taps past the data read its zeros), Catmull-Rom.
//
// Rounding as the plain version (ops/stream.py stream_feed_call_plain),
// which is XLA's on the CPU for this node: the quantum's position one f64
// fma, the anchors and offsets product by product (__dmul_rn/__dadd_rn,
// __f*_rn), and three of the polynomial's multiply-adds fmas (fmaf), as
// XLA contracts them. 128 q is an exact integer, so a quantum's position is
// the double the per-step read computed as j0 + 128 s.
//
// Bound on the H100: memory. A 30 s call of a stereo stream reads and
// writes about 11.5 MB each (≈ 6.6-6.9 µs at 3.35 TB/s). Grid (M / 1024,
// C) with M = n_steps * T, 256 threads, a block 1024 frames of one channel,
// a thread four consecutive frames, one 16-byte store (unity: one 16-byte
// load too). The four frames lie in one 16-sample sub-chunk, so they share
// its f64 anchor: one f64 anchor per four outputs. The taps of neighbouring
// outputs overlap and are read through the read-only path (__ldg), whose L1
// serves the repeats. The resampler's per-output work is issue-bound on
// the conversion unit unless kept off it: rate's f32 rounding comes from the
// host, the in-chunk index is converted once a thread, and floor(local) is
// taken by adding 2^23 rounded down (exact for 0 <= local < 2^23, which the
// wrapper's bound on rate guarantees), its integer read from the sum's bits.
// A warp a quantum with lane-strided outputs (four anchors a lane) timed
// slower.
#include "common.cuh"

namespace {

constexpr int kQuantum = 128;
constexpr int kSubChunk = 16;  // samples between two f64 anchors
constexpr int kThreads = 256;
constexpr int kVec = 4;        // consecutive outputs a thread
constexpr float kTwo23 = 8388608.0f;

template <bool kResample>
__global__ void __launch_bounds__(kThreads) stream_feed_call_kernel(
    const float* __restrict__ feed, int n, double x0, double rate, float rate_f, uint32_t T,
    uint32_t M, float* __restrict__ out) {
  const uint32_t j = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (j >= M) return;
  const int c = blockIdx.y;
  const uint32_t k = j / T;
  const float* f = feed + static_cast<int64_t>(c) * n;
  float4* o = reinterpret_cast<float4*>(
      out + (static_cast<int64_t>(k) * gridDim.y + c) * T + (j - k * T));
  if (!kResample) {
    *o = __ldg(reinterpret_cast<const float4*>(f + j));
    return;
  }
  const uint32_t r = j % kQuantum;  // a multiple of kVec: the four share a sub-chunk
  const double xb = fma(static_cast<double>(j - r), rate, x0);
  const double anchor = __dadd_rn(
      xb, __dmul_rn(static_cast<double>(r / kSubChunk), __dmul_rn(16.0, rate)));
  const double a_int = floor(anchor);
  const float a_frac = __double2float_rn(__dsub_rn(anchor, a_int));
  const int a_base = static_cast<int>(a_int);
  const float m0 = static_cast<float>(r % kSubChunk);
  float res[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const float local = __fadd_rn(a_frac, __fmul_rn(__fadd_rn(m0, static_cast<float>(u)), rate_f));
    const float shifted = __fadd_rd(local, kTwo23);  // 2^23 + floor(local)
    const float t = __fsub_rn(local, __fsub_rn(shifted, kTwo23));
    const int base = a_base + (__float_as_int(shifted) - __float_as_int(kTwo23));
    float tap[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      tap[m] = __ldg(f + min(max(base + m - 1, 0), n - 1));
    }
    const float s0 = tap[0], s1 = tap[1], s2 = tap[2], s3 = tap[3];
    const float cc = __fadd_rn(__fmul_rn(0.5f, __fsub_rn(s3, s0)),
                               __fmul_rn(1.5f, __fsub_rn(s1, s2)));
    const float b = __fsub_rn(__fadd_rn(fmaf(-2.5f, s1, s0), __fmul_rn(2.0f, s2)),
                              __fmul_rn(0.5f, s3));
    const float x = __fadd_rn(__fmul_rn(0.5f, __fsub_rn(s2, s0)), __fmul_rn(t, fmaf(t, cc, b)));
    res[u] = fmaf(t, x, s1);
  }
  *o = make_float4(res[0], res[1], res[2], res[3]);
}

}  // namespace

GA_EXPORT int ga_stream_feed_call(const float* feed, int C, int n, int n_steps, int S,
                                  double x0, double rate, int resample, float* out,
                                  void* stream) {
  const uint32_t T = static_cast<uint32_t>(S) * kQuantum;
  const uint32_t M = static_cast<uint32_t>(n_steps) * T;
  const dim3 grid((M + kThreads * kVec - 1) / (kThreads * kVec), C);
  const float rate_f = static_cast<float>(rate);  // round to nearest, as __double2float_rn
  auto st = static_cast<cudaStream_t>(stream);
  if (resample) {
    stream_feed_call_kernel<true><<<grid, kThreads, 0, st>>>(feed, n, x0, rate, rate_f, T, M,
                                                             out);
  } else {
    stream_feed_call_kernel<false><<<grid, kThreads, 0, st>>>(feed, n, x0, rate, rate_f, T, M,
                                                              out);
  }
  return ga_launch_status();
}
