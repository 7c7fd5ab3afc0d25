// K15: the decoder stream node's read of its per-call feed, one superblock.
//
// Replaces graphaudio_tpu/io/stream.py AudioDecoderStreamNode.process
// (:304-325), which the JAX package computes inside its jitted step (no
// Pallas kernel): the feed f32[C, N] holds the call's upcoming source
// samples, staged by the host (io/stream.py prepare_feed), and the step reads
// its T = S*128 frames from frame j0 = frame0 - base of it:
//   unity:    out[c, i] = feed[c, j0 + i];
//   resample: quantum s starts at x = x0 + (j0 + 128 s) * rate (f64, the
//             stage's state), expanded per sample as ops/resample.py
//             split_positions does (an f64 anchor every 16 samples, the f32
//             offset within the chunk, floors), four taps at base - 1 ..
//             base + 2 clamped to [0, N - 1] (the padded feed: taps past the
//             data read its zeros), Catmull-Rom.
//
// Rounding as the plain version (ops/stream.py stream_feed_plain), which is
// XLA's on the CPU for this node: the quantum's position one f64 fma, the
// anchors and offsets product by product (__dmul_rn/__dadd_rn, __f*_rn), and
// three of the polynomial's multiply-adds fmas (fmaf), as XLA contracts them.
//
// Grid (S, C), a block a quantum of one channel, a thread an output; the
// output is a fresh contiguous [C, T]. Bound on the H100: memory (the taps
// are neighbours, read once from DRAM; 8 bytes a frame a channel unity, about
// 4 + 4 rate resample).
#include "common.cuh"

namespace {

constexpr int kQuantum = 128;
constexpr int kSubChunk = 16;  // samples between two f64 anchors

template <bool kResample>
__global__ void __launch_bounds__(kQuantum) stream_feed_kernel(
    const float* __restrict__ feed, int64_t n, int64_t j0, const double* __restrict__ x0p,
    const double* __restrict__ ratep, int T, float* __restrict__ out) {
  const int s = blockIdx.x;
  const int i = threadIdx.x;
  const float* f = feed + static_cast<int64_t>(blockIdx.y) * n;
  float* o = out + static_cast<int64_t>(blockIdx.y) * T + s * kQuantum;
  if (!kResample) {
    o[i] = f[j0 + s * kQuantum + i];
    return;
  }
  const double rate = *ratep;
  const double xb = fma(static_cast<double>(j0 + s * kQuantum), rate, *x0p);
  const double anchor = __dadd_rn(
      xb, __dmul_rn(static_cast<double>(i / kSubChunk), __dmul_rn(16.0, rate)));
  const double a_int = floor(anchor);
  const float a_frac = __double2float_rn(__dsub_rn(anchor, a_int));
  const float local = __fadd_rn(
      a_frac, __fmul_rn(static_cast<float>(i % kSubChunk), __double2float_rn(rate)));
  const float base_local = floorf(local);
  const float t = __fsub_rn(local, base_local);
  const int64_t base = static_cast<int64_t>(static_cast<int>(a_int) + static_cast<int>(base_local));
  float tap[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int64_t at = base + k - 1;
    at = at < 0 ? 0 : (at > n - 1 ? n - 1 : at);
    tap[k] = f[at];
  }
  const float s0 = tap[0], s1 = tap[1], s2 = tap[2], s3 = tap[3];
  const float c = __fadd_rn(__fmul_rn(0.5f, __fsub_rn(s3, s0)), __fmul_rn(1.5f, __fsub_rn(s1, s2)));
  const float b = __fsub_rn(__fadd_rn(fmaf(-2.5f, s1, s0), __fmul_rn(2.0f, s2)),
                            __fmul_rn(0.5f, s3));
  const float x = __fadd_rn(__fmul_rn(0.5f, __fsub_rn(s2, s0)), __fmul_rn(t, fmaf(t, c, b)));
  o[i] = fmaf(t, x, s1);
}

}  // namespace

GA_EXPORT int ga_stream_feed(const float* feed, int C, int64_t n, int64_t j0, int S,
                             const double* x0, const double* rate, int resample, float* out,
                             void* stream) {
  const dim3 grid(S, C);
  const int T = S * kQuantum;
  auto st = static_cast<cudaStream_t>(stream);
  if (resample) {
    stream_feed_kernel<true><<<grid, kQuantum, 0, st>>>(feed, n, j0, x0, rate, T, out);
  } else {
    stream_feed_kernel<false><<<grid, kQuantum, 0, st>>>(feed, n, j0, x0, rate, T, out);
  }
  return ga_launch_status();
}
