// K13: the equal-power stereo panner over a group's lanes for one superblock.
//
// Replaces graphaudio_tpu/nodes/panner.py StereoPannerNode.process (:44-63),
// StereoPannerNode.cs:76-153. pan is clipped to [-1, 1]. Mono input: x =
// (pan + 1) / 2, gL = cos(x pi/2), gR = sin(x pi/2), L = in gL, R = in gR.
// Stereo input: x = pan + 1 for pan <= 0, else pan; pan <= 0 gives L = inL +
// inR gL, R = inR gR, else L = inL gL, R = inR + inL gR. The TPU version is
// XLA's elementwise fusion; its reference is the C# per-sample loop.
//
// Rounding as the plain version (nodes/panner.py): cos and sin in f64 of the
// f32 angle, rounded once (the correctly rounded f32 values; XLA's own f32
// trig is one ulp off now and then, which the CPU tests state as their
// tolerance), XLA's contraction of inL + inR gL and inR + inL gR into one
// fma each (tests/test_torch_delay_panner.py), __f*_rn elsewhere.
// pan is a row a lane, or one base value a lane (a pan without events: the
// broadcast view is never copied).
//
// Bound on the H100: memory, 12 (mono) or 16 (stereo) bytes a frame a lane
// with a row of pans, against two f64 transcendentals a frame (~40 f64
// operations: under a third of the byte time at 34 TFLOP/s). One thread a
// frame of a lane, coalesced rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kHalfPi = 1.57079632679489661923f;  // fl32(pi / 2)

__global__ void __launch_bounds__(kThreads) stereo_pan_kernel(
    const float* __restrict__ x, int C, const float* __restrict__ pan, int pan_rows, int T,
    float* __restrict__ out) {
  const int v = blockIdx.y;
  const int t = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (t >= T) return;
  float p = pan_rows ? pan[static_cast<int64_t>(v) * T + t] : pan[v];
  p = p < -1.0f ? -1.0f : p;  // comparisons: NaN passes, as torch.clamp lets it
  p = p > 1.0f ? 1.0f : p;
  const float* xv = x + static_cast<int64_t>(v) * C * T;
  float* ol = out + static_cast<int64_t>(v) * 2 * T;
  float* orr = ol + T;
  if (C == 1) {
    const float a = __fmul_rn(__fmul_rn(__fadd_rn(p, 1.0f), 0.5f), kHalfPi);
    const float gl = static_cast<float>(cos(static_cast<double>(a)));
    const float gr = static_cast<float>(sin(static_cast<double>(a)));
    const float m = xv[t];
    ol[t] = __fmul_rn(m, gl);
    orr[t] = __fmul_rn(m, gr);
  } else {
    const bool left = p <= 0.0f;
    const float a = __fmul_rn(left ? __fadd_rn(p, 1.0f) : p, kHalfPi);
    const float gl = static_cast<float>(cos(static_cast<double>(a)));
    const float gr = static_cast<float>(sin(static_cast<double>(a)));
    const float l = xv[t], r = xv[T + t];
    ol[t] = left ? fmaf(r, gl, l) : __fmul_rn(l, gl);
    orr[t] = left ? __fmul_rn(r, gr) : fmaf(l, gr, r);
  }
}

}  // namespace

GA_EXPORT int ga_stereo_pan(const float* x, int V, int C, const float* pan, int pan_rows, int T,
                            float* out, void* stream) {
  const dim3 grid((T + kThreads - 1) / kThreads, V);
  stereo_pan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, C, pan, pan_rows, T, out);
  return ga_launch_status();
}
