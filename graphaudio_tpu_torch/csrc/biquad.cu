// K8: per-sample RBJ biquad coefficients and pole split of one filter group.
//
// Replaces graphaudio_tpu/ops/biquad.py rbj_coefficients (:43-121) and the
// pole split at the head of biquad_apply (:488-495), with the clamps and the
// k-rate gain expansion of nodes/biquad.py BiQuadFilterNode.process
// (:146-157). One thread per (lane, sample), all elementwise: bound by the
// launch and the f64 sin/cos/pow at a few thousand samples per lane.
//
// Rounding follows the plain version (ops/biquad.py) and, through it, the
// XLA CPU build of the reference, because config 3's low-frequency resonant
// sections amplify one-ulp differences in a1/a2 into output differences
// near the 1e-5 bar: the same association order, every f32 operation spelt
// __f*_rn so nvcc contracts nothing on its own, one fmaf exactly where XLA
// fuses (the discriminant), the constant divisions as XLA rewrites them
// (f * (2pi/sr), g * (1/40)), and sin/cos/pow in f64 rounded once to f32
// (the correctly rounded value, which XLA's f32 functions return for
// 98.7-99.9 % of inputs; see ops/xla_rounding.py).
//
// Pole order: for complex poles Im(p1) >= 0, as XLA's complex sqrt returns
// for a negative real discriminant with either sign of zero imaginary part.
#include "common.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__global__ void biquad_coeffs_kernel(
    const float* __restrict__ freq, const float* __restrict__ qp,
    const float* __restrict__ gain, int V, int T, int type, float half_sr,
    float w0_scale, float* __restrict__ b, float2* __restrict__ p) {
  const int64_t n = static_cast<int64_t>(V) * T;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= n) return;
  const int v = static_cast<int>(gid / T);
  const int t = static_cast<int>(gid - static_cast<int64_t>(v) * T);
  const int S = T / 128;

  // Per-sample clamps (BiQuadFilterNode.cs:123-124), k-rate gain per quantum.
  const float f = fminf(fmaxf(freq[gid], 1.0f), half_sr);
  const float q = fmaxf(qp[gid], 0.001f);
  const float g = gain[static_cast<int64_t>(v) * S + t / 128];

  const float w0 = mul(f, w0_scale);
  const float cosw = static_cast<float>(cos(static_cast<double>(w0)));
  const float sinw = static_cast<float>(sin(static_cast<double>(w0)));
  const float alpha = dvd(sinw, mul(2.0f, q));

  float b0, b1, b2, a0, a1, a2;
  if (type <= 4) {  // the types without gain share a0, a1, a2
    a0 = add(1.0f, alpha);
    a1 = mul(-2.0f, cosw);
    a2 = sub(1.0f, alpha);
    switch (type) {
      case 0:  // lowpass
        b1 = sub(1.0f, cosw);
        b0 = mul(b1, 0.5f);
        b2 = b0;
        break;
      case 1:  // highpass
        b0 = mul(add(1.0f, cosw), 0.5f);
        b1 = -add(1.0f, cosw);
        b2 = b0;
        break;
      case 2:  // bandpass
        b0 = alpha;
        b1 = 0.0f;
        b2 = -alpha;
        break;
      case 3:  // notch
        b0 = 1.0f;
        b1 = a1;
        b2 = 1.0f;
        break;
      default:  // allpass
        b0 = sub(1.0f, alpha);
        b1 = a1;
        b2 = add(1.0f, alpha);
        break;
    }
  } else {
    const float A = static_cast<float>(pow(10.0, static_cast<double>(mul(g, 0.025f))));
    if (type == 5) {  // peaking
      const float aA = mul(alpha, A), adA = dvd(alpha, A);
      b0 = add(1.0f, aA);
      b1 = mul(-2.0f, cosw);
      b2 = sub(1.0f, aA);
      a0 = add(1.0f, adA);
      a1 = b1;
      a2 = sub(1.0f, adA);
    } else {
      const float beta = dvd(__fsqrt_rn(A), q);
      const float ap1 = add(A, 1.0f), am1 = sub(A, 1.0f);
      const float am1c = mul(am1, cosw), ap1c = mul(ap1, cosw), bs = mul(beta, sinw);
      if (type == 6) {  // lowshelf
        b0 = mul(A, add(sub(ap1, am1c), bs));
        b1 = mul(mul(2.0f, A), sub(am1, ap1c));
        b2 = mul(A, sub(sub(ap1, am1c), bs));
        a0 = add(add(ap1, am1c), bs);
        a1 = mul(-2.0f, add(am1, ap1c));
        a2 = sub(add(ap1, am1c), bs);
      } else {  // highshelf
        b0 = mul(A, add(add(ap1, am1c), bs));
        b1 = mul(mul(-2.0f, A), add(am1, ap1c));
        b2 = mul(A, sub(add(ap1, am1c), bs));
        a0 = add(sub(ap1, am1c), bs);
        a1 = mul(2.0f, sub(am1, ap1c));
        a2 = sub(sub(ap1, am1c), bs);
      }
    }
  }
  const float inv_a0 = dvd(1.0f, a0);
  b[gid] = mul(b0, inv_a0);
  b[n + gid] = mul(b1, inv_a0);
  b[2 * n + gid] = mul(b2, inv_a0);
  const float na1 = mul(a1, inv_a0), na2 = mul(a2, inv_a0);

  // Pole split: d = a1*a1 - 4*a2 fused as XLA fuses it.
  const float d = fmaf(na1, na1, -mul(4.0f, na2));
  const float s = __fsqrt_rn(fabsf(d));
  if (d >= 0.0f) {
    p[gid] = make_float2(mul(0.5f, add(-na1, s)), 0.0f);
    p[n + gid] = make_float2(mul(0.5f, sub(-na1, s)), 0.0f);
  } else {
    p[gid] = make_float2(mul(0.5f, -na1), mul(0.5f, s));
    p[n + gid] = make_float2(mul(0.5f, -na1), -mul(0.5f, s));
  }
}

}  // namespace

GA_EXPORT int ga_biquad_coeffs(const float* freq, const float* q, const float* gain, int V,
                               int T, int type, float half_sr, float w0_scale, float* b,
                               float2* p, void* stream) {
  const int64_t n = static_cast<int64_t>(V) * T;
  const int threads = 256;
  const int blocks = static_cast<int>((n + threads - 1) / threads);
  biquad_coeffs_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      freq, q, gain, V, T, type, half_sr, w0_scale, b, p);
  return ga_launch_status();
}
