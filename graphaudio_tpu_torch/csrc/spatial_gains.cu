// K10b: the spatial panner's closed-form direct path, per (voice, quantum).
//
// Replaces graphaudio_tpu/nodes/spatial.py _direct_gains (:270-348) with
// the source direction of process (:399-400): listener-basis direction,
// cone directivity, the three distance models, the occlusion band gains
// and the blend, then azimuth = atan2(dx, -dz), elevation = asin(dy).
// The plain version (nodes/spatial.py spatial_gains_plain) is the same
// arithmetic as some sixty torch launches; here it is one.
//
// Inputs: p f32[17, N] (N = V*S), the k-rate params in GAIN_PARAMS order
// (nodes/spatial.py), the listener's position and basis f32[3] each.
// Output: f32[6, N]: azimuth, elevation, low/mid/high band gains, blend.
// One thread per (voice, quantum). Every f32 operation is spelled __f*_rn
// in the plain version's order, so nvcc contracts nothing; sqrt, acos,
// atan2, asin and pow are the CUDA math library's, as torch's are.
//
// Bound on the H100: launch. Config 5 has N = 4096: 278 KB in, 98 KB out,
// a few hundred flops each, well under a microsecond on either limit.
#include "common.cuh"

namespace {

enum { kLinear = 0, kInverse = 1, kExponential = 2 };

__global__ void spatial_gains_kernel(const float* __restrict__ p, const float* __restrict__ lpos,
                                     const float* __restrict__ right, const float* __restrict__ up,
                                     const float* __restrict__ ahead, int N, int model,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float q[17];
  for (int j = 0; j < 17; ++j) q[j] = p[static_cast<int64_t>(j) * N + i];
  const float px = q[0], py = q[1], pz = q[2], ox = q[3], oy = q[4], oz = q[5];
  const float ref = q[6], mx = q[7], rolloff = q[8], inner = q[9], outer = q[10];
  const float outer_gain = q[11], blend = q[12], occ = q[13], tl = q[14], tm = q[15], th = q[16];

  const float w0 = __fsub_rn(px, lpos[0]), w1 = __fsub_rn(py, lpos[1]), w2 = __fsub_rn(pz, lpos[2]);
  float distance =
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(w0, w0), __fmul_rn(w1, w1)), __fmul_rn(w2, w2)));
  const bool near = distance <= 1e-4f;
  const float inv = near ? 0.0f : __fdiv_rn(1.0f, fmaxf(distance, 1e-9f));
  const float n0 = __fmul_rn(w0, inv), n1 = __fmul_rn(w1, inv), n2 = __fmul_rn(w2, inv);
  auto dot3 = [&](const float* b) {
    return __fadd_rn(__fadd_rn(__fmul_rn(n0, b[0]), __fmul_rn(n1, b[1])), __fmul_rn(n2, b[2]));
  };
  const float dx = near ? 0.0f : dot3(right);
  const float dy = near ? 0.0f : dot3(up);
  const float dz = near ? -1.0f : dot3(ahead);
  if (near) distance = 0.0f;

  // Cone directivity (SpatialPannerNode.cs:166-204).
  const float omag =
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)), __fmul_rn(oz, oz)));
  const bool o_ok = omag > 1e-4f;
  const float oinv = o_ok ? __fdiv_rn(1.0f, fmaxf(omag, 1e-9f)) : 0.0f;
  const float odot = __fadd_rn(__fadd_rn(__fmul_rn(ox, n0), __fmul_rn(oy, n1)), __fmul_rn(oz, n2));
  const float cdot = fminf(fmaxf(__fmul_rn(-odot, oinv), -1.0f), 1.0f);
  const float angle = fabsf(__fmul_rn(acosf(cdot), 57.2957802f));  // f32(180/pi)
  const float half_inner = __fmul_rn(inner, 0.5f), half_outer = __fmul_rn(outer, 0.5f);
  const float tcone = __fdiv_rn(__fsub_rn(angle, half_inner),
                                fmaxf(__fsub_rn(half_outer, half_inner), 1e-6f));
  float directivity = angle <= half_inner  ? 1.0f
                      : angle >= half_outer ? outer_gain
                                            : __fadd_rn(1.0f, __fmul_rn(tcone, __fsub_rn(outer_gain, 1.0f)));
  if (!(((inner < 360.0f) || (outer < 360.0f)) && o_ok)) directivity = 1.0f;

  // Distance attenuation (:206-216, 263-284).
  const float dc = fminf(fmaxf(distance, ref), mx);
  float atten;
  if (model == kLinear) {
    atten = __fsub_rn(1.0f, __fdiv_rn(__fmul_rn(rolloff, __fsub_rn(dc, ref)),
                                      fmaxf(__fsub_rn(mx, ref), 1e-9f)));
  } else if (model == kExponential) {
    atten = powf(fmaxf(__fdiv_rn(dc, fmaxf(ref, 1e-9f)), 1e-9f), -rolloff);
  } else {
    atten = distance <= ref ? 1.0f : __fdiv_rn(ref, fmaxf(distance, 1e-9f));
  }
  atten = fminf(fmaxf(atten, 0.0f), 1.0f);

  // Occlusion with 3-band transmission (:218-248).
  const bool any_trans = (tl > 0.0f) || (tm > 0.0f) || (th > 0.0f);
  const float oocc = __fsub_rn(1.0f, occ);
  auto band = [&](float tr) {
    if (!(occ > 0.0f)) return 1.0f;
    return any_trans ? __fadd_rn(oocc, __fmul_rn(occ, tr)) : oocc;
  };
  const float base = __fmul_rn(atten, directivity);

  out[i] = atan2f(dx, -dz);
  out[N + i] = asinf(fminf(fmaxf(dy, -1.0f), 1.0f));
  out[2 * N + i] = __fmul_rn(base, band(tl));
  out[3 * N + i] = __fmul_rn(base, band(tm));
  out[4 * N + i] = __fmul_rn(base, band(th));
  out[5 * N + i] = blend;
}

}  // namespace

GA_EXPORT int ga_spatial_gains(const float* p, const float* lpos, const float* right,
                               const float* up, const float* ahead, int N, int model, float* out,
                               void* stream) {
  const int threads = 128;
  spatial_gains_kernel<<<(N + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, lpos, right, up, ahead, N,
                                                              model, out);
  return ga_launch_status();
}
