// K10b: the spatial panner's closed-form direct path, per (lane, quantum),
// for every panner stage of a step in one launch.
//
// Replaces graphaudio_tpu/nodes/spatial.py _direct_gains (:270-348) with
// the source direction of process (:399-400): listener-basis direction,
// cone directivity, the three distance models, the occlusion band gains
// and the blend, then azimuth = atan2(dx, -dz), elevation = asin(dy).
// The plain version (nodes/spatial.py spatial_gains_plain) is the same
// arithmetic as some sixty torch launches; here it is one launch a step,
// over every lane of every panner stage, and it reads the 17 k-rate params
// where they lie: no [17, V, S] tensor is built.
//
// Plan (nodes/spatial.py pack_gains_table, once per param encoding), passed
// by value as a __grid_constant__ struct, so a thread reads it from the
// constant bank and the params are its only dependent global loads: per
// stage its first lane, its distance model (data, as K8 takes the filter
// type), the offset of its f32[6, V, S] output and one source word a
// param, off << 2 | mode (ops/param_eval.py source_words) of the stage's
// lane 0. SRC_KRATE reads src[off + v*S + s] (lane v's k-rate row of the
// step's K6 arena), SRC_ARATE src[off + 128 (v*S + s)] (an a-rate row),
// SRC_CONST consts[off + v] (lane v's base value of a param without
// events). The listener's position and basis are f32[3] each (the step's
// globals). Output, per stage: azimuth, elevation, low/mid/high band gains
// and blend, the rows P1 reads. A launch takes up to kMaxStages stages.
//
// One thread per (lane, quantum), blocks of 32 threads, so config 5's 4096
// pairs take 128 blocks on 128 SMs: each thread's dependent chain of sqrt,
// divides, acos, pow, atan2 and asin runs beside the others. Every f32
// operation is spelled __f*_rn in the plain version's order, so nvcc
// contracts nothing; sqrt, acos, atan2, asin and pow are the CUDA math
// library's, as torch's are.
//
// Bound on the H100: launch. Config 5 (V=128, S=32): 278 KB of params in at
// most, 98 KB out, a few hundred flops a pair, well under a microsecond on
// either limit.
#include <cstring>

#include "common.cuh"

namespace {

enum { kLinear = 0, kInverse = 1, kExponential = 2 };
enum { kSrcArate = 0, kSrcKrate = 1, kSrcConst = 2 };
constexpr int kParams = 17;
constexpr int kMaxStages = 32;
constexpr int kThreads = 32;

// The layout of nodes/spatial.py _plan_words, int32 words in this order.
struct GainsPlan {
  int n;                         // stages
  int lane0[kMaxStages + 1];     // first lane of each stage, then the lane count
  int model[kMaxStages];
  int out[kMaxStages];           // offset of the stage's [6, V, S] output
  int src[kMaxStages][kParams];  // lane 0's source word of each param
};

__global__ void __launch_bounds__(kThreads)
    spatial_gains_kernel(const float* __restrict__ src, const float* __restrict__ consts, int S,
                         const float* __restrict__ lpos, const float* __restrict__ right,
                         const float* __restrict__ up, const float* __restrict__ ahead,
                         float* __restrict__ out, const __grid_constant__ GainsPlan plan) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (lane, quantum), quantum fastest
  const int lane = i / S, s = i - lane * S;
  if (lane >= plan.lane0[plan.n]) return;
  int k = 0;
  while (lane >= plan.lane0[k + 1]) ++k;
  const int v = lane - plan.lane0[k], V = plan.lane0[k + 1] - plan.lane0[k];
  float q[kParams];
#pragma unroll
  for (int j = 0; j < kParams; ++j) {
    // 32-bit: every index is below the K6 arena's size, which
    // pack_param_table keeps under 2^31 floats.
    const int word = plan.src[k][j], mode = word & 3;
    const int at = (word >> 2) + (mode == kSrcConst   ? v
                                  : mode == kSrcKrate ? v * S + s
                                                      : (v * S + s) * 128);
    q[j] = __ldg((mode == kSrcConst ? consts : src) + at);
  }
  const int model = plan.model[k];
  float* o = out + plan.out[k] + static_cast<int64_t>(v) * S + s;
  const int64_t stride = static_cast<int64_t>(V) * S;
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

  o[0] = atan2f(dx, -dz);
  o[stride] = asinf(fminf(fmaxf(dy, -1.0f), 1.0f));
  o[2 * stride] = __fmul_rn(base, band(tl));
  o[3 * stride] = __fmul_rn(base, band(tm));
  o[4 * stride] = __fmul_rn(base, band(th));
  o[5 * stride] = blend;
}

}  // namespace

// src: the K6 arena (or any f32 the source words index), consts: the base
// values, S quanta; plan: host int32 words of a GainsPlan.
GA_EXPORT int ga_spatial_gains_batch(const float* src, const float* consts, int S,
                                     const float* lpos, const float* right, const float* up,
                                     const float* ahead, float* out, const int* plan_words,
                                     void* stream) {
  GainsPlan plan;
  static_assert(sizeof(GainsPlan) % sizeof(int) == 0, "int32 words");
  std::memcpy(&plan, plan_words, sizeof(GainsPlan));
  if (plan.n < 1 || plan.n > kMaxStages || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < plan.n; ++k)
    if (plan.lane0[k + 1] <= plan.lane0[k] || plan.model[k] < kLinear ||
        plan.model[k] > kExponential)
      return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(plan.lane0[plan.n]) * S;
  if (plan.lane0[0] != 0 || n >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  spatial_gains_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(src, consts, S, lpos, right, up,
                                                              ahead, out, plan);
  return ga_launch_status();
}
