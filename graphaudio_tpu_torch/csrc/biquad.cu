// K8: per-sample RBJ biquad coefficients and pole split of every biquad
// stage of a render step, in one launch.
//
// Replaces graphaudio_tpu/ops/biquad.py rbj_coefficients (:43-121), with the
// type as data as in rbj_coefficients_dyn (:131-150), and the pole split at
// the head of biquad_apply (:488-495), with the clamps and the k-rate gain
// expansion of nodes/biquad.py BiQuadFilterNode.process (:146-157). XLA fuses
// these into the step's program; the port packs the step's stages into one
// table (ops/biquad.py pack_coefficient_table: a row of eight words per
// (stage, lane)) and launches once. A block of 128 threads owns one row and
// one quantum: each thread reads its sample's frequency and Q from the row's
// sources (a K6 arena row, a-rate or k-rate, or a constant), and for the
// types that read the gain one thread computes A = 10^(g/40) once for the
// quantum (g is constant over it, so this is the value every thread computed
// before) and shares it through shared memory. Bound on the H100: the launch
// and each thread's f64 sin and cos polynomials (and, for the gain types,
// the one f64 pow before the barrier), not its ~40 flops a sample; config 3's
// four stages are 128 blocks, one wave.
//
// Rounding follows the plain version (ops/biquad.py) and, through it, the
// XLA CPU build of the reference, because config 3's low-frequency resonant
// sections amplify one-ulp differences in a1/a2 into output differences
// near the 1e-5 bar: the same association order, every f32 operation spelt
// __f*_rn so nvcc contracts nothing on its own, one fmaf exactly where XLA
// fuses (the discriminant), the constant divisions as XLA rewrites them
// (f * (2pi/sr), g * (1/40)), sin and cos as glibc's sinf/cosf, which XLA's
// CPU build calls (glibc_sincosf below), and pow in f64 rounded once to f32
// (the correctly rounded value, which XLA's f32 pow returns for 99.9 % of
// inputs; see ops/xla_rounding.py).
//
// Pole order: for complex poles Im(p1) >= 0, as XLA's complex sqrt returns
// for a negative real discriminant with either sign of zero imaginary part.
#include "common.cuh"

namespace {

constexpr int kQuantum = 128;
// Source word modes (ops/biquad.py SRC_*): word = off << 2 | mode.
constexpr int kSrcARate = 0, kSrcKRate = 1, kSrcConst = 2;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// glibc's sinf and cosf for |y| < 120 (its x86-64 FMA build; the plain
// version is ops/xla_rounding.py sincosf, the same f64 operations): the
// quadrant by one scaled multiply, the reduced argument by one fma, and two
// short polynomials whose every step is an fma, each rounded once to f32.
// The caller's w0 lies in (0, pi]; past 120 this returns the f64 functions
// rounded once, as the plain version does.
__device__ __forceinline__ void glibc_sincosf(float y, float* sinp, float* cosp) {
  const double d = static_cast<double>(y);
  const uint32_t top = (__float_as_uint(y) >> 20) & 0x7ffu;
  if (top >= 0x42fu) {  // |y| >= 120
    *sinp = static_cast<float>(sin(d));
    *cosp = static_cast<float>(cos(d));
    return;
  }
  if (top < 0x398u) {  // |y| < 2^-12
    *sinp = y;
    *cosp = 1.0f;
    return;
  }
  int n = 0;
  double r = d;
  if (top >= 0x3f4u) {  // |y| >= 0.75: reduce to [-pi/4, pi/4]
    n = (__double2int_rz(__dmul_rn(d, 0x1.45f306dc9c883p+23)) + 0x800000) >> 24;
    r = fma(-static_cast<double>(n), 0x1.921fb54442d18p+0, d);
  }
  const double r2 = __dmul_rn(r, r);
  const double xs = ((n + 1) & 2) ? -r : r;
  const double cn = (n & 2) ? -1.0 : 1.0;
  const double x3 = __dmul_rn(xs, r2);
  const double s1 = fma(r2, -0x1.994eb3774cf24p-13, 0x1.1107605230bc4p-7);
  const double x7 = __dmul_rn(x3, r2);
  const double sp = fma(x7, s1, fma(x3, -0x1.555545995a603p-3, xs));
  const double r4 = __dmul_rn(r2, r2);
  const double c2 = fma(r2, cn * 0x1.99343027bf8c3p-16, cn * -0x1.6c087e89a359dp-10);
  const double c1 = fma(r2, cn * -0x1.ffffffd0c621cp-2, cn);
  const double r6 = __dmul_rn(r4, r2);
  const double cp = fma(r6, c2, fma(r4, cn * 0x1.55553e1068f19p-5, c1));
  *sinp = static_cast<float>((n & 1) ? cp : sp);
  *cosp = static_cast<float>((n & 1) ? sp : cp);
}

// The value of source `word` at sample i of quantum s.
__device__ __forceinline__ float source(const float* __restrict__ src,
                                        const float* __restrict__ consts, int word, int s,
                                        int i) {
  const int mode = word & 3;
  const int64_t off = static_cast<int64_t>(static_cast<uint32_t>(word) >> 2);
  if (mode == kSrcConst) return consts[off];
  if (mode == kSrcKRate) return src[off + s];
  return src[off + static_cast<int64_t>(s) * kQuantum + i];  // kSrcARate
}

__global__ void __launch_bounds__(kQuantum) biquad_coeffs_batch_kernel(
    const float* __restrict__ f_src, const float* __restrict__ q_src,
    const float* __restrict__ g_src, const float* __restrict__ consts,
    const int32_t* __restrict__ rows, int S, float half_sr, float w0_scale,
    float* __restrict__ b, float2* __restrict__ p) {
  __shared__ float gain_a;
  const int r = blockIdx.x, s = blockIdx.y, i = threadIdx.x;
  const int32_t* w = rows + 8 * r;
  const int type = w[0];
  const int64_t T = static_cast<int64_t>(S) * kQuantum;
  const int64_t t = static_cast<int64_t>(s) * kQuantum + i;

  if (type >= 5 && i == 0) {  // the types with gain: A once for the quantum
    const float g = source(g_src, consts, w[3], s, 0);
    gain_a = static_cast<float>(pow(10.0, static_cast<double>(mul(g, 0.025f))));
  }

  // Per-sample clamps (BiQuadFilterNode.cs:123-124).
  const float f = fminf(fmaxf(source(f_src, consts, w[1], s, i), 1.0f), half_sr);
  const float q = fmaxf(source(q_src, consts, w[2], s, i), 0.001f);

  const float w0 = mul(f, w0_scale);
  float sinw, cosw;
  glibc_sincosf(w0, &sinw, &cosw);
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
    __syncthreads();  // uniform: the row's type is the block's
    const float A = gain_a;
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
  const int64_t V = w[6];
  const int64_t bo = w[4] * T + t, po = w[5] * T + t;
  const float inv_a0 = dvd(1.0f, a0);
  b[bo] = mul(b0, inv_a0);
  b[bo + V * T] = mul(b1, inv_a0);
  b[bo + 2 * V * T] = mul(b2, inv_a0);
  const float na1 = mul(a1, inv_a0), na2 = mul(a2, inv_a0);

  // Pole split: d = a1*a1 - 4*a2 fused as XLA fuses it.
  const float d = fmaf(na1, na1, -mul(4.0f, na2));
  const float sq = __fsqrt_rn(fabsf(d));
  if (d >= 0.0f) {
    p[po] = make_float2(mul(0.5f, add(-na1, sq)), 0.0f);
    p[po + V * T] = make_float2(mul(0.5f, sub(-na1, sq)), 0.0f);
  } else {
    p[po] = make_float2(mul(0.5f, -na1), mul(0.5f, sq));
    p[po + V * T] = make_float2(mul(0.5f, -na1), -mul(0.5f, sq));
  }
}

}  // namespace

// NR table rows over S quanta: one block per (row, quantum).
GA_EXPORT int ga_biquad_coeffs_batch(const float* f_src, const float* q_src, const float* g_src,
                                     const float* consts, const int32_t* rows, int NR, int S,
                                     float half_sr, float w0_scale, float* b, float2* p,
                                     void* stream) {
  const dim3 grid(NR, S);
  biquad_coeffs_batch_kernel<<<grid, kQuantum, 0, static_cast<cudaStream_t>(stream)>>>(
      f_src, q_src, g_src, consts, rows, S, half_sr, w0_scale, b, p);
  return ga_launch_status();
}
