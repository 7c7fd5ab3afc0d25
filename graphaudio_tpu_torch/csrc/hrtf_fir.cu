// P1 / K10: the spatial panner's per-quantum binaural HRTF filter.
//
// Replaces the Pallas kernel fir_kernel / fir_pallas_call
// (benchmarks/probes/hrtf_fir_pallas.py:113, :127) and what the package
// computes on its spatializer path: graphaudio_tpu/ops/hrtf.py interp_hrir
// (:135) of the grid spectra and fir_freq_per_block (:255), the mono
// downmix and the SpatialBlend crossfade of nodes/spatial.py (:398, :439).
//
// ga_hrtf_fir: one block per (quantum s, voice v), one thread per output
// sample t of the quantum. INPUT-side semantics, as the package and its
// oracle: input quantum s is convolved with the HRIR interpolated at s, and
// the tail of quantum s-1 (convolved with ITS HRIR) overlap-adds into s:
//   wet[e, t] = sum_{k <= t} h_s[e, k] m_s[t-k]
//             + sum_{k > t} h_{s-1}[e, k] m_{s-1}[128+t-k]   (ola for s = 0)
//   out[e, t] = wet * blend + dry * (1 - blend)
// where m is the mono downmix of direct = x * gain (gain per quantum, or
// none when the caller already applied the occlusion band gains), and dry
// is direct up-mixed to stereo. The probe's kernel is OUTPUT-side (quantum s
// applies h_s to the last 191 input samples), which differs for a moving
// source. Interpolating time-domain HRIRs instead of spectra is exact by
// linearity. The block interpolates h_s and h_{s-1} from the four grid
// rows (the grid, 86 KB for the analytic 7x24x2x64 set, stays in L2) and
// keeps them and the two mono quanta in shared memory. The block of the
// last quantum also writes the carried tail (ola) of quantum S-1.
// Every f32 operation is spelled __f*_rn, in the plain version's order
// (ops/hrtf.py hrtf_fir_plain), so nvcc contracts nothing and the two agree
// bit for bit.
//
// Bound on the H100: bytes, barely. At config 5's shapes (V=128, C=2: the
// voices' gains up-mix them to stereo, S=32, L=64) the 1.05 M outputs take
// 64 multiply-adds each (134 MFLOP, 2.0 us at 67 TFLOP/s f32) and the call
// moves 8.7 MB (2.6 us at 3.35 TB/s). This simple form walks each output's
// taps as one dependent chain of shared-memory reads and adds.
//
// ga_hrtf_fir_rows: the probe's own row form, out[r, c*F+t] =
// sum_k h[r, c*L+k] x[r, L-1-k+t], one block per row, kept to hold the port
// against fir_kernel.
#include "common.cuh"

namespace {

constexpr int kF = 128;      // frames per quantum
constexpr int kMaxL = 128;   // longest HRIR of the single-partition path
constexpr float kTwoPi = 6.28318548f;
constexpr float kHalfPi = 1.57079637f;

__device__ __forceinline__ float direct_at(const float* __restrict__ x,
                                          const float* __restrict__ gain, int v, int c, int C,
                                          int S, int q, int t) {
  const float xv = x[(static_cast<int64_t>(v) * C + c) * S * kF + q * kF + t];
  return gain ? __fmul_rn(xv, gain[v * S + q]) : xv;
}

__global__ void hrtf_fir_kernel(const float* __restrict__ x, const float* __restrict__ gain,
                                const float* __restrict__ az, const float* __restrict__ el,
                                const float* __restrict__ blend, const float* __restrict__ grid,
                                const float* __restrict__ ola, int C, int S, int E, int A,
                                int L, int W, float c_az, float c_el, float* __restrict__ out,
                                float* __restrict__ ola_out) {
  __shared__ float m[2][kF];          // mono direct of quanta s-1, s
  __shared__ float h[2][2][kMaxL];    // HRIRs of quanta s-1, s: [quantum][ear][tap]
  const int s = blockIdx.x, v = blockIdx.y, t = threadIdx.x;
  const int T = S * kF;

  for (int j = 0; j < 2; ++j) {
    const int q = s - 1 + j;
    if (q < 0) continue;
    m[j][t] = C == 1 ? direct_at(x, gain, v, 0, C, S, q, t)
                     : __fmul_rn(__fadd_rn(direct_at(x, gain, v, 0, C, S, q, t),
                                           direct_at(x, gain, v, 1, C, S, q, t)),
                                 0.5f);
    // Bilinear corners and weights (ops/hrtf.py interp_corners).
    float mo = fmodf(az[v * S + q], kTwoPi);
    if (mo < 0.0f) mo = __fadd_rn(mo, kTwoPi);  // jnp.mod: fmod, then into [0, 2pi)
    const float a = __fmul_rn(mo, c_az);
    const float e = __fmul_rn(__fadd_rn(el[v * S + q], kHalfPi), c_el);
    const float af = floorf(a), ef = floorf(e);
    const int a0 = static_cast<int>(af) % A, a1 = (a0 + 1) % A;
    const int e0 = min(max(static_cast<int>(ef), 0), E - 1), e1 = min(e0 + 1, E - 1);
    const float fa = __fsub_rn(a, af), fe = __fsub_rn(e, ef);
    const float ofa = __fsub_rn(1.0f, fa), ofe = __fsub_rn(1.0f, fe);
    const int rows[4] = {e0 * A + a0, e0 * A + a1, e1 * A + a0, e1 * A + a1};
    const float w[4] = {__fmul_rn(ofa, ofe), __fmul_rn(fa, ofe), __fmul_rn(ofa, fe),
                        __fmul_rn(fa, fe)};
    for (int i = t; i < 2 * L; i += blockDim.x) {
      const int ear = i / L, k = i - ear * L;
      float acc = __fmul_rn(w[0], grid[(static_cast<int64_t>(rows[0]) * 2 + ear) * L + k]);
      for (int c = 1; c < 4; ++c)
        acc = __fadd_rn(acc, __fmul_rn(w[c], grid[(static_cast<int64_t>(rows[c]) * 2 + ear) * L + k]));
      h[j][ear][k] = acc;
    }
  }
  __syncthreads();

  const float b = blend[v * S + s];
  const float omb = __fsub_rn(1.0f, b);
  for (int ear = 0; ear < 2; ++ear) {
    float first = 0.0f;
    const int kmax = min(t, L - 1);
    for (int k = 0; k <= kmax; ++k) first = __fadd_rn(first, __fmul_rn(h[1][ear][k], m[1][t - k]));
    float wet = first;
    if (t < W) {
      float prev;
      if (s == 0) {
        prev = ola[(static_cast<int64_t>(v) * 2 + ear) * W + t];
      } else {
        prev = 0.0f;
        for (int k = t + 1; k < L; ++k)
          prev = __fadd_rn(prev, __fmul_rn(h[0][ear][k], m[0][kF + t - k]));
      }
      wet = __fadd_rn(first, prev);
    }
    const float dry = C == 1 ? m[1][t] : direct_at(x, gain, v, ear, C, S, s, t);
    out[(static_cast<int64_t>(v) * 2 + ear) * T + s * kF + t] =
        __fadd_rn(__fmul_rn(wet, b), __fmul_rn(dry, omb));
    if (s == S - 1 && t < W) {
      float tail = 0.0f;
      for (int k = t + 1; k < L; ++k)
        tail = __fadd_rn(tail, __fmul_rn(h[1][ear][k], m[1][kF + t - k]));
      ola_out[(static_cast<int64_t>(v) * 2 + ear) * W + t] = tail;
    }
  }
}

__global__ void hrtf_fir_rows_kernel(const float* __restrict__ x, const float* __restrict__ h,
                                     int F, int L, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* xs = sm;               // [F + L - 1]
  float* hs = sm + F + L - 1;   // [2L]
  const int64_t r = blockIdx.x;
  const int n = F + L - 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = x[r * n + i];
  for (int i = threadIdx.x; i < 2 * L; i += blockDim.x) hs[i] = h[r * 2 * L + i];
  __syncthreads();
  for (int t = threadIdx.x; t < F; t += blockDim.x) {
    float a0 = 0.0f, a1 = 0.0f;
    for (int k = 0; k < L; ++k) {
      const float xv = xs[L - 1 - k + t];
      a0 = __fadd_rn(a0, __fmul_rn(hs[k], xv));
      a1 = __fadd_rn(a1, __fmul_rn(hs[L + k], xv));
    }
    out[r * 2 * F + t] = a0;
    out[r * 2 * F + F + t] = a1;
  }
}

}  // namespace

GA_EXPORT int ga_hrtf_fir(const float* x, const float* gain, const float* az, const float* el,
                          const float* blend, const float* grid, const float* ola, int V, int C,
                          int S, int E, int A, int L, int W, float c_az, float c_el, float* out,
                          float* ola_out, void* stream) {
  if (L > kMaxL || W > kF || C < 1 || C > 2) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid_dim(S, V);
  hrtf_fir_kernel<<<grid_dim, kF, 0, static_cast<cudaStream_t>(stream)>>>(
      x, gain, az, el, blend, grid, ola, C, S, E, A, L, W, c_az, c_el, out, ola_out);
  return ga_launch_status();
}

GA_EXPORT int ga_hrtf_fir_rows(const float* x, const float* h, int R, int F, int L, float* out,
                               void* stream) {
  const size_t smem = static_cast<size_t>(F + L - 1 + 2 * L) * sizeof(float);
  hrtf_fir_rows_kernel<<<R, 128, smem, static_cast<cudaStream_t>(stream)>>>(x, h, F, L, out);
  return ga_launch_status();
}
