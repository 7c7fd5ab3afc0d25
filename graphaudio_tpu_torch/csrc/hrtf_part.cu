// K10p: the spatial panner's partitioned HRTF filter, for HRIRs of 129-1024
// taps (P = 2..8 uniform 128-tap partitions on 256-point transforms).
//
// Replaces what the JAX package computes on the panner's long-HRIR path:
// graphaudio_tpu/ops/hrtf.py fir_freq_partitioned (:302) with interp_hrir
// (:135) of the partition spectra (hrir_grid_spectra, :214), as
// nodes/spatial.py (:410-430) calls them. The transforms are torch.fft's
// (cuFFT); these two kernels are the rest:
//
// ga_hrtf_part_mac (K10p-a): for voice v, output quantum s, ear e, bin b,
//   acc = sum_{p < P} X[s-p] H_p(s-p),  p ascending,
// over the concatenated timeline of the last P-1 input spectra (the ring,
// packed [R | I] rows, oldest first) and this superblock's S. H_p(u) is
// partition p of the grid spectra interpolated at quantum u's direction:
// the four corners and weights of ops/hrtf.py interp_corners, summed left
// to right as interp_hrir sums them, so the interpolated spectra
// [V, P-1+S, 2, P, 129] are never written. The complex MAC is spelled as
// the JAX package's expression, yr + xr hr - xi hi and yi + xr hi + xi hr,
// each operation rounded (__f*_rn, so nvcc contracts nothing), in the
// plain version's order (ops/hrtf.py partitioned_mac_plain): the two agree
// bit for bit. The blocks of the first P-1 quanta also write the next ring
// and its directions (the last P-1 rows of the concatenation) into fresh
// buffers: with S < P-1 those rows come partly from the old ring.
//
// One block per (s, v), a thread a bin (129 threads); thread p < P first
// computes the corners of partition p's input quantum into shared memory.
// Each thread then reads, for each partition, its bin of the input spectrum
// once and of the 8 corner spectra of each ear (the grid spectra stay in
// L2: 0.7 MB at P = 2, 2.8 MB at P = 8 on a 7 x 24 grid).
//
// ga_hrtf_part_ola (K10p-b): a thread an output sample of (v, ear):
//   wet = y[s][e][t] + (s > 0 ? y[s-1][e][128 + t] : ola[e][t]),
//   out = wet * blend + dry * (1 - blend), dry = x * gain up-mixed to
// stereo (x itself when gain is null), in ops/hrtf.py
// partitioned_ola_plain's order; the last quantum's threads also write
// the next ola, y[S-1][e][128 + t].
#include "common.cuh"

namespace {

constexpr int kF = 128;        // frames per quantum
constexpr int kB = kF + 1;     // bins of the 256-point real DFT
constexpr int kMaxP = 8;       // partitions of the longest HRIR (1024 taps)
constexpr int kOlaThreads = 256;
constexpr float kTwoPi = 6.28318548f;
constexpr float kHalfPi = 1.57079637f;

// Bilinear corners and weights of one direction (ops/hrtf.py
// interp_corners; csrc/hrtf_fir.cu has the same function).
__device__ __forceinline__ void corners(float azv, float elv, int E, int A, float c_az,
                                        float c_el, int* rows, float* w) {
  float mo = fmodf(azv, kTwoPi);
  if (mo < 0.0f) mo = __fadd_rn(mo, kTwoPi);  // jnp.mod: fmod, then into [0, 2pi)
  const float a = __fmul_rn(mo, c_az);
  const float e = __fmul_rn(__fadd_rn(elv, kHalfPi), c_el);
  const float af = floorf(a), ef = floorf(e);
  const int a0 = static_cast<int>(af) % A, a1 = (a0 + 1) % A;
  const int e0 = min(max(static_cast<int>(ef), 0), E - 1), e1 = min(e0 + 1, E - 1);
  const float fa = __fsub_rn(a, af), fe = __fsub_rn(e, ef);
  const float ofa = __fsub_rn(1.0f, fa), ofe = __fsub_rn(1.0f, fe);
  rows[0] = e0 * A + a0;
  rows[1] = e0 * A + a1;
  rows[2] = e1 * A + a0;
  rows[3] = e1 * A + a1;
  w[0] = __fmul_rn(ofa, ofe);
  w[1] = __fmul_rn(fa, ofe);
  w[2] = __fmul_rn(ofa, fe);
  w[3] = __fmul_rn(fa, fe);
}

__global__ void __launch_bounds__(kB)
hrtf_part_mac_kernel(const float2* __restrict__ X, const float* __restrict__ hx,
                     const float* __restrict__ haz, const float* __restrict__ hel,
                     const float* __restrict__ az, const float* __restrict__ el,
                     const float* __restrict__ sr, const float* __restrict__ si, int S, int P,
                     int E, int A, float c_az, float c_el, float2* __restrict__ acc,
                     float* __restrict__ hx_out, float* __restrict__ haz_out,
                     float* __restrict__ hel_out) {
  __shared__ int rows[kMaxP][4];
  __shared__ float wts[kMaxP][4];
  const int s = blockIdx.x, v = blockIdx.y, b = threadIdx.x;
  const int R = P - 1;  // ring rows; row u of the concatenation: u < R ring, else X[u - R]
  const int64_t ring = static_cast<int64_t>(v) * R;
  const int64_t row = static_cast<int64_t>(v) * S;

  // The next ring's row s: row S + s of the concatenation.
  if (s < R) {
    const int u = S + s;
    float re, im, a, e;
    if (u < R) {
      const float* h = hx + (ring + u) * 2 * kB;
      re = h[b];
      im = h[kB + b];
      a = haz[ring + u];
      e = hel[ring + u];
    } else {
      const float2 q = X[(row + u - R) * kB + b];
      re = q.x;
      im = q.y;
      a = az[row + u - R];
      e = el[row + u - R];
    }
    float* o = hx_out + (ring + s) * 2 * kB;
    o[b] = re;
    o[kB + b] = im;
    if (b == 0) {
      haz_out[ring + s] = a;
      hel_out[ring + s] = e;
    }
  }
  if (s >= S) return;

  // Partition p applies the HRIR of input quantum u = s - p (row s - p + R).
  if (b < P) {
    const int u = s - b + R;
    const float a = u < R ? haz[ring + u] : az[row + u - R];
    const float e = u < R ? hel[ring + u] : el[row + u - R];
    corners(a, e, E, A, c_az, c_el, rows[b], wts[b]);
  }
  __syncthreads();

  float yr[2] = {0.0f, 0.0f}, yi[2] = {0.0f, 0.0f};
  for (int p = 0; p < P; ++p) {
    const int u = s - p + R;
    float xr, xi;
    if (u < R) {
      const float* h = hx + (ring + u) * 2 * kB;
      xr = h[b];
      xi = h[kB + b];
    } else {
      const float2 q = X[(row + u - R) * kB + b];
      xr = q.x;
      xi = q.y;
    }
    const int* rw = rows[p];
    const float* w = wts[p];
#pragma unroll
    for (int ear = 0; ear < 2; ++ear) {
      float g[2][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t at = ((static_cast<int64_t>(rw[c]) * 2 + ear) * P + p) * kB + b;
        g[0][c] = __ldg(sr + at);
        g[1][c] = __ldg(si + at);
      }
      float hr = __fmul_rn(w[0], g[0][0]), hi = __fmul_rn(w[0], g[1][0]);
#pragma unroll
      for (int c = 1; c < 4; ++c) {
        hr = __fadd_rn(hr, __fmul_rn(w[c], g[0][c]));
        hi = __fadd_rn(hi, __fmul_rn(w[c], g[1][c]));
      }
      yr[ear] = __fsub_rn(__fadd_rn(yr[ear], __fmul_rn(xr, hr)), __fmul_rn(xi, hi));
      yi[ear] = __fadd_rn(__fadd_rn(yi[ear], __fmul_rn(xr, hi)), __fmul_rn(xi, hr));
    }
  }
#pragma unroll
  for (int ear = 0; ear < 2; ++ear)
    acc[((row + s) * 2 + ear) * kB + b] = make_float2(yr[ear], yi[ear]);
}

__global__ void __launch_bounds__(kOlaThreads)
hrtf_part_ola_kernel(const float* __restrict__ y, const float* __restrict__ ola,
                     const float* __restrict__ x, const float* __restrict__ gain,
                     const float* __restrict__ blend, int C, int S, float* __restrict__ out,
                     float* __restrict__ ola_out) {
  const int T = S * kF;
  const int t = blockIdx.x * kOlaThreads + threadIdx.x;
  if (t >= T) return;
  const int ear = blockIdx.y, v = blockIdx.z;
  const int q = t / kF, i = t % kF;
  const int64_t vq = static_cast<int64_t>(v) * S + q;
  const float* yq = y + (vq * 2 + ear) * 2 * kF;  // quantum q's block of this ear
  const float prev = q == 0 ? ola[(static_cast<int64_t>(v) * 2 + ear) * kF + i]
                            : yq[-4 * kF + kF + i];  // quantum q-1's second half
  const float wet = __fadd_rn(yq[i], prev);
  const float xv = x[(static_cast<int64_t>(v) * C + (C == 1 ? 0 : ear)) * T + t];
  const float dry = gain ? __fmul_rn(xv, gain[vq]) : xv;
  const float bl = blend[vq];
  out[(static_cast<int64_t>(v) * 2 + ear) * T + t] =
      __fadd_rn(__fmul_rn(wet, bl), __fmul_rn(dry, __fsub_rn(1.0f, bl)));
  if (q == S - 1) ola_out[(static_cast<int64_t>(v) * 2 + ear) * kF + i] = yq[kF + i];
}

}  // namespace

// X complex64 [V, S, 129] (float2); hx f32[V, P-1, 258]; haz, hel f32[V, P-1];
// az, el f32[V, S]; sr, si f32[E, A, 2, P, 129]; c_az, c_el the folded
// scales of interp_corners. Writes acc complex64 [V, S, 2, 129] and the next
// ring into fresh buffers (hx_out, haz_out, hel_out must not alias hx, haz,
// hel).
GA_EXPORT int ga_hrtf_part_mac(const void* X, const float* hx, const float* haz,
                               const float* hel, const float* az, const float* el,
                               const float* sr, const float* si, int V, int S, int P, int E,
                               int A, float c_az, float c_el, void* acc, float* hx_out,
                               float* haz_out, float* hel_out, void* stream) {
  if (V < 1 || S < 1 || P < 2 || P > kMaxP || E < 1 || A < 1 || V > 65535 ||
      hx == hx_out || haz == haz_out || hel == hel_out)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(max(S, P - 1), V);
  hrtf_part_mac_kernel<<<grid, kB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(X), hx, haz, hel, az, el, sr, si, S, P, E, A, c_az, c_el,
      static_cast<float2*>(acc), hx_out, haz_out, hel_out);
  return ga_launch_status();
}

// y f32[V, S, 2, 256]; ola f32[V, 2, 128]; x f32[V, C, S*128]; gain f32[V, S]
// or null; blend f32[V, S]. Writes out f32[V, 2, S*128] and ola_out
// f32[V, 2, 128].
GA_EXPORT int ga_hrtf_part_ola(const float* y, const float* ola, const float* x,
                               const float* gain, const float* blend, int V, int C, int S,
                               float* out, float* ola_out, void* stream) {
  if (V < 1 || S < 1 || C < 1 || C > 2 || V > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S * kF + kOlaThreads - 1) / kOlaThreads, 2, V);
  hrtf_part_ola_kernel<<<grid, kOlaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, ola, x, gain, blend, C, S, out, ola_out);
  return ga_launch_status();
}
