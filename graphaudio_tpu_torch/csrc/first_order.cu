// P2: the complex first-order recurrence s_t = a_t s_{t-1} + x_t, as the
// biquad's pole-split cascade, sequential in time.
//
// Replaces the Pallas kernel fo_kernel / fo_pallas_call
// (benchmarks/probes/hrtf_fir_pallas.py:276, :290) and what the package
// computes with it: graphaudio_tpu/ops/biquad.py biquad_apply (:445-539),
// whose two cascaded recurrences per pass (_first_order_scan :153,
// _hs_prefix :203; _first_order_const :387 for constant poles) run twice
// when the poles vary (the correction pass).
//
// ga_biquad_cascade: one block per lane, one thread per channel walks the
// lane's T samples in order:
//   pass 1  v_t = p1_t v_{t-1} + x_t,  w_t = p2_t w_{t-1} + v_t
//   pass 2  the same on x_t - p1_t (p2_t - p2_{t-1}) w1_{t-2}, where w1 is
//           pass 1's real output: it runs in the SAME sweep two samples
//           behind pass 1 (w1_{t-2} is already in a register), so the
//           correction costs no second launch and no intermediate buffer;
//   output  y_t = b0_t w_t + b1_t w_{t-1} + b2_t w_{t-2} (rounded to f32),
//           and the carried state (w_{T-1}, w_{T-2}) rounded to f32.
// Inputs, coefficients and poles are f32 / c64 as the package has them; the
// recurrence state is f64, as in the plain version (ops/biquad.py says why:
// the golden's own f32 rounding already uses most of config 3's 1e-5 bar).
// In a latency-bound sequential loop f64 costs only its longer fma latency.
// The whole block stages each chunk of poles, coefficients and input in
// shared memory with coalesced loads, so the recurrence reads only shared
// memory. The output goes straight to global memory: a store into the same
// shared array would let the compiler assume it aliases the next sample's
// loads and serialise the whole loop on it.
//
// Bound on the H100: latency. Each sample is a chain of dependent complex
// multiply-adds (about four fma latencies per pass), and only V*C threads
// work: config 3 has V = 1, C = 2. A chunked two-level scan across threads
// would use the card; it is the later redesign.
//
// ga_first_order_tb: the probe's own form (constant pole per column, [T, B]
// layout, f32 state as fo_kernel has it), one thread per column, kept to
// hold the port against fo_kernel.
#include "common.cuh"

namespace {

struct cplx {
  float r, i;
};

struct cplxd {
  double r, i;
};

// a * s + u (complex), contracted into fmas.
__device__ __forceinline__ cplx cmad(float2 a, cplx s, cplx u) {
  return {fmaf(a.x, s.r, fmaf(-a.y, s.i, u.r)), fmaf(a.x, s.i, fmaf(a.y, s.r, u.i))};
}

__device__ __forceinline__ cplxd cmad(double2 a, cplxd s, cplxd u) {
  return {fma(a.x, s.r, fma(-a.y, s.i, u.r)), fma(a.x, s.i, fma(a.y, s.r, u.i))};
}

__global__ void biquad_cascade_kernel(
    const float* __restrict__ x, const float* __restrict__ b0,
    const float* __restrict__ b1, const float* __restrict__ b2,
    const float2* __restrict__ p1, const float2* __restrict__ p2,
    const float* __restrict__ w1_in, const float* __restrict__ w2_in, int C, int T,
    int CH, int tv, float* __restrict__ y, float* __restrict__ w1_out,
    float* __restrict__ w2_out) {
  // Poles and coefficients are widened to f64 while staged, so the
  // sequential loop converts only its input sample.
  extern __shared__ double2 smem2[];
  double2* s_p1 = smem2;
  double2* s_p2 = s_p1 + CH;
  double* s_b0 = reinterpret_cast<double*>(s_p2 + CH);
  double* s_b1 = s_b0 + CH;
  double* s_b2 = s_b1 + CH;
  float* s_x = reinterpret_cast<float*>(s_b2 + CH);

  const int v = blockIdx.x;
  const int c = threadIdx.x;
  const bool act = c < C;
  const int64_t lt = static_cast<int64_t>(v) * T;
  const int64_t lct = static_cast<int64_t>(v) * C * T;

  // Initial state: w_{-1} = W1, w_{-2} = W2, v_{-1} = W1 - p2_0 W2.
  const double W1 = act ? w1_in[v * C + c] : 0.0;
  const double W2 = act ? w2_in[v * C + c] : 0.0;
  const double2 p20 = make_double2(p2[lt].x, p2[lt].y);
  const cplxd v0 = {fma(-p20.x, W2, W1), -p20.y * W2};
  const cplxd w0 = {W1, 0.0};
  cplxd va = v0, wa = w0;  // pass 1
  cplxd vb = v0, wb = w0;  // pass 2
  double h1 = W1, h2 = W2;  // pass 1's real w at t-1, t-2
  double o1 = W1, o2 = W2;  // output w at t-1, t-2
  double2 p2prev = p20;

  for (int t0 = 0; t0 < T; t0 += CH) {
    const int n = min(CH, T - t0);
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float2 a1 = p1[lt + t0 + k], a2 = p2[lt + t0 + k];
      s_p1[k] = make_double2(a1.x, a1.y);
      s_p2[k] = make_double2(a2.x, a2.y);
      s_b0[k] = b0[lt + t0 + k];
      s_b1[k] = b1[lt + t0 + k];
      s_b2[k] = b2[lt + t0 + k];
    }
    for (int cc = 0; cc < C; ++cc)
      for (int k = threadIdx.x; k < n; k += blockDim.x)
        s_x[cc * CH + k] = x[lct + static_cast<int64_t>(cc) * T + t0 + k];
    __syncthreads();
    if (act) {
      const float* xs = s_x + c * CH;
      float* __restrict__ ys = y + lct + static_cast<int64_t>(c) * T + t0;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const double2 a1 = s_p1[k], a2 = s_p2[k];
        const double xk = xs[k];
        va = cmad(a1, va, {xk, 0.0});
        wa = cmad(a2, wa, va);
        double wt = wa.r;
        if (tv) {
          // corr = -(p1 (p2 - p2prev)) * h2; input xk + corr
          const double dr = a2.x - p2prev.x, di = a2.y - p2prev.y;
          const double qr = fma(a1.x, dr, -a1.y * di), qi = fma(a1.x, di, a1.y * dr);
          vb = cmad(a1, vb, {fma(-qr, h2, xk), -qi * h2});
          wb = cmad(a2, wb, vb);
          wt = wb.r;
        }
        ys[k] = static_cast<float>(fma(s_b2[k], o2, fma(s_b0[k], wt, s_b1[k] * o1)));
        o2 = o1;
        o1 = wt;
        h2 = h1;
        h1 = wa.r;
        p2prev = a2;
      }
    }
    __syncthreads();  // the next chunk overwrites what this one read
  }
  if (act) {
    w1_out[v * C + c] = static_cast<float>(o1);
    w2_out[v * C + c] = static_cast<float>(o2);
  }
}

__global__ void first_order_tb_kernel(const float* __restrict__ xr,
                                      const float* __restrict__ xi,
                                      const float* __restrict__ ar,
                                      const float* __restrict__ ai, int T, int B,
                                      float* __restrict__ yr, float* __restrict__ yi) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float2 a = make_float2(ar[b], ai[b]);
  cplx s = {0.0f, 0.0f};
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const int64_t o = static_cast<int64_t>(t) * B + b;
    s = cmad(a, s, {xr[o], xi[o]});
    yr[o] = s.r;
    yi[o] = s.i;
  }
}

}  // namespace

GA_EXPORT int ga_biquad_cascade(const float* x, const float* b0, const float* b1,
                                const float* b2, const float2* p1, const float2* p2,
                                const float* w1, const float* w2, int V, int C, int T,
                                int CH, int tv, float* y, float* w1_out, float* w2_out,
                                void* stream) {
  const size_t smem = static_cast<size_t>(CH) * (2 * sizeof(double2) + 3 * sizeof(double) +
                                                 sizeof(float) * C);
  const int threads = C <= 32 ? 128 : ((C + 31) / 32) * 32;
  biquad_cascade_kernel<<<V, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, b0, b1, b2, p1, p2, w1, w2, C, T, CH, tv, y, w1_out, w2_out);
  return ga_launch_status();
}

GA_EXPORT int ga_first_order_tb(const float* xr, const float* xi, const float* ar,
                                const float* ai, int T, int B, float* yr, float* yi,
                                void* stream) {
  const int threads = 128;
  first_order_tb_kernel<<<(B + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(xr, xi, ar, ai, T, B, yr, yi);
  return ga_launch_status();
}
