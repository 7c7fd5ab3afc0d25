// P2: the complex first-order recurrence s_t = a_t s_{t-1} + x_t, as the
// biquad's pole-split cascade, solved as a chunked two-level scan.
//
// Replaces the Pallas kernel fo_kernel / fo_pallas_call
// (benchmarks/probes/hrtf_fir_pallas.py:276, :290) and what the package
// computes with it: graphaudio_tpu/ops/biquad.py biquad_apply (:445-539),
// whose two cascaded recurrences per pass (_first_order_scan :153,
// _hs_prefix :203; _first_order_const :387 for constant poles) run twice
// when the poles vary (the correction pass).
//
// ga_biquad_cascade computes, per (lane, channel),
//   pass 1  v_t = p1_t v_{t-1} + x_t,  w_t = p2_t w_{t-1} + v_t
//   pass 2  (time-varying poles only) the same on
//           x_t - p1_t (p2_t - p2_{t-1}) w1_{t-2}, w1 = pass 1's real w
//   output  y_t = b0_t w_t + b1_t w_{t-1} + b2_t w_{t-2} (rounded to f32),
//           and the carried state (w_{T-1}, w_{T-2}) rounded to f32,
// from w_{-1} = W1, w_{-2} = W2, v_{-1} = W1 - p2_0 W2. Inputs,
// coefficients and poles are f32 / c64 as the package has them; the state is
// f64, as in the plain version (ops/biquad.py says why: the golden's own f32
// rounding already uses most of config 3's 1e-5 bar).
//
// Design. One block of 256 threads per (lane, channel); each thread owns a
// contiguous chunk of 16 samples, so a block covers a 4096-sample tile and
// longer inputs loop over tiles, carrying the state. Both recurrences of a
// pass are one affine map of the state (v, w),
//   (v, w) -> (m11 v + d1, m21 v + m22 w + d2),
// so each pass is three steps: every thread composes its chunk's map (the
// chunk solved from the zero state); an inclusive scan of the maps in
// registers (shuffles within a warp, then the eight warp totals walked in
// order from the tile's carried state) gives each chunk its carry-in; each
// thread replays its chunk from there, keeping every sample's real w in
// registers. Pass 2's w1_{t-2} and the output's w_{t-1}, w_{t-2} at a
// chunk's first two samples belong to the chunk before: each thread
// publishes its last two values in shared memory. Poles, coefficients and
// input go straight from global memory into registers with 16-byte loads.
//
// Bound on the H100: one SM per (lane, channel). The bytes (180 KB at
// [1, 2, 4096]) take 0.05 us at the card's rate, but a tile's 128 KB all
// enter one SM; then come the f64 chains (per pass, 16 steps to compose the
// chunk's map, five shuffle rounds of the warp scan, up to seven warp
// totals applied in order, 16 replay steps, against 4096 steps of the
// sequential sweep it replaces) and the scan's f64 work on all 256
// threads. The scan reassociates the f64 products, so the output may
// differ from the plain version's in the last f32 bit.
//
// ga_first_order_tb: the probe's own form (constant pole per column, [T, B]
// layout, f32 state as fo_kernel has it), one thread per column, kept to
// hold the port against fo_kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kChunk;
constexpr unsigned kAll = 0xffffffffu;

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

__device__ __forceinline__ cplxd cmad(cplxd a, cplxd s, cplxd u) {
  return cmad(make_double2(a.r, a.i), s, u);
}

__device__ __forceinline__ cplxd cmul(cplxd a, cplxd s) { return cmad(a, s, {0.0, 0.0}); }

__device__ __forceinline__ double2 widen(float2 a) { return make_double2(a.x, a.y); }

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ cplxd shfl_up(cplxd a, int d) {
  return {__shfl_up_sync(kAll, a.r, d), __shfl_up_sync(kAll, a.i, d)};
}

// The cascade's state (v, w).
struct State {
  cplxd v, w;
};

// An affine map of the state: (v, w) -> (m11 v + d1, m21 v + m22 w + d2).
struct Map {
  cplxd m11, m21, m22, d1, d2;
};

__device__ __forceinline__ Map identity() {
  return {{1.0, 0.0}, {0.0, 0.0}, {1.0, 0.0}, {0.0, 0.0}, {0.0, 0.0}};
}

// l after e.
__device__ __forceinline__ Map compose(const Map& l, const Map& e) {
  return {cmul(l.m11, e.m11), cmad(l.m21, e.m11, cmul(l.m22, e.m21)), cmul(l.m22, e.m22),
          cmad(l.m11, e.d1, l.d1), cmad(l.m21, e.d1, cmad(l.m22, e.d2, l.d2))};
}

__device__ __forceinline__ State apply(const Map& m, State s) {
  return {cmad(m.m11, s.v, m.d1), cmad(m.m21, s.v, cmad(m.m22, s.w, m.d2))};
}

__device__ __forceinline__ Map shfl_up(const Map& m, int d) {
  return {shfl_up(m.m11, d), shfl_up(m.m21, d), shfl_up(m.m22, d), shfl_up(m.d1, d),
          shfl_up(m.d2, d)};
}

// Pass 1's input: x_t.
struct Input {
  const float (&xs)[kChunk];
  __device__ __forceinline__ cplxd operator()(int k) const { return {xs[k], 0.0}; }
};

// Pass 2's input: x_t + corr_t, corr_t = -(p1_t (p2_t - p2_{t-1})) w1_{t-2},
// with w1 at the chunk's first two samples from the chunk before (hp).
struct CorrectedInput {
  const float (&xs)[kChunk];
  const float2 (&a1)[kChunk];
  const float2 (&a2)[kChunk];
  float2 a2prev;  // p2 at the sample before the chunk
  const double (&rw)[kChunk];
  double2 hp;  // (w1_{s-1}, w1_{s-2}) at the chunk's start s
  __device__ __forceinline__ cplxd operator()(int k) const {
    const double2 a = widen(a1[k]), b = widen(a2[k]);
    const double2 bp = widen(k > 0 ? a2[k - 1] : a2prev);
    const double h = k >= 2 ? rw[k - 2] : (k == 1 ? hp.x : hp.y);
    const double dr = b.x - bp.x, di = b.y - bp.y;
    const double qr = fma(a.x, dr, -a.y * di), qi = fma(a.x, di, a.y * dr);
    return {fma(-qr, h, static_cast<double>(xs[k])), -qi * h};
  }
};

// One pass of the cascade over this thread's chunk (the input of sample k
// is u(k)), seeded with the tile's carried state. Keeps each sample's real
// w in rw; thread kThreads-1 writes the state at the tile's end to *end.
template <class In>
__device__ __forceinline__ void cascade_pass(const float2 (&a1)[kChunk],
                                             const float2 (&a2)[kChunk], bool active,
                                             In u, State seed, Map* s_tot, State* end,
                                             double (&rw)[kChunk]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Map m = identity();
  if (active) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const double2 p = widen(a1[k]), q = widen(a2[k]);
      m.d1 = cmad(p, m.d1, u(k));
      m.d2 = cmad(q, m.d2, m.d1);
      m.m11 = cmad(p, m.m11, {0.0, 0.0});
      m.m21 = cmad(q, m.m21, m.m11);
      m.m22 = cmad(q, m.m22, {0.0, 0.0});
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Map e = shfl_up(m, off);
    if (lane >= off) m = compose(m, e);
  }
  if (lane == 31) s_tot[warp] = m;
  __syncthreads();
  State s = seed;  // the state where this warp's first chunk starts
  for (int w = 0; w < warp; ++w) s = apply(s_tot[w], s);
  const State e = apply(m, s);  // the state where this chunk ends
  State c = {shfl_up(e.v, 1), shfl_up(e.w, 1)};
  if (lane == 0) c = s;
  if (threadIdx.x == kThreads - 1) *end = e;  // idle chunks are identities
  if (active) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      c.v = cmad(widen(a1[k]), c.v, u(k));
      c.w = cmad(widen(a2[k]), c.w, c.v);
      rw[k] = c.w.r;
    }
  }
}

// Publishes this chunk's last two values (slot j) and returns the chunk
// before's, (w_{s-1}, w_{s-2}) at its start s; chunk 0 takes the tile's
// carry. The caller synchronises before the slots are written again.
__device__ __forceinline__ double2 edge(const double (&rw)[kChunk], bool active, double2 carry,
                                        double2* slots) {
  if (active) slots[threadIdx.x] = make_double2(rw[kChunk - 1], rw[kChunk - 2]);
  __syncthreads();
  return threadIdx.x == 0 ? carry : slots[threadIdx.x - 1];
}

__global__ void __launch_bounds__(kThreads, 1) biquad_cascade_kernel(
    const float* __restrict__ x, const float* __restrict__ b0, const float* __restrict__ b1,
    const float* __restrict__ b2, const float2* __restrict__ p1, const float2* __restrict__ p2,
    const float* __restrict__ w1_in, const float* __restrict__ w2_in, int C, int T, int tv,
    float* __restrict__ y, float* __restrict__ w1_out, float* __restrict__ w2_out) {
  __shared__ Map s_tot[kWarps];
  __shared__ State s_end[2];
  __shared__ double2 s_h[kThreads];  // pass 1's last two real w per chunk
  __shared__ double2 s_o[kThreads];  // the output w's last two per chunk

  const int lc = blockIdx.x;  // lane * C + channel
  const int64_t lt = static_cast<int64_t>(lc / C) * T;
  const int64_t ct = static_cast<int64_t>(lc) * T;

  const double W1 = w1_in[lc], W2 = w2_in[lc];
  const double2 p20 = widen(p2[lt]);
  const State s0 = {{fma(-p20.x, W2, W1), -p20.y * W2}, {W1, 0.0}};
  State seed1 = s0, seed2 = s0;
  double2 hc = make_double2(W1, W2);  // pass 1's real w at t0-1, t0-2
  double2 oc = hc;                    // the output w at t0-1, t0-2

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int ts = t0 + threadIdx.x * kChunk;
    const bool active = ts < T;
    const int last = min(kThreads, (T - t0) / kChunk) - 1;  // the tile's last chunk
    float2 a1[kChunk], a2[kChunk];
    float xs[kChunk];
    float2 a2prev = make_float2(0.0f, 0.0f);
    if (active) {
      const float4* q1 = reinterpret_cast<const float4*>(p1 + lt + ts);
      const float4* q2 = reinterpret_cast<const float4*>(p2 + lt + ts);
#pragma unroll
      for (int k = 0; k < kChunk / 2; ++k) {
        const float4 f1 = q1[k], f2 = q2[k];
        a1[2 * k] = make_float2(f1.x, f1.y);
        a1[2 * k + 1] = make_float2(f1.z, f1.w);
        a2[2 * k] = make_float2(f2.x, f2.y);
        a2[2 * k + 1] = make_float2(f2.z, f2.w);
      }
      const float4* qx = reinterpret_cast<const float4*>(x + ct + ts);
#pragma unroll
      for (int k = 0; k < kChunk / 4; ++k) {
        const float4 f = qx[k];
        xs[4 * k] = f.x;
        xs[4 * k + 1] = f.y;
        xs[4 * k + 2] = f.z;
        xs[4 * k + 3] = f.w;
      }
      a2prev = p2[lt + (ts > 0 ? ts - 1 : 0)];  // p2_{-1} := p2_0: no correction at t = 0
      // The output taps' coefficients are read after both passes: bring
      // them into L2 now (each chunk's 64 bytes lie in one 128-byte line).
      prefetch_l2(b0 + lt + ts);
      prefetch_l2(b1 + lt + ts);
      prefetch_l2(b2 + lt + ts);
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        a1[k] = a2[k] = make_float2(0.0f, 0.0f);
        xs[k] = 0.0f;
      }
    }

    double rw[kChunk];
    cascade_pass(a1, a2, active, Input{xs}, seed1, s_tot, &s_end[0], rw);
    const double2 hp = edge(rw, active, hc, s_h);
    hc = s_h[last];
    double2 op = hp;
    if (tv) {
      double rw2[kChunk];
      cascade_pass(a1, a2, active, CorrectedInput{xs, a1, a2, a2prev, rw, hp}, seed2, s_tot,
                   &s_end[1], rw2);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) rw[k] = rw2[k];
      op = edge(rw, active, oc, s_o);
      oc = s_o[last];
    } else {
      oc = hc;
    }
    if (active) {
      const float4* q0 = reinterpret_cast<const float4*>(b0 + lt + ts);
      const float4* q1 = reinterpret_cast<const float4*>(b1 + lt + ts);
      const float4* q2 = reinterpret_cast<const float4*>(b2 + lt + ts);
      float4* qy = reinterpret_cast<float4*>(y + ct + ts);
#pragma unroll
      for (int k = 0; k < kChunk / 4; ++k) {
        const float4 c0 = q0[k], c1 = q1[k], c2 = q2[k];
        const float f0[4] = {c0.x, c0.y, c0.z, c0.w}, f1[4] = {c1.x, c1.y, c1.z, c1.w},
                    f2[4] = {c2.x, c2.y, c2.z, c2.w};
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 4 * k + j;
          const double wm1 = n >= 1 ? rw[n - 1] : op.x;
          const double wm2 = n >= 2 ? rw[n - 2] : (n == 1 ? op.x : op.y);
          o[j] = static_cast<float>(fma(static_cast<double>(f2[j]), wm2,
                                        fma(static_cast<double>(f0[j]), rw[n],
                                            static_cast<double>(f1[j]) * wm1)));
        }
        qy[k] = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    seed1 = s_end[0];
    if (tv) seed2 = s_end[1];
    // The next tile's first writes to s_tot, s_end and the edge slots
    // follow its first __syncthreads, after every thread has read these.
  }
  if (threadIdx.x == 0) {
    w1_out[lc] = static_cast<float>(oc.x);
    w2_out[lc] = static_cast<float>(oc.y);
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

// T must be a multiple of kChunk (16) and every pointer 16-byte aligned
// (the wrapper checks both).
GA_EXPORT int ga_biquad_cascade(const float* x, const float* b0, const float* b1,
                                const float* b2, const float2* p1, const float2* p2,
                                const float* w1, const float* w2, int V, int C, int T, int tv,
                                float* y, float* w1_out, float* w2_out, void* stream) {
  biquad_cascade_kernel<<<V * C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, b0, b1, b2, p1, p2, w1, w2, C, T, tv, y, w1_out, w2_out);
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
