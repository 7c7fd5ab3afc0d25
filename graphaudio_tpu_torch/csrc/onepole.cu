// K9: the spatial panner's occlusion band split, one launch a step: both
// static-pole one-pole crossovers y[n] = a y[n-1] + (1-a) x[n] and the
// 3-band gain combine. A template flag runs one pole alone.
//
// Replaces graphaudio_tpu/ops/onepole.py onepole_lowpass (:62), called twice
// by the panner's _split_bands (graphaudio_tpu/nodes/spatial.py:350-367, the
// 800 Hz and 8 kHz crossovers), and the band combine of its process
// (:380-386): direct = (low gl + mid gm) + high gh with mid = lowmid - low,
// high = x - lowmid and the gains held over each 128-frame quantum. The
// package writes each lowpass as a per-block decay matmul plus a carry
// matmul over the superblock (_matrices :33).
//
// ga_onepole_split, per row (a (voice, channel) pair of x f32[V, C, T]):
//   split:    direct f32[V, C, T] from x, the poles a_low, a_high, the
//             carry-ins y0_low, y0_high f32[V, C] and the band gains gl, gm,
//             gh f32[V, S] (the panner's K10b rows); the carry-outs are the
//             f32 of each chain's last sample, the next step's xlow, xhigh;
//   one pole: y f32[V, C, T] and its carry-out from x, a_low, y0_low.
// The state is f64 and each output sample is its f32 rounding; the
// combine is f32, every operation spelled __f*_rn in the plain version's
// order (ops/onepole.py band_combine_plain), so given the same bands the
// direct signal is the plain combine's bit for bit. The plain lowpass is
// f32 matmuls, so the bands themselves agree to about one f32 rounding.
//
// Design. One block per row, each thread owning a contiguous chunk of
// kChunk = 16 samples; a block covers a tile of up to kMaxThreads x 16 =
// 8192 samples and longer rows loop over tiles, carrying the f64 state.
// The tile comes into shared memory with coalesced float4 loads (a warp
// reads 512 contiguous bytes an instruction) and leaves the same way; in
// between each thread reads its own chunk as four float4s from a layout
// padded by 4 floats every two chunks, so no two threads of a quarter warp
// share a bank. Each pole is then a chunked two-level scan of affine maps
// y_out = A y_in + t, as P2's (first_order.cu) with a real constant pole:
//   1. each thread runs its chunk from 0 (the tail t), with A = a^16 from
//      the host in f64, both poles' chains interleaved;
//   2. an inclusive warp scan of the maps with __shfl_up_sync (5 rounds),
//      (A, t) after (A', t') = (A A', A t' + t), then warp 0 scans the
//      block's warp totals (log2(warps) rounds) and applies them to the
//      tile's carry-in: the state where each warp starts;
//   3. each thread's carry-in is its left neighbour's end state; it reruns
//      its chunk from there over the 16 inputs it kept in registers and
//      writes each sample's output (the combine, or y) over its own slot.
// Idle chunks (past the row's end) are identities. The f64 arithmetic is
// __dmul_rn / __dadd_rn, nothing contracted, in an order the numpy walk in
// tests/test_torch_onepole_scan.py repeats.
//
// Bound on the H100: bytes. Config 5's occluded stage (V=128, C=2, S=32)
// reads x once (4.2 MB) and writes direct once (4.2 MB), with 98 KB of
// gains: 8.4 MB, 2.5 us at 3.35 TB/s. The dependent chain a thread is, for
// each pole, 2 x 16 f64 steps (a multiply then an add) to build and to
// rerun its chunk, plus the 5 + log2(warps) scan rounds.
#include "common.cuh"

namespace {

constexpr int kChunk = 16;
constexpr int kMaxThreads = 512;
constexpr unsigned kAll = 0xffffffffu;

// Shared-memory float offset of chunk c: 16 floats a chunk plus 4 after
// every two, so the 8 threads of a quarter warp reading float4 k of their
// chunks (c .. c+7) touch 32 distinct banks.
__device__ __forceinline__ int slot(int c) { return c * kChunk + (c >> 1) * 4; }

// One pole's state map y_out = A y_in + t.
struct Map {
  double A, t;
};

// l after e.
__device__ __forceinline__ Map after(Map l, Map e) {
  return {__dmul_rn(l.A, e.A), __dadd_rn(__dmul_rn(l.A, e.t), l.t)};
}

__device__ __forceinline__ double apply(Map m, double s) {
  return __dadd_rn(__dmul_rn(m.A, s), m.t);
}

__device__ __forceinline__ Map shfl_up(Map m, int d) {
  return {__shfl_up_sync(kAll, m.A, d), __shfl_up_sync(kAll, m.t, d)};
}

// One sample of the recurrence: a p + (1 - a) x.
__device__ __forceinline__ double step(double a, double oma, double p, float x) {
  return __dadd_rn(__dmul_rn(a, p), __dmul_rn(oma, static_cast<double>(x)));
}

// The poles and their chunk multipliers a^16, f64 from the host.
struct Poles {
  double a[2], am[2];
};

template <int NP>  // 2: the band split; 1: one pole's y
__global__ void __launch_bounds__(kMaxThreads) onepole_split_kernel(
    const float* __restrict__ x, const float* __restrict__ y0_low,
    const float* __restrict__ y0_high, Poles poles, const float* __restrict__ gl,
    const float* __restrict__ gm, const float* __restrict__ gh, int C, int T,
    float* __restrict__ out, float* __restrict__ carry_low, float* __restrict__ carry_high) {
  extern __shared__ float4 s_raw[];
  float* s_buf = reinterpret_cast<float*>(s_raw);  // the tile, slot() layout
  __shared__ Map s_tot[32][NP];                     // each warp's inclusive map
  __shared__ double s_start[33][NP];                // where each warp starts; [nw]: the tile's end

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int tile = nthreads * kChunk;
  const float* xr = x + static_cast<int64_t>(row) * T;
  float* yr = out + static_cast<int64_t>(row) * T;
  const int64_t grow = static_cast<int64_t>(row / C) * (T / 128);  // the voice's gain row

  double a[NP], oma[NP], seed[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    a[q] = poles.a[q];
    oma[q] = 1.0 - a[q];
  }
  seed[0] = y0_low[row];
  if (NP == 2) seed[NP - 1] = y0_high[row];

  for (int t0 = 0; t0 < T; t0 += tile) {
    const int n = min(tile, T - t0);  // a multiple of 128
    for (int j = tid; j < n / 4; j += nthreads) {
      *reinterpret_cast<float4*>(s_buf + slot(j >> 2) + (j & 3) * 4) =
          reinterpret_cast<const float4*>(xr + t0)[j];
    }
    __syncthreads();

    // 1. the chunk's map from the zero state
    const bool active = tid * kChunk < n;
    float xs[kChunk];
    Map m[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) m[q] = {1.0, 0.0};
    if (active) {
#pragma unroll
      for (int k = 0; k < kChunk / 4; ++k) {
        const float4 f = *reinterpret_cast<const float4*>(s_buf + slot(tid) + 4 * k);
        xs[4 * k] = f.x;
        xs[4 * k + 1] = f.y;
        xs[4 * k + 2] = f.z;
        xs[4 * k + 3] = f.w;
      }
      double p[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) p[q] = 0.0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
#pragma unroll
        for (int q = 0; q < NP; ++q) p[q] = step(a[q], oma[q], p[q], xs[k]);
      }
#pragma unroll
      for (int q = 0; q < NP; ++q) m[q] = {poles.am[q], p[q]};
    }

    // 2. the warp scan, then warp 0 over the warp totals
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const Map e = shfl_up(m[q], off);
        if (lane >= off) m[q] = after(m[q], e);
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int q = 0; q < NP; ++q) s_tot[warp][q] = m[q];
    }
    __syncthreads();
    if (warp == 0) {
      Map w[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) w[q] = lane < nwarps ? s_tot[lane][q] : Map{1.0, 0.0};
      for (int off = 1; off < nwarps; off <<= 1) {
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const Map e = shfl_up(w[q], off);
          if (lane >= off) w[q] = after(w[q], e);
        }
      }
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (lane < nwarps) s_start[lane + 1][q] = apply(w[q], seed[q]);
        if (lane == 0) s_start[0][q] = seed[q];
      }
    }
    __syncthreads();

    // 3. the carry-in from the left neighbour's end state, then the rerun
    double c[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const double s = s_start[warp][q];
      const double e = __shfl_up_sync(kAll, apply(m[q], s), 1);
      c[q] = lane == 0 ? s : e;
      seed[q] = s_start[nwarps][q];
    }
    if (active) {
      const int64_t gi = grow + (t0 + tid * kChunk) / 128;  // the chunk's quantum
      float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
      if (NP == 2) {
        g0 = gl[gi];
        g1 = gm[gi];
        g2 = gh[gi];
      }
      float ys[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
#pragma unroll
        for (int q = 0; q < NP; ++q) c[q] = step(a[q], oma[q], c[q], xs[k]);
        const float lo = static_cast<float>(c[0]);
        if (NP == 2) {
          const float lm = static_cast<float>(c[NP - 1]);
          ys[k] = __fadd_rn(__fadd_rn(__fmul_rn(lo, g0), __fmul_rn(__fsub_rn(lm, lo), g1)),
                            __fmul_rn(__fsub_rn(xs[k], lm), g2));
        } else {
          ys[k] = lo;
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk / 4; ++k) {
        *reinterpret_cast<float4*>(s_buf + slot(tid) + 4 * k) =
            make_float4(ys[4 * k], ys[4 * k + 1], ys[4 * k + 2], ys[4 * k + 3]);
      }
      if (t0 + (tid + 1) * kChunk == T) {
        carry_low[row] = static_cast<float>(c[0]);
        if (NP == 2) carry_high[row] = static_cast<float>(c[NP - 1]);
      }
    }
    __syncthreads();
    for (int j = tid; j < n / 4; j += nthreads) {
      reinterpret_cast<float4*>(yr + t0)[j] =
          *reinterpret_cast<const float4*>(s_buf + slot(j >> 2) + (j & 3) * 4);
    }
    __syncthreads();  // the next tile overwrites the buffer and s_start
  }
}

}  // namespace

// split != 0: the band split (y0_high, a_high, gl, gm, gh, carry_high
// used); split == 0: one pole's y (those unused, may be null).
GA_EXPORT int ga_onepole_split(const float* x, const float* y0_low, const float* y0_high,
                               double a_low, double am_low, double a_high, double am_high,
                               const float* gl, const float* gm, const float* gh, int rows,
                               int C, int T, int split, float* out, float* carry_low,
                               float* carry_high, void* stream) {
  if (T < 128 || T % 128 || T / 128 > 1024 || C < 1 || rows % C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int chunks = T / kChunk;
  const int threads = chunks >= kMaxThreads ? kMaxThreads : (chunks + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(threads) * (kChunk + 2) * sizeof(float);
  const Poles poles = {{a_low, a_high}, {am_low, am_high}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split) {
    onepole_split_kernel<2><<<rows, threads, smem, s>>>(x, y0_low, y0_high, poles, gl, gm, gh,
                                                        C, T, out, carry_low, carry_high);
  } else {
    onepole_split_kernel<1><<<rows, threads, smem, s>>>(x, y0_low, nullptr, poles, nullptr,
                                                        nullptr, nullptr, C, T, out, carry_low,
                                                        nullptr);
  }
  return ga_launch_status();
}
