// P1 / K10: the spatial panner's per-quantum binaural HRTF filter.
//
// Replaces the Pallas kernel fir_kernel / fir_pallas_call
// (benchmarks/probes/hrtf_fir_pallas.py:113, :127) and what the package
// computes on its spatializer path: graphaudio_tpu/ops/hrtf.py interp_hrir
// (:135) of the grid spectra and fir_freq_per_block (:255), the mono
// downmix and the SpatialBlend crossfade of nodes/spatial.py (:398, :439).
//
// ga_hrtf_fir: INPUT-side semantics, as the package and its oracle: input
// quantum s is convolved with the HRIR interpolated at s, and the tail of
// quantum s-1 (convolved with ITS HRIR) overlap-adds into s:
//   wet[e, t] = sum_{k <= t} h_s[e, k] m_s[t-k]
//             + sum_{k > t} h_{s-1}[e, k] m_{s-1}[128+t-k]   (ola for s = 0)
//   out[e, t] = wet * blend + dry * (1 - blend)
// where m is the mono downmix of direct = x * gain (gain per quantum, or
// none when the caller already applied the occlusion band gains), and dry
// is direct up-mixed to stereo. The probe's kernel is OUTPUT-side (quantum s
// applies h_s to the last 191 input samples), which differs for a moving
// source. Interpolating time-domain HRIRs instead of spectra is exact by
// linearity. The block of the last quantum also writes the carried tail
// (ola) of quantum S-1. Every f32 operation is spelled __f*_rn, in the
// plain version's order (ops/hrtf.py hrtf_fir_plain), so nvcc contracts
// nothing and the two agree bit for bit.
//
// What bounds it on the H100, at config 5's shapes (V=128, C=2, S=32,
// L=64): the call moves 8.7 MB, 2.59 us at 3.35 TB/s; its 1.05 M outputs
// take 64 taps each, and with the multiply and the add rounded apart (as
// the plain version rounds them) that is 134 M f32 instructions, 4.0 us
// at 128 lanes x 132 SMs x 1.98 GHz. Issue, not bytes, is the floor: the
// design cuts the instructions an output-tap (below) and keeps the bytes
// near the bound (x is read by two blocks, the grid rows come from L2, the
// outputs leave as float4 stores).
//
// The design: one block per (quantum s, voice v) of 256 / R threads,
// R = 8; lane i owns R consecutive outputs of one ear, each in its own
// register accumulator, so every output still sums its taps in ascending
// k. Which ear and outputs a lane owns, and how many chunks each of its
// chains runs, the kernel takes from the caller's lane table: ops/hrtf.py
// fir_tile_plan computes it, and the CPU tests walk that same table in an
// emulation of the loops below. The taps run in chunks of R: per
// chunk a lane loads a 2R-sample window of the mono quantum and R taps as
// float4s from shared memory (6 loads) and does R x R multiply-adds, where
// one thread per output loaded two values for every tap it added. The
// mono buffers carry exact zeros before and after the quantum, so no lane
// branches on a tap (a product with a padded zero is +-0 and leaves a sum
// that started at +0 unchanged). A lane of the ramp (t0 < L-1) runs its own
// chain up to k0 = t0, then the previous quantum's from k0 = t0: L/R + 1
// chunks, against L/R for the rest, in one loop whose chunks differ only
// in their base pointers, so a warp that mixes the two kinds idles one
// chunk at most. Both ears of a tile are neighbouring lanes and read the
// same window; the h rows are 132 floats apart, so the four tap rows a
// warp reads in one chunk sit on different banks. Before the barrier each
// thread computes both quanta's corner rows and weights and then issues
// its grid loads together (the grid, 86 KB for the analytic 7x24x2x64 set,
// stays in L2): one L2 trip after the az/el loads.
//
// ga_hrtf_fir_rows: the probe's own row form, out[r, c*F+t] =
// sum_k h[r, c*L+k] x[r, L-1-k+t], one block per row, kept to hold the port
// against fir_kernel.
#include "common.cuh"

namespace {

constexpr int kF = 128;       // frames per quantum
constexpr int kMaxL = 128;    // longest HRIR of the single-partition path
constexpr int kHS = kMaxL + 4;  // h row stride: ears and quanta on other banks
constexpr int kR = 8;         // consecutive outputs of one ear a lane owns
constexpr int kThreads = 2 * kF / kR;

// The lane table (ops/hrtf.py fir_tile_plan): lane i's word holds its ear
// in bit 0, its first output t0 in bits 1-8, the chunks of its own chain
// in bits 9-16 and those of the previous quantum's tail in bits 17-24.
struct FirLanes {
  int word[kThreads];
};
constexpr float kTwoPi = 6.28318548f;
constexpr float kHalfPi = 1.57079637f;

__device__ __forceinline__ float direct_at(const float* __restrict__ x,
                                          const float* __restrict__ gain, int v, int c, int C,
                                          int S, int q, int t) {
  const float xv = x[(static_cast<int64_t>(v) * C + c) * S * kF + q * kF + t];
  return gain ? __fmul_rn(xv, gain[v * S + q]) : xv;
}

// Bilinear corners and weights of one direction (ops/hrtf.py interp_corners).
__device__ __forceinline__ void corners(float azv, float elv, int E, int A, float c_az,
                                        float c_el, int (&rows)[4], float (&w)[4]) {
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

template <int N>
__device__ __forceinline__ void load4(float (&dst)[N], int at, const float* src) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  dst[at] = q.x;
  dst[at + 1] = q.y;
  dst[at + 2] = q.z;
  dst[at + 3] = q.w;
}

// One chunk of R taps k0 .. k0+R-1 into a lane's R accumulators: hk points
// at tap k0 of an HRIR row, mw at the window's first sample, which output
// r meets at tap k0 + j as mw[R + r - j]. Taps at or past L (klim = L - k0)
// are skipped where L is not a multiple of R.
template <bool kRagged>
__device__ __forceinline__ void mac_chunk(float (&acc)[kR], const float* hk, const float* mw,
                                          int klim) {
  constexpr int R = kR;
  float w[2 * R], hv[R];
#pragma unroll
  for (int i = 0; i < 2 * R; i += 4) load4(w, i, mw + i);
#pragma unroll
  for (int j = 0; j < R; j += 4) load4(hv, j, hk + j);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (!kRagged || j < klim) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(hv[j], w[R + r - j]));
    }
  }
}

// At most 64 registers a thread, so that 32 single-warp blocks (the SM's
// block limit) fit on an SM and config 5's 4096 blocks take one wave of
// the 132 SMs. Lc is L rounded up to a multiple of R (the plan's taps).
template <bool kRagged>
__global__ void __launch_bounds__(kThreads, 32)
hrtf_fir_kernel(const float* __restrict__ x, const float* __restrict__ gain,
                const float* __restrict__ az, const float* __restrict__ el,
                const float* __restrict__ blend, const float* __restrict__ grid,
                const float* __restrict__ ola, int C, int S, int E, int A, int L, int Lc, int W,
                float c_az, float c_el, const __grid_constant__ FirLanes lanes,
                float* __restrict__ out, float* __restrict__ ola_out) {
  constexpr int R = kR;
  // Mono direct of quantum s at ms[R + t], R zeros either side; of quantum
  // s-1 at mp[t], R zeros after; the direct channels of s for the dry mix
  // (C = 2); the HRIRs of s-1 and s, [quantum][ear][tap], zero past L.
  __shared__ __align__(16) float ms[R + kF + R];
  __shared__ __align__(16) float mp[kF + R];
  __shared__ __align__(16) float dd[2][kF];
  __shared__ __align__(16) float h[2][2][kHS];
  const int s = blockIdx.x, v = blockIdx.y, tid = threadIdx.x;
  const int T = S * kF;
  const int lane = lanes.word[tid];
  const bool has_prev = s > 0 && L > 1;

  // 1. Both quanta's corners and weights, then every grid load of a batch
  //    before any is used.
  int rows[2][4];
  float wts[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = max(s - 1 + j, 0);
    corners(az[v * S + q], el[v * S + q], E, A, c_az, c_el, rows[j], wts[j]);
  }
  for (int it0 = 0; it0 * kThreads < Lc; it0 += 2) {
    float g[2][4][4];
#pragma unroll
    for (int di = 0; di < 2; ++di) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {  // (quantum j, ear) = (p / 2, p % 2)
        const int k = tid + (it0 + di) * kThreads;
        const bool live = k < L && (p >= 2 || s > 0);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          g[di][p][c] = live ? __ldg(grid + (static_cast<int64_t>(rows[p / 2][c]) * 2 + p % 2) * L + k)
                             : 0.0f;
      }
    }
#pragma unroll
    for (int di = 0; di < 2; ++di) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int k = tid + (it0 + di) * kThreads;
        if (k < Lc) {
          const float* wj = wts[p / 2];
          float acc = __fmul_rn(wj[0], g[di][p][0]);
#pragma unroll
          for (int c = 1; c < 4; ++c) acc = __fadd_rn(acc, __fmul_rn(wj[c], g[di][p][c]));
          h[p / 2][p % 2][k] = k < L ? acc : 0.0f;
        }
      }
    }
  }
  // 2. The mono quanta and the direct channels, and the zero pads.
#pragma unroll
  for (int i = 0; i < kF / kThreads; ++i) {
    const int t = tid + i * kThreads;
    const float a0 = direct_at(x, gain, v, 0, C, S, s, t);
    if (C == 1) {
      ms[R + t] = a0;
    } else {
      const float a1 = direct_at(x, gain, v, 1, C, S, s, t);
      dd[0][t] = a0;
      dd[1][t] = a1;
      ms[R + t] = __fmul_rn(__fadd_rn(a0, a1), 0.5f);
    }
    if (has_prev) {
      const float b0 = direct_at(x, gain, v, 0, C, S, s - 1, t);
      mp[t] = C == 1 ? b0
                     : __fmul_rn(__fadd_rn(b0, direct_at(x, gain, v, 1, C, S, s - 1, t)), 0.5f);
    }
  }
  if (tid < R) {
    ms[tid] = 0.0f;
    ms[R + kF + tid] = 0.0f;
    mp[kF + tid] = 0.0f;
  }
  __syncthreads();

  // 3. The lane's tile (the lane table): its own chain, then the previous
  //    quantum's, chunk by chunk.
  const int ear = lane & 1, t0 = (lane >> 1) & 0xff;
  const int n_first = (lane >> 9) & 0xff, n_tail = (lane >> 17) & 0xff;
  const int n = n_first + (has_prev ? n_tail : 0);
  float acc[R], first[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  const float* hb = h[1][ear];
  const float* mw = ms + t0;  // the window of chunk k0 = 0: ms[R + t0 - k0 - R ..]
  int k0 = 0;
  for (int c = 0; c < n; ++c) {
    if (c == n_first) {  // the previous quantum's tail, from k0 = t0
#pragma unroll
      for (int r = 0; r < R; ++r) {
        first[r] = acc[r];
        acc[r] = 0.0f;
      }
      hb = h[0][ear];
      k0 = t0;
      mw = mp + kF - R;
    }
    mac_chunk<kRagged>(acc, hb + k0, mw, L - k0);
    k0 += R;
    mw -= R;
  }
  float prev[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (n == n_first) {  // no previous chain ran: acc holds the quantum's own
      first[r] = acc[r];
      prev[r] = 0.0f;
    } else {
      prev[r] = acc[r];
    }
  }
  if (s == 0 && t0 < W) {
#pragma unroll
    for (int r = 0; r < R; ++r) prev[r] = ola[(static_cast<int64_t>(v) * 2 + ear) * W + t0 + r];
  }

  // 4. wet = first + prev (prev is +0 where the plain version adds none),
  //    the blend with dry, float4 stores.
  const float b = blend[v * S + s];
  const float omb = __fsub_rn(1.0f, b);
  const float* dry = C == 1 ? ms + R + t0 : dd[ear] + t0;
  float* o = out + (static_cast<int64_t>(v) * 2 + ear) * T + s * kF + t0;
#pragma unroll
  for (int r = 0; r < R; r += 4) {
    float d[4];
    load4(d, 0, dry + r);
    float4 q;
    q.x = __fadd_rn(__fmul_rn(__fadd_rn(first[r], prev[r]), b), __fmul_rn(d[0], omb));
    q.y = __fadd_rn(__fmul_rn(__fadd_rn(first[r + 1], prev[r + 1]), b), __fmul_rn(d[1], omb));
    q.z = __fadd_rn(__fmul_rn(__fadd_rn(first[r + 2], prev[r + 2]), b), __fmul_rn(d[2], omb));
    q.w = __fadd_rn(__fmul_rn(__fadd_rn(first[r + 3], prev[r + 3]), b), __fmul_rn(d[3], omb));
    *reinterpret_cast<float4*>(o + r) = q;
  }

  // 5. The last quantum's block: the carried tail of quantum S-1, its own
  //    HRIR over the zeros after the quantum.
  if (s == S - 1 && t0 < W) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    mw = ms + kF;  // ms[R + kF + t0 - k0 - R ..] at k0 = t0
    for (int c = 0, k = t0; c < n_tail; ++c, k += R, mw -= R)
      mac_chunk<kRagged>(acc, h[1][ear] + k, mw, L - k);
    float* ot = ola_out + (static_cast<int64_t>(v) * 2 + ear) * W + t0;
#pragma unroll
    for (int r = 0; r < R; r += 4)
      *reinterpret_cast<float4*>(ot + r) = make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]);
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

// taps and lanes: ops/hrtf.py fir_tile_plan(L, W)'s taps and its 32 lane
// words (host memory). out and ola_out must be 16-byte aligned (fresh
// allocations).
GA_EXPORT int ga_hrtf_fir(const float* x, const float* gain, const float* az, const float* el,
                          const float* blend, const float* grid, const float* ola, int V, int C,
                          int S, int E, int A, int L, int W, float c_az, float c_el, int taps,
                          const int* lanes, float* out, float* ola_out, void* stream) {
  if (L < 1 || L > W || W > kF || C < 1 || C > 2 || W % kR || taps % kR || taps < L ||
      taps >= L + kR || !lanes ||
      (reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(ola_out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  FirLanes table;
  for (int i = 0; i < kThreads; ++i) table.word[i] = lanes[i];
  const auto kernel = L % kR ? hrtf_fir_kernel<true> : hrtf_fir_kernel<false>;
  kernel<<<dim3(S, V), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, gain, az, el, blend, grid, ola, C, S, E, A, L, taps, W, c_az, c_el, table, out, ola_out);
  return ga_launch_status();
}

GA_EXPORT int ga_hrtf_fir_rows(const float* x, const float* h, int R, int F, int L, float* out,
                               void* stream) {
  const size_t smem = static_cast<size_t>(F + L - 1 + 2 * L) * sizeof(float);
  hrtf_fir_rows_kernel<<<R, 128, smem, static_cast<cudaStream_t>(stream)>>>(x, h, F, L, out);
  return ga_launch_status();
}
