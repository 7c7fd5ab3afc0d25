// K10p: the spatial panner's partitioned HRTF filter, for HRIRs of 129-1024
// taps (P = 2..8 uniform 128-tap partitions on 256-point transforms).
//
// Replaces what the JAX package computes on the panner's long-HRIR path:
// graphaudio_tpu/ops/hrtf.py fir_freq_partitioned (:302) with interp_hrir
// (:135) of the partition spectra (hrir_grid_spectra, :214), as
// nodes/spatial.py (:392-430) calls them. The transforms are torch.fft's
// (cuFFT: rfft of the input pass's buffer, irfft without its scale); these
// three kernels are the rest:
//
// ga_hrtf_part_input (the input pass): rfft's real input f32[V, S, 256],
//   each quantum's direct signal x * gain (x itself when gain is null),
//   its channel mean and the zero half of the 256-point transform, in
//   ops/hrtf.py partitioned_input_plain's operations: x * g for one
//   channel, ((0 + a) + b) * 0.5 for two (torch's mean: a sum from its
//   identity, then the factor). A thread four consecutive outputs: a
//   16-byte load a channel, one 16-byte store (x's base on 16 bytes).
//
// ga_hrtf_part_mac (K10p-a): for voice v, output quantum s, ear e, bin b,
//   acc = sum_{p < P} X[s-p] H_p(s-p),  p ascending,
// over the concatenated timeline of the last P-1 input spectra (the ring,
// packed [R | I] rows, oldest first) and this superblock's S. H_p(u) is
// partition p of the grid spectra interpolated at quantum u's direction:
// the four corners and weights of ops/hrtf.py interp_corners, summed left
// to right as interp_hrir sums them. The complex MAC is spelled as the JAX
// package's expression, yr + xr hr - xi hi and yi + xr hi + xi hr, each
// operation rounded (__f*_rn, so nvcc contracts nothing), in the plain
// version's order (ops/hrtf.py partitioned_mac_plain): the two agree bit
// for bit.
//
// What bounds it: its bytes (X in, the sums out: 4.2 and 8.5 MB at V = 128,
// S = 32) are a few microseconds; the corner spectra are not, if each
// (voice, quantum, partition) fetches its four corners again (8.3 KB from
// the L2: 271 MB a call at P = 8). The design takes the direction-run
// lever: a block owns kQ consecutive output quanta of one voice and walks
// them in order for each partition in turn. Partition p of output quantum
// s needs H_p at input quantum s - p, so each partition's walk visits
// consecutive input quanta; a quantum whose (azimuth, elevation) bits equal
// the one before it reuses the spectrum held in registers, and one whose
// four corners equal the one before's re-weights the corner spectra held
// in registers. A static voice thus fetches P x 4 corners once a block, and
// one that moves inside a grid cell does too (it re-interpolates each
// quantum from registers). The runs are found in the block from the staged
// directions (no host table). The other lever, each block staging a bin
// slice of the whole E x A x 2 x P grid in shared memory, is not taken:
// a slice of 8 bins is 172 KB at P = 8, so a block must serve every voice
// to repay it, leaving 17 blocks on 132 SMs, and its X and sum rows would
// be read 64 bytes at a time. Reuse gives the static and slowly moving
// renders P x 4 corners a block; a source that crosses a cell every
// quantum fetches as many corners as a block a quantum would, but one walk
// step after another, so it can run slower than that design did.
//
// Layout: grid (ceil(S / kQ), V), a thread an (ear, bin): 258 threads; kQ
// is 16, or 8 or 4 where fewer blocks than SMs would run (ops/hrtf.py
// mac_block_quanta): a walk is a chain of fetches when its corners move
// at every step, so a few voices take more, shorter walks. The block
// stages its window of the concatenation (rows s0 .. s0 + nq + P - 2, ring
// or X) with cp.async, while warp 0 computes each row's corners and
// weights and, by ballot, the rows whose direction or corners differ from
// the row before (two bit masks). The first walk's corners, and each next
// walk's while the current one runs, are fetched before they are used; a
// walk with one direction is a plain run of multiply-adds; a moving walk
// first interpolates each step's spectrum (fetching where the corners
// move), then multiplies them in. The sums of the block's quanta stay in
// registers. The last block of a voice also writes the next ring and its
// directions (the concatenation's last P-1 rows, all in its window) into
// fresh buffers: with S < P-1 those rows come partly from the old ring.
//
// ga_hrtf_part_ola (K10p-b): a thread an output sample of (v, ear), y the
// UNSCALED inverse transform (irfft with norm="forward"):
//   wet = y[s][e][t] / 256 + (s > 0 ? y[s-1][e][128 + t] / 256 : ola[e][t]),
//   out = wet * blend + dry * (1 - blend), dry = x * gain up-mixed to
// stereo (x itself when gain is null), in ops/hrtf.py
// partitioned_ola_plain's order; / 256 is the multiply by 2^-8 that
// irfft's own scale launch applied (one rounding, exact but for
// subnormals). The last quantum's threads also write the next ola,
// y[S-1][e][128 + t] / 256.
#include "common.cuh"

namespace {

constexpr int kF = 128;        // frames per quantum
constexpr int kB = kF + 1;     // bins of the 256-point real DFT
constexpr int kN = 2 * kF;     // points of the transform
constexpr int kMaxP = 8;       // partitions of the longest HRIR (1024 taps)
constexpr int kMacThreads = 2 * kB;      // an (ear, bin) a thread
constexpr int kInThreads = 256;
constexpr int kOlaThreads = 256;
constexpr float kInvN = 0.00390625f;     // 2^-8: the inverse transform's scale
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

// The four corner spectra (re, im) of partition p at one (ear, bin).
__device__ __forceinline__ void fetch_corners(const float* __restrict__ sr,
                                              const float* __restrict__ si, int4 rows, int ear,
                                              int P, int p, int b, float* gr, float* gi) {
  const int r[4] = {rows.x, rows.y, rows.z, rows.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int64_t at = ((static_cast<int64_t>(r[c]) * 2 + ear) * P + p) * kB + b;
    gr[c] = __ldg(sr + at);
    gi[c] = __ldg(si + at);
  }
}

// interp_hrir's left-to-right corner sum.
__device__ __forceinline__ float interp(float4 w, const float* g) {
  float h = __fmul_rn(w.x, g[0]);
  h = __fadd_rn(h, __fmul_rn(w.y, g[1]));
  h = __fadd_rn(h, __fmul_rn(w.z, g[2]));
  return __fadd_rn(h, __fmul_rn(w.w, g[3]));
}

// The JAX package's complex multiply-add, each operation rounded.
__device__ __forceinline__ void mac(float& yr, float& yi, float2 x, float hr, float hi) {
  yr = __fsub_rn(__fadd_rn(yr, __fmul_rn(x.x, hr)), __fmul_rn(x.y, hi));
  yi = __fadd_rn(__fadd_rn(yi, __fmul_rn(x.x, hi)), __fmul_rn(x.y, hr));
}

// cp.async: copies to shared memory that no register waits on.
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void copy_async8(float2* dst, const float2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::);
}

__global__ void __launch_bounds__(kInThreads)
hrtf_part_input_kernel(const float* __restrict__ x, const float* __restrict__ gain, int C,
                       int S, int64_t n4, float4* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kInThreads + threadIdx.x;
  if (i >= n4) return;
  const int64_t vs = i / (kN / 4);  // the quantum v * S + s
  const int k = static_cast<int>(i - vs * (kN / 4));
  float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k < kF / 4) {  // a warp is all first half or all zero half
    const int64_t v = vs / S;
    const int64_t T = static_cast<int64_t>(S) * kF;
    const float* x0 = x + v * C * T + (vs - v * S) * kF + 4 * k;
    float4 a = *reinterpret_cast<const float4*>(x0);
    if (gain) {
      const float g = gain[vs];
      a = make_float4(__fmul_rn(a.x, g), __fmul_rn(a.y, g), __fmul_rn(a.z, g),
                      __fmul_rn(a.w, g));
    }
    o = a;
    if (C == 2) {
      float4 c = *reinterpret_cast<const float4*>(x0 + T);
      if (gain) {
        const float g = gain[vs];
        c = make_float4(__fmul_rn(c.x, g), __fmul_rn(c.y, g), __fmul_rn(c.z, g),
                        __fmul_rn(c.w, g));
      }
      o = make_float4(__fmul_rn(__fadd_rn(__fadd_rn(0.0f, a.x), c.x), 0.5f),
                      __fmul_rn(__fadd_rn(__fadd_rn(0.0f, a.y), c.y), 0.5f),
                      __fmul_rn(__fadd_rn(__fadd_rn(0.0f, a.z), c.z), 0.5f),
                      __fmul_rn(__fadd_rn(__fadd_rn(0.0f, a.w), c.w), 0.5f));
    }
  }
  out[i] = o;
}

// kQ: the output quanta of a block (ops/hrtf.py mac_block_quanta).
template <int kQ>
__global__ void __launch_bounds__(kMacThreads)
hrtf_part_mac_kernel(const float2* __restrict__ X, const float* __restrict__ hx,
                     const float* __restrict__ haz, const float* __restrict__ hel,
                     const float* __restrict__ az, const float* __restrict__ el,
                     const float* __restrict__ sr, const float* __restrict__ si, int S, int P,
                     int E, int A, float c_az, float c_el, float2* __restrict__ acc,
                     float* __restrict__ hx_out, float* __restrict__ haz_out,
                     float* __restrict__ hel_out) {
  constexpr int kWin = kQ + kMaxP - 1;  // window rows
  static_assert(kWin <= 32, "warp 0 plans the window a lane a row");
  __shared__ float2 win[kWin][kB];  // the window's input spectra
  __shared__ float waz[kWin], wel[kWin];
  __shared__ int4 rows[kWin];
  __shared__ float4 wts[kWin];
  __shared__ unsigned masks[2];
  const int s0 = blockIdx.x * kQ, v = blockIdx.y, t = threadIdx.x;
  const int R = P - 1;            // ring rows
  const int nq = min(kQ, S - s0);  // output quanta of this block
  const int nw = nq + R;           // window row j is concatenation row s0 + j
  const int64_t ring = static_cast<int64_t>(v) * R;
  const int64_t row = static_cast<int64_t>(v) * S;

  for (int i = t; i < nw * kB; i += kMacThreads) {
    const int j = i / kB, b = i - j * kB, c = s0 + j;
    if (c < R) {
      const float* h = hx + (ring + c) * 2 * kB;
      copy_async4(&win[j][b].x, h + b);
      copy_async4(&win[j][b].y, h + kB + b);
    } else {
      copy_async8(&win[j][b], X + (row + c - R) * kB + b);
    }
  }
  if (t < 32) {
    // Warp 0, lane j: window row j's direction, corners and weights, and
    // whether its direction (bit j of masks[0]) and its corners (masks[1])
    // differ from row j - 1's.
    unsigned ab = 0, eb = 0;
    int r0 = -1;
    if (t < nw) {
      const int c = s0 + t;
      const float a = c < R ? haz[ring + c] : az[row + c - R];
      const float e = c < R ? hel[ring + c] : el[row + c - R];
      int r[4];
      float w[4];
      corners(a, e, E, A, c_az, c_el, r, w);
      waz[t] = a;
      wel[t] = e;
      rows[t] = make_int4(r[0], r[1], r[2], r[3]);
      wts[t] = make_float4(w[0], w[1], w[2], w[3]);
      ab = __float_as_uint(a);
      eb = __float_as_uint(e);
      r0 = r[0];
    }
    const unsigned pa = __shfl_up_sync(0xffffffffu, ab, 1);
    const unsigned pe = __shfl_up_sync(0xffffffffu, eb, 1);
    const int pr = __shfl_up_sync(0xffffffffu, r0, 1);
    const bool in = t >= 1 && t < nw;
    const unsigned dm = __ballot_sync(0xffffffffu, in && (ab != pa || eb != pe));
    const unsigned rm = __ballot_sync(0xffffffffu, in && r0 != pr);
    if (t == 0) {
      masks[0] = dm;
      masks[1] = rm;
    }
  }
  copy_async_wait();
  __syncthreads();

  if (s0 + nq == S) {  // the next ring: concatenation rows S .. S + R - 1
    for (int i = t; i < R * kB; i += kMacThreads) {
      const int j = i / kB, b = i - j * kB;
      const float2 q = win[nq + j][b];
      float* o = hx_out + (ring + j) * 2 * kB;
      o[b] = q.x;
      o[kB + b] = q.y;
    }
    if (t < R) {
      haz_out[ring + t] = waz[nq + t];
      hel_out[ring + t] = wel[nq + t];
    }
  }

  const int ear = t < kB ? 0 : 1, b = t - ear * kB;
  const unsigned walk = (1u << nq) - 1;  // the walk's steps s < nq
  float yr[kQ], yi[kQ];
#pragma unroll
  for (int s = 0; s < kQ; ++s) yr[s] = yi[s] = 0.0f;
  // Partition p walks window rows R - p .. R - p + nq - 1; its first
  // corners are fetched during the walk before it. A walk step past nq
  // reads a row no output takes (the window's rows are kWin) and is not
  // stored.
  float nr[4], ni[4];
  fetch_corners(sr, si, rows[R], ear, P, 0, b, nr, ni);
  for (int p = 0; p < P; ++p) {
    float gr[4], gi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      gr[c] = nr[c];
      gi[c] = ni[c];
    }
    if (p + 1 < P) fetch_corners(sr, si, rows[R - p - 1], ear, P, p + 1, b, nr, ni);
    const int j0 = R - p;
    const unsigned dm = (masks[0] >> j0) & walk & ~1u, rm = (masks[1] >> j0) & walk & ~1u;
    float hr = interp(wts[j0], gr), hi = interp(wts[j0], gi);
    if (dm == 0) {  // one direction for the whole walk
#pragma unroll
      for (int s = 0; s < kQ; ++s) mac(yr[s], yi[s], win[j0 + s][b], hr, hi);
      continue;
    }
    // New weights at the steps of dm, new corners at those of rm.
    float hrs[kQ], his[kQ];
    hrs[0] = hr;
    his[0] = hi;
#pragma unroll
    for (int s = 1; s < kQ; ++s) {
      if ((dm >> s) & 1u) {
        if ((rm >> s) & 1u) fetch_corners(sr, si, rows[j0 + s], ear, P, p, b, gr, gi);
        hr = interp(wts[j0 + s], gr);
        hi = interp(wts[j0 + s], gi);
      }
      hrs[s] = hr;
      his[s] = hi;
    }
#pragma unroll
    for (int s = 0; s < kQ; ++s) mac(yr[s], yi[s], win[j0 + s][b], hrs[s], his[s]);
  }
#pragma unroll
  for (int s = 0; s < kQ; ++s)
    if (s < nq) acc[(row + s0 + s) * 2 * kB + t] = make_float2(yr[s], yi[s]);
}

// K14b: K10p-a over one rank's slice of the partitions (see the export's
// note). A block is one warp: 32 (ear, bin) columns of one output quantum
// of one voice; kPl, the slice's partition count, is a template argument,
// so the partition loop unrolls and every load is issued before the first
// multiply-add.
constexpr int kSliceCols = 32;
constexpr int kSliceChunks = (2 * kB + kSliceCols - 1) / kSliceCols;  // 9, the last of 2

template <int kPl>
__global__ void __launch_bounds__(kSliceCols)
hrtf_part_mac_slice_kernel(const float2* __restrict__ X, const float* __restrict__ hx,
                           const float* __restrict__ haz, const float* __restrict__ hel,
                           const float* __restrict__ az, const float* __restrict__ el,
                           const float* __restrict__ sr, const float* __restrict__ si, int S,
                           int P, int p_base, int E, int A, float c_az, float c_el,
                           float2* __restrict__ acc, float* __restrict__ hx_out,
                           float* __restrict__ haz_out, float* __restrict__ hel_out) {
  const int lane = threadIdx.x, col = blockIdx.x * kSliceCols + lane;
  const int s = blockIdx.y, v = blockIdx.z;
  const int R = P - 1;  // ring rows: the global partition count's
  const int64_t ring = static_cast<int64_t>(v) * R;
  const int64_t row = static_cast<int64_t>(v) * S;
  const bool live = col < 2 * kB;
  const int ear = col < kB ? 0 : 1, b = col - ear * kB;

  // The next ring (concatenation rows S .. S + R - 1, f32[R, 258]) and its
  // directions, read from the inputs, one value a thread over the voice's
  // blocks: loaded first, stored last.
  const int n_ring = R * 2 * kB, n_next = n_ring + 2 * R;
  const int stride = gridDim.x * gridDim.y * kSliceCols;
  const int first = (blockIdx.y * gridDim.x + blockIdx.x) * kSliceCols + lane;
  auto next_value = [&](int e) {
    if (e < n_ring) {
      const int i = e / (2 * kB), q = e - i * (2 * kB), c = S + i;
      if (c < R) return hx[(ring + c) * 2 * kB + q];
      const float2 x = X[(row + c - R) * kB + (q < kB ? q : q - kB)];
      return q < kB ? x.x : x.y;
    }
    const int i = (e - n_ring) % R, c = S + i;
    if (e - n_ring < R) return c < R ? haz[ring + c] : az[row + c - R];
    return c < R ? hel[ring + c] : el[row + c - R];
  };
  auto store_next = [&](int e, float val) {
    if (e < n_ring)
      hx_out[ring * 2 * kB + e] = val;
    else if (e - n_ring < R)
      haz_out[ring + e - n_ring] = val;
    else
      hel_out[ring + e - n_ring - R] = val;
  };
  const float next0 = first < n_next ? next_value(first) : 0.0f;

  // Local partition j (global p_base + j) takes concatenation row c = R + s
  // - p_base - j (ring rows first): its input spectrum at this bin, and in
  // lane j its direction's corners and weights.
  float xr[kPl], xi[kPl];
#pragma unroll
  for (int j = 0; j < kPl; ++j) {
    const int c = R + s - p_base - j;
    xr[j] = xi[j] = 0.0f;
    if (!live) continue;
    if (c < R) {
      const float* h = hx + (ring + c) * 2 * kB;
      xr[j] = h[b];
      xi[j] = h[kB + b];
    } else {
      const float2 q = X[(row + c - R) * kB + b];
      xr[j] = q.x;
      xi[j] = q.y;
    }
  }
  int r[4] = {0, 0, 0, 0};
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < kPl) {
    const int c = R + s - p_base - lane;
    corners(c < R ? haz[ring + c] : az[row + c - R], c < R ? hel[ring + c] : el[row + c - R],
            E, A, c_az, c_el, r, w);
  }
  // Every lane takes partition j's corners from lane j and loads their
  // spectra at its column; then the multiply-adds, j ascending.
  float gr[kPl][4], gi[kPl][4];
  float4 wj[kPl];
#pragma unroll
  for (int j = 0; j < kPl; ++j) {
    wj[j] = make_float4(__shfl_sync(0xffffffffu, w[0], j), __shfl_sync(0xffffffffu, w[1], j),
                        __shfl_sync(0xffffffffu, w[2], j), __shfl_sync(0xffffffffu, w[3], j));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int rc = __shfl_sync(0xffffffffu, r[c], j);
      const int at = ((rc * 2 + ear) * kPl + j) * kB + b;
      gr[j][c] = live ? __ldg(sr + at) : 0.0f;
      gi[j][c] = live ? __ldg(si + at) : 0.0f;
    }
  }
  float yr = 0.0f, yi = 0.0f;
#pragma unroll
  for (int j = 0; j < kPl; ++j)
    mac(yr, yi, make_float2(xr[j], xi[j]), interp(wj[j], gr[j]), interp(wj[j], gi[j]));
  if (live) acc[(row + s) * 2 * kB + col] = make_float2(yr, yi);
  if (first < n_next) store_next(first, next0);
  for (int e = first + stride; e < n_next; e += stride) store_next(e, next_value(e));
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
  const float* yq = y + (vq * 2 + ear) * kN;  // quantum q's block of this ear
  const float prev = q == 0 ? ola[(static_cast<int64_t>(v) * 2 + ear) * kF + i]
                            : __fmul_rn(yq[-2 * kN + kF + i], kInvN);  // q-1's second half
  const float wet = __fadd_rn(__fmul_rn(yq[i], kInvN), prev);
  const float xv = x[(static_cast<int64_t>(v) * C + (C == 1 ? 0 : ear)) * T + t];
  const float dry = gain ? __fmul_rn(xv, gain[vq]) : xv;
  const float bl = blend[vq];
  out[(static_cast<int64_t>(v) * 2 + ear) * T + t] =
      __fadd_rn(__fmul_rn(wet, bl), __fmul_rn(dry, __fsub_rn(1.0f, bl)));
  if (q == S - 1)
    ola_out[(static_cast<int64_t>(v) * 2 + ear) * kF + i] = __fmul_rn(yq[kF + i], kInvN);
}

}  // namespace

// x f32[V, C, S*128] (C = 1 or 2; its base on 16 bytes); gain f32[V, S] or
// null. Writes out f32[V, S, 256].
GA_EXPORT int ga_hrtf_part_input(const float* x, const float* gain, int V, int C, int S,
                                 float* out, void* stream) {
  const int64_t n4 = static_cast<int64_t>(V) * S * (kN / 4);
  const int64_t blocks = (n4 + kInThreads - 1) / kInThreads;
  if (V < 1 || S < 1 || C < 1 || C > 2 || reinterpret_cast<uintptr_t>(x) % 16 ||
      blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  hrtf_part_input_kernel<<<static_cast<unsigned>(blocks), kInThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, gain, C, S, n4, reinterpret_cast<float4*>(out));
  return ga_launch_status();
}

// X complex64 [V, S, 129] (float2); hx f32[V, P-1, 258]; haz, hel f32[V, P-1];
// az, el f32[V, S]; sr, si f32[E, A, 2, P, 129]; c_az, c_el the folded
// scales of interp_corners; Q the quanta a block, 4, 8 or 16. Writes acc complex64 [V, S, 2, 129] and the next
// ring into fresh buffers (hx_out, haz_out, hel_out must not alias hx, haz,
// hel).
GA_EXPORT int ga_hrtf_part_mac(const void* X, const float* hx, const float* haz,
                               const float* hel, const float* az, const float* el,
                               const float* sr, const float* si, int V, int S, int P, int E,
                               int A, float c_az, float c_el, int Q, void* acc, float* hx_out,
                               float* haz_out, float* hel_out, void* stream) {
  if (V < 1 || S < 1 || P < 2 || P > kMaxP || E < 1 || A < 1 || V > 65535 ||
      hx == hx_out || haz == haz_out || hel == hel_out || (Q != 4 && Q != 8 && Q != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + Q - 1) / Q, V);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* Xc = static_cast<const float2*>(X);
  auto* accc = static_cast<float2*>(acc);
  if (Q == 16)
    hrtf_part_mac_kernel<16><<<grid, kMacThreads, 0, st>>>(Xc, hx, haz, hel, az, el, sr, si, S,
                                                           P, E, A, c_az, c_el, accc, hx_out,
                                                           haz_out, hel_out);
  else if (Q == 8)
    hrtf_part_mac_kernel<8><<<grid, kMacThreads, 0, st>>>(Xc, hx, haz, hel, az, el, sr, si, S,
                                                          P, E, A, c_az, c_el, accc, hx_out,
                                                          haz_out, hel_out);
  else
    hrtf_part_mac_kernel<4><<<grid, kMacThreads, 0, st>>>(Xc, hx, haz, hel, az, el, sr, si, S,
                                                          P, E, A, c_az, c_el, accc, hx_out,
                                                          haz_out, hel_out);
  return ga_launch_status();
}

// K14b: K10p-a's MAC over the partitions [p_base, p_base + Pl) of a
// P-partition HRIR (the rank's slice under a mesh whose `part` dimension
// splits the partitions), at their global offsets into the replicated
// timeline. Replaces the `part_axis` branch of graphaudio_tpu/ops/hrtf.py
// fir_freq_partitioned (:345-379), its per-device MAC before the psum.
// X complex64 [V, S, 129]; hx f32[V, P-1, 258], haz, hel f32[V, P-1] the
// whole ring (P the global, padded, count); az, el f32[V, S]; sr, si f32[E,
// A, 2, Pl, 129] the slice's grid spectra, 1 <= Pl <= 8. Writes the partial
// acc complex64 [V, S, 2, 129] (sum_j X[s-p] H_p(s-p), p = p_base + j, j
// ascending: the caller's all_reduce completes it) and the next ring into
// fresh buffers, the whole of it on every rank. The corners, weights,
// interpolation and multiply-add are K10p-a's functions, each operation
// rounded, in ops/hrtf.py partitioned_mac_slice_plain's order.
//
// Bound on the H100: bytes (X in, the partial sums out, the ring, the
// corners' spectra from the L2). One voice of a per-node HRIR (V = 1, S =
// 32, P = 8 over part = 2): X 33 KB, acc 66 KB, the slice's corners 33 KB
// a direction; about 0.15 MB, 0.05 us, far under the launch's floor (about
// 1 us). What costs is the chain of dependent round trips to the L2 and
// the work each SM does in turn, so the design keeps the chain at two
// trips and spreads the work thin: a block is one warp, 32 (ear, bin)
// columns of one output quantum (9 blocks a quantum, 288 at S = 32, two
// an SM); its lanes j < Pl load partition j's direction and compute its
// corners and weights, the warp's shuffles hand them to every lane (no
// shared memory, no barrier), and every lane then issues all Pl x 8
// corner loads at once, its Pl input spectra and its share of the next
// ring having gone out before the directions. The next ring's R x 258
// values and 2R directions come from the inputs, not from the MAC, so
// they are spread one a thread over all the voice's blocks. A block
// fetches its own quantum's corners, so a still source costs what a moving
// one does. (A block of 4 quanta walking each partition, its direction
// runs' corners staged in shared memory by cp.async in waves of 5, as
// K10p-a walks, read 1.05-1.75x the first port's time at these shapes: its
// fewer, busier blocks and the staging cost more than the corner reuse
// saves at V = 1.)
GA_EXPORT int ga_hrtf_part_mac_slice(const void* X, const float* hx, const float* haz,
                                     const float* hel, const float* az, const float* el,
                                     const float* sr, const float* si, int V, int S, int P, int Pl,
                                     int p_base, int E, int A, float c_az, float c_el, void* acc,
                                     float* hx_out, float* haz_out, float* hel_out,
                                     void* stream) {
  if (V < 1 || S < 1 || P < 2 || Pl < 1 || Pl > kMaxP || p_base < 0 || p_base + Pl > P ||
      E < 1 || A < 1 || V > 65535 || S > 65535 || hx == hx_out || haz == haz_out ||
      hel == hel_out || static_cast<int64_t>(E) * A * 2 * Pl * kB > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kSliceChunks, S, V);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* Xc = static_cast<const float2*>(X);
  auto* accc = static_cast<float2*>(acc);
  switch (Pl) {
#define GA_SLICE_CASE(N)                                                                      \
  case N:                                                                                     \
    hrtf_part_mac_slice_kernel<N><<<grid, kSliceCols, 0, st>>>(                               \
        Xc, hx, haz, hel, az, el, sr, si, S, P, p_base, E, A, c_az, c_el, accc, hx_out,      \
        haz_out, hel_out);                                                                    \
    break;
    GA_SLICE_CASE(1)
    GA_SLICE_CASE(2)
    GA_SLICE_CASE(3)
    GA_SLICE_CASE(4)
    GA_SLICE_CASE(5)
    GA_SLICE_CASE(6)
    GA_SLICE_CASE(7)
    GA_SLICE_CASE(8)
#undef GA_SLICE_CASE
  }
  return ga_launch_status();
}

// y f32[V, S, 2, 256], the inverse transform unscaled; ola f32[V, 2, 128];
// x f32[V, C, S*128]; gain f32[V, S] or null; blend f32[V, S]. Writes out
// f32[V, 2, S*128] and ola_out f32[V, 2, 128].
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
