// K2: uniformly partitioned convolution, the spectral MAC and the overlap-add.
//
// Replaces graphaudio_tpu/ops/convolve.py spectral_mac / conv_superblock
// (:72-126), conv_superblock_big (:163-188) and conv_superblock_sub
// (:191-233): all three are one computation at grain B with L sub-blocks
// per step. The forward and inverse real FFTs around it are cuFFT
// (torch.fft); these two kernels are what the JAX code computed itself.
//
// MAC: for channel k, sub-block l and bin b,
//     acc[k, l, b] = sum_{lag < P} H[k, lag, b] * D(l - lag)[k, b]
// where D(m) is the spectrum of sub-block m of this step (m >= 0, read from
// X) or of a past step (m < 0, read from the ring). The delay line is a ring
// of R = P - 1 + L slots with a head: sub-block m lives in slot
// (head + m) mod R. H rows are in lag order (rev = 0, prepare_ir) or
// reversed (rev = 1, prepare_ir_big, whose newest-input row is last).
// Written as a correlation over the sequence seq[s] = D(s - (P - 1)),
// s = 0 .. R-1 (oldest first):
//     acc[l] = sum_{j < P} Hc[j] * seq[l + j],  Hc[j] = H[rev ? j : P-1-j].
//
// Bound on the H100: bytes, and before that latency. Per (k, bin) the MAC
// is an [L x P] by [P] complex matrix-vector product, a few flops a byte,
// far below the ridge; so no tensor cores (and TF32 is off in the port).
// At config 4's shape (K=2, L=8, P=94, 1025 bins) the unique bytes are
// ~3.5 MB (1.03 us at 3.35 TB/s). A thread per (k, l, bin) walking all P
// lags would load each H value L times and wait on one chain of P
// dependent loads; with 144 blocks most SMs would idle. So:
//  - a thread owns one column (k, bin) and a tile of LT sub-blocks
//    (LT = L rounded up to a power of two, at most 8) for one group of
//    lags: it loads each H value once and slides a window of LT delay-line
//    values through registers, so a group of n lags costs n H loads and
//    n + LT - 1 delay-line loads instead of LT x n of each;
//  - the lags are cut into groups: S groups (warps) in a block, and the
//    blocks of one thread-block cluster of C <= 8 share a column tile, so
//    the grid has about two blocks on every SM (the wrapper's mac_plan picks
//    LT, C, S and the lags a group from K, L, P and the bin count);
//  - the partial sums are reduced in a fixed order, with no atomics: the S
//    groups of a block in shared memory, then the C blocks of the cluster
//    through distributed shared memory, so every run gives the same bits;
//  - a group's delay-line range touches at most two runs of ring slots and
//    then X: the wrap point is computed once, not a modulo per lag;
//  - a warp is 32 consecutive columns of one group, so every load is
//    coalesced and the warp's lanes follow the same path; a thread issues
//    the loads of four lags together, ahead of their multiply-adds.
// The ring write stays in this launch: the cluster's rank-0 block, group 0,
// writes X[k, l, b] into slot head + l. Those slots hold seq[P-1 .. R-1],
// which the MAC reads from X, never from the ring; the past slots it reads
// are disjoint from them, so there is no race and no barrier between them.
//
// OLA (K2b) replaces graphaudio_tpu/ops/convolve.py:120 and :229 (the
// overlap-add at the end of conv_superblock and conv_superblock_sub) and
// the true-stereo combine of graphaudio_tpu/nodes/convolver.py:284-287:
//     z[k, l*B + t] = yfull[k, l, t] + (l ? yfull[k, l-1, B+t] : overlap[k, t]),
//     overlap[k, t] = yfull[k, L-1, B+t],
//     y[c] = z[a[c]]  or  z[a[c]] + z[b[c]]   (the combine map, c < C),
// the sum in exactly that order, so y is bit for bit the plain version's
// overlap-add followed by its stack of sums. One thread per (output c,
// sub-block l, 4-sample group) loops over nothing: it reads a float4 head
// of row l and a float4 tail of row l - 1 (or the carried overlap for
// l = 0) of each of its instances and writes one float4 of y. The thread
// that writes l = 0 also writes its instances' new overlap from row
// L - 1's tail, so the old tail's reader and the new tail's writer are one
// thread and blocks cannot race; the map covers every instance once, so
// all K overlaps are carried. B is a multiple of 128, so every float4 is
// aligned. Bound on the H100: bytes, about 213 KB at config 4's shape (K=2
// L=8 B=1024: yfull read once, the overlaps read and written, y written),
// 0.064 us at 3.35 TB/s; in practice the launch (4096 threads, 32 blocks).
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 32;        // columns (k, bin) a block: one warp wide
constexpr int kMaxGroups = 16;   // lag groups (warps) a block
constexpr int kMaxCluster = 8;   // the portable cluster size

template <int LT>
__global__ void __launch_bounds__(kCols * kMaxGroups)
    conv_mac_kernel(const float* __restrict__ X, const float* __restrict__ hr,
                    const float* __restrict__ hi, float* __restrict__ ring_r,
                    float* __restrict__ ring_i, float2* __restrict__ acc, int K, int L, int P,
                    int NB, int R, int head_arg, const long long* __restrict__ head_dev, int rev,
                    int lags) {
  extern __shared__ float2 part[];  // [S][LT][kCols]
  // the ring's head: the argument, or where given, read from the card (a
  // launch captured in a CUDA graph reads the head of each replay)
  const int head = head_dev != nullptr ? static_cast<int>(*head_dev) : head_arg;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x;  // the grid is one cluster wide
  const int S = blockDim.y, x = threadIdx.x, gy = threadIdx.y;
  const int col = blockIdx.y * kCols + x;
  const bool live = col < K * NB;
  const int k = live ? col / NB : 0, b = live ? col - k * NB : 0;
  const int l0 = blockIdx.z * LT;
  const int j0 = min(P, (rank * S + gy) * lags), j1 = min(P, j0 + lags);

  float ar[LT], ai[LT];
#pragma unroll
  for (int i = 0; i < LT; ++i) ar[i] = ai[i] = 0.0f;
  const float* Xr = X + 2 * (static_cast<int64_t>(k) * L * NB + b);  // interleaved complex
  const float* rr = ring_r + static_cast<int64_t>(k) * R * NB + b;
  const float* ri = ring_i + static_cast<int64_t>(k) * R * NB + b;
  if (live && j0 < j1) {
    const float* hrc = hr + static_cast<int64_t>(k) * P * NB + b;
    const float* hic = hi + static_cast<int64_t>(k) * P * NB + b;
    const int past = P - 1;                    // seq[s] for s < past is in the ring
    const int first = head + L < R ? head + L : head + L - R;  // slot of seq[0]
    const int wrap = R - first;                // seq[wrap] is in slot 0
    float wr[LT], wi[LT];                      // the window seq[l0 + j .. l0 + j + LT - 1]
    auto seq_at = [&](int s, float& vr, float& vi) {
      if (s >= R) {
        vr = vi = 0.0f;  // past the last sub-block: rows of a ragged tile only
      } else if (s >= past) {
        vr = Xr[2 * static_cast<int64_t>(s - past) * NB];
        vi = Xr[2 * static_cast<int64_t>(s - past) * NB + 1];
      } else {
        const int64_t slot = s < wrap ? first + s : first + s - R;
        vr = rr[slot * NB];
        vi = ri[slot * NB];
      }
    };
#pragma unroll
    for (int i = 0; i + 1 < LT; ++i) seq_at(l0 + j0 + i, wr[i], wi[i]);
    int64_t hrow = static_cast<int64_t>(rev ? j0 : P - 1 - j0) * NB;
    const int64_t hstep = rev ? NB : -NB;
    // One lag: the newest window value in, Hc[j] times the window, slide.
    auto step = [&](float vr, float vi, float h_r, float h_i) {
      wr[LT - 1] = vr;
      wi[LT - 1] = vi;
#pragma unroll
      for (int i = 0; i < LT; ++i) {
        ar[i] = fmaf(wr[i], h_r, fmaf(-wi[i], h_i, ar[i]));
        ai[i] = fmaf(wr[i], h_i, fmaf(wi[i], h_r, ai[i]));
      }
#pragma unroll
      for (int i = 0; i + 1 < LT; ++i) {
        wr[i] = wr[i + 1];
        wi[i] = wi[i + 1];
      }
    };
    // n lags taking seq from pr/pi + t * stride, four at a time: a batch's
    // loads are issued together, ahead of its multiply-adds.
    auto run = [&](const float* pr, const float* pi, int64_t stride, int n) {
#pragma unroll 1
      for (int t = 0; t < n; t += 4) {
        const int m = min(4, n - t);
        float vr[4], vi[4], h_r[4], h_i[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u < m) {
            vr[u] = pr[(t + u) * stride];
            vi[u] = pi[(t + u) * stride];
            h_r[u] = hrc[hrow + u * hstep];
            h_i[u] = hic[hrow + u * hstep];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < m) step(vr[u], vi[u], h_r[u], h_i[u]);
        hrow += m * hstep;
      }
    };
    // Lag j takes seq[l0 + j + LT - 1] in; s runs over [s1, s2) in order:
    // ring slots up to the wrap, ring slots from slot 0, X, then zeros.
    const int s1 = l0 + j0 + LT - 1, s2 = l0 + j1 + LT - 1;
    int a = s1, e = min(s2, min(past, wrap));
    int64_t o = static_cast<int64_t>(first + a) * NB;
    if (e > a) run(rr + o, ri + o, NB, e - a);
    a = max(s1, wrap);
    e = min(s2, past);
    o = static_cast<int64_t>(first + a - R) * NB;
    if (e > a) run(rr + o, ri + o, NB, e - a);
    a = max(s1, past);
    e = min(s2, R);
    o = 2 * static_cast<int64_t>(a - past) * NB;
    if (e > a) run(Xr + o, Xr + o + 1, 2 * NB, e - a);
#pragma unroll 1
    for (a = max(s1, R); a < s2; ++a, hrow += hstep) step(0.0f, 0.0f, hrc[hrow], hic[hrow]);
  }

  // This step's spectra into the ring, once per (k, l, bin).
  if (live && rank == 0 && gy == 0) {
#pragma unroll
    for (int i = 0; i < LT; ++i) {
      const int l = l0 + i;
      if (l < L) {
        const int64_t slot = (head + l < R ? head + l : head + l - R) * static_cast<int64_t>(NB);
        const int64_t o = 2 * static_cast<int64_t>(l) * NB;
        ring_r[static_cast<int64_t>(k) * R * NB + slot + b] = Xr[o];
        ring_i[static_cast<int64_t>(k) * R * NB + slot + b] = Xr[o + 1];
      }
    }
  }

  // The block's S groups, in order, into part[0] ...
  const int n_out = LT * kCols, tid = gy * kCols + x, n_thr = S * kCols;
#pragma unroll
  for (int i = 0; i < LT; ++i) part[(gy * LT + i) * kCols + x] = make_float2(ar[i], ai[i]);
  __syncthreads();
  for (int f = tid; f < n_out; f += n_thr) {
    float2 v = part[f];
    for (int g = 1; g < S; ++g) {
      const float2 u = part[g * n_out + f];
      v.x += u.x;
      v.y += u.y;
    }
    part[f] = v;
  }
  cluster.sync();
  // ... then the cluster's C blocks, in rank order: block `rank` finishes
  // its C-th of the tile's outputs.
  const int chunk = n_out / C;
  for (int f = rank * chunk + tid; f < (rank + 1) * chunk; f += n_thr) {
    float2 v = *cluster.map_shared_rank(part + f, 0);
    for (int q = 1; q < C; ++q) {
      const float2 u = *cluster.map_shared_rank(part + f, q);
      v.x += u.x;
      v.y += u.y;
    }
    const int c = blockIdx.y * kCols + f % kCols, l = l0 + f / kCols;
    if (c < K * NB && l < L) {
      const int kk = c / NB;
      acc[(static_cast<int64_t>(kk) * L + l) * NB + (c - kk * NB)] = v;
    }
  }
  cluster.sync();  // no block leaves while another still reads its part
}

constexpr int kOlaThreads = 128;
constexpr int kMaxOut = 32;  // output channels of the combine map (MAX_CHANNELS)

// Output c sums instance a[c] and, where b[c] >= 0, instance b[c].
struct OlaMap {
  int a[kMaxOut];
  int b[kMaxOut];
};

__device__ __forceinline__ float4 add4(float4 u, float4 v) {
  return make_float4(__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y), __fadd_rn(u.z, v.z),
                     __fadd_rn(u.w, v.w));
}

__global__ void __launch_bounds__(kOlaThreads)
    conv_ola_kernel(const float4* __restrict__ yfull, float4* __restrict__ overlap,
                    float4* __restrict__ y, int C, int L, int G,
                    const __grid_constant__ OlaMap map) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (c, l, g), g fastest: y's order
  if (i >= C * L * G) return;
  const int g = i % G, r = i / G, l = r % L, c = r / L;
  // G = B / 4 float4s a half row; row l of instance k starts at (k*L + l)*2G.
  auto part = [&](int k) {
    const float4* yk = yfull + static_cast<int64_t>(k) * L * 2 * G;
    const float4 head = yk[static_cast<int64_t>(l) * 2 * G + g];
    float4* ov = overlap + static_cast<int64_t>(k) * G + g;
    const float4 tail = l ? yk[static_cast<int64_t>(l - 1) * 2 * G + G + g] : *ov;
    if (l == 0) *ov = yk[static_cast<int64_t>(L - 1) * 2 * G + G + g];
    return add4(head, tail);
  };
  float4 v = part(map.a[c]);
  if (map.b[c] >= 0) v = add4(v, part(map.b[c]));
  y[i] = v;
}

// K14a: the MAC over one rank's slice of the partitions (see the export's
// note). A thread an output (k, l, bin): grid (bin tiles, L, K), so a
// block's threads are consecutive bins of one row and a warp's loads are 32
// consecutive floats; its rows in batches of kSliceRows, the next batch's
// loads issued before this one's multiply-adds. Offsets are 32-bit (the
// export checks that every array fits).
constexpr int kSliceThreads = 128;
constexpr int kSliceRows = 8;

__global__ void __launch_bounds__(kSliceThreads)
    conv_mac_slice_kernel(const float2* __restrict__ X, const float* __restrict__ hr,
                          const float* __restrict__ hi, float* __restrict__ ring_r,
                          float* __restrict__ ring_i, float2* __restrict__ acc, int Pl, int NB,
                          int R, int head, int rev, int p0) {
  const int b = blockIdx.x * kSliceThreads + threadIdx.x;
  if (b >= NB) return;
  const int l = blockIdx.y, k = blockIdx.z, L = gridDim.y;
  const int P = R - L + 1;  // the global (padded) partition count
  // Row j's lag is p0 + j, or P-1-(p0+j) when reversed, so the sub-block it
  // multiplies, m = l - lag, steps by one a row: m0 + dm j. X row m for m
  // >= 0 (interleaved: re at 2 m NB, im after it), else ring slot head + m,
  // wrapped once (m >= -(P-1) > -R).
  const int m0 = rev ? l - (P - 1 - p0) : l - p0, dm = rev ? 1 : -1;
  const float* xk = reinterpret_cast<const float*>(X) + 2 * (k * L * NB + b);
  const float* rr = ring_r + k * R * NB + b;
  const float* ri = ring_i + k * R * NB + b;
  const float* hrk = hr + k * Pl * NB + b;
  const float* hik = hi + k * Pl * NB + b;
  const int i = (k * L + l) * NB + b;
  const float2 own = X[i];  // this step's spectrum, for the ring
  struct Batch {
    float xr[kSliceRows], xi[kSliceRows], h_r[kSliceRows], h_i[kSliceRows];
  };
  auto load = [&](Batch& q, int j0) {
#pragma unroll
    for (int u = 0; u < kSliceRows; ++u) {
      const int j = j0 + u;
      if (j < Pl) {
        const int m = m0 + dm * j;
        const int slot = head + m < 0 ? head + m + R : head + m;
        const float* pr = m >= 0 ? xk + 2 * m * NB : rr + slot * NB;
        const float* pi = m >= 0 ? pr + 1 : ri + slot * NB;
        q.xr[u] = *pr;
        q.xi[u] = *pi;
        q.h_r[u] = hrk[j * NB];
        q.h_i[u] = hik[j * NB];
      }
    }
  };
  float ar = 0.0f, ai = 0.0f;
  // acc + (xr hr - xi hi), acc + (xr hi + xi hr): each operation rounded,
  // rows ascending, the plain version's order.
  auto add = [&](const Batch& q, int j0) {
#pragma unroll
    for (int u = 0; u < kSliceRows; ++u)
      if (j0 + u < Pl) {
        ar = __fadd_rn(ar, __fsub_rn(__fmul_rn(q.xr[u], q.h_r[u]), __fmul_rn(q.xi[u], q.h_i[u])));
        ai = __fadd_rn(ai, __fadd_rn(__fmul_rn(q.xr[u], q.h_i[u]), __fmul_rn(q.xi[u], q.h_r[u])));
      }
  };
  Batch q0, q1;
  load(q0, 0);
  for (int j0 = 0; j0 < Pl; j0 += 2 * kSliceRows) {
    load(q1, j0 + kSliceRows);
    add(q0, j0);
    load(q0, j0 + 2 * kSliceRows);
    add(q1, j0 + kSliceRows);
  }
  acc[i] = make_float2(ar, ai);
  // This step's spectrum into its slot. The slots read above hold sub-blocks
  // m < 0, slots head + L .. head + R - 1 (mod R); these are head .. head +
  // L - 1: disjoint, so no thread reads what another writes.
  const int slot = k * R * NB + (head + l < R ? head + l : head + l - R) * NB + b;
  ring_r[slot] = own.x;
  ring_i[slot] = own.y;
}

template <int LT>
cudaError_t launch_mac(dim3 grid, dim3 block, size_t smem, cudaStream_t stream, const float* X,
                       const float* hr, const float* hi, float* ring_r, float* ring_i, float2* acc,
                       int K, int L, int P, int NB, int R, int head, const long long* head_dev, int rev,
                       int lags) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, conv_mac_kernel<LT>, X, hr, hi, ring_r, ring_i, acc, K, L, P,
                            NB, R, head, head_dev, rev, lags);
}

}  // namespace

// lt: sub-blocks a thread owns (1, 2, 4 or 8); clusters: blocks a cluster
// (1, 2, 4 or 8); groups: lag groups a block (1..16); lags: lags a group,
// with clusters * groups * lags >= P. X and acc are interleaved complex.
// head_dev: null, or an int64 on the card holding the head (in [0, R)),
// read in place of head.
GA_EXPORT int ga_conv_mac(const float* X, const float* hr, const float* hi, float* ring_r,
                          float* ring_i, float* acc, int K, int L, int P, int NB, int R,
                          int head, const long long* head_dev, int rev, int lt, int clusters,
                          int groups, int lags, void* stream) {
  if (groups < 1 || groups > kMaxGroups || clusters < 1 || clusters > kMaxCluster ||
      (clusters & (clusters - 1)) || static_cast<int64_t>(clusters) * groups * lags < P ||
      R != P - 1 + L || (head_dev == nullptr && (head < 0 || head >= R)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(clusters, (K * NB + kCols - 1) / kCols, (L + lt - 1) / lt);
  const dim3 block(kCols, groups);
  const size_t smem = sizeof(float2) * groups * lt * kCols;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = reinterpret_cast<float2*>(acc);
  cudaError_t err;
  switch (lt) {
#define GA_MAC_CASE(T)                                                                   \
  case T:                                                                                \
    err = launch_mac<T>(grid, block, smem, s, X, hr, hi, ring_r, ring_i, a, K, L, P, NB, R, \
                        head, head_dev, rev, lags);                                      \
    break;
    GA_MAC_CASE(1)
    GA_MAC_CASE(2)
    GA_MAC_CASE(4)
    GA_MAC_CASE(8)
#undef GA_MAC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return err != cudaSuccess ? static_cast<int>(err) : ga_launch_status();
}

// K14a: K2a's MAC over the partitions [p0, p0 + Pl) of a P-partition IR, P =
// R - L + 1, at their global lags (the rank's slice under a mesh whose
// `part` dimension splits the partitions). Replaces graphaudio_tpu/ops/
// convolve.py conv_superblock_big_sharded (:236-265, its per-device MAC
// before the psum) and the MAC of graphaudio_tpu/parallel/sharded.py
// (:170-180). hr, hi f32[K, Pl, NB] hold the slice's rows, in lag order
// (rev = 0) or reversed (rev = 1: global row p multiplies the sub-block
// P-1-p steps ago); X, acc interleaved complex [K, L, NB]; the ring f32[K,
// R, NB] is the whole delay line (replicated on every rank), this step's
// spectra written at slots head .. head + L - 1. The caller completes the
// sum across ranks (all_reduce). acc[k, l, b] = sum over j ascending of
// D(l - lag_j)[k, b] * H[k, j, b], D(m) X[k, m] for m >= 0 and ring slot
// (head + m) mod R otherwise.
//
// Bound on the H100: bytes. Config 4 under part = 2 (K=2, L=1, NB=8193,
// Pl=6 of P=12) reads X, the slice's spectra and the 6 ring rows it needs
// and writes acc and one ring row, about 2 MB (0.6 us at 3.35 TB/s); its
// 8 flops a (k, l, b, j) are 0.8 MFLOP. What costs is latency: a thread an
// output, 128 a block (130 blocks at config 4: 65 bin tiles x 2 channels,
// about one an SM), each H value and ring value read once by one thread,
// coalesced across the warp's bins; no thread divides to find its output.
// The source of each row (an X row or a ring slot) follows from its lag in
// one add a row, so a thread issues a batch of kSliceRows rows' loads
// together, and the next batch's before this one's multiply-adds: config
// 4's slice is one batch, one round trip to memory.
// Bins are read one float at a time: with NB odd, a row's base is not
// 8-byte aligned. K2a's lag split over clusters is for P in the hundreds
// at the 128 grain; a slice has Pl = P / part rows, and under `part` the
// grain is T (L = 1).
GA_EXPORT int ga_conv_mac_slice(const float* X, const float* hr, const float* hi, float* ring_r,
                                float* ring_i, float* acc, int K, int L, int Pl, int NB, int R,
                                int head, int rev, int p0, void* stream) {
  const int P = R - L + 1;
  const int64_t most = static_cast<int64_t>(K) * NB * std::max(std::max(R, Pl), 2 * L);
  if (K < 1 || L < 1 || Pl < 1 || NB < 1 || P < 1 || p0 < 0 || p0 + Pl > P || head < 0 ||
      head >= R || K > 65535 || L > 65535 || most > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((NB + kSliceThreads - 1) / kSliceThreads, L, K);
  conv_mac_slice_kernel<<<grid, kSliceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(X), hr, hi, ring_r, ring_i, reinterpret_cast<float2*>(acc),
      Pl, NB, R, head, rev, p0);
  return ga_launch_status();
}

// comb: host int32[2, C], row 0 each output's first instance, row 1 its
// second or -1; every instance k < K must appear exactly once. yfull f32[K,
// L, 2B], overlap f32[K, B] (replaced), y f32[C, L*B]; B % 4 == 0 and the
// three 16-byte aligned.
GA_EXPORT int ga_conv_ola(const float* yfull, float* overlap, float* y, int K, int C, int L, int B,
                          const int* comb, void* stream) {
  if (C < 1 || C > kMaxOut || K < 1 || K > 2 * kMaxOut || L < 1 || B < 4 || B % 4 ||
      ((reinterpret_cast<uintptr_t>(yfull) | reinterpret_cast<uintptr_t>(overlap) |
        reinterpret_cast<uintptr_t>(y)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  OlaMap map;
  int seen[2 * kMaxOut] = {};
  for (int c = 0; c < C; ++c) {
    map.a[c] = comb[c];
    map.b[c] = comb[C + c];
    if (map.a[c] < 0 || map.a[c] >= K || map.b[c] < -1 || map.b[c] >= K)
      return static_cast<int>(cudaErrorInvalidValue);
    ++seen[map.a[c]];
    if (map.b[c] >= 0) ++seen[map.b[c]];
  }
  for (int k = 0; k < K; ++k)
    if (seen[k] != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int G = B / 4;
  const int64_t n = static_cast<int64_t>(C) * L * G;
  if (n >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  conv_ola_kernel<<<static_cast<unsigned>((n + kOlaThreads - 1) / kOlaThreads), kOlaThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(yfull), reinterpret_cast<float4*>(overlap),
      reinterpret_cast<float4*>(y), C, L, G, map);
  return ga_launch_status();
}

GA_EXPORT const char* ga_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
