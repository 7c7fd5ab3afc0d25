// K11: the oscillator's and the constant source's group steps.
//
// Replaces graphaudio_tpu/nodes/sources.py OscillatorNode.process
// (:300-333) and ConstantSourceNode.process (:230-235), with the sample
// gate of ScheduledSourceNode._sample_gate (:143-170), over every lane of
// a stage in one launch. The arithmetic is ops/oscillator.py's plain
// version operation for operation (__f*_rn / __d*_rn, so nvcc contracts
// nothing):
//   inc = gate ? fl32(2 pi/sr) * f : 0, in f32;
//   the in-quantum phase cumsum(inc) - inc in XLA's CPU order: sequential
//   runs of 16 samples, each run plus the sequential sum of the runs
//   before it;
//   the quantum's f64 sum of the gated f (runs of 16, then the 8 runs) times
//   2 pi/sr; the anchors phase + the sequential sum of the quanta before,
//   mod 2 pi, to f32;
//   mod(anchor32 + local, fl32(2 pi)) in f32, the waveform (the sine in f64,
//   rounded once to f32: the correctly rounded sine, so the card's bits are
//   the CPU's), gated; the new phase mod(phase + sum, 2 pi) in f64.
// mod is jnp.mod: exact fmod, moved into the divisor's sign.
//
// Bound on the H100: neither bytes nor flops at config 6's size (64 lanes
// x 4096 samples: 1 MB written, about 30 operations a sample) but latency:
// the 16 sequential adds of a run, then the anchors' chain of dependent
// f64 adds over a lane's quanta, then the waveform (an exact fmodf and
// an f64 sin a sample, issue-bound once every SM has work). The design fills the
// card and keeps the anchor chain the only serial part:
// - a block writes a tile of 8 quanta of one lane (256 threads), so config
//   6's step is 4 x 64 = 256 blocks;
// - the tile's anchors need the f64 sums of every quantum before it: each
//   block computes them itself, 32 quanta a pass (a thread a run of 16
//   samples), rather than sharing them between a lane's blocks through a
//   thread-block cluster: timed on the H100 (PERF.md §6), the cluster
//   barrier (its release fence is a GPU-wide MEMBAR) and the distributed
//   shared-memory gather took longer than summing up to 24 quanta more,
//   and at config 6's superblock of 32 quanta every block needs one pass;
// - per quantum, once: its gate bounds (t1 = t0 + 128/sr, the f64 the host
//   passes); its f64 sum, the 8 run sums in order, and the runs' exclusive
//   f32 sums, both from the quantum's 8 neighbouring run lanes by warp
//   shuffles (no barrier); and jmod of its anchor. Thread q of the tile
//   runs the chain phase + sum_{j<q} bsum_j in ascending j from the
//   running sum the passes before carried;
// - the waveform, a template argument, is evaluated a thread per 4
//   consecutive samples from the run prefixes staged in shared memory, and
//   written as coalesced float4s; the 16-sample serial loop keeps only the
//   adds.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;        // samples a quantum
constexpr int kRun = 16;       // samples a run (XLA's CPU cumsum)
constexpr int kRuns = kQ / kRun;
constexpr int kTile = 8;       // quanta a block writes
constexpr int kPass = kThreads / kRuns;  // 32 quanta a pass of the sums
// Floats a run occupies in shared memory: 16 and a float4 of padding, so
// that a quarter warp's float4 writes of its runs hit distinct banks.
constexpr int kRunStride = kRun + 4;
static_assert(kTile * kQ == 4 * kThreads, "the waveform is a float4 a thread");
static_assert(kPass % kTile == 0, "a tile lies in one pass");

// jnp.mod by 2 pi (f64) and by fl32(2 pi) (f32): the exact fmod, moved
// into the divisor's sign.
__device__ __forceinline__ double jmod_2pi(double x) {
  const double y = 6.283185307179586;
  const double r = fmod(x, y);
  return r < 0.0 ? __dadd_rn(r, y) : r;
}

__device__ __forceinline__ float jmodf_2pi(float x) {
  const float y = 6.28318548202514648f;
  const float r = fmodf(x, y);
  return r < 0.0f ? __fadd_rn(r, y) : r;
}

// Quantum [t0, t0 + qdur)'s gate for one lane, as the samples [lo, hi)
// that play (lo = hi = 0 when the quantum is silent).
__device__ __forceinline__ int2 gate_of(bool started, double start, double stop, double t0,
                                        double qdur, double sr) {
  const double t1 = __dadd_rn(t0, qdur);
  const bool active = started && (t1 > start) && (t0 < stop);
  const double sf =
      (t0 < start && start < t1)
          ? fmin(fmax(ceil(__dmul_rn(__dsub_rn(start, t0), sr)), 0.0), 128.0)
          : 0.0;
  const double ef =
      (isfinite(stop) && t0 < stop && stop < t1)
          ? fmin(fmax(floor(__dmul_rn(__dsub_rn(stop, t0), sr)), 0.0), 128.0)
          : 128.0;
  return active ? make_int2(static_cast<int>(sf), static_cast<int>(ef)) : make_int2(0, 0);
}

template <int kWave>
__device__ __forceinline__ float waveform(float p) {
  const float two_pi_f = 6.28318548202514648f;  // fl32(2 pi)
  if (kWave == 0) return static_cast<float>(sin(static_cast<double>(p)));
  if (kWave == 1) return p < 3.14159274101257324f ? 1.0f : -1.0f;  // fl32(pi)
  if (kWave == 2) return __fsub_rn(__fmul_rn(2.0f, __fdiv_rn(p, two_pi_f)), 1.0f);
  const float u = __fdiv_rn(p, two_pi_f);
  return __fsub_rn(__fmul_rn(4.0f, fabsf(__fsub_rn(u, floorf(__fadd_rn(u, 0.5f))))), 1.0f);
}

// Grid (tiles, L): block (x, v) writes quanta [8x, 8x + 8) of lane v.
template <int kWave>
__global__ void __launch_bounds__(kThreads) oscillator_kernel(
    const float* __restrict__ f, int per_sample, const int32_t* __restrict__ started,
    const double* __restrict__ start_time, const double* __restrict__ stop_time,
    const double* __restrict__ phase, const double* __restrict__ block_times, int S, double sr,
    double qdur, float c32, double c64, float* __restrict__ out,
    double* __restrict__ new_phase) {
  __shared__ __align__(16) float part[kTile * kRuns * kRunStride];  // inclusive run prefixes
  __shared__ __align__(16) float incs[kTile * kRuns * kRunStride];  // the gated increments
  __shared__ float run_before[kTile * kRuns];  // the quantum's runs before, summed in f32
  __shared__ double bsum[kPass];  // the pass's quantum sums
  __shared__ int2 gate[kPass];
  __shared__ float anchor32[kTile];
  __shared__ double carry;
  const int v = blockIdx.y, tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile, nq = min(kTile, S - q0), q_end = q0 + nq;
  const int64_t T = static_cast<int64_t>(S) * kQ;
  const bool st = started[v] > 0;
  const double start = start_time[v], stop = stop_time[v], ph0 = phase[v];
  const float f_lane = per_sample ? 0.0f : f[v];
  double cs = 0.0;  // the running f64 sum of the quanta of the passes before
  int g0 = 0;
  for (;; g0 += kPass) {
    const int pn = min(kPass, q_end - g0);
    const bool last = g0 + pn == q_end;  // the pass that holds the tile
    // 0. each quantum's gate, once
    if (tid < pn) gate[tid] = gate_of(st, start, stop, block_times[g0 + tid], qdur, sr);
    __syncthreads();
    // 1. a thread a run: the f64 sum of its 16 samples; in the tile, also
    //    the f32 prefix and the increments
    const int ql = tid / kRuns, r = tid % kRuns, q = g0 + ql;
    const bool active = ql < pn;
    float inc[kRun], pre[kRun];
    float acc = 0.0f;
    double dacc = 0.0;
    if (active) {
      const int2 g = gate[ql];
      const float* fq = f + static_cast<int64_t>(v) * T + static_cast<int64_t>(q) * kQ + r * kRun;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const float fv = per_sample ? fq[k] : f_lane;
        const int i = r * kRun + k;
        const bool on = i >= g.x && i < g.y;
        inc[k] = on ? __fmul_rn(c32, fv) : 0.0f;
        acc = __fadd_rn(acc, inc[k]);
        pre[k] = acc;
        dacc = __dadd_rn(dacc, on ? static_cast<double>(fv) : 0.0);
      }
    }
    // 2. the quantum's 8 runs are 8 neighbouring lanes: gathered by
    //    shuffles, its f64 sum (the runs in order, in its first lane) and,
    //    in the tile, each run's exclusive f32 sum of the runs before
    const int first = (tid & 31) & ~(kRuns - 1);
    double dr[kRuns];
    float tr[kRuns];
#pragma unroll
    for (int c = 0; c < kRuns; ++c) {
      dr[c] = __shfl_sync(0xffffffffu, dacc, first + c);
      tr[c] = __shfl_sync(0xffffffffu, acc, first + c);
    }
    if (active) {
      if (r == 0) {
        double b = dr[0];
#pragma unroll
        for (int c = 1; c < kRuns; ++c) b = __dadd_rn(b, dr[c]);
        bsum[ql] = __dmul_rn(b, c64);
      }
      if (q >= q0) {
        float e = 0.0f;
#pragma unroll
        for (int c = 0; c < kRuns - 1; ++c)
          if (c < r) e = __fadd_rn(e, tr[c]);
        const int run = (q - q0) * kRuns + r;
        float4* pp = reinterpret_cast<float4*>(part + run * kRunStride);
        float4* ip = reinterpret_cast<float4*>(incs + run * kRunStride);
#pragma unroll
        for (int k = 0; k < kRun / 4; ++k) {
          pp[k] = make_float4(pre[4 * k], pre[4 * k + 1], pre[4 * k + 2], pre[4 * k + 3]);
          ip[k] = make_float4(inc[4 * k], inc[4 * k + 1], inc[4 * k + 2], inc[4 * k + 3]);
        }
        run_before[run] = e;
      }
    }
    __syncthreads();
    if (last) break;
    // 3a. a pass before the tile's: one thread carries its sums on
    if (tid == 0) {
      double c = cs;
      for (int j = 0; j < pn; ++j) c = __dadd_rn(c, bsum[j]);
      carry = c;
    }
    __syncthreads();
    cs = carry;
  }
  // 3b. the anchors: thread q adds the pass's sums before its quantum in
  //     ascending order
  if (tid < nq) {
    const int upto = q0 - g0 + tid;
    double c = cs;
    for (int j = 0; j < upto; ++j) c = __dadd_rn(c, bsum[j]);
    anchor32[tid] = static_cast<float>(jmod_2pi(__dadd_rn(ph0, c)));
    if (q0 + tid == S - 1) new_phase[v] = jmod_2pi(__dadd_rn(ph0, __dadd_rn(c, bsum[upto])));
  }
  __syncthreads();
  // 4. a thread a float4 of samples: local phase, waveform, gate
  const int s4 = tid * 4, ql = s4 / kQ;
  if (ql < nq) {
    const int i = s4 % kQ, run = ql * kRuns + i / kRun, k = i % kRun;
    const float4 pv = *reinterpret_cast<const float4*>(part + run * kRunStride + k);
    const float4 iv = *reinterpret_cast<const float4*>(incs + run * kRunStride + k);
    const float e = run_before[run], a = anchor32[ql];
    const int2 g = gate[q0 - g0 + ql];
    const float pa[4] = {pv.x, pv.y, pv.z, pv.w}, ia[4] = {iv.x, iv.y, iv.z, iv.w};
    float w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float local = __fsub_rn(__fadd_rn(pa[m], e), ia[m]);
      const float ph = jmodf_2pi(__fadd_rn(a, local));
      w[m] = (i + m >= g.x && i + m < g.y) ? waveform<kWave>(ph) : 0.0f;
    }
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(v) * T + static_cast<int64_t>(q0) * kQ +
                               s4) = make_float4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(kThreads) constant_kernel(
    const float* __restrict__ offset, int per_sample, const int32_t* __restrict__ started,
    const double* __restrict__ start_time, const double* __restrict__ stop_time,
    const double* __restrict__ block_times, int S, double sr, float* __restrict__ out) {
  const int v = blockIdx.y;
  const int64_t T = static_cast<int64_t>(S) * kQ;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= T) return;
  const int s = static_cast<int>(j / kQ), i = static_cast<int>(j % kQ);
  const int2 g = gate_of(started[v] > 0, start_time[v], stop_time[v], block_times[s],
                         __ddiv_rn(128.0, sr), sr);
  const int64_t at = static_cast<int64_t>(v) * T + j;
  out[at] = (i >= g.x && i < g.y) ? (per_sample ? offset[at] : offset[v]) : 0.0f;
}

}  // namespace

// qdur is 128 / sr in f64; wave: 0 sine, 1 square, 2 sawtooth, 3 triangle.
GA_EXPORT int ga_oscillator_step(const float* f, int per_sample, const int32_t* started,
                                 const double* start_time, const double* stop_time,
                                 const double* phase, const double* block_times, int L, int S,
                                 double sr, double qdur, float c32, double c64, int wave,
                                 float* out, double* new_phase, void* stream) {
  const dim3 grid((S + kTile - 1) / kTile, L);
  auto s = static_cast<cudaStream_t>(stream);
  switch (wave) {
#define GA_OSC(W)                                                                              \
  case W:                                                                                      \
    oscillator_kernel<W><<<grid, kThreads, 0, s>>>(f, per_sample, started, start_time,        \
                                                   stop_time, phase, block_times, S, sr, qdur, \
                                                   c32, c64, out, new_phase);                  \
    break;
    GA_OSC(0)
    GA_OSC(1)
    GA_OSC(2)
    GA_OSC(3)
#undef GA_OSC
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return ga_launch_status();
}

GA_EXPORT int ga_constant_step(const float* offset, int per_sample, const int32_t* started,
                               const double* start_time, const double* stop_time,
                               const double* block_times, int L, int S, double sr, float* out,
                               void* stream) {
  const int64_t T = static_cast<int64_t>(S) * kQ;
  const dim3 grid(static_cast<unsigned>((T + kThreads - 1) / kThreads), L);
  constant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      offset, per_sample, started, start_time, stop_time, block_times, S, sr, out);
  return ga_launch_status();
}
