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
//   mod(anchor32 + local, fl32(2 pi)) in f32, the waveform (sinf, not the
//   fast __sinf), gated; the new phase mod(phase + sum, 2 pi) in f64.
// mod is jnp.mod: exact fmod, moved into the divisor's sign.
//
// Bound on the H100: neither bytes nor flops at config 6's size (64 lanes
// x 4096 samples: 1 MB written, about 30 operations a sample) but the
// chain of dependent steps inside a block: 16 sequential adds a thread,
// two barriers, then the one thread that runs the f64 anchors over the
// quanta. One block of 256 threads per lane covers 32 quanta (8 threads a
// quantum, one run of 16 samples each), so config 6's step is 64 blocks.
// A longer superblock loops over groups of 32 quanta in the same block,
// carrying the running f64 sum.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;        // samples a quantum
constexpr int kRun = 16;       // samples a thread (one run)
constexpr int kRuns = kQ / kRun;
constexpr int kGroupQuanta = kThreads / kRuns;  // 32

__device__ __forceinline__ double jmod(double x, double y) {
  const double r = fmod(x, y);
  return (r != 0.0 && ((r < 0.0) != (y < 0.0))) ? __dadd_rn(r, y) : r;
}

__device__ __forceinline__ float jmodf(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) ? __fadd_rn(r, y) : r;
}

// Quantum s's gate bounds [sf, ef) for one lane, or an empty range.
struct Gate {
  bool active;
  double sf, ef;
};

__device__ __forceinline__ Gate gate_of(bool started, double start, double stop, double t0,
                                        double sr) {
  const double t1 = __dadd_rn(t0, __ddiv_rn(128.0, sr));
  Gate g;
  g.active = started && (t1 > start) && (t0 < stop);
  g.sf = (t0 < start && start < t1)
             ? fmin(fmax(ceil(__dmul_rn(__dsub_rn(start, t0), sr)), 0.0), 128.0)
             : 0.0;
  g.ef = (isfinite(stop) && t0 < stop && stop < t1)
             ? fmin(fmax(floor(__dmul_rn(__dsub_rn(stop, t0), sr)), 0.0), 128.0)
             : 128.0;
  return g;
}

__device__ __forceinline__ bool gated(const Gate& g, int i) {
  const double x = static_cast<double>(i);
  return g.active && x >= g.sf && x < g.ef;
}

__global__ void __launch_bounds__(kThreads) oscillator_kernel(
    const float* __restrict__ f, int per_sample, const int32_t* __restrict__ started,
    const double* __restrict__ start_time, const double* __restrict__ stop_time,
    const double* __restrict__ phase, const double* __restrict__ block_times, int S,
    double sr, float c32, double c64, int wave, float* __restrict__ out,
    double* __restrict__ new_phase) {
  __shared__ float run_total[kThreads];
  __shared__ double run_dsum[kThreads];
  __shared__ double anchor[kGroupQuanta];
  const int v = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t T = static_cast<int64_t>(S) * kQ;
  const bool st = started[v] > 0;
  const double start = start_time[v], stop = stop_time[v], ph0 = phase[v];
  const float f_lane = per_sample ? 0.0f : f[v];
  const float* f_row = f + static_cast<int64_t>(v) * T;
  const float two_pi_f = 6.28318548202514648f;  // fl32(2 pi)
  const double two_pi = 6.283185307179586;
  const int ql = tid / kRuns, r = tid % kRuns;
  double cs = 0.0;  // thread 0: the running f64 sum of the quanta before
  for (int g0 = 0; g0 < S; g0 += kGroupQuanta) {
    const int s = g0 + ql;
    const bool valid = s < S;
    float inc[kRun], part[kRun];
    bool on[kRun];
    float acc = 0.0f;
    double dacc = 0.0;
    if (valid) {
      const Gate g = gate_of(st, start, stop, block_times[s], sr);
      const float* fq = f_row + static_cast<int64_t>(s) * kQ + r * kRun;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const float fv = per_sample ? fq[k] : f_lane;
        on[k] = gated(g, r * kRun + k);
        inc[k] = on[k] ? __fmul_rn(c32, fv) : 0.0f;
        acc = __fadd_rn(acc, inc[k]);
        part[k] = acc;
        dacc = __dadd_rn(dacc, on[k] ? static_cast<double>(fv) : 0.0);
      }
    }
    run_total[tid] = acc;
    run_dsum[tid] = dacc;
    __syncthreads();
    if (tid == 0) {
      const int nq = min(kGroupQuanta, S - g0);
      for (int q = 0; q < nq; ++q) {
        double b = run_dsum[q * kRuns];
        for (int c = 1; c < kRuns; ++c) b = __dadd_rn(b, run_dsum[q * kRuns + c]);
        anchor[q] = __dadd_rn(ph0, cs);
        cs = __dadd_rn(cs, __dmul_rn(b, c64));
      }
      if (g0 + kGroupQuanta >= S) new_phase[v] = jmod(__dadd_rn(ph0, cs), two_pi);
    }
    __syncthreads();
    if (valid) {
      float e = 0.0f;
      for (int c = 0; c < r; ++c) e = __fadd_rn(e, run_total[ql * kRuns + c]);
      const float a32 = static_cast<float>(jmod(anchor[ql], two_pi));
      float* oq = out + static_cast<int64_t>(v) * T + static_cast<int64_t>(s) * kQ + r * kRun;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const float local = __fsub_rn(__fadd_rn(part[k], e), inc[k]);
        const float p = jmodf(__fadd_rn(a32, local), two_pi_f);
        float w;
        if (wave == 0) {
          w = sinf(p);
        } else if (wave == 1) {
          w = p < 3.14159274101257324f ? 1.0f : -1.0f;  // fl32(pi)
        } else if (wave == 2) {
          w = __fsub_rn(__fmul_rn(2.0f, __fdiv_rn(p, two_pi_f)), 1.0f);
        } else {
          const float u = __fdiv_rn(p, two_pi_f);
          w = __fsub_rn(__fmul_rn(4.0f, fabsf(__fsub_rn(u, floorf(__fadd_rn(u, 0.5f))))), 1.0f);
        }
        oq[k] = on[k] ? w : 0.0f;
      }
    }
    __syncthreads();  // run_total / anchor are rewritten by the next group
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
  const Gate g = gate_of(started[v] > 0, start_time[v], stop_time[v], block_times[s], sr);
  const int64_t at = static_cast<int64_t>(v) * T + j;
  out[at] = gated(g, i) ? (per_sample ? offset[at] : offset[v]) : 0.0f;
}

}  // namespace

GA_EXPORT int ga_oscillator_step(const float* f, int per_sample, const int32_t* started,
                                 const double* start_time, const double* stop_time,
                                 const double* phase, const double* block_times, int L, int S,
                                 double sr, float c32, double c64, int wave, float* out,
                                 double* new_phase, void* stream) {
  oscillator_kernel<<<L, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f, per_sample, started, start_time, stop_time, phase, block_times, S, sr, c32, c64, wave,
      out, new_phase);
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
