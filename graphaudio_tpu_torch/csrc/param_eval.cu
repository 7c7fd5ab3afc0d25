// K6: AudioParam automation curves of one superblock, every automated param
// of a render step in one launch.
//
// Replaces graphaudio_tpu/ops/param_eval.py eval_intrinsic_blocked
// (:175-336) with its exact branches (:213-222, :287-306) and
// eval_intrinsic (:85-172). The TPU version locates each sample's
// surrounding events with [S, n, cap] one-hot reductions and XLA fuses the
// step's params into one program; here the step's table (ops/param_eval.py
// pack_param_table: one row per (param, lane), its events padded to the
// batch's capacity, its third word the row's kind) is evaluated by one
// launch. Each row is evaluated at its own clock: its fourth word picks a
// row of the step's clock matrix f64[C, S] (a chained stage's lanes run
// superblocks behind the live one, core/graph.py), 0 where nothing is
// chained. A block owns one row and a
// tile of 256 consecutive samples: it stages the row's event fields in
// shared memory with one coalesced load (when the capacity is at most
// kStageCap; larger tables are read from global memory), and each thread
// counts the events at or before its f64 absolute time with broadcast reads,
// then reads the prev/next fields.
//
// Arithmetic follows the plain version (ops/param_eval.py) operation for
// operation: f64 absolute times for the event index, f32 relative times for
// the curve, fma/fmaf where XLA contracts a multiply-add (ops/xla_rounding.py),
// __f*_rn elsewhere so nvcc does not contract on its own, and exp/pow in
// f64 rounded once to f32. A row of the exact kind (a param that a consumer
// integrates: playbackRate, oscillator frequency) evaluates at k-rate the
// whole curve in f64 at the block time (eval_intrinsic), at a-rate
// its linear ramps in f64 on the uncontracted sample time bt + i*dt (where
// XLA leaves it so); either is rounded once to f32. CUDA's f64 pow/exp may
// differ from the CPU's by an ulp, which the f32 rounding almost always
// hides. Padding a row to a larger capacity changes no
// output: +inf times are never counted, the index never passes the row's n,
// and the next event is read only while idx < n.
//
// Bound on the H100: not the work (about ten flops a sample, a few
// kilobytes) but the launch and a chain of dependent reads, the row's words
// and staged events, then its block clock, then the store; config 3's step
// (8 rows x 4096 samples) is 128 blocks, one wave on the 132 SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageCap = 1024;  // 28.7 KB of staged fields at most

__host__ __device__ inline size_t stage_bytes(int cap) {
  return cap <= kStageCap
             ? static_cast<size_t>(cap) * (2 * sizeof(double) + 2 * sizeof(float)) +
                   static_cast<size_t>(cap + 1) * sizeof(float)
             : 0;
}

__global__ void __launch_bounds__(kThreads) param_eval_batch_kernel(
    const double* __restrict__ times, const float* __restrict__ values,
    const double* __restrict__ tcs, const int32_t* __restrict__ types,
    const float* __restrict__ boundary, const int32_t* __restrict__ nev,
    const float* __restrict__ base, const int32_t* __restrict__ rows,
    const double* __restrict__ clocks, int cap, int S, double dt,
    float* __restrict__ out) {
  // The row's words, count and base load while its events are staged:
  // nothing below waits on them until the barrier.
  const int r = blockIdx.x;
  const int npb = rows[4 * r], off = rows[4 * r + 1];
  const bool exact = rows[4 * r + 2] != 0;
  const double* block_times = clocks + static_cast<int64_t>(rows[4 * r + 3]) * S;
  const int n = nev[r];
  const float base_r = base[r];
  const int64_t row = static_cast<int64_t>(r) * cap;
  const double* tl = times + row;
  const double* cl = tcs + row;
  const float* vl = values + row;
  const int32_t* yl = types + row;
  const float* bl = boundary + static_cast<int64_t>(r) * (cap + 1);
  extern __shared__ double stage[];
  if (cap <= kStageCap) {
    double* st = stage;
    double* sc = st + cap;
    float* sv = reinterpret_cast<float*>(sc + cap);
    int32_t* sy = reinterpret_cast<int32_t*>(sv + cap);
    float* sb = reinterpret_cast<float*>(sy + cap);
    for (int k = threadIdx.x; k < cap; k += kThreads) {
      st[k] = tl[k];
      sc[k] = cl[k];
      sv[k] = vl[k];
      sy[k] = yl[k];
    }
    for (int k = threadIdx.x; k <= cap; k += kThreads) sb[k] = bl[k];
    __syncthreads();
    tl = st;
    cl = sc;
    vl = sv;
    yl = sy;
    bl = sb;
  }
  // Tiles past a short (k-rate) row have nothing to write.
  const int j = static_cast<int>(blockIdx.y) * kThreads + static_cast<int>(threadIdx.x);
  if (j >= S * npb) return;
  const int s = j / npb, i = j - s * npb;
  const double bt = block_times[s];
  const double off_t = __dmul_rn(static_cast<double>(i), dt);
  const double t = fma(static_cast<double>(i), dt, bt);  // as XLA fuses it

  int idx = 0;
  for (int k = 0; k < cap; ++k) idx += (t >= tl[k]) ? 1 : 0;
  idx = min(idx, n);
  const int prev = max(idx - 1, 0);
  const int nxt = min(idx, cap - 1);
  const bool has_prev = idx > 0, has_next = idx < n;

  auto rel = [&](int k) {
    double d = __dsub_rn(tl[k], bt);
    d = fmin(fmax(d, -3.0e38), 3.0e38);
    return static_cast<float>(d);
  };
  if (exact && npb == 1) {  // the whole curve in f64 (eval_intrinsic)
    const double t0 = tl[prev], t1 = tl[nxt];
    const double v0 = vl[prev], v1 = vl[nxt];
    const double t0s = isfinite(t0) ? t0 : 0.0;
    const double t1s = isfinite(t1) ? t1 : __dadd_rn(t0s, 1.0);
    const double denom = __dsub_rn(t1s, t0s);
    double u = __ddiv_rn(__dsub_rn(t, t0s), denom == 0.0 ? 1.0 : denom);
    u = u < 0.0 ? 0.0 : (u > 1.0 ? 1.0 : u);
    const double lin = fma(__dsub_rn(v1, v0), u, v0);
    double val;
    if (has_next && yl[nxt] == 1) {
      val = lin;
    } else if (has_next && yl[nxt] == 2) {
      val = (v0 > 0.0 && v1 > 0.0) ? __dmul_rn(v0, pow(__ddiv_rn(v1, v0), u)) : lin;
    } else if (yl[prev] == 3) {
      const double b = bl[idx];
      const double elapsed = __dsub_rn(t, t0s);
      const double tc = fmax(cl[prev], 0.001);
      val = elapsed <= 0.0
                ? b
                : fma(__dsub_rn(b, v0), exp(__ddiv_rn(-fmax(elapsed, 0.0), tc)), v0);
    } else {
      val = v0;
    }
    out[off + j] = (has_prev && n > 0) ? static_cast<float>(val) : base_r;
    return;
  }

  const float io = static_cast<float>(off_t);
  const float t0r = rel(prev), t1r = rel(nxt);
  const float v0 = vl[prev], v1 = vl[nxt];

  const float denom = __fsub_rn(t1r, t0r);
  const float safe_denom = denom == 0.0f ? 1.0f : denom;
  const float u = fminf(fmaxf(__fdiv_rn(__fsub_rn(io, t0r), safe_denom), 0.0f), 1.0f);
  float lin = fmaf(__fsub_rn(v1, v0), u, v0);
  if (exact) {  // the linear ramp in f64 absolute time, rounded once
    const double t0a = isfinite(tl[prev]) ? tl[prev] : 0.0;
    const double t1a = isfinite(tl[nxt]) ? tl[nxt] : 0.0;
    const double den = __dsub_rn(t1a, t0a);
    double u64 = __ddiv_rn(__dsub_rn(__dadd_rn(bt, off_t), t0a), den == 0.0 ? 1.0 : den);
    u64 = u64 < 0.0 ? 0.0 : (u64 > 1.0 ? 1.0 : u64);
    const double v0a = v0;
    lin = static_cast<float>(fma(__dsub_rn(static_cast<double>(v1), v0a), u64, v0a));
  }

  float val;
  if (has_next && yl[nxt] == 1) {  // EVT_LINEAR_RAMP
    val = lin;
  } else if (has_next && yl[nxt] == 2) {  // EVT_EXPONENTIAL_RAMP
    if (v0 > 0.0f && v1 > 0.0f) {
      const float ratio = __fdiv_rn(v1, v0);
      val = __fmul_rn(v0, static_cast<float>(pow(static_cast<double>(ratio),
                                                 static_cast<double>(u))));
    } else {
      val = lin;
    }
  } else if (yl[prev] == 3) {  // EVT_SET_TARGET
    const float b = bl[min(idx, cap)];
    const float elapsed = __fsub_rn(io, t0r);
    if (elapsed <= 0.0f) {
      val = b;
    } else {
      const float tc = fmaxf(static_cast<float>(cl[prev]), 0.001f);
      const float e = static_cast<float>(exp(static_cast<double>(__fdiv_rn(-elapsed, tc))));
      val = fmaf(__fsub_rn(b, v0), e, v0);
    }
  } else {
    val = v0;
  }
  if (!(has_prev && n > 0)) val = base_r;
  out[off + j] = val;
}

}  // namespace

// R rows of `cap` events, each (npb, arena offset, kind, clock row of
// `clocks` f64[C, S]); `max_len` is the longest row's S * npb. Grid: one
// block column per row, one block row per tile of kThreads samples.
GA_EXPORT int ga_param_eval_batch(const double* times, const float* values, const double* tcs,
                                  const int32_t* types, const float* boundary,
                                  const int32_t* nev, const float* base, const int32_t* rows,
                                  const double* clocks, int R, int cap, int S, int max_len,
                                  double dt, float* out, void* stream) {
  const dim3 grid(R, (max_len + kThreads - 1) / kThreads);
  param_eval_batch_kernel<<<grid, kThreads, stage_bytes(cap),
                            static_cast<cudaStream_t>(stream)>>>(
      times, values, tcs, types, boundary, nev, base, rows, clocks, cap, S, dt, out);
  return ga_launch_status();
}

// K6m: an AudioParam's modulation, added and clamped.
//
// Replaces graphaudio_tpu/ops/param_eval.py apply_modulation (:339) and its
// two inline uses in graphaudio_tpu/core/graph.py (:1163-1175, one stage;
// :1271-1297, a group): out = clamp(intrinsic + mono(mod), lo, hi), the
// hidden mono modulation input of AudioParam.cs:66-70. The intrinsic
// values are a row per lane (an arena row, or K6m's own earlier output) or,
// for a param without events, one base value per lane (the broadcast view
// is never copied). mod is the producer's [V, Cm, T]: a CHAIN route's group
// output, down-mixed here as adapt_channels does (the channels summed in
// order, times fl32(1/sqrt(Cm)), a multiply that XLA contracts with the add
// into one fma, and so does this kernel), or an explicit route's stacked
// mono sums (Cm = 1). A k-rate param (npb = 1, L = S) reads the modulation at sample
// 0 of each quantum (AudioParam.cs:150-156). The clamp is min(max(x, lo),
// hi) written as comparisons, so a NaN passes as torch.clamp passes it.
//
// Bound on the H100: memory (8 to 12 bytes a sample of a-rate output); at
// config 6's [64, 4096] that is under a microsecond of HBM time, so the
// launch dominates. One thread per output element.
namespace {

__global__ void apply_modulation_kernel(const float* __restrict__ intr, int intr_rows,
                                        const float* __restrict__ mod, int Cm, int T, int L,
                                        int npb, float scale, float lo, float hi,
                                        float* __restrict__ out) {
  const int v = blockIdx.y;
  const int j = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (j >= L) return;
  const int t = npb == 1 ? j * 128 : j;
  const float* m = mod + static_cast<int64_t>(v) * Cm * T + t;
  float sum = m[0];
  for (int c = 1; c < Cm; ++c) sum = __fadd_rn(sum, m[static_cast<int64_t>(c) * T]);
  const int64_t at = static_cast<int64_t>(v) * L + j;
  const float base = intr_rows ? intr[at] : intr[v];
  float x = Cm == 1 ? __fadd_rn(base, sum) : fmaf(sum, scale, base);
  x = x < lo ? lo : x;
  x = x > hi ? hi : x;
  out[at] = x;
}

}  // namespace

GA_EXPORT int ga_apply_modulation(const float* intr, int intr_rows, const float* mod, int V,
                                  int Cm, int T, int L, int npb, float scale, float lo, float hi,
                                  float* out, void* stream) {
  const dim3 grid((L + kThreads - 1) / kThreads, V);
  apply_modulation_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      intr, intr_rows, mod, Cm, T, L, npb, scale, lo, hi, out);
  return ga_launch_status();
}
