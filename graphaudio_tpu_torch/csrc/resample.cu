// K7: one whole step of a time-varying-rate voice group, in one launch.
//
// Replaces graphaudio_tpu/nodes/sources.py AudioBufferSourceNode
// ._process_resample (:783-900) as the JAX package runs it over a group
// (graphaudio_tpu/core/graph.py:1302-1340): each voice's f64 bookkeeping
// (active mask, duration end, loop wrap, window start, the per-quantum
// rates and their offsets, the consumed-position gates, the new x, primed
// and stop_time), ops/resample.py split_positions (:99-127) and the 4-tap
// Catmull-Rom interpolation. The TPU version fetches each voice's window by
// a row gather and a one-hot lane-shift matmul (_gather_windows_group,
// :1044-1071) and interpolates through a banded matmul over overlapping
// 64-sample tiles (:824-851); here every output reads its four taps
// straight from the arena through the read-only path. What the tiles
// decide is kept: a tap outside its quantum's tile has weight 0.
//
// Plain version: AudioBufferSourceNode.resample_group_step_plain
// (nodes/sources.py), which follows the reference op for op with XLA's
// roundings. The kernel follows the plain version: __dmul_rn / __dadd_rn
// for every f64 op but the multiply-adds XLA contracts (the sub-chunk
// anchors k*(16*rate) + ub, the consumed position 127*rate + xd: fma; the
// in-chunk offsets j*rate + a_frac and the Catmull-Rom weights: fmaf), the
// offsets as XLA's CPU cumsum sums them (inclusive runs of 16, plus the
// sequential sum of the runs before, minus the element), the new x as its
// sum (runs of 32 in order), torch's rules for remainder, rounding and
// casts (voice_group.cuh). Each output sums its taps as
// ((w0*a0 + w1*a1) + w2*a2) + w3*a3, as the plain version does.
//
// Grid (span, c, v): a block owns kSpan quanta of one channel of one voice,
// kPer consecutive outputs a thread. Every block recomputes its voice's
// plan: the S rates and offsets (a thread a quantum, a thread a run of 16
// for the prefix sums), then the gates of every quantum (first_stop needs
// them all) and the anchors of its own; only block (0, 0, v) writes the new
// state.
//
// Bound on the H100: memory. Config 4 pitched (V=64, C=1, S=64) writes 2.1
// MB of audio and reads about as much of the arena: ~1.3 us of HBM time.
#include "voice_group.cuh"

namespace {

using namespace voice_group;

// The group constants in the packed table's last row.
enum { kW, kCap, kTile, kNTiles, kSampleRate };
constexpr int kHop = 64;  // the reference's tile hop
constexpr int kRun = 16;  // XLA's CPU cumsum: runs of 16
constexpr int kSumRun = 32;  // XLA's CPU f64 sum: runs of 32

struct VoiceStates {  // the group's stacked [V] states, read only
  const int32_t* started;
  const double* start_time;
  const double* stop_time;
  const double* offset;
  const double* duration;
  const double* pos;
  const double* x;
  const int32_t* primed;
};

// The Catmull-Rom tap weights of fraction t, each multiply-add one fmaf as
// XLA contracts them (ops/resample.cr_weights_fma).
__device__ __forceinline__ void cr_weights(float t, float w[4]) {
  const float tt = __fmul_rn(t, t);
  w[0] = __fmul_rn(t, fmaf(t, fmaf(-0.5f, t, 1.0f), -0.5f));
  w[1] = fmaf(tt, fmaf(1.5f, t, -2.5f), 1.0f);
  w[2] = __fmul_rn(t, fmaf(t, fmaf(-1.5f, t, 2.0f), 0.5f));
  w[3] = __fmul_rn(tt, fmaf(0.5f, t, -0.5f));
}

__global__ void __launch_bounds__(kThreads) resample_step_kernel(
    const float* __restrict__ arena, int64_t W, int S, const double* __restrict__ gtab,
    VoiceStates st, const float* __restrict__ rates, int rate_rows,
    const double* __restrict__ bt, const double* __restrict__ bet, float* __restrict__ out,
    double* __restrict__ st_out, int32_t* __restrict__ primed_out) {
  const int span = blockIdx.x, c = blockIdx.y, v = blockIdx.z;
  const int C = gridDim.y, V = gridDim.z;
  const int tid = threadIdx.x;
  const double* g = gtab + static_cast<int64_t>(v) * kGeomCols;
  const double* k = gtab + static_cast<int64_t>(V) * kGeomCols;
  const int nruns = (S + kRun - 1) / kRun;

  extern __shared__ __align__(16) double smem[];
  double* adv_s = smem;            // [S] 128 * rate of an active quantum, else 0
  double* rate_s = adv_s + S;      // [S] the clamped f64 rates
  double* pre_s = rate_s + S;      // [S] inclusive sums within runs of 16
  double* carry_s = pre_s + S;     // [nruns] the runs before, summed in order
  __shared__ double ub_sp[kSpan];  // the span's block anchors in the window
  __shared__ double rate_sp[kSpan];
  __shared__ int64_t band_sp[kSpan];  // the first sample of each quantum's tile
  __shared__ uint8_t ok_sp[kSpan];
  __shared__ double warp_min[kWarps];

  // -- the voice's scalars, resample_group_step_plain's op order ------------
  const double length = g[kLength], rate = g[kRate], lsf = g[kLsf], lef = g[kLef];
  const double llen = g[kLlen];
  const bool looping = g[kLooping] != 0.0, loop_flag = g[kLoopFlag] != 0.0;
  const int64_t region_len = static_cast<int64_t>(g[kRegionLen]);
  const int64_t base = static_cast<int64_t>(g[kOff]) + static_cast<int64_t>(g[kFront]);
  const int64_t w = static_cast<int64_t>(k[kW]), tile = static_cast<int64_t>(k[kTile]);
  const int64_t n_tiles = static_cast<int64_t>(k[kNTiles]);
  const double cap = k[kCap];

  const bool started = st.started[v] > 0;
  const double start_time = st.start_time[v], stop_time = st.stop_time[v];
  const double p0 = st.pos[v];
  const double de = duration_end(st.offset[v], st.duration[v], rate, length);
  const double llen1 = llen < 1.0 ? 1.0 : llen;
  const double ratio = __ddiv_rn(rate, k[kSampleRate]);

  // The first output of a fresh voice lies at pos + 1 (the warmup).
  const double x0 = st.primed[v] > 0 ? st.x[v] : __dadd_rn(p0, 1.0);
  const double qmod = torch_remainder(__dsub_rn(x0, lsf), llen1);
  const double e0 = (looping && x0 >= lsf) ? __dadd_rn(__dadd_rn(lsf, llen), qmod) : x0;
  int64_t start = static_cast<int64_t>(floor(e0)) - 1;
  if (start < 0) start = 0;
  if (start > region_len - w) start = region_len - w;
  const int64_t win0 = base + start;
  const double e0s = __dsub_rn(e0, static_cast<double>(start));
  const int64_t shift = static_cast<int64_t>(rint(__dsub_rn(x0, e0))) + start;
  const int64_t de_i = static_cast<int64_t>(de);
  const int64_t lef_i = static_cast<int64_t>(lef);
  const int64_t end_bound = loop_flag ? (lef_i < de_i ? lef_i : de_i) : de_i;
  const double p4 = __dadd_rn(p0, 4.0);

  // -- the rates and the advance of each quantum ---------------------------
  int any_act = 0;
  for (int s = tid; s < S; s += kThreads) {
    const bool act = started && bet[s] > start_time && bt[s] < stop_time;
    const float r = rates[rate_rows ? static_cast<int64_t>(v) * S + s : v];
    double rb = __dmul_rn(ratio, static_cast<double>(r));
    rb = rb > cap ? cap : rb;  // NaN passes, as torch.clamp passes it
    rate_s[s] = rb;
    adv_s[s] = act ? __dmul_rn(128.0, rb) : 0.0;
    any_act |= act;
  }
  any_act = __syncthreads_or(any_act);
  // XLA's cumsum: inclusive runs of 16, then the runs before in order
  for (int r = tid; r < nruns; r += kThreads) {
    double acc = 0.0;
    for (int s = r * kRun; s < min(S, (r + 1) * kRun); ++s) {
      acc = s == r * kRun ? adv_s[s] : __dadd_rn(acc, adv_s[s]);
      pre_s[s] = acc;
    }
  }
  __syncthreads();
  if (tid == 0) {
    double carry = 0.0;
    for (int r = 0; r < nruns; ++r) {
      carry_s[r] = carry;
      carry = __dadd_rn(carry, pre_s[min(S, (r + 1) * kRun) - 1]);
    }
  }
  __syncthreads();

  // -- per quantum: offsets, gates, first_stop; the span's anchors ---------
  double first_stop = INFINITY;
  for (int s = tid; s < S; s += kThreads) {
    const bool act = started && bet[s] > start_time && bt[s] < stop_time;
    const double rb = rate_s[s];
    const double du = __dsub_rn(__dadd_rn(pre_s[s], carry_s[s / kRun]), adv_s[s]);
    const double ub = __dadd_rn(e0s, du);
    const double xd = __dadd_rn(x0, du);
    const double consumed_b = __dadd_rn(p4, floor(__dsub_rn(__dsub_rn(xd, p0), 1.0)));
    const bool blk_valid = looping || consumed_b < de;
    const double consumed_after =
        __dadd_rn(p4, floor(__dsub_rn(__dsub_rn(fma(127.0, rb, xd), p0), 1.0)));
    const bool cleared = act && !looping && consumed_after >= de;
    // the quantum's first sample; later ones lie no earlier
    const double a_int = floor(ub);
    const float a_frac = __double2float_rn(__dsub_rn(ub, a_int));
    const int64_t base0 = static_cast<int64_t>(a_int) + static_cast<int64_t>(floorf(a_frac));
    const bool any_valid = blk_valid && (looping || base0 + shift + 2 <= end_bound - 1);
    if (act && (!any_valid || cleared)) first_stop = fmin(first_stop, bet[s]);
    const int sl = s - span * kSpan;
    if (sl >= 0 && sl < kSpan) {
      int64_t m_b = floor_div<int64_t>(static_cast<int64_t>(a_int) - 1, kHop);
      m_b = m_b < 0 ? 0 : (m_b > n_tiles - 1 ? n_tiles - 1 : m_b);
      ub_sp[sl] = ub;
      rate_sp[sl] = rb;
      band_sp[sl] = m_b * kHop;
      ok_sp[sl] = act && blk_valid && !cleared;
    }
  }

  if (span == 0 && c == 0) {
    const double fs = block_min(first_stop, warp_min);
    if (tid == 0) {
      // XLA's f64 sum of the advances: runs of 32, the runs in order
      double total = 0.0;
      for (int r0 = 0; r0 < S; r0 += kSumRun) {
        double acc = adv_s[r0];
        for (int s = r0 + 1; s < min(S, r0 + kSumRun); ++s) acc = __dadd_rn(acc, adv_s[s]);
        total = r0 == 0 ? acc : __dadd_rn(total, acc);
      }
      double new_x = __dadd_rn(x0, total);
      if (looping && new_x >= lef)
        new_x = __dadd_rn(lsf, torch_remainder(__dsub_rn(new_x, lef), llen1));
      st_out[v] = new_x;
      st_out[V + v] = min_nan(stop_time, fs);
      primed_out[v] = any_act ? 1 : st.primed[v];
    }
  }
  __syncthreads();

  // -- the span's outputs: kPer consecutive samples of one quantum a thread --
  const int o0 = tid * kPer;
  const int sl = o0 >> 7;
  const int s = span * kSpan + sl;
  if (s >= S) return;
  const int i0 = o0 & 127;
  float y[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) y[u] = 0.0f;
  if (ok_sp[sl]) {
    const double rb = rate_sp[sl];
    const float rf = __double2float_rn(rb);
    // the sub-chunk's f64 anchor (kPer outputs never straddle one)
    const double anchor =
        fma(static_cast<double>(i0 / 16), __dmul_rn(16.0, rb), ub_sp[sl]);
    const double a_int = floor(anchor);
    const float a_frac = __double2float_rn(__dsub_rn(anchor, a_int));
    const int64_t band = band_sp[sl];
    const float* a_c = arena + static_cast<int64_t>(c) * W + win0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const float local = fmaf(static_cast<float>((i0 & 15) + u), rf, a_frac);
      const float bl = floorf(local);
      const float frac = __fsub_rn(local, bl);
      const int64_t base_l = static_cast<int64_t>(a_int) + static_cast<int64_t>(bl);
      if (!(looping || base_l + shift + 2 <= end_bound - 1)) continue;
      float wk[4];
      cr_weights(frac, wk);
      const int64_t row = base_l - band;
      float term[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t at = row + q - 1;
        term[q] = (at >= 0 && at < tile) ? __fmul_rn(wk[q], __ldg(a_c + base_l + q - 1)) : 0.0f;
      }
      y[u] = __fadd_rn(__fadd_rn(__fadd_rn(term[0], term[1]), term[2]), term[3]);
    }
  }
  const int64_t T = static_cast<int64_t>(S) * 128;
  *reinterpret_cast<float4*>(out + (static_cast<int64_t>(v) * C + c) * T + o0 +
                             static_cast<int64_t>(span) * kSpan * 128) =
      make_float4(y[0], y[1], y[2], y[3]);
}

}  // namespace

GA_EXPORT int ga_resample_group_step(const float* arena, int64_t W, int C, int V, int S,
                                     const double* gtab, const int32_t* started,
                                     const double* start_time, const double* stop_time,
                                     const double* offset, const double* duration,
                                     const double* pos, const double* x, const int32_t* primed,
                                     const float* rates, int rate_rows, const double* bt,
                                     const double* bet, float* out, double* st_out,
                                     int32_t* primed_out, void* stream) {
  const VoiceStates st{started, start_time, stop_time, offset, duration, pos, x, primed};
  const dim3 grid((S + kSpan - 1) / kSpan, C, V);
  const size_t smem = (3 * static_cast<size_t>(S) + (S + kRun - 1) / kRun) * sizeof(double);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  resample_step_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      arena, W, S, gtab, st, rates, rate_rows, bt, bet, out, st_out, primed_out);
  return ga_launch_status();
}
