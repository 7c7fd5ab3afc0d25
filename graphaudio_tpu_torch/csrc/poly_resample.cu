// K1: one whole step of a static-ratio polyphase voice group, in one launch.
//
// Replaces graphaudio_tpu/nodes/sources.py AudioBufferSourceNode
// .process_poly_group (:1212-1347): the voices' f64 bookkeeping (active
// mask, duration end, loop wrap, window start, block placement, validity
// gates, the new x, primed and stop_time), the window fetch by row gather
// plus one-hot lane shift (_gather_windows_group, :1044), the slab matmul
// against ops/resample.poly_matrix (:1256-1269) and the one-hot j0 column
// rotation (:1271-1281).
//
// Plain version: nodes/sources.AudioBufferSourceNode.poly_group_plan then
// ops/resample.poly_resample_plain. The kernel is bit-identical to it: every
// f64 expression is the plan's torch op sequence, one rounding an op
// (__dmul_rn / __dadd_rn, so nvcc contracts nothing into an fma), with
// torch's rules: rint for torch.round (half to even), torch.remainder as
// fmod plus the divisor when the signs differ, floor division for
// rounding_mode="floor", truncation for f64 -> integer casts. Each output
// sums its four taps as ((w0*a0 + w1*a1) + w2*a2) + w3*a3, as the plain
// version's loop does.
//
// Grid (span, c, v): a block owns kSpan quanta of one channel of one voice,
// kPer consecutive outputs a thread. Every block recomputes its voice's
// plan (a few dozen f64 ops a thread, redundantly, plus one op a quantum
// per thread s < S); the block placement bidx is an exclusive count of the
// active quanta (warp ballots); first_stop is a min over the starved
// quanta, exact in any order. Only block (0, 0, v) writes the new state.
// Each thread walks its outputs' phase r incrementally (no division an
// output). The phase table (20 bytes a phase) and the taps are read through
// L1: neighbouring outputs share them, and a table of any q fits.
//
// Bound on the H100: memory and launch. Config 4 (V=64, C=1, S=64) writes
// 2 MB of audio and reads ~1.9 MB of arena windows; ~1.2 us of HBM time.
#include "voice_group.cuh"

namespace {

using namespace voice_group;

// The group constants in the packed table's last row.
enum { kP, kQ, kPinv, kW, kInvQ, kBlkPQ, kC127, kInvP };

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

__global__ void __launch_bounds__(kThreads) poly_step_kernel(
    const float* __restrict__ arena, int64_t W, int S, const double* __restrict__ gtab,
    VoiceStates st, const double* __restrict__ bt, const double* __restrict__ bet,
    const float* __restrict__ wtab, const int32_t* __restrict__ btab,
    float* __restrict__ out, double* __restrict__ st_out, int32_t* __restrict__ primed_out) {
  const int span = blockIdx.x, c = blockIdx.y, v = blockIdx.z;
  const int C = gridDim.y, V = gridDim.z;
  const int tid = threadIdx.x;
  const double* g = gtab + static_cast<int64_t>(v) * kGeomCols;
  const double* k = gtab + static_cast<int64_t>(V) * kGeomCols;
  const int p = static_cast<int>(k[kP]), q = static_cast<int>(k[kQ]);

  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* bidx_s = reinterpret_cast<int32_t*>(smem);          // [S]
  uint8_t* ok_s = reinterpret_cast<uint8_t*>(bidx_s + S);      // [S]
  __shared__ int32_t warp_tot[kWarps];
  __shared__ double warp_min[kWarps];

  // -- the voice's scalars, poly_group_plan's op order (every thread) -------
  const double length = g[kLength], rate = g[kRate], lsf = g[kLsf], lef = g[kLef];
  const double llen = g[kLlen];
  const bool looping = g[kLooping] != 0.0, loop_flag = g[kLoopFlag] != 0.0;
  const int64_t region_len = static_cast<int64_t>(g[kRegionLen]);
  const int64_t base = static_cast<int64_t>(g[kOff]) + static_cast<int64_t>(g[kFront]);
  const double inv_q = k[kInvQ], blk_pq = k[kBlkPQ], c127 = k[kC127], inv_p = k[kInvP];
  const int64_t pinv = static_cast<int64_t>(k[kPinv]), w = static_cast<int64_t>(k[kW]);
  const double qd = static_cast<double>(q);

  const bool started = st.started[v] > 0;
  const double start_time = st.start_time[v], stop_time = st.stop_time[v];
  const double p0 = st.pos[v];
  const double de = duration_end(st.offset[v], st.duration[v], rate, length);
  const double llen1 = llen < 1.0 ? 1.0 : llen;

  double x0 = st.primed[v] > 0 ? st.x[v] : __dadd_rn(p0, 1.0);
  x0 = __dmul_rn(rint(__dmul_rn(x0, qd)), inv_q);
  const double qmod = torch_remainder(__dsub_rn(x0, lsf), llen1);
  const double e0 = (looping && x0 >= lsf) ? __dadd_rn(__dadd_rn(lsf, llen), qmod) : x0;
  const double ef = floor(e0);
  int64_t A0 = static_cast<int64_t>(ef);
  int64_t r0 = static_cast<int64_t>(rint(__dmul_rn(__dsub_rn(e0, ef), qd)));
  A0 += (r0 == q);
  if (r0 == q) r0 = 0;
  const int64_t j0 = (r0 * pinv) % q;
  const int64_t m0 = floor_div<int64_t>(j0 * p - r0, q);
  int64_t start = A0 - m0 - 1;
  if (start < -(p + 8)) start = -(p + 8);
  if (start > region_len - w) start = region_len - w;
  const int64_t win_start = base + start;

  const int64_t de_i = static_cast<int64_t>(de);
  const int64_t lef_i = static_cast<int64_t>(lef);
  const int64_t end_bound = loop_flag ? (lef_i < de_i ? lef_i : de_i) : de_i;
  const double x0q = rint(__dmul_rn(x0, qd));
  const double num =
      __dsub_rn(__dmul_rn(__dsub_rn(static_cast<double>(end_bound), 2.0), qd), x0q);
  const float jlim =
      __double2float_rn(floor(__dmul_rn(__dadd_rn(num, static_cast<double>(p - 1)), inv_p)));

  // -- per quantum: placement and gates (thread s, in chunks of kThreads) ---
  int carry = 0;  // active quanta before the chunk, then in all
  double first_stop = INFINITY;
  for (int s0 = 0; s0 < S; s0 += kThreads) {
    const int s = s0 + tid;
    const bool act = s < S && started && bet[s] > start_time && bt[s] < stop_time;
    const int before = count_active_before(act, carry, warp_tot);
    if (s < S) {
      const int bidx = before < 0 ? 0 : (before > S - 1 ? S - 1 : before);
      const double x_b = __dadd_rn(x0, __dmul_rn(static_cast<double>(bidx), blk_pq));
      const double consumed_b =
          __dadd_rn(__dadd_rn(p0, 4.0), floor(__dsub_rn(__dsub_rn(x_b, p0), 1.0)));
      const bool blk_valid = looping || consumed_b < de;
      const double consumed_after = __dadd_rn(
          __dadd_rn(p0, 4.0), floor(__dsub_rn(__dsub_rn(__dadd_rn(x_b, c127), p0), 1.0)));
      const bool cleared = act && !looping && consumed_after >= de;
      const bool first_ok =
          looping || static_cast<float>(static_cast<int64_t>(bidx) * 128) < jlim;
      const bool starved = act && (!(blk_valid && first_ok) || cleared);
      bidx_s[s] = bidx;
      ok_s[s] = act && blk_valid && !cleared;
      if (starved) first_stop = fmin(first_stop, bet[s]);
    }
  }

  if (span == 0 && c == 0) {
    const double fs = block_min(first_stop, warp_min);
    if (tid == 0) {
      // Exact advance: n_active*128*p is an exact f64 integer; one rounding
      // at the /q, then the grid snap.
      const double n_active = static_cast<double>(carry);
      double new_x = __dadd_rn(x0, __dmul_rn(__dmul_rn(n_active, static_cast<double>(128 * p)),
                                             inv_q));
      if (looping && new_x >= lef)
        new_x = __dadd_rn(lsf, torch_remainder(__dsub_rn(new_x, lef), llen1));
      new_x = __dmul_rn(rint(__dmul_rn(new_x, qd)), inv_q);
      st_out[v] = new_x;
      st_out[V + v] = min_nan(stop_time, fs);
      primed_out[v] = carry > 0 ? 1 : st.primed[v];
    }
  }
  __syncthreads();

  // -- the span's outputs: kPer consecutive samples of one quantum a thread --
  const int o0 = tid * kPer;
  const int s = span * kSpan + (o0 >> 7);
  if (s >= S) return;
  const int i0 = o0 & 127;
  float y[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) y[u] = 0.0f;
  if (ok_s[s]) {
    const int64_t jpos0 = static_cast<int64_t>(bidx_s[s]) * 128 + i0;
    const int64_t kk = j0 + jpos0;
    int64_t n = kk / q;
    int r = static_cast<int>(kk - n * q);
    const float* a_c = arena + static_cast<int64_t>(c) * W + win_start;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (looping || static_cast<float>(jpos0 + u) < jlim) {
        const float4 wr = __ldg(reinterpret_cast<const float4*>(wtab) + r);
        const int32_t br = __ldg(btab + r);
        const float* a = a_c + n * p + br;
        const float a0 = __ldg(a), a1 = __ldg(a + 1), a2 = __ldg(a + 2), a3 = __ldg(a + 3);
        y[u] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(wr.x, a0), __fmul_rn(wr.y, a1)),
                                   __fmul_rn(wr.z, a2)),
                         __fmul_rn(wr.w, a3));
      }
      if (++r == q) {
        r = 0;
        ++n;
      }
    }
  }
  const int64_t T = static_cast<int64_t>(S) * 128;
  *reinterpret_cast<float4*>(out + (static_cast<int64_t>(v) * C + c) * T + o0 +
                             static_cast<int64_t>(span) * kSpan * 128) =
      make_float4(y[0], y[1], y[2], y[3]);
}

}  // namespace

GA_EXPORT int ga_poly_group_step(const float* arena, int64_t W, int C, int V, int S,
                                 const double* gtab, const int32_t* started,
                                 const double* start_time, const double* stop_time,
                                 const double* offset, const double* duration,
                                 const double* pos, const double* x, const int32_t* primed,
                                 const double* bt, const double* bet, const float* wtab,
                                 const int32_t* btab, float* out, double* st_out,
                                 int32_t* primed_out, void* stream) {
  const VoiceStates st{started, start_time, stop_time, offset, duration, pos, x, primed};
  const dim3 grid((S + kSpan - 1) / kSpan, C, V);
  const size_t smem = static_cast<size_t>(S) * 5;  // bidx_s and ok_s
  poly_step_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      arena, W, S, gtab, st, bt, bet, wtab, btab, out, st_out, primed_out);
  return ga_launch_status();
}
