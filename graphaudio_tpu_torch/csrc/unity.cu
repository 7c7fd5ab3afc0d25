// K5: one whole step of a unity-rate voice group, in one launch.
//
// Replaces graphaudio_tpu/nodes/sources.py AudioBufferSourceNode
// .process_unity_group (:1104-1209): the voices' f64 bookkeeping (active
// mask, block positions, loop wrap, window row and lane offset, the
// duration and end-of-buffer gates, the new pos and stop_time), the
// aligned 128-row gather (:1147-1163) and the unaligned row-gather pair
// plus one-hot lane-shift matmuls of _gather_blocks_group (:1073-1101).
//
// Plain version: nodes/sources.AudioBufferSourceNode.unity_group_plan then
// ops/unity.unity_gather_plain. The kernel is bit-identical to it: the f64
// expressions follow the plan's torch op sequence one rounding an op, with
// torch's rules (torch.remainder as fmod plus the divisor when the signs
// differ, floor division, truncating casts); the audio is a masked copy.
//
// Grid (span, c, v): a block owns kSpan quanta of one channel of one voice,
// kPer consecutive samples a thread. Every block recomputes its voice's
// plan with the prologue it shares with K1 (voice_group.cuh: an exclusive
// count of the active quanta by warp ballots, a min over the cleared
// quanta); only block (0, 0, v) writes the new pos and stop_time.
//
// Bound on the H100: memory and launch. Config 5 (V=128, C=1, S=32) copies
// 2 MB out of the arena; config 3 (V=1, C=2) 32 KB, so its launch dominates.
#include "voice_group.cuh"

namespace {

using namespace voice_group;

// The group constants in the packed table's last row.
enum { kW, kAligned };

struct VoiceStates {  // the group's stacked [V] states, read only
  const int32_t* started;
  const double* start_time;
  const double* stop_time;
  const double* offset;
  const double* duration;
  const double* pos;
};

__global__ void __launch_bounds__(kThreads) unity_step_kernel(
    const float* __restrict__ arena, int64_t W, int S, const double* __restrict__ gtab,
    VoiceStates st, const double* __restrict__ bt, const double* __restrict__ bet,
    float* __restrict__ out, double* __restrict__ st_out) {
  const int span = blockIdx.x, c = blockIdx.y, v = blockIdx.z;
  const int C = gridDim.y, V = gridDim.z;
  const int tid = threadIdx.x;
  const double* g = gtab + static_cast<int64_t>(v) * kGeomCols;
  const double* k = gtab + static_cast<int64_t>(V) * kGeomCols;

  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* bidx_s = reinterpret_cast<int32_t*>(smem);  // [S]
  int32_t* g0_s = bidx_s + S;                           // [S]
  uint8_t* ok_s = reinterpret_cast<uint8_t*>(g0_s + S); // [S]
  __shared__ int32_t warp_tot[kWarps];
  __shared__ double warp_min[kWarps];

  // -- the voice's scalars, unity_group_plan's op order (every thread) ------
  const double length = g[kLength], rate = g[kRate], lsf = g[kLsf], lef = g[kLef];
  const double llen = g[kLlen];
  const bool looping = g[kLooping] != 0.0, loop_flag = g[kLoopFlag] != 0.0;
  const int32_t region_len = static_cast<int32_t>(g[kRegionLen]);
  const int32_t base = static_cast<int32_t>(g[kOff]) + static_cast<int32_t>(g[kFront]);
  const int32_t w = static_cast<int32_t>(k[kW]);
  const bool aligned = k[kAligned] != 0.0;

  const bool started = st.started[v] > 0;
  const double start_time = st.start_time[v], stop_time = st.stop_time[v];
  const double p0 = st.pos[v];
  const double de = duration_end(st.offset[v], st.duration[v], rate, length);
  const double llen1 = llen < 1.0 ? 1.0 : llen;

  const double qmod = torch_remainder(__dsub_rn(p0, lsf), llen1);
  const int32_t e0 = static_cast<int32_t>(
      (looping && p0 >= lsf) ? __dadd_rn(__dadd_rn(lsf, llen), qmod) : p0);
  const int32_t e0c = e0 < 0 ? 0 : e0;
  int64_t row0;
  int32_t delta;
  if (aligned) {
    // Positions and arena offsets are multiples of 128; the end-clip is
    // floored so the start stays aligned.
    const int32_t hi = floor_div<int32_t>(region_len - w, 128) * 128;
    row0 = floor_div<int32_t>(base + (e0c < hi ? e0c : hi), 128);
    delta = 0;
  } else {
    const int32_t abs_start = base + (e0c < region_len - w ? e0c : region_len - w);
    const int32_t r = floor_div<int32_t>(abs_start, 128);
    row0 = r;
    delta = abs_start - r * 128;
  }
  const int32_t p0_i = static_cast<int32_t>(p0);
  const int32_t de_i = static_cast<int32_t>(de);
  const int32_t lef_i = static_cast<int32_t>(lef);
  const int32_t end_bound = loop_flag ? (lef_i < de_i ? lef_i : de_i) : de_i;

  // -- per quantum: positions, placement, gates (thread s, chunks) ---------
  int carry = 0;  // active quanta before the chunk, then in all
  double first_stop = INFINITY;
  for (int s0 = 0; s0 < S; s0 += kThreads) {
    const int s = s0 + tid;
    const bool act = s < S && started && bet[s] > start_time && bt[s] < stop_time;
    const int before = count_active_before(act, carry, warp_tot);
    if (s < S) {
      // pos_b = p0 + (cumsum(adv) - adv): the sum is 128 x (active quanta
      // before s), exact; the one rounding is the add.
      const double pos_b = __dadd_rn(p0, 128.0 * static_cast<double>(before));
      const int32_t delta_b = static_cast<int32_t>(__dsub_rn(pos_b, p0));
      const int32_t b = floor_div<int32_t>(delta_b, 128);
      const int32_t g0 = p0_i + delta_b;
      const bool any_valid = looping || g0 < end_bound;
      const double pos_after = __dadd_rn(pos_b, 128.0);
      const bool cleared = act && (looping ? !any_valid : (pos_after >= de || !any_valid));
      bidx_s[s] = b < 0 ? 0 : (b > S - 1 ? S - 1 : b);
      g0_s[s] = g0;
      ok_s[s] = act && !cleared;
      if (cleared) first_stop = fmin(first_stop, bet[s]);
    }
  }

  if (span == 0 && c == 0) {
    const double fs = block_min(first_stop, warp_min);
    if (tid == 0) {
      double new_pos = __dadd_rn(p0, 128.0 * static_cast<double>(carry));
      if (looping && new_pos >= lef)
        new_pos = __dadd_rn(lsf, torch_remainder(__dsub_rn(new_pos, lef), llen1));
      st_out[v] = new_pos;
      st_out[V + v] = min_nan(stop_time, fs);
    }
  }
  __syncthreads();

  // -- the span's samples: kPer consecutive samples of one quantum a thread --
  const int o0 = tid * kPer;
  const int s = span * kSpan + (o0 >> 7);
  if (s >= S) return;
  const int i0 = o0 & 127;
  float y[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) y[u] = 0.0f;
  if (ok_s[s]) {
    const int64_t nrows = W / 128;
    int64_t lo = row0 + bidx_s[s];
    lo = lo < 0 ? 0 : (lo > nrows - 1 ? nrows - 1 : lo);
    const int64_t hi = lo + 1 > nrows - 1 ? nrows - 1 : lo + 1;
    const float* a_c = arena + static_cast<int64_t>(c) * W;
    const int64_t g0 = g0_s[s];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = i0 + u;
      if (looping || g0 + i < end_bound) {
        const int j = delta + i;
        y[u] = __ldg(a_c + (j < 128 ? lo * 128 + j : hi * 128 + j - 128));
      }
    }
  }
  const int64_t T = static_cast<int64_t>(S) * 128;
  *reinterpret_cast<float4*>(out + (static_cast<int64_t>(v) * C + c) * T + o0 +
                             static_cast<int64_t>(span) * kSpan * 128) =
      make_float4(y[0], y[1], y[2], y[3]);
}

}  // namespace

GA_EXPORT int ga_unity_group_step(const float* arena, int64_t W, int C, int V, int S,
                                  const double* gtab, const int32_t* started,
                                  const double* start_time, const double* stop_time,
                                  const double* offset, const double* duration,
                                  const double* pos, const double* bt, const double* bet,
                                  float* out, double* st_out, void* stream) {
  const VoiceStates st{started, start_time, stop_time, offset, duration, pos};
  const dim3 grid((S + kSpan - 1) / kSpan, C, V);
  const size_t smem = static_cast<size_t>(S) * 9;
  unity_step_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      arena, W, S, gtab, st, bt, bet, out, st_out);
  return ga_launch_status();
}
