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
// ((w0*a0 + w1*a1) + w2*a2) + w3*a3, as the plain version does. The
// voice's rate / sample_rate is the table's own column (kRatio, divided
// once on the host, correctly rounded as the plain version's torch
// division is).
//
// Grid (span, c, v): a block owns kSpan quanta of one channel of one voice,
// a warp a quantum, lane i its outputs i, i + 32, i + 64 and i + 96, so
// neighbouring lanes read neighbouring taps and store whole lines. The grid
// is one wave at the main path's shapes, so a step takes one block's
// latency chain; the design keeps that chain short:
// - warp 0 plans the quanta up to the block's span. At entry it issues its
//   loads: the scalars the advances need, and the quanta's clocks and
//   rates (cp.async into shared memory, padded so that lane r's run of 16
//   meets no bank twice). A lane a quantum takes the rates and advances;
//   lane r sums run r of 16 in order, a burst of loads before its adds;
//   the runs' carries are a shuffle chain in run order (passes of 32 runs);
//   lanes 0-7 then take the span's quanta (anchors, bands, gates), and
//   lane 0 asks the L2 for the window samples the span's taps can touch
//   (cp.async.bulk.prefetch.L2: one instruction, nothing to wait on), so
//   the taps' cold read from HBM starts before the block barrier;
// - warp 1 meanwhile loads the voice's table row and states and computes
//   its scalars (the duration end, the loop's fmod, the window), handed to
//   warp 0 through a named barrier; rate / sample_rate is a table column;
// - one block barrier publishes the span. Each lane computes one
//   sub-chunk's f64 anchor and the warp shares them by shuffles; window
//   bases are int32 (as the plain version's); a tap that does not count
//   takes weight +0 and value +0, so no predicate outlives the loads, and
//   every tap's load is issued before any is used;
// - block (0, 0, v) plans every quantum, and its warps 1-7 take the new
//   state's sums while warp 0 plans the span: every quantum's gates a
//   thread a quantum, first_stop by warp mins; warp 1's lane q sums run q
//   of 32 from the run sum of its first 16, the runs combined in order.
//   Thread 0 writes the state while its taps are in flight.
// The prefetch, timed with and without in one call (H100 80GB HBM3, 700 W):
// warm, alone, within 0.05 us either way; cold (the arena out of L2) 0.4
// us faster at config4_pitched's step and 0.25 at the vibrato's launch; in
// the vibrato's render 1.2-2.0 us a step faster over its 8 launches.
//
// Bound on the H100: memory. Config 4 pitched (V=64, C=1, S=64) writes 2.1
// MB of audio and reads about as much of the arena: ~1.2 us of HBM time.
#include <climits>

#include "voice_group.cuh"

namespace {

using namespace voice_group;

// The group constants in the packed table's last row.
enum { kW, kCap, kTile, kNTiles, kSampleRate };
// K7's own column of the table: the voice's rate / sample_rate.
constexpr int kRatio = kGeomCols;
constexpr int kCols = kGeomCols + 1;
constexpr int kHop = 64;  // the reference's tile hop
constexpr int kRun = 16;  // XLA's CPU cumsum: runs of 16
constexpr int kSumRun = 32;  // XLA's CPU f64 sum: runs of 32
constexpr int kBurst = 4;  // shared-memory loads issued together before a chain of adds
constexpr double kPrefetchMax = 16384.0;  // a quantum's tap range the L2 is asked for, at most
constexpr unsigned kFull = 0xffffffffu;

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

// The voice's scalars in shared memory: warp 0 writes those the advances
// read, warp 1 the rest.
struct Plan {
  double x0, p0, p4, e0s, de, start_time, stop_time, lsf, lef, llen1, ratio, cap;
  int64_t win0, shift, end_bound, tile, n_tiles;
  int started, looping, any_act, primed;
  int lim;  // an output plays while its base <= lim (the window's int32 bases)
};

// The span's quanta, published by warp 0.
struct Span {
  double ub[kSpan];  // block anchors in the window
  double rate[kSpan];
  int64_t band[kSpan];  // the first sample of each quantum's tile
  uint8_t ok[kSpan];
};

// Quantum s's slot in the padded arrays: s + s/16, so lane r's run of 16
// starts 17 slots after lane r-1's and no two lanes meet in a bank.
__host__ __device__ __forceinline__ int pad(int s) { return s + (s >> 4); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Asks the L2 for row[a, b), cut to [0, W) and to the 16-byte words inside
// it (the bulk prefetch's alignment); a hint, with no completion.
__device__ __forceinline__ void prefetch_l2(const float* row, int64_t a, int64_t b, int64_t W) {
  a = a < 0 ? 0 : (a > W ? W : a);
  b = b < 0 ? 0 : (b > W ? W : b);
  const uintptr_t pa = (reinterpret_cast<uintptr_t>(row + a) + 15) & ~uintptr_t(15);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(row + b) & ~uintptr_t(15);
  if (pa < pb)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(pa),
                 "r"(static_cast<uint32_t>(pb - pa))
                 : "memory");
}

// The Catmull-Rom tap weights of fraction t, each multiply-add one fmaf as
// XLA contracts them (ops/resample.cr_weights_fma).
__device__ __forceinline__ void cr_weights(float t, float w[4]) {
  const float tt = __fmul_rn(t, t);
  w[0] = __fmul_rn(t, fmaf(t, fmaf(-0.5f, t, 1.0f), -0.5f));
  w[1] = fmaf(tt, fmaf(1.5f, t, -2.5f), 1.0f);
  w[2] = __fmul_rn(t, fmaf(t, fmaf(-1.5f, t, 2.0f), 0.5f));
  w[3] = __fmul_rn(tt, fmaf(0.5f, t, -0.5f));
}

// Quantum s's plan from the staged inputs and the run sums:
// resample_group_step_plain's op order.
struct Quantum {
  double ub, rb, a_int;
  bool act, ok, starved;
};

__device__ __forceinline__ Quantum plan_quantum(int s, const Plan& p, const double* bt_s,
                                                const double* bet_s, const float* rate_in,
                                                int rate_rows, const double* adv_s,
                                                const double* pre_s, const double* carry_s) {
  Quantum q;
  q.act = p.started && bet_s[pad(s)] > p.start_time && bt_s[pad(s)] < p.stop_time;
  q.rb = __dmul_rn(p.ratio, static_cast<double>(rate_in[rate_rows ? pad(s) : 0]));
  q.rb = q.rb > p.cap ? p.cap : q.rb;  // NaN passes, as torch.clamp passes it
  const double du = __dsub_rn(__dadd_rn(pre_s[pad(s)], carry_s[s / kRun]), adv_s[pad(s)]);
  q.ub = __dadd_rn(p.e0s, du);
  const double xd = __dadd_rn(p.x0, du);
  const double consumed_b = __dadd_rn(p.p4, floor(__dsub_rn(__dsub_rn(xd, p.p0), 1.0)));
  const bool blk_valid = p.looping || consumed_b < p.de;
  const double consumed_after =
      __dadd_rn(p.p4, floor(__dsub_rn(__dsub_rn(fma(127.0, q.rb, xd), p.p0), 1.0)));
  const bool cleared = q.act && !p.looping && consumed_after >= p.de;
  // the quantum's first sample; later ones lie no earlier
  q.a_int = floor(q.ub);
  const float a_frac = __double2float_rn(__dsub_rn(q.ub, q.a_int));
  const int64_t base0 = static_cast<int64_t>(q.a_int) + static_cast<int64_t>(floorf(a_frac));
  const bool any_valid = blk_valid && (p.looping || base0 + p.shift + 2 <= p.end_bound - 1);
  q.ok = q.act && blk_valid && !cleared;
  q.starved = q.act && (!any_valid || cleared);
  return q;
}

// Block (0, 0, v)'s warps 1-7, while warp 0 plans the span: each a
// quantum's gates at a time for first_stop (its warp's min into warp_min),
// and in warp 1 the new x's sum (XLA's f64 sum of the advances: lane q sums
// run q of 32 in order, the runs combined in order) into *total.
__device__ __forceinline__ void state_sums(int S, const Plan& p, const double* bt_s,
                                           const double* bet_s, const float* rate_in,
                                           int rate_rows, const double* adv_s,
                                           const double* pre_s, const double* carry_s,
                                           double* warp_min, double* total_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double fs = INFINITY;
  for (int s = threadIdx.x - 32; s < S; s += kThreads - 32) {
    const Quantum q = plan_quantum(s, p, bt_s, bet_s, rate_in, rate_rows, adv_s, pre_s, carry_s);
    if (q.starved) fs = fmin(fs, bet_s[pad(s)]);
  }
  for (int o = 16; o > 0; o >>= 1) fs = fmin(fs, __shfl_xor_sync(kFull, fs, o));
  if (lane == 0) warp_min[warp] = fs;
  if (warp != 1) return;
  const int nsum = (S + kSumRun - 1) / kSumRun;
  double total = 0.0;
  for (int q0 = 0; q0 < nsum; q0 += 32) {
    const int q = q0 + lane;
    double acc = 0.0;
    if (q < nsum) {
      // its first 16 summed in order are the run sum of 16 the plan keeps
      const int s0 = q * kSumRun, s1 = min(S, s0 + kSumRun), mid = min(s1, s0 + kRun);
      acc = pre_s[pad(mid - 1)];
#pragma unroll
      for (int j0 = 0; j0 < kRun; j0 += kBurst) {
        double a[kBurst];
#pragma unroll
        for (int j = 0; j < kBurst; ++j)
          a[j] = mid + j0 + j < s1 ? adv_s[pad(mid + j0 + j)] : 0.0;
#pragma unroll
        for (int j = 0; j < kBurst; ++j)
          if (mid + j0 + j < s1) acc = __dadd_rn(acc, a[j]);
      }
    }
    const int n = min(32, nsum - q0);
    for (int j = 0; j < n; ++j) {
      const double t = __shfl_sync(kFull, acc, j);
      total = q0 + j == 0 ? t : __dadd_rn(total, t);
    }
  }
  if (lane == 0) *total_s = total;
}

// 4 blocks an SM (<= 64 registers): config4_pitched's 512 blocks in one wave
__global__ void __launch_bounds__(kThreads, 4) resample_step_kernel(
    const float* __restrict__ arena, int64_t W, int S, const double* __restrict__ gtab,
    VoiceStates st, const float* __restrict__ rates, int rate_rows,
    const double* __restrict__ bt, const double* __restrict__ bet, float* __restrict__ out,
    double* __restrict__ st_out, int32_t* __restrict__ primed_out) {
  const int span = blockIdx.x, c = blockIdx.y, v = blockIdx.z;
  const int C = gridDim.y, V = gridDim.z;
  const int tid = threadIdx.x;
  const bool head = span == 0 && c == 0;  // the block that writes the state
  // the quanta whose advances the block's span needs: all of them for the head
  const int P = head ? S : min(S, (span + 1) * kSpan);
  const int nruns = (P + kRun - 1) / kRun;

  extern __shared__ __align__(16) double smem[];
  double* bt_s = smem;                // [pad(S)] the staged clocks
  double* bet_s = bt_s + pad(S);      // [pad(S)]
  double* adv_s = bet_s + pad(S);     // [pad(S)] 128 * rate of an active quantum, else 0
  double* pre_s = adv_s + pad(S);     // [pad(S)] inclusive sums within runs of 16
  double* carry_s = pre_s + pad(S);   // [runs] the runs before, summed in order
  float* rate_in = reinterpret_cast<float*>(carry_s + (S + kRun - 1) / kRun);  // [pad(S)] or [1]
  __shared__ Plan plan;
  __shared__ Span sp;
  __shared__ double warp_min[kWarps], total_s;  // block (0, 0, v)'s state sums

  if (tid < 32) {
    // -- warp 0: every input load at entry (the scalars it reads, the quanta's
    //    clocks and rates staged into shared memory), then the plan ----------
    const int lane = tid;
    const double ratio = gtab[static_cast<int64_t>(v) * kCols + kRatio];
    const double cap = gtab[static_cast<int64_t>(V) * kCols + kCap];
    const bool started = st.started[v] > 0;
    const double start_time = st.start_time[v], stop_time = st.stop_time[v];
    for (int s = lane; s < P; s += 32) {
      cp_async8(bt_s + pad(s), bt + s);
      cp_async8(bet_s + pad(s), bet + s);
      if (rate_rows) cp_async4(rate_in + pad(s), rates + static_cast<int64_t>(v) * S + s);
    }
    if (!rate_rows && lane == 0) cp_async4(rate_in, rates + v);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (lane == 0) {
      plan.ratio = ratio;
      plan.cap = cap;
      plan.started = started;
      plan.start_time = start_time;
      plan.stop_time = stop_time;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();

    // -- the rates and the advance of each quantum, a lane a quantum --------
    int act_any = 0;
    for (int s = lane; s < P; s += 32) {
      const bool act = started && bet_s[pad(s)] > start_time && bt_s[pad(s)] < stop_time;
      double rb = __dmul_rn(ratio, static_cast<double>(rate_in[rate_rows ? pad(s) : 0]));
      rb = rb > cap ? cap : rb;  // NaN passes, as torch.clamp passes it
      adv_s[pad(s)] = act ? __dmul_rn(128.0, rb) : 0.0;
      act_any |= act;
    }
    act_any = __any_sync(kFull, act_any);
    if (lane == 0) plan.any_act = act_any;
    __syncwarp();

    // -- XLA's cumsum: lane r sums run r of 16 in order; the carries of the
    //    runs before in run order (a shuffle chain), passes of 32 runs -----
    double carry = 0.0;
    for (int r0 = 0; r0 < nruns; r0 += 32) {
      const int r = r0 + lane;
      const int s0 = r * kRun;
      double acc = s0 < P ? adv_s[pad(s0)] : 0.0;
      if (s0 < P) pre_s[pad(s0)] = acc;
      // the run's advances in bursts, each burst's loads before its adds
#pragma unroll
      for (int j0 = 0; j0 < kRun; j0 += kBurst) {
        double a[kBurst];
#pragma unroll
        for (int j = 0; j < kBurst; ++j)
          a[j] = j0 + j > 0 && s0 + j0 + j < P ? adv_s[pad(s0 + j0 + j)] : 0.0;
#pragma unroll
        for (int j = 0; j < kBurst; ++j) {
          if (j0 + j > 0 && s0 + j0 + j < P) {
            acc = __dadd_rn(acc, a[j]);
            pre_s[pad(s0 + j0 + j)] = acc;
          }
        }
      }
      const int n = min(32, nruns - r0);
      double cr = carry;
      for (int j = 0; j < n - 1; ++j) {
        const double t = __shfl_sync(kFull, acc, j);
        if (lane > j) cr = __dadd_rn(cr, t);
      }
      if (r < nruns) carry_s[r] = cr;
      carry = __shfl_sync(kFull, __dadd_rn(cr, acc), 31);
    }
    __syncwarp();
    if (head) {  // the run sums to warps 1-7 (named barrier 1)
      __threadfence_block();
      asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
    }
    asm volatile("bar.sync 2, 64;\n" ::: "memory");  // warp 1's scalars

    // -- the span's quanta (lane l: quantum span*kSpan + l): anchors, bands,
    //    gates; then the span's tap range into L2 -----------------------------
    const int s = span * kSpan + lane;
    int lo = INT_MAX, hi = INT_MIN;  // the window samples the quantum's taps can touch
    if (lane < kSpan && s < S) {
      const Quantum q = plan_quantum(s, plan, bt_s, bet_s, rate_in, rate_rows, adv_s, pre_s,
                                     carry_s);
      const int64_t n_tiles = plan.n_tiles;
      int64_t m_b = floor_div<int64_t>(static_cast<int64_t>(q.a_int) - 1, kHop);
      m_b = m_b < 0 ? 0 : (m_b > n_tiles - 1 ? n_tiles - 1 : m_b);
      sp.ub[lane] = q.ub;
      sp.rate[lane] = q.rb;
      sp.band[lane] = m_b * kHop;
      sp.ok[lane] = q.ok;
      // floor(ub) - 1 to floor(ub + 127 rate) + 3, one more for the f32
      // offsets' rounding
      const double last = floor(fma(127.0, q.rb, q.ub));
      if (q.ok && q.ub == q.ub && last == last && last - q.a_int <= kPrefetchMax) {
        lo = static_cast<int>(fmax(q.a_int - 1.0, -1.0e9));
        hi = static_cast<int>(fmin(last + 4.0, 1.0e9));
      }
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0 && lo < hi)
      prefetch_l2(arena + static_cast<int64_t>(c) * W, plan.win0 + lo, plan.win0 + hi, W);
  } else if (tid < 64) {
    // -- warp 1, meanwhile: the voice's scalars, resample_group_step_plain's
    //    op order ------------------------------------------------------------
    const double* g = gtab + static_cast<int64_t>(v) * kCols;
    const double* k = gtab + static_cast<int64_t>(V) * kCols;
    const double length = g[kLength], rate = g[kRate], lsf = g[kLsf], lef = g[kLef];
    const double llen = g[kLlen];
    const bool looping = g[kLooping] != 0.0, loop_flag = g[kLoopFlag] != 0.0;
    const int64_t region_len = static_cast<int64_t>(g[kRegionLen]);
    const int64_t base = static_cast<int64_t>(g[kOff]) + static_cast<int64_t>(g[kFront]);
    const int64_t w = static_cast<int64_t>(k[kW]);
    const double offset = st.offset[v], duration = st.duration[v];
    const double p0 = st.pos[v], x_in = st.x[v];
    const int primed = st.primed[v];
    const double de = duration_end(offset, duration, rate, length);
    const double llen1 = llen < 1.0 ? 1.0 : llen;
    // The first output of a fresh voice lies at pos + 1 (the warmup).
    const double x0 = primed > 0 ? x_in : __dadd_rn(p0, 1.0);
    const double qmod = torch_remainder(__dsub_rn(x0, lsf), llen1);
    const double e0 = (looping && x0 >= lsf) ? __dadd_rn(__dadd_rn(lsf, llen), qmod) : x0;
    int64_t start = static_cast<int64_t>(floor(e0)) - 1;
    if (start < 0) start = 0;
    if (start > region_len - w) start = region_len - w;
    const int64_t de_i = static_cast<int64_t>(de);
    const int64_t lef_i = static_cast<int64_t>(lef);
    if (tid == 32) {
      plan.de = de;
      plan.llen1 = llen1;
      plan.x0 = x0;
      plan.win0 = base + start;
      plan.e0s = __dsub_rn(e0, static_cast<double>(start));
      plan.shift = static_cast<int64_t>(rint(__dsub_rn(x0, e0))) + start;
      plan.end_bound = loop_flag ? (lef_i < de_i ? lef_i : de_i) : de_i;
      plan.p0 = p0;
      plan.p4 = __dadd_rn(p0, 4.0);
      plan.lsf = lsf;
      plan.lef = lef;
      plan.tile = static_cast<int64_t>(k[kTile]);
      plan.n_tiles = static_cast<int64_t>(k[kNTiles]);
      plan.looping = looping;
      plan.primed = primed;
      // base + shift + 2 <= end_bound - 1, for the int32 bases of the window
      const int64_t lim = plan.end_bound - 3 - plan.shift;
      plan.lim = looping || lim > INT_MAX ? INT_MAX : (lim < INT_MIN ? INT_MIN : static_cast<int>(lim));
    }
    __threadfence_block();
    asm volatile("bar.arrive 2, 64;\n" ::: "memory");
    if (head) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
      state_sums(S, plan, bt_s, bet_s, rate_in, rate_rows, adv_s, pre_s, carry_s, warp_min,
                 &total_s);
    }
  } else if (head) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    state_sums(S, plan, bt_s, bet_s, rate_in, rate_rows, adv_s, pre_s, carry_s, warp_min,
               &total_s);
  }
  __syncthreads();  // publishes the plan, the span and the state sums

  // -- the span's outputs: warp sl owns quantum sl, lane i its outputs i,
  //    i + 32, i + 64, i + 96 (neighbouring lanes read neighbouring taps) --
  const int sl = tid >> 5, lane = tid & 31;
  const int s = span * kSpan + sl;
  if (s >= S) return;  // never warp 0: its quantum is the span's first
  const bool ok = sp.ok[sl];
  const int lim = plan.lim, tile = static_cast<int>(plan.tile);
  const int band = static_cast<int>(sp.band[sl]);
  const double rb = sp.rate[sl];
  const float rf = __double2float_rn(rb);
  // lane i computes sub-chunk (i & 7)'s f64 anchor; an output takes its
  // sub-chunk's from the lane that computed it. Bases in the window are
  // int32, as the plain version's are.
  const double anchor = fma(static_cast<double>(lane & 7), __dmul_rn(16.0, rb), sp.ub[sl]);
  const double fl = floor(anchor);
  const int my_int = static_cast<int>(fl);
  const float my_frac = __double2float_rn(__dsub_rn(anchor, fl));
  const float* a_c = arena + static_cast<int64_t>(c) * W + plan.win0;
  // every tap's weight and load first, so block (0, 0, v)'s thread 0
  // writes the state while the loads are in flight. A tap outside its
  // quantum's tile, or of an output that does not play, weighs +0 and
  // reads +0: its product is the plain version's +0 term.
  float wq[kPer][4], tap[kPer][4];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = u * 32 + lane;
    const int a_int = __shfl_sync(kFull, my_int, i >> 4);
    const float a_frac = __shfl_sync(kFull, my_frac, i >> 4);
    const float local = fmaf(static_cast<float>(i & 15), rf, a_frac);
    const float bl = floorf(local);
    const int base_l = a_int + static_cast<int>(bl);
    const bool valid = ok && base_l <= lim;
    const int row = base_l - band;
    float wk[4];
    cr_weights(__fsub_rn(local, bl), wk);
    const float* at = a_c + base_l - 1;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool inb = valid && static_cast<unsigned>(row + q - 1) < static_cast<unsigned>(tile);
      wq[u][q] = inb ? wk[q] : 0.0f;
      tap[u][q] = 0.0f;
      if (inb) tap[u][q] = __ldg(at + q);
    }
  }
  if (head && tid == 0) {
    double fs = warp_min[1];
    for (int w = 2; w < kWarps; ++w) fs = fmin(fs, warp_min[w]);
    double new_x = __dadd_rn(plan.x0, total_s);
    if (plan.looping && new_x >= plan.lef)
      new_x = __dadd_rn(plan.lsf, torch_remainder(__dsub_rn(new_x, plan.lef), plan.llen1));
    st_out[v] = new_x;
    st_out[V + v] = min_nan(plan.stop_time, fs);
    primed_out[v] = plan.any_act ? 1 : plan.primed;
  }
  float* o = out + ((static_cast<int64_t>(v) * C + c) * S + s) * 128;
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    o[u * 32 + lane] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(wq[u][0], tap[u][0]),
                                                     __fmul_rn(wq[u][1], tap[u][1])),
                                           __fmul_rn(wq[u][2], tap[u][2])),
                                 __fmul_rn(wq[u][3], tap[u][3]));
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
  // the clocks, advances and run sums (padded), the runs' carries, the rates
  const size_t smem = (4 * static_cast<size_t>(pad(S)) + (S + kRun - 1) / kRun) * sizeof(double) +
                      static_cast<size_t>(pad(S)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resample_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  resample_step_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      arena, W, S, gtab, st, rates, rate_rows, bt, bet, out, st_out, primed_out);
  return ga_launch_status();
}
