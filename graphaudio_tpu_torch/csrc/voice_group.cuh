// What the fused buffer-source group steps K1 (poly_resample.cu) and K5
// (unity.cu) share: the packed geometry table's layout, torch's rounding
// rules for the f64 plan, and the block prologue's two reductions.
//
// The plan they recompute is a sequence of torch ops (nodes/sources.py
// poly_group_plan, unity_group_plan), so each helper follows torch, not C:
// torch.remainder adds the divisor when the signs differ, rounding_mode=
// "floor" divides towards minus infinity, torch.minimum propagates NaN.
#pragma once

#include "common.cuh"

namespace voice_group {

constexpr int kThreads = 256;                       // threads a block
constexpr int kSpan = 8;                            // quanta a block
constexpr int kPer = kSpan * 128 / kThreads;        // outputs a thread
constexpr int kWarps = kThreads / 32;

// Columns of the packed geometry table, f64 [V + 1, kGeomCols]
// (ops/voice_group.pack_group_table); its last row holds the group's
// constants, whose meaning each kernel defines.
enum { kLength, kRate, kLsf, kLef, kLlen, kLooping, kLoopFlag, kRegionLen, kFront, kOff,
       kGeomCols };

__device__ __forceinline__ double torch_remainder(double a, double b) {
  double m = fmod(a, b);
  if (m != 0.0 && ((m < 0.0) != (b < 0.0))) m = __dadd_rn(m, b);
  return m;
}

template <typename I>
__device__ __forceinline__ I floor_div(I a, I b) {
  I d = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --d;
  return d;
}

__device__ __forceinline__ double min_nan(double a, double b) {  // torch.minimum
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// The voice's duration end frame (AudioBufferSourceNode._duration_end).
__device__ __forceinline__ double duration_end(double offset, double duration, double rate,
                                               double length) {
  double de = isfinite(duration)
                  ? __dadd_rn(trunc(__dmul_rn(offset, rate)), trunc(__dmul_rn(duration, rate)))
                  : length;
  return min_nan(de, length);
}

// One chunk of kThreads quanta: the active quanta before this thread's
// (warp ballots, then the warp totals in order) plus ``carry``, the count
// of the chunks before; ``carry`` becomes the count through this chunk.
// Every thread of the block calls it; ``warp_tot`` is kWarps shared ints.
__device__ __forceinline__ int count_active_before(bool act, int& carry, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, act);
  if (lane == 0) warp_tot[warp] = __popc(mask);
  __syncthreads();
  int before = carry + __popc(mask & ((1u << lane) - 1u)), total = carry;
  for (int i = 0; i < kWarps; ++i) {
    before += i < warp ? warp_tot[i] : 0;
    total += warp_tot[i];
  }
  __syncthreads();  // warp_tot is rewritten by the next chunk
  carry = total;
  return before;
}

// The min of ``v`` over the block (exact in any order), returned to every
// thread. Every thread calls it; ``warp_min`` is kWarps shared doubles.
__device__ __forceinline__ double block_min(double v, double* warp_min) {
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = v;
  __syncthreads();
  double m = warp_min[0];
  for (int i = 1; i < kWarps; ++i) m = fmin(m, warp_min[i]);
  return m;
}

}  // namespace voice_group
