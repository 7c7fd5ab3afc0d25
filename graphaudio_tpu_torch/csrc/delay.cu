// K12: the delay line of one DelayNode stage for one superblock.
//
// Replaces graphaudio_tpu/nodes/delay.py DelayNode.process (:54-90), the
// reference's per-sample circular buffer (DelayNode.cs:66-91, :143-144).
// Per sample i: d = trunc(f32(delayTime[i]) * f32(sr)), clipped to [0, L];
// d <= 0 reads silence, else x[i - d] when i >= d, or the carried ring at
// (w + i - d) mod L. Then the ring takes this superblock's input (only the
// trailing L samples when T >= L) and the write cursor moves to (w + T) mod
// L. The TPU version gathers both sources and scatters the write with
// ring.at[].set.
//
// Reads and writes never race: the kernel reads the OLD ring and writes a
// NEW one. At d = L sample i reads slot (w + i) mod L, the slot this step's
// write fills with x[i]; an in-place ring would need a second launch or a
// grid-wide barrier. Thread (c, k) writes slot k of the new ring (this
// step's input sample if the write reaches the slot, else the old slot) and,
// for k < T, output sample k. The cursor lives on the device: every thread
// reads it, thread 0 of block (0, 0) writes the new one to its own word.
//
// Memory-bound on the H100. The function needs x, the delay times, the
// output and the ring slots it reads and writes (at most min(T, L) a
// channel each); this design also copies the rest of the ring, 8 bytes a
// slot a channel. At config 4's ping-pong send (C = 2, T = 8192, L = 48000)
// the kernel moves ~0.93 MB a step, 0.77 MB of it the ring copy, where the
// function needs ~0.29 MB. One thread an element, coalesced in both rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) delay_kernel(
    const float* __restrict__ x, const float* __restrict__ dtime, int dt_rows,
    const float* __restrict__ ring, const int* __restrict__ wpos, int T, int L, float sr,
    float* __restrict__ out, float* __restrict__ new_ring, int* __restrict__ new_wpos) {
  const int c = blockIdx.y;
  const int i = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  const int w = *wpos;
  const float* xc = x + static_cast<int64_t>(c) * T;
  const float* rc = ring + static_cast<int64_t>(c) * L;
  if (i < T) {
    const float v = dt_rows ? dtime[i] : dtime[0];
    // the f32 product truncated toward zero (NaN reads 0, as XLA converts)
    int d = __float2int_rz(__fmul_rn(v, sr));
    d = d < 0 ? 0 : (d > L ? L : d);
    float y = 0.0f;
    if (d > 0) {
      const int s = i - d;
      if (s >= 0) {
        y = xc[s];
      } else {
        const int k = w + s;  // in [-L, L - 1]
        y = rc[k < 0 ? k + L : k];
      }
    }
    out[static_cast<int64_t>(c) * T + i] = y;
  }
  if (i < L) {
    int j = i - w;  // the slot's place in this step's write, mod L
    if (j < 0) j += L;
    int src = -1;
    if (T < L) {
      if (j < T) src = j;
    } else {
      // inputs T - L .. T - 1 fill slots (w + T - L + m) mod L, m < L
      int m = j - (T - L) % L;
      if (m < 0) m += L;
      src = T - L + m;
    }
    new_ring[static_cast<int64_t>(c) * L + i] = src >= 0 ? xc[src] : rc[i];
  }
  if (c == 0 && i == 0) *new_wpos = static_cast<int>((static_cast<int64_t>(w) + T) % L);
}

}  // namespace

GA_EXPORT int ga_delay_step(const float* x, const float* dtime, int dt_rows, const float* ring,
                            const int* wpos, int C, int T, int L, float sr, float* out,
                            float* new_ring, int* new_wpos, void* stream) {
  const int n = T > L ? T : L;
  const dim3 grid((n + kThreads - 1) / kThreads, C);
  delay_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dtime, dt_rows, ring, wpos, T, L, sr, out, new_ring, new_wpos);
  return ga_launch_status();
}
