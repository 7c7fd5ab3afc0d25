// K12: the delay line of one DelayNode stage for one superblock, in place.
//
// Replaces graphaudio_tpu/nodes/delay.py DelayNode.process (:54-90), the
// reference's per-sample circular buffer (DelayNode.cs:66-91, :143-144).
// Per sample i: d = trunc(f32(delayTime[i]) * f32(sr)), clipped to [0, L];
// d <= 0 reads silence, else x[i - d] when i >= d, or the sample d - i
// before this superblock from the ring. Then the ring takes this
// superblock's input (only the trailing L samples when T >= L). The TPU
// version gathers both sources and scatters the write with ring.at[].set
// into a new ring of L slots.
//
// Why reads and writes never meet. The ring has R = L + W slots a channel,
// W = min(T, L), and a slot cursor c: the L slots before c (mod R) hold
// the last L samples before this superblock, the sample k back in slot
// (c - k) mod R. A step reads only those L slots (d <= L), writes x's
// trailing W samples to the W slots from c on, and moves c by W. With R =
// L + W the two ranges are disjoint mod R, so d = L and T >= L need no
// second launch, no grid barrier and no copy: the ring is one static
// tensor updated in place. (The JAX package's L-slot ring is the same
// history, slot (w + s) mod L for the sample s < 0 samples back;
// nodes/delay.py maps one onto the other.)
//
// Cursors on the card, without a race. Every block needs the slot cursor
// c, and a block that moved a shared cursor could do so before another
// block had read it. So the state keeps one copy of c for each block of
// the launch: the caller sizes the slot state (nodes/delay.py, from T and
// C, which are fixed for a context) and the launcher takes the grid from
// it, copies / C blocks a channel of ceil(T / (copies / C)) threads each.
// Thread 0 of block b reads copy b at entry and writes it back moved by W,
// mod R, after its own work, and no other block reads or writes copy b.
// The copies start equal and move together, so no atomic, fence, ticket or
// grid barrier is needed. (A last-arrival ticket on one shared word was
// tried first; its round trip stayed on the kernel's critical path.) Block
// 0 alone reads and moves the JAX package's write cursor w to (w + T) mod
// L, for the JAX view and a hand-off. Both loads are issued at entry,
// before any store that might alias them, and both stores come last. No
// host reads a cursor.
//
// Latency, not bytes, sets the time at the render's sizes: the cursor,
// the delay time, the input sample that goes to the ring and the input
// sample an output reads when d <= i are all in flight at once before the
// block barrier that publishes c, so an output that reads the ring waits
// on two round trips to memory, as the copy design's did.
//
// Thread (c, i) of the T x C grid writes out[c, i] and, when x[c, i] is
// one of the W survivors, its ring slot. The input is read through its
// strides: the splitter's mono row up-mixed to stereo is a stride-0 view,
// read as it is. A stride-0 delay time is one base value.
//
// Memory-bound on the H100, and launch-bound at the render's sizes. The
// function needs each distinct element of x it reads once (one row for a
// stride-0 channel), the delay times, the output and the ring slots that
// this step's data reads and writes. The kernel's loads ask for more: a
// thread reads x[i - d] for its output and x[i] for the ring, so an
// element can be asked for twice, and every row of a stride-0 channel
// asks for the same elements; those repeats should hit in L1 or L2 (x is
// 32 KB a row at the ping-pong's T = 8192; DRAM bytes are not measured,
// PERF.md). On top, each block's copy of the cursor is read and written,
// and block 0's write cursor.
#include "common.cuh"

namespace {

// kThreads: the block size when it is known at compile time (0: read
// blockDim). A constant block size made the launch faster on the H100
// than reading blockDim (PERF.md, K12), so the launcher takes the
// specialization when the slot state gives the usual block of 256.
template <int kThreads>
__global__ void __launch_bounds__(kThreads ? kThreads : 1024) delay_kernel(
    const float* __restrict__ x, int64_t xs_c, int64_t xs_t, const float* __restrict__ dtime,
    int dt_rows, float* ring, int R, int* slot, int* wpos, int T, int L, float sr,
    float* __restrict__ out) {
  __shared__ int cur;
  const int W = T < L ? T : L;
  const bool first = blockIdx.x == 0 && blockIdx.y == 0;
  int* mine = slot + blockIdx.y * gridDim.x + blockIdx.x;  // this block's copy of c
  int w = 0;
  if (threadIdx.x == 0) {
    cur = *mine;
    if (first) w = *wpos;
  }
  const int c = blockIdx.y;
  const int nt = kThreads ? kThreads : static_cast<int>(blockDim.x);
  const int i = static_cast<int>(blockIdx.x) * nt + static_cast<int>(threadIdx.x);
  const bool live = i < T;
  const float* xc = x + c * xs_c;
  const int m = i - (T - W);  // this sample's place among the W survivors
  int d = 0;
  float y = 0.0f, survivor = 0.0f;
  if (live) {
    const float v = dt_rows ? dtime[i] : dtime[0];
    // the f32 product truncated toward zero (NaN reads 0, as XLA converts)
    d = __float2int_rz(__fmul_rn(v, sr));
    d = d < 0 ? 0 : (d > L ? L : d);
    if (d > 0 && i >= d) y = xc[static_cast<int64_t>(i - d) * xs_t];
    if (m >= 0) survivor = xc[i * xs_t];
  }
  __syncthreads();
  const int c0 = cur;
  if (live) {
    float* rc = ring + static_cast<int64_t>(c) * R;
    if (d > i) {
      const int k = c0 + i - d;  // one of the L slots before c0
      y = rc[k < 0 ? k + R : k];
    }
    out[static_cast<int64_t>(c) * T + i] = y;
    if (m >= 0) {
      const int k = c0 + m;  // one of the W slots from c0 on
      rc[k >= R ? k - R : k] = survivor;
    }
  }
  // the cursors move last, off the loads' path (no other block reads them)
  if (threadIdx.x == 0) {
    *mine = c0 + W >= R ? c0 + W - R : c0 + W;
    if (first) *wpos = static_cast<int>((static_cast<int64_t>(w) + T) % L);
  }
}

}  // namespace

GA_EXPORT int ga_delay_step(const float* x, int64_t xs_c, int64_t xs_t, const float* dtime,
                            int dt_rows, float* ring, int R, int* slot, int copies, int* wpos,
                            int C, int T, int L, float sr, float* out, void* stream) {
  // the grid is the slot state's: one block a copy of the cursor
  const int blocks = C > 0 ? copies / C : 0;
  const int threads = blocks > 0 ? (T + blocks - 1) / blocks : 0;
  if (C <= 0 || T <= 0 || blocks <= 0 || blocks * C != copies || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks, C);
  const auto s = static_cast<cudaStream_t>(stream);
  if (threads == 256)
    delay_kernel<256><<<grid, threads, 0, s>>>(x, xs_c, xs_t, dtime, dt_rows, ring, R, slot, wpos,
                                               T, L, sr, out);
  else
    delay_kernel<0><<<grid, threads, 0, s>>>(x, xs_c, xs_t, dtime, dt_rows, ring, R, slot, wpos, T,
                                             L, sr, out);
  return ga_launch_status();
}
