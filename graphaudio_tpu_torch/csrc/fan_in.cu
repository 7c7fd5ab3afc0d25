// K3: lane fan-in of a group tensor into its consumer's channel count.
//
// Replaces the ("ALL", ...) whole-group sum of graphaudio_tpu/core/graph.py
// mixed_signal (:1119-1127) followed by core/mixing.adapt_channels (:23):
// out[d, t] = adapt(sum_v x[v, :, t])[d] with the Web Audio mixing rules
//   mode 0  Cs == D       per-channel sum
//   mode 1  Cs == 1 < D   mono up-mix: every output channel is the mono sum
//   mode 2  D == 1 < Cs   down-mix: sum of the channel sums, times scale
//   mode 3  otherwise     discrete: first min(Cs, D) channels, rest silent
// Phantom (padding) lanes are silent, so summing the padded tensor is exact.
//
// Bound on the H100: memory. At config 4's shape ([64, 1, 8192] ->
// [2, 8192]) it reads 2 MB and writes 64 KB: 0.65 us at 3.35 TB/s. So the
// whole input has to be in flight at once. A block of 256 threads takes a
// 16-sample tile of one output job (a channel, or all of them in mode 2):
// its threads are 4 float4 columns x 64 lane groups, group g summing lanes
// g, g+64, ..., so every thread starts its loads at once and the grid has
// T/16 blocks per job (512 at config 4's shape, 256 at config 5's 4096).
// The 64 partial sums are reduced in a fixed order (shuffles within a warp,
// then the eight warp sums in order), each channel's lane sum is taken
// once, and mode 1 writes it to all D rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // float4 columns: 16 samples a block
constexpr int kGroups = kThreads / kCols;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_xor(float4 a, int m) {
  return make_float4(__shfl_xor_sync(0xffffffffu, a.x, m), __shfl_xor_sync(0xffffffffu, a.y, m),
                     __shfl_xor_sync(0xffffffffu, a.z, m), __shfl_xor_sync(0xffffffffu, a.w, m));
}

__global__ void __launch_bounds__(kThreads) fan_in_kernel(const float4* __restrict__ x,
                                                          float4* __restrict__ out, int V, int Cs,
                                                          int D, int64_t T4, int mode,
                                                          float scale) {
  __shared__ float4 s_warp[kWarps][kCols];
  const int col = threadIdx.x % kCols, g = threadIdx.x / kCols;
  const int64_t t4 = static_cast<int64_t>(blockIdx.x) * kCols + col;
  // The channels this block sums: all (mode 2), the mono one (mode 1), or
  // channel blockIdx.y, none if it is past the source's (mode 3).
  int c0 = mode == 0 || mode == 3 ? static_cast<int>(blockIdx.y) : 0;
  const int c1 = mode == 2 ? Cs : min(c0 + 1, Cs);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (; c0 < c1; ++c0) {
#pragma unroll 4
    for (int v = g; v < V; v += kGroups)
      acc = add(acc, x[(static_cast<int64_t>(v) * Cs + c0) * T4 + t4]);
  }
  // Threads kCols apart hold the same column: fold the warp's 8 groups.
#pragma unroll
  for (int m = kCols; m < 32; m <<= 1) acc = add(acc, shfl_xor(acc, m));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < kCols) s_warp[warp][lane] = acc;
  __syncthreads();
  if (threadIdx.x >= kCols) return;
  float4 sum = s_warp[0][col];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) sum = add(sum, s_warp[w][col]);
  if (mode == 2) sum = make_float4(sum.x * scale, sum.y * scale, sum.z * scale, sum.w * scale);
  const int d0 = mode == 1 ? 0 : blockIdx.y, d1 = mode == 1 ? D : d0 + 1;
  for (int d = d0; d < d1; ++d) out[static_cast<int64_t>(d) * T4 + t4] = sum;
}

}  // namespace

// T must be a multiple of 16 and x, out 16-byte aligned (the wrapper checks).
GA_EXPORT int ga_fan_in(const float* x, float* out, int V, int Cs, int D, int64_t T, int mode,
                        float scale, void* stream) {
  const dim3 grid(static_cast<unsigned>(T / (4 * kCols)), mode == 1 || mode == 2 ? 1 : D);
  fan_in_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), V, Cs, D, T / 4, mode,
      scale);
  return ga_launch_status();
}
