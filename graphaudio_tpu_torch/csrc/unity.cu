// K5: unity-rate playback of one voice group, a masked block copy.
//
// Replaces graphaudio_tpu/nodes/sources.py AudioBufferSourceNode
// .process_unity_group (:1104-1209): the aligned 128-row gather (:1147-1163)
// and the unaligned row-gather pair plus one-hot lane-shift matmuls of
// _gather_blocks_group (:1073-1101), with the active / valid / cleared masks
// (:1170-1192). One thread per output sample of [V, C, S, 128] reads
// arena[c, row*128 + delta + i] (the next row once delta + i >= 128), row =
// clip(row0[v] + bidx[v, s]), and writes it or zero.
//
// Bound on the H100: memory and launch. Config 1 copies 2 x 4096 samples a
// step, config 2 8 x 4096: tens of KB, so the launch dominates. Neighbouring
// threads read neighbouring arena samples, so loads coalesce even when
// delta is not 0. The f64 bookkeeping stays in torch around it.
#include "common.cuh"

namespace {

__global__ void unity_gather_kernel(
    const float* __restrict__ arena, int64_t W, const int64_t* __restrict__ row0,
    const int32_t* __restrict__ delta, const int32_t* __restrict__ bidx,
    const int32_t* __restrict__ g0, const int32_t* __restrict__ end_bound,
    const uint8_t* __restrict__ looping, const uint8_t* __restrict__ blk_ok, int S,
    float* __restrict__ out) {
  // grid (S, C, V), block 128: one thread per sample of one quantum.
  const int s = blockIdx.x, c = blockIdx.y, v = blockIdx.z, i = threadIdx.x;
  const int C = gridDim.y;
  const int vs = v * S + s;
  float y = 0.0f;
  if (blk_ok[vs] && (looping[v] || g0[vs] + i < end_bound[v])) {
    const int64_t nrows = W / 128;
    int64_t row = row0[v] + bidx[vs];
    row = row < 0 ? 0 : (row > nrows - 1 ? nrows - 1 : row);
    int j = delta[v] + i;
    if (j >= 128) {
      row = row + 1 > nrows - 1 ? nrows - 1 : row + 1;
      j -= 128;
    }
    y = arena[static_cast<int64_t>(c) * W + row * 128 + j];
  }
  out[(static_cast<int64_t>(v) * C + c) * S * 128 + static_cast<int64_t>(s) * 128 + i] = y;
}

}  // namespace

GA_EXPORT int ga_unity_gather(const float* arena, int64_t W, int C, int V, int S,
                              const int64_t* row0, const int32_t* delta,
                              const int32_t* bidx, const int32_t* g0,
                              const int32_t* end_bound, const uint8_t* looping,
                              const uint8_t* blk_ok, float* out, void* stream) {
  dim3 grid(S, C, V);
  unity_gather_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      arena, W, row0, delta, bidx, g0, end_bound, looping, blk_ok, S, out);
  return ga_launch_status();
}
