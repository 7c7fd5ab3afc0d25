// K4: interleaved int16 PCM packing.
//
// Replaces graphaudio_tpu/core/context.py _pack_int16 (:36-47):
// out[t*C + c] = round_half_even(clip(x[c, t], -1, 1) * 32767) as int16.
// __float2int_rn rounds to nearest even, as jnp.round does; the product is
// a single f32 multiply, so no contraction can change it.
//
// Bound on the H100: memory. At the bench shape ([2, 1,433,600] f32 ->
// 2,867,200 int16) it reads 11.5 MB and writes 5.7 MB, a few microseconds
// of HBM time. One thread per output element: writes are contiguous, reads
// come from C interleaved rows, which the L1/L2 lines absorb for C = 2.
#include "common.cuh"

namespace {

__global__ void pack_int16_kernel(const float* __restrict__ x, int16_t* __restrict__ out,
                                  int C, int64_t T) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= T * C) return;
  const int64_t t = i / C;
  const int c = static_cast<int>(i - t * C);
  const float v = fminf(fmaxf(x[static_cast<int64_t>(c) * T + t], -1.0f), 1.0f);
  out[i] = static_cast<int16_t>(__float2int_rn(__fmul_rn(v, 32767.0f)));
}

}  // namespace

GA_EXPORT int ga_pack_int16(const float* x, int16_t* out, int C, int64_t T, void* stream) {
  const int threads = 256;
  const int64_t n = T * C;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  pack_int16_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, C, T);
  return ga_launch_status();
}

// K4mu: interleaved G.711 mu-law packing.
//
// Replaces graphaudio_tpu/ops/wire.py pack_mulaw (:66-82): the int16
// quantizer of K4 above, then the G.711 byte of the quantized sample. The
// exponent is the count of the 7 segment thresholds 0x100 << k that the
// biased magnitude reaches, as the reference counts them, so the byte is
// mulaw_encode_np's bit for bit.
//
// Bound on the H100: memory, like K4 (4 bytes read and 1 written a
// sample). One thread per output byte, reads from C interleaved rows.
namespace {

__global__ void pack_mulaw_kernel(const float* __restrict__ x, uint8_t* __restrict__ out,
                                  int C, int64_t T) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= T * C) return;
  const int64_t t = i / C;
  const int c = static_cast<int>(i - t * C);
  const float v = fminf(fmaxf(x[static_cast<int64_t>(c) * T + t], -1.0f), 1.0f);
  const int q = __float2int_rn(__fmul_rn(v, 32767.0f));
  const int sign = q < 0 ? 1 : 0;
  const int mag = min(abs(q), 32635) + 0x84;
  int e = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) e += mag >= (0x100 << k) ? 1 : 0;
  const int mant = (mag >> (e + 3)) & 0xF;
  out[i] = static_cast<uint8_t>(~((sign << 7) | (e << 4) | mant) & 0xFF);
}

}  // namespace

GA_EXPORT int ga_pack_mulaw(const float* x, uint8_t* out, int C, int64_t T, void* stream) {
  const int threads = 256;
  const int64_t n = T * C;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  pack_mulaw_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, C, T);
  return ga_launch_status();
}
