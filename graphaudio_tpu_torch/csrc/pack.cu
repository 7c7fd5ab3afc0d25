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
// quantizer of K4 above, then the G.711 byte of the quantized sample,
// mulaw_encode_np's bit for bit. The exponent is 24 - clz of the biased
// magnitude, floored at 0: for every magnitude the quantizer gives,
// [0x84, 0x7FFF], that equals the reference's count of the 7 segment
// thresholds 0x100 << k (tests/test_torch_mulaw_tiles.py checks each).
//
// Bound on the H100: memory, 4 bytes read and 1 written a sample (5.2 MB,
// 1.57 us at config 4's launch chunk [2, 524288]). The first port, a
// thread an output byte with a 64-bit division by C and a byte store
// each, was bound by instruction issue at 3x that. Here a thread owns kV
// consecutive frames of every channel: it loads them (16-byte loads
// through the read-only path when every row base is 16-byte aligned, else
// kV scalar loads a row in the same map), encodes the C x kV bytes and
// stores them interleaved as whole words: for C = 1 and 2 (template
// instantiations) built in registers, for any other C through the
// thread's own slice of shared memory. The grid covers the groups in one
// pass; the thread after the last whole group writes the T mod kV tail
// frames a byte at a time. kV = 8 timed faster than 16 and than a
// grid-stride grid of 132-528 blocks on the H100 (PERF.md). The geometry
// (instantiation, kV, threads, blocks, tail start, shared bytes) is
// ops/wire.mulaw_pack_plan's: the launcher takes it as given and refuses
// what it has no instantiation for.
namespace {

constexpr int kV = 8;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ uint32_t mulaw_byte(float x) {
  const float v = fminf(fmaxf(x, -1.0f), 1.0f);
  const int q = __float2int_rn(__fmul_rn(v, 32767.0f));
  const uint32_t sign = static_cast<uint32_t>(q) >> 31;
  const int mag = min(abs(q), 32635) + 0x84;
  const int e = max(0, 24 - __clz(mag));
  const uint32_t mant = static_cast<uint32_t>(mag >> (e + 3)) & 0xFu;
  return ((sign << 7) | (static_cast<uint32_t>(e) << 4) | mant) ^ 0xFFu;
}

// kV consecutive frames of one row from p: two 16-byte loads through the
// read-only path (p 16-byte aligned), or kV scalar ones.
template <bool VEC>
__device__ __forceinline__ void load_frames(const float* __restrict__ p, float (&f)[kV]) {
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < kV / 4; ++k) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(p) + k);
      f[4 * k] = w.x;
      f[4 * k + 1] = w.y;
      f[4 * k + 2] = w.z;
      f[4 * k + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kV; ++k) f[k] = __ldg(p + k);
  }
}

// CT: the channel count, 1 or 2, or 0 for any C (through shared memory:
// blockDim.x * kV * C dynamic bytes). Thread g encodes frames
// [g kV, g kV + kV) of every channel; thread tail / kV the frames [tail, T).
template <int CT, bool VEC>
__global__ void __launch_bounds__(kMaxThreads) pack_mulaw_kernel(const float* __restrict__ x,
                                                                 uint8_t* __restrict__ out,
                                                                 int C, int64_t T,
                                                                 int64_t tail) {
  const int64_t groups = tail / kV;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g < groups) {
    const float* p = x + g * kV;
    uint8_t* q = out + g * kV * C;
    if constexpr (CT > 0) {
      float f[CT][kV];
#pragma unroll
      for (int c = 0; c < CT; ++c) load_frames<VEC>(p + c * T, f[c]);
      uint32_t w[CT * kV / 4];  // byte i of the run: frame i / CT, channel i % CT
#pragma unroll
      for (int k = 0; k < CT * kV / 4; ++k) {
        w[k] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          w[k] |= mulaw_byte(f[(4 * k + b) % CT][(4 * k + b) / CT]) << (8 * b);
      }
      if constexpr (CT == 2) {
        reinterpret_cast<uint4*>(q)[0] = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        reinterpret_cast<uint2*>(q)[0] = make_uint2(w[0], w[1]);
      }
    } else {
      extern __shared__ __align__(16) uint8_t stage[];
      uint8_t* s = stage + threadIdx.x * kV * C;
      for (int c = 0; c < C; ++c) {
        float f[kV];
        load_frames<VEC>(p + c * T, f);
#pragma unroll
        for (int j = 0; j < kV; ++j) s[j * C + c] = static_cast<uint8_t>(mulaw_byte(f[j]));
      }
      // the thread's own C x kV bytes back as 8-byte words
      for (int k = 0; k < C; ++k)
        reinterpret_cast<uint2*>(q)[k] = reinterpret_cast<const uint2*>(s)[k];
    }
  } else if (g == groups) {
    for (int64_t t = tail; t < T; ++t)
      for (int c = 0; c < C; ++c)
        out[t * C + c] = static_cast<uint8_t>(mulaw_byte(__ldg(x + c * T + t)));
  }
}

template <int CT>
int launch_mulaw(bool vec, const float* x, uint8_t* out, int C, int64_t T, int64_t tail,
                 int threads, int blocks, int smem, cudaStream_t stream) {
  if (vec)
    pack_mulaw_kernel<CT, true><<<blocks, threads, smem, stream>>>(x, out, C, T, tail);
  else
    pack_mulaw_kernel<CT, false><<<blocks, threads, smem, stream>>>(x, out, C, T, tail);
  return ga_launch_status();
}

}  // namespace

// The plan's geometry: variant (C for 1 and 2, 0 for any C), vec (16-byte
// loads), V frames a thread, the tail's first frame, threads, blocks and
// dynamic shared bytes. Returns cudaErrorInvalidValue, launching nothing,
// for a geometry this file has no instantiation for, that leaves a frame
// out, or whose vector accesses would be misaligned.
GA_EXPORT int ga_pack_mulaw(const float* x, uint8_t* out, int C, int64_t T, int variant,
                            int vec, int V, int64_t tail, int threads, int blocks, int smem,
                            void* stream) {
  const bool ok =
      C >= 1 && T >= 1 && (variant == 0 || variant == C) && variant <= 2 && V == kV &&
      tail == T / kV * kV && threads >= 1 && threads <= kMaxThreads &&
      static_cast<int64_t>(blocks) * threads >= (T + kV - 1) / kV &&
      smem >= (variant == 0 ? threads * kV * C : 0) &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
      (!vec || (reinterpret_cast<uintptr_t>(x) % 16 == 0 && (C == 1 || T % 4 == 0)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) return launch_mulaw<1>(vec != 0, x, out, C, T, tail, threads, blocks, smem, s);
  if (variant == 2) return launch_mulaw<2>(vec != 0, x, out, C, T, tail, threads, blocks, smem, s);
  return launch_mulaw<0>(vec != 0, x, out, C, T, tail, threads, blocks, smem, s);
}
