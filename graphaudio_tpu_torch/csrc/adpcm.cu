// K4a: IMA ADPCM (WAV tag 0x11) encoder of one launch chunk of a stream.
//
// Replaces graphaudio_tpu/ops/wire.py make_ima_chunk_encoder (:338-459),
// with its contract: the chunk's audio f32[C, F], quantized as K4 does,
// follows `carry_len` samples of the carry row int16[C, spb-1]; the stream
// buffer is built as the reference builds it (the whole carry row, the
// chunk written over it from carry_len, zeros after), cut into
// ncap = (spb-1+F)/spb block slots, and each (channel, slot) is one WAV-IMA
// block: the integer header index (sum |diff| against step*(spb-1), the 89
// threshold compares of :394-401), then spb-1 sequential IMA steps
// (:403-427), their nibbles packed low first into 4-byte words, round-robin
// over the channels. The new carry row is the buffer from the first block
// the caller does not keep, nblk = (carry_len+F)/spb.
//
// Bound on the H100: the serial recurrence. A block's 504 steps depend on
// each other (a chain of 11 dependent integer operations a step), and a
// chunk has only C*ncap blocks (34 at one config-4 step), so the kernel is
// latency-bound: its floor is one thread's chain, not the bytes. The design
// keeps that chain short: the step table lives in shared memory (lanes
// index it divergently, which the constant cache would serialise), and a
// warp's 32 consecutive blocks of one channel are staged through shared
// memory with coalesced loads (one thread's block starts 2 KB after its
// neighbour's in global memory), so every step reads shared memory only.
// The staging loops are unrolled so that a thread's loads are in flight
// together (a warp whose blocks lie inside the chunk's audio takes a
// branch-free one; the edge warps, which also read the carry, one over
// predicated loads): with one warp on most SMs, a load at a time left the
// edge warps, and with them the launch, about 1.5x slower. Threads write
// whole 32-bit words of the output rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kStageBytes = 40 * 1024;  // under the 48 KB default with step_tab

__constant__ int kImaStep[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

// Sample j of channel c's stream buffer. Written as selects over
// predicated loads, so an unrolled loop keeps several loads in flight.
__device__ __forceinline__ int16_t buffer_sample(const float* __restrict__ audio,
                                                 const int16_t* __restrict__ carry, int c,
                                                 int64_t F, int spb, int carry_len, int64_t j) {
  const int64_t a = j - carry_len;
  const bool in_chunk = a >= 0 && a < F;
  const bool in_carry = j < spb - 1;
  const float x = in_chunk ? audio[c * F + a] : 0.0f;
  const int16_t k = in_carry ? carry[static_cast<int64_t>(c) * (spb - 1) + j] : 0;
  const float v = fminf(fmaxf(x, -1.0f), 1.0f);
  return in_chunk ? static_cast<int16_t>(__float2int_rn(__fmul_rn(v, 32767.0f))) : k;
}

__global__ void __launch_bounds__(kThreads) ima_encode_kernel(
    const float* __restrict__ audio, const int16_t* __restrict__ carry, int C, int64_t F,
    int spb, int carry_len, int ncap, int slots, uint8_t* __restrict__ blocks,
    int16_t* __restrict__ new_carry) {
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  if (blockIdx.x == gridDim.x - 1) {  // the new carry row of channel c
    const int64_t start = static_cast<int64_t>((carry_len + F) / spb) * spb;
    for (int k = tid; k < spb - 1; k += kThreads)
      new_carry[static_cast<int64_t>(c) * (spb - 1) + k] =
          buffer_sample(audio, carry, c, F, spb, carry_len, start + k);
    return;
  }
  __shared__ int step_tab[89];
  extern __shared__ int16_t stage[];  // [slots, spb]
  for (int k = tid; k < 89; k += kThreads) step_tab[k] = kImaStep[k];
  const int slot0 = blockIdx.x * slots;
  const int n = min(slots, ncap - slot0);
  const int64_t j0 = static_cast<int64_t>(slot0) * spb;
  const int total = n * spb;
  if (j0 >= carry_len && j0 + total <= carry_len + F) {
    // Every sample from the chunk's audio (all but the edge warps): a
    // branch-free loop whose unrolled loads are in flight together.
    const float* src = audio + c * F + (j0 - carry_len);
#pragma unroll 8
    for (int j = tid; j < total; j += kThreads) {
      const float v = fminf(fmaxf(src[j], -1.0f), 1.0f);
      stage[j] = static_cast<int16_t>(__float2int_rn(__fmul_rn(v, 32767.0f)));
    }
  } else {
#pragma unroll 8
    for (int j = tid; j < total; j += kThreads)
      stage[j] = buffer_sample(audio, carry, c, F, spb, carry_len, j0 + j);
  }
  __syncthreads();
  if (tid >= n) return;

  const int16_t* xs = stage + tid * spb;
  const int nm1 = spb - 1;
  int sad = 0;
  for (int t = 1; t < spb; ++t) sad += abs(static_cast<int>(xs[t]) - static_cast<int>(xs[t - 1]));
  int index = 0;
  for (int k = 0; k < 89; ++k)
    index += static_cast<long long>(sad) > static_cast<long long>(step_tab[k]) * nm1 ? 1 : 0;
  index = min(index, 88);
  int pred = xs[0];

  const int block_align = C * (4 + nm1 / 2);
  uint8_t* row = blocks + static_cast<int64_t>(slot0 + tid) * block_align;
  reinterpret_cast<uint32_t*>(row)[c] =
      (static_cast<uint32_t>(pred) & 0xFFFFu) | (static_cast<uint32_t>(index) << 16);
  uint32_t* words = reinterpret_cast<uint32_t*>(row + 4 * C);
  uint32_t word = 0;
  for (int t = 1; t < spb; ++t) {
    const int step = step_tab[index];
    const int diff = static_cast<int>(xs[t]) - pred;
    const int sign = diff < 0 ? 1 : 0;
    int adiff = sign ? -diff : diff;
    int delta = 0;
    int vp = step >> 3;
    if (adiff >= step) {
      delta = 4;
      adiff -= step;
      vp += step;
    }
    const int s2 = step >> 1;
    if (adiff >= s2) {
      delta += 2;
      adiff -= s2;
      vp += s2;
    }
    const int s1 = step >> 2;
    if (adiff >= s1) {
      delta += 1;
      vp += s1;
    }
    pred = min(max(sign ? pred - vp : pred + vp, -32768), 32767);
    index = min(max(index + (delta < 4 ? -1 : 2 * (delta - 3)), 0), 88);
    const int m = t - 1;  // nibble m of the block's data
    word |= static_cast<uint32_t>(delta + 8 * sign) << (4 * (m & 7));
    if ((m & 7) == 7) {
      words[(m >> 3) * C + c] = word;
      word = 0;
    }
  }
}

}  // namespace

GA_EXPORT int ga_ima_chunk_encode(const float* audio, const int16_t* carry, int C, int64_t F,
                                  int spb, int carry_len, int ncap, uint8_t* blocks,
                                  int16_t* new_carry, void* stream) {
  const int slots = max(1, min(kThreads, kStageBytes / (2 * spb)));
  const dim3 grid((ncap + slots - 1) / slots + 1, C);
  const size_t smem = static_cast<size_t>(slots) * spb * sizeof(int16_t);
  ima_encode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, carry, C, F, spb, carry_len, ncap, slots, blocks, new_carry);
  return ga_launch_status();
}
