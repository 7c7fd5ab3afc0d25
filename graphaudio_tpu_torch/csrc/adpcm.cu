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
// Bound on the H100: the serial recurrence. A block's spb-1 steps depend on
// each other, so the kernel's floor is one thread's chain of steps, not
// the bytes. The design keeps everything else off that chain:
// - a thread block (512 threads) takes `sb` <= 16 consecutive blocks of
//   one channel (ops/wire.ima_chunk_plan; config 4's chunk is 2 x 65
//   thread blocks on 132 SMs) and stages their span of the chunk's f32
//   audio into shared memory with one thread's 1-D bulk copies (the Tensor
//   Memory Accelerator, completion on an mbarrier): a 16-byte-aligned
//   superset of the span cut to the tensor's own 16-byte words, placed so
//   that sample j of the span lands on word lead + j (the at most 3
//   samples at either end of the tensor that the cut leaves out are read
//   directly);
// - all its threads then turn the span into int16 samples in place (int
//   bits in the f32 words): the quantized audio, and outside the chunk the
//   carry's samples or 0, so no quantize is left on a block's chain;
// - the header runs a warp a block: partial |diff| sums (integers, exact
//   in any order) and the 89 threshold compares split 32 ways, each
//   reduced by warp shuffles;
// - the step is branch-free: the magnitude's code from 7 independent
//   compares against thresholds known from the step size at the step's
//   start (one level, where the reference's greedy compares are three in
//   series), a select tree for vp and one for the next (index, step size)
//   among the five possible next indices (index - 1, + 2, + 4, + 6, + 8,
//   clamped), read as packed words from a padded table in shared memory
//   while the step's compares run, so no shared-memory read is on the
//   chain from one step to the next. What bounds a step is then issue:
//   about 60 integer instructions, at two clocks each on a sub-partition's
//   16 integer lanes, near 120 clocks a step.
// A block too long for the stage (spb over ops/wire.IMA_MAX_SPB, up to
// WAV's 16-bit block align and past it) takes the streamed path, which
// ops/wire.ima_chunk_plan picks: a thread block of one warp a block slot
// (ncap + 1 thread blocks a channel, so the slots' chains run on as many
// SMs); the warp sums the header's |diff|s over the whole block reading
// the samples straight from the chunk (quantized on the fly), then walks
// the block in tiles of kLongTile samples: the warp quantizes a tile into
// shared memory, lane 0 runs its steps with the same step code. The chain
// still bounds it: a tile's loads (one device-memory latency) add about
// 1 % to its kLongTile steps.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kHeaderLanes = 32;                  // a warp a block's header
constexpr int kMaxBlocks = kThreads / kHeaderLanes;  // 16 blocks a thread block
constexpr int kCopyBytes = 32 * 1024;  // bytes a bulk copy
constexpr int kLongTile = 2048;  // samples a streamed tile (a multiple of 8)
// The step table padded and packed: entry i holds (step[j] << 8) | j for
// j = clamp(i - 1, 0, 88), so tab[index + 1 + k] gives the step size and the
// index clamp(index + k) for k in [-1, 8] in one word.
constexpr int kPadTab = 89 + 9;

__constant__ int kImaStep[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

__device__ __forceinline__ int quantize(float x) {
  const float v = fminf(fmaxf(x, -1.0f), 1.0f);
  return static_cast<int16_t>(__float2int_rn(__fmul_rn(v, 32767.0f)));
}

// Sample j of channel c's stream buffer when it is not in the chunk: the
// carry row's, or 0.
__device__ __forceinline__ int edge_sample(const int16_t* __restrict__ carry, int c, int spb,
                                           int64_t j) {
  return j < spb - 1 ? carry[static_cast<int64_t>(c) * (spb - 1) + j] : 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The padded, packed step table in shared memory (every thread calls it).
__device__ __forceinline__ void fill_tab(int* tab) {
  for (int k = threadIdx.x; k < kPadTab; k += blockDim.x) {
    const int j = min(max(k - 1, 0), 88);
    tab[k] = (kImaStep[j] << 8) | j;
  }
}

// The new carry row of channel c: the buffer from the first block the
// caller does not keep (the last thread block of the channel).
__device__ __forceinline__ void write_carry(const float* __restrict__ audio,
                                            const int16_t* __restrict__ carry, int c, int64_t F,
                                            int spb, int carry_len,
                                            int16_t* __restrict__ new_carry) {
  const int64_t start = static_cast<int64_t>((carry_len + F) / spb) * spb;
  for (int k = threadIdx.x; k < spb - 1; k += blockDim.x) {
    const int64_t j = start + k, a = j - carry_len;
    new_carry[static_cast<int64_t>(c) * (spb - 1) + k] = static_cast<int16_t>(
        a >= 0 && a < F ? quantize(audio[c * F + a]) : edge_sample(carry, c, spb, j));
  }
}

// The header index of a block from a warp's partial |diff| sums: the sum
// over the warp, then `sum > step * (spb - 1)` counted over the 89 steps
// (a share a lane), reduced over the warp and clamped. 64-bit, as the
// host encoder (ima_encode_np) and the plain version compare: a long
// block's sum and thresholds pass 2^31.
__device__ __forceinline__ int header_index(unsigned long long sad, int part, int nm1,
                                            const int* tab) {
#pragma unroll
  for (int o = 1; o < kHeaderLanes; o <<= 1) sad += __shfl_xor_sync(0xffffffffu, sad, o);
  const long long s = static_cast<long long>(sad);
  int count = 0;
  for (int k = part; k < 89; k += kHeaderLanes)
    count += s > static_cast<long long>(tab[k + 1] >> 8) * nm1 ? 1 : 0;
#pragma unroll
  for (int o = 1; o < kHeaderLanes; o <<= 1) count += __shfl_xor_sync(0xffffffffu, count, o);
  return min(count, 88);
}

// Eight IMA steps of one block from samples x[0..7]: the magnitude's code
// delta is the number of its 7 increasing thresholds (s1, s2, s2+s1, step,
// step+s1, step+s2, step+s2+s1) that |diff| reaches, the greedy compares
// of the reference in one level; vp is step/8 plus the largest threshold
// reached. Returns the eight nibbles packed low first.
__device__ __forceinline__ uint32_t ima_word(const int* __restrict__ x, int& pred, int& index,
                                             int& step, const int* __restrict__ tab) {
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int xt = x[k];
    const int* tp = tab + index;  // tp[1 + k]: clamp(index + k) and its step
    const int cm1 = tp[0], c2 = tp[3], c4 = tp[5], c6 = tp[7], c8 = tp[9];
    const int s1 = step >> 2, s2 = step >> 1;
    const int t3 = s2 + s1, t5 = step + s1, t6 = step + s2, t7 = t6 + s1;
    const int diff = xt - pred;
    const bool neg = diff < 0;
    const int ad = abs(diff);
    const bool p1 = ad >= s1, p2 = ad >= s2, p3 = ad >= t3, p4 = ad >= step;
    const bool p5 = ad >= t5, p6 = ad >= t6, p7 = ad >= t7;
    const bool b2 = p4 ? p6 : p2, b1 = p4 ? (p6 ? p7 : p5) : (p2 ? p3 : p1);
    const int top = p4 ? (p6 ? (p7 ? t7 : t6) : (p5 ? t5 : step))
                       : (p2 ? (p3 ? t3 : s2) : (p1 ? s1 : 0));
    const int vp = (step >> 3) + top;
    pred = min(max(neg ? pred - vp : pred + vp, -32768), 32767);
    const int next = p4 ? (b2 ? (b1 ? c8 : c6) : (b1 ? c4 : c2)) : cm1;
    step = next >> 8;
    index = next & 0xFF;
    word |= static_cast<uint32_t>((p4 ? 4 : 0) | (b2 ? 2 : 0) | (b1 ? 1 : 0) | (neg ? 8 : 0))
            << (4 * k);
  }
  return word;
}

__global__ void __launch_bounds__(kThreads) ima_encode_kernel(
    const float* __restrict__ audio, const int16_t* __restrict__ carry, int C, int64_t F,
    int spb, int carry_len, int ncap, int sb, uint8_t* __restrict__ blocks,
    int16_t* __restrict__ new_carry) {
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  if (blockIdx.x == gridDim.x - 1) {  // the new carry row of channel c
    write_carry(audio, carry, c, F, spb, carry_len, new_carry);
    return;
  }
  __shared__ int tab[kPadTab];
  __shared__ int hdr_index[kMaxBlocks];
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(16) float stage[];  // sb * spb words, the lead and the tail

  const int slot0 = blockIdx.x * sb;
  const int n = min(sb, ncap - slot0);
  const int total = n * spb;
  // the audio index of the span's sample 0, and the span's part in the chunk
  const int64_t a_lo = static_cast<int64_t>(slot0) * spb - carry_len;
  const int64_t c_lo = a_lo > 0 ? a_lo : 0, c_hi = a_lo + total < F ? a_lo + total : F;
  const float* row = audio + c * F;
  // The copy: [c_lo, c_hi) widened to 16-byte boundaries (m samples before,
  // at most 3 after), to words d + lead.. with d + lead a multiple of 4, then
  // cut to the 16-byte words that lie wholly in the tensor, so that it reads
  // nothing outside it: it brings the row's samples [k_lo, k_hi), and the at
  // most 3 of the chunk at either end of the tensor that the cut leaves out
  // are read directly.
  int lead = 0;
  int64_t k_lo = c_hi, k_hi = c_hi;
  uint32_t bytes = 0;
  if (c_lo < c_hi) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(row + c_lo);
    const uintptr_t g_lo = lo & ~uintptr_t(15);
    const uintptr_t g_hi = (reinterpret_cast<uintptr_t>(row + c_hi) + 15) & ~uintptr_t(15);
    const uintptr_t t_lo = (reinterpret_cast<uintptr_t>(audio) + 15) & ~uintptr_t(15);
    const uintptr_t t_hi = reinterpret_cast<uintptr_t>(audio + C * F) & ~uintptr_t(15);
    const uintptr_t b_lo = g_lo > t_lo ? g_lo : t_lo, b_hi = g_hi < t_hi ? g_hi : t_hi;
    const int m = static_cast<int>((lo - g_lo) / 4);
    const int d = static_cast<int>(c_lo - m - a_lo);  // >= -3
    lead = (-d) & 3;
    if (b_lo < b_hi) {
      bytes = static_cast<uint32_t>(b_hi - b_lo);
      const int cut = static_cast<int>((b_lo - g_lo) / 4);
      k_lo = c_lo - m + cut;
      k_hi = k_lo + bytes / 4;
      if (tid == 0) {
        const uint32_t b = smem_addr(&bar);
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                     "r"(bytes)
                     : "memory");
        const uint32_t dst = smem_addr(stage + d + lead + cut);
        for (uint32_t off = 0; off < bytes; off += kCopyBytes) {
          const uint32_t len = min(bytes - off, static_cast<uint32_t>(kCopyBytes));
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
              "%2, [%3];\n" ::"r"(dst + off),
              "l"(b_lo + off), "r"(len), "r"(b)
              : "memory");
        }
      }
    }
  }
  fill_tab(tab);
  __syncthreads();  // the barrier's init before any thread waits on it
  if (bytes) {
    const uint32_t b = smem_addr(&bar);
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b), "r"(0u)
          : "memory");
  }
  // The span's words become int16 samples in place (int bits in the f32
  // words): in the chunk the quantized audio; outside it (after the copy,
  // whose widened edges may cover them) the carry's samples or 0.
  const int in_lo = static_cast<int>(c_lo - a_lo < total ? c_lo - a_lo : total);
  const int in_hi = c_hi > c_lo ? static_cast<int>(c_hi - a_lo) : in_lo;
  const int cp_lo = static_cast<int>(k_lo - a_lo), cp_hi = static_cast<int>(k_hi - a_lo);
  float* const xw = stage + lead;
#pragma unroll 4
  for (int i = in_lo + tid; i < in_hi; i += kThreads)
    xw[i] = __int_as_float(quantize(i >= cp_lo && i < cp_hi ? xw[i] : row[a_lo + i]));
  const int64_t j0 = static_cast<int64_t>(slot0) * spb;
  for (int i = tid; i < in_lo; i += kThreads)
    xw[i] = __int_as_float(edge_sample(carry, c, spb, j0 + i));
  for (int i = in_hi + tid; i < total; i += kThreads)
    xw[i] = __int_as_float(edge_sample(carry, c, spb, j0 + i));
  __syncthreads();

  const int nm1 = spb - 1;
  // 1. the header index: a warp a block, each lane a share of the |diff|s
  //    and of the 89 compares, reduced over the warp
  {
    const int b = tid / kHeaderLanes, part = tid % kHeaderLanes;
    uint32_t sad = 0;
    if (b < n) {  // lanes on consecutive t: no bank conflicts
      const float* xs = xw + b * spb;
#pragma unroll 4
      for (int t = 1 + part; t < spb; t += kHeaderLanes)
        sad += static_cast<uint32_t>(abs(__float_as_int(xs[t]) - __float_as_int(xs[t - 1])));
    }
    const int index = header_index(sad, part, nm1, tab);
    if (b < n && part == 0) hdr_index[b] = index;
  }
  __syncthreads();
  if (tid >= n) return;

  // 2. one thread a block: the spb-1 steps, eight a word (ima_word)
  const float* xs = xw + tid * spb;
  int index = hdr_index[tid];
  int pred = __float_as_int(xs[0]);
  int step = tab[index + 1] >> 8;
  const int block_align = C * (4 + nm1 / 2);
  uint8_t* out_row = blocks + static_cast<int64_t>(slot0 + tid) * block_align;
  reinterpret_cast<uint32_t*>(out_row)[c] =
      (static_cast<uint32_t>(pred) & 0xFFFFu) | (static_cast<uint32_t>(index) << 16);
  uint32_t* words = reinterpret_cast<uint32_t*>(out_row + 4 * C);
  const int* xi = reinterpret_cast<const int*>(xs) + 1;  // the int bits of the words
  for (int w = 0; w < nm1 / 8; ++w)
    words[w * C + c] = ima_word(xi + 8 * w, pred, index, step, tab);
}

// The streamed path: a warp a block slot, the block read straight from the
// chunk (no stage), its steps tile by tile through shared memory.
__global__ void __launch_bounds__(kHeaderLanes) ima_encode_streamed_kernel(
    const float* __restrict__ audio, const int16_t* __restrict__ carry, int64_t F, int spb,
    int carry_len, uint8_t* __restrict__ blocks, int16_t* __restrict__ new_carry) {
  const int c = blockIdx.y, C = gridDim.y;
  if (blockIdx.x == gridDim.x - 1) {
    write_carry(audio, carry, c, F, spb, carry_len, new_carry);
    return;
  }
  __shared__ int tab[kPadTab];
  __shared__ int xs[kLongTile];
  fill_tab(tab);
  __syncwarp();
  const int lane = threadIdx.x;
  const int slot = blockIdx.x;
  const int64_t j0 = static_cast<int64_t>(slot) * spb;  // stream index of sample 0
  const int64_t a_lo = j0 - carry_len;
  const float* row = audio + c * F;
  auto sample = [&](int64_t i) {  // sample i of the block, as an int16 value
    const int64_t a = a_lo + i;
    return a >= 0 && a < F ? quantize(row[a]) : edge_sample(carry, c, spb, j0 + i);
  };
  const int nm1 = spb - 1;
  unsigned long long sad = 0;
  for (int64_t t = 1 + lane; t < spb; t += kHeaderLanes)
    sad += static_cast<unsigned long long>(abs(sample(t) - sample(t - 1)));
  int index = header_index(sad, lane, nm1, tab);
  int pred = sample(0);
  int step = tab[index + 1] >> 8;
  const int block_align = C * (4 + nm1 / 2);
  uint8_t* out_row = blocks + static_cast<int64_t>(slot) * block_align;
  if (lane == 0)
    reinterpret_cast<uint32_t*>(out_row)[c] =
        (static_cast<uint32_t>(pred) & 0xFFFFu) | (static_cast<uint32_t>(index) << 16);
  uint32_t* words = reinterpret_cast<uint32_t*>(out_row + 4 * C);
  for (int t0 = 1; t0 < spb; t0 += kLongTile) {
    const int n = min(kLongTile, spb - t0);  // a multiple of 8
    __syncwarp();  // lane 0 is done with the last tile
    for (int i = lane; i < n; i += kHeaderLanes) xs[i] = sample(t0 + i);
    __syncwarp();
    if (lane == 0)
      for (int w = 0; w < n / 8; ++w)
        words[((t0 - 1) / 8 + w) * C + c] = ima_word(xs + 8 * w, pred, index, step, tab);
  }
}

}  // namespace

// The geometry is ops/wire.ima_chunk_plan's: sb blocks a thread block
// (1..16), `tiles` thread blocks a channel (the last writes the new carry
// row), `smem` bytes of stage (sb * spb samples and the copy's lead and
// tail words); `streamed` takes the streamed path (sb 1, no stage).
GA_EXPORT int ga_ima_chunk_encode(const float* audio, const int16_t* carry, int C, int64_t F,
                                  int spb, int carry_len, int ncap, int sb, int tiles, int smem,
                                  int streamed, uint8_t* blocks, int16_t* new_carry,
                                  void* stream) {
  if (sb < 1 || sb > kMaxBlocks || static_cast<int64_t>(tiles - 1) * sb < ncap || spb < 9 ||
      (spb - 1) % 8 || carry_len < 0 || carry_len >= spb || (streamed && (sb != 1 || smem)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (streamed) {
    ima_encode_streamed_kernel<<<dim3(tiles, C), kHeaderLanes, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        audio, carry, F, spb, carry_len, blocks, new_carry);
    return ga_launch_status();
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ima_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ima_encode_kernel<<<dim3(tiles, C), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, carry, C, F, spb, carry_len, ncap, sb, blocks, new_carry);
  return ga_launch_status();
}
