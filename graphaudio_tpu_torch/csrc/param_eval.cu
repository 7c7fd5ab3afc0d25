// K6: AudioParam automation-curve evaluation for one superblock.
//
// Replaces graphaudio_tpu/ops/param_eval.py eval_intrinsic_blocked
// (:175-336, the non-exact branch). The TPU version locates each sample's
// surrounding events with [S, n, cap] one-hot reductions (per-element
// gathers serialize there); here one thread per (lane, sample) counts the
// events at or before its f64 absolute time with a loop over the small
// padded capacity, then reads the prev/next fields directly.
//
// Arithmetic follows the plain version (ops/param_eval.py) operation for
// operation: f64 absolute times for the event index, f32 relative times for
// the curve, fma/fmaf where XLA contracts a multiply-add (ops/xla_rounding.py),
// __f*_rn elsewhere so nvcc does not contract on its own, and exp/pow in
// f64 rounded once to f32.
//
// Bound on the H100: the per-sample compare loop over cap events (cap = 16
// or 32 for the configs) and the launch; a superblock is at most a few
// thousand samples per lane.
#include "common.cuh"

namespace {

__global__ void param_eval_kernel(
    const double* __restrict__ times, const float* __restrict__ values,
    const double* __restrict__ tcs, const int32_t* __restrict__ types,
    const float* __restrict__ boundary, const int32_t* __restrict__ nev,
    const float* __restrict__ base, const double* __restrict__ block_times,
    int L, int cap, int S, int npb, double dt, float* __restrict__ out) {
  const int64_t per_lane = static_cast<int64_t>(S) * npb;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= per_lane * L) return;
  const int l = static_cast<int>(gid / per_lane);
  const int j = static_cast<int>(gid - static_cast<int64_t>(l) * per_lane);
  const int s = j / npb, i = j - s * npb;
  const double* tl = times + static_cast<int64_t>(l) * cap;
  const float* vl = values + static_cast<int64_t>(l) * cap;
  const int32_t* yl = types + static_cast<int64_t>(l) * cap;
  const int n = nev[l];
  const double bt = block_times[s];
  const double off = __dmul_rn(static_cast<double>(i), dt);
  const double t = fma(static_cast<double>(i), dt, bt);  // as XLA fuses it

  int idx = 0;
  for (int k = 0; k < cap; ++k) idx += (t >= tl[k]) ? 1 : 0;
  idx = min(idx, n);
  const int prev = max(idx - 1, 0);
  const int nxt = min(idx, cap - 1);
  const bool has_prev = idx > 0, has_next = idx < n;

  auto rel = [&](int k) {
    double d = __dsub_rn(tl[k], bt);
    d = fmin(fmax(d, -3.0e38), 3.0e38);
    return static_cast<float>(d);
  };
  const float io = static_cast<float>(off);
  const float t0r = rel(prev), t1r = rel(nxt);
  const float v0 = vl[prev], v1 = vl[nxt];

  const float denom = __fsub_rn(t1r, t0r);
  const float safe_denom = denom == 0.0f ? 1.0f : denom;
  const float u = fminf(fmaxf(__fdiv_rn(__fsub_rn(io, t0r), safe_denom), 0.0f), 1.0f);
  const float lin = fmaf(__fsub_rn(v1, v0), u, v0);

  float val;
  if (has_next && yl[nxt] == 1) {  // EVT_LINEAR_RAMP
    val = lin;
  } else if (has_next && yl[nxt] == 2) {  // EVT_EXPONENTIAL_RAMP
    if (v0 > 0.0f && v1 > 0.0f) {
      const float r = __fdiv_rn(v1, v0);
      val = __fmul_rn(v0, static_cast<float>(pow(static_cast<double>(r),
                                                 static_cast<double>(u))));
    } else {
      val = lin;
    }
  } else if (yl[prev] == 3) {  // EVT_SET_TARGET
    const float bl = boundary[static_cast<int64_t>(l) * (cap + 1) + min(idx, cap)];
    const float elapsed = __fsub_rn(io, t0r);
    if (elapsed <= 0.0f) {
      val = bl;
    } else {
      const float tc = fmaxf(static_cast<float>(tcs[static_cast<int64_t>(l) * cap + prev]),
                             0.001f);
      const float e = static_cast<float>(exp(static_cast<double>(__fdiv_rn(-elapsed, tc))));
      val = fmaf(__fsub_rn(bl, v0), e, v0);
    }
  } else {
    val = v0;
  }
  if (!(has_prev && n > 0)) val = base[l];
  out[gid] = val;
}

}  // namespace

GA_EXPORT int ga_param_eval(const double* times, const float* values, const double* tcs,
                            const int32_t* types, const float* boundary, const int32_t* nev,
                            const float* base, const double* block_times, int L, int cap,
                            int S, int npb, double dt, float* out, void* stream) {
  const int64_t total = static_cast<int64_t>(L) * S * npb;
  const int threads = 256;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  param_eval_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      times, values, tcs, types, boundary, nev, base, block_times, L, cap, S, npb, dt, out);
  return ga_launch_status();
}
