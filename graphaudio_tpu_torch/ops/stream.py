"""K15: the stream node's read of its per-call feed.

The decoder stream node (io/stream.py) stages a feed f32[C, N] of upcoming
source samples at each render call. The JAX package reads each step's
superblock of T = S*128 frames from it inside its jitted step
(graphaudio_tpu/io/stream.py:304-325), not in a Pallas kernel. Every input
of that read is fixed once the call starts (the feed, the stage's x0 and
rate, the mode), so the port reads all of a call's steps at once, before
the step loop: ``stream_feed_call`` launches csrc/stream.cu once on a CUDA
feed and ``stream_feed_call_plain`` is its plain version. Row k of the
result is step k's output, frames ``j = k*T + i`` of the call:

* unity (the source at the context rate, playbackRate untouched):
  ``out[k, c, i] = feed[c, j]``;
* resample: quantum q = j // 128 starts at the f64 position
  ``x0 + (128 q) * rate``, expanded per sample by ``split_positions`` and
  interpolated over four taps clamped to ``[0, N - 1]`` (``N`` the padded
  feed length: taps past the data read the padding's zeros).

x0 and rate are host f64 values (the stage's state, set once a call by
``prepare_feed``). ``stream_feed_plain`` is one step's read, the JAX
node's per-step form, kept as the yardstick the tests stack.

Rounding, as XLA compiles the stream node's ``process`` (measured against
the jitted JAX node on the CPU): the block positions are one f64 fma
(``block_positions``), the anchors and the in-chunk offsets are rounded
product by product (``split_positions(..., contract=False)``), and of the
Catmull-Rom polynomial's multiply-adds three are single fmas
(``catmull_rom_stream``). A quantum's position is the same double whether
it is read in its step or in its call: ``128 q`` is an exact integer.
"""

from __future__ import annotations

import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.ops import xla_rounding
from graphaudio_tpu_torch.ops.resample import gather_resample, split_positions
from graphaudio_tpu_torch.utils import cudabuild


def catmull_rom_stream(s0, s1, s2, s3, t):
    """The reference's cubic kernel (CubicResampler.cs:52-57) as XLA
    rounds it in the stream node: with B = fma(-2.5, s1, s0) + 2 s2 -
    0.5 s3 and C = 0.5 (s3 - s0) + 1.5 (s1 - s2), Y = fma(t, C, B),
    X = 0.5 (s2 - s0) + t Y (rounded apart) and out = fma(t, X, s1)."""
    fma = xla_rounding.fma
    t = t.to(torch.float32)
    c = 0.5 * (s3 - s0) + 1.5 * (s1 - s2)
    b = fma(torch.full_like(s1, -2.5), s1, s0) + 2.0 * s2 - 0.5 * s3
    x = 0.5 * (s2 - s0) + t * fma(t, c, b)
    return fma(t, x, s1)


def block_positions(x0, rate, j0: int, S: int):
    """f64[S]: the first position of each of S quanta from frame j0,
    ``x0 + (j0 + 128 s) * rate``, one fma (XLA contracts it). x0 and rate
    are f64 0-d tensors."""
    blk = j0 + torch.arange(S, dtype=torch.float64, device=x0.device) * FRAMES_PER_BLOCK
    return xla_rounding.fma64(blk, rate.expand(S), x0.expand(S))


def _resample(feed, j0: int, Q: int, x0, rate):
    """f32[C, Q*128]: the resample mode over Q quanta from frame j0."""
    xb = block_positions(x0, rate, j0, Q)
    base, frac = split_positions(xb, rate.expand(Q), FRAMES_PER_BLOCK, contract=False)
    n = feed.shape[1]
    return gather_resample(feed, base, frac, False, 0, n, n, length=n,
                           interp=catmull_rom_stream).reshape(feed.shape[0], Q * FRAMES_PER_BLOCK)


def stream_feed_plain(feed, j0: int, S: int, x0=None, rate=None):
    """One step's read, the JAX node's form. feed f32[C, N]; j0 the step's
    first frame in the feed; x0 and rate (f64 0-d tensors) select the
    resample mode, None the unity copy. Returns a fresh contiguous
    f32[C, S*128]."""
    if x0 is None:
        return feed[:, j0:j0 + S * FRAMES_PER_BLOCK].clone()
    return _resample(feed, j0, S, x0, rate)


def stream_feed_call_plain(feed, n_steps: int, S: int, x0=None, rate=None):
    """Plain torch K15: a render call's read. feed f32[C, N]; x0 and rate
    (host floats) select the resample mode, None the unity copy. Returns a
    fresh contiguous f32[n_steps, C, S*128] whose row k is
    ``stream_feed_plain(feed, k*S*128, S, x0, rate)``."""
    C = feed.shape[0]
    T = S * FRAMES_PER_BLOCK
    if x0 is None:
        flat = feed[:, :n_steps * T]
    else:
        f64 = dict(dtype=torch.float64, device=feed.device)
        flat = _resample(feed, 0, n_steps * S, torch.tensor(x0, **f64), torch.tensor(rate, **f64))
    return flat.reshape(C, n_steps, T).transpose(0, 1).contiguous()


def stream_feed_call(feed, n_steps: int, S: int, x0=None, rate=None):
    """K15: one launch of csrc/stream.cu over the whole call on CUDA
    tensors, counted as ``stream_feed`` and by its mode
    (``stream_feed/resample`` or ``stream_feed/unity``); the plain version
    on CPU tensors. Arguments and result as ``stream_feed_call_plain``; on
    the card the feed is also 16-byte aligned with N % 4 == 0 (the
    kernel's vector loads), as every staged feed is."""
    if feed.device.type == "cpu":
        return stream_feed_call_plain(feed, n_steps, S, x0, rate)
    cudabuild.require(feed, "feed", torch.float32, ndim=2)
    C, n = feed.shape
    T = S * FRAMES_PER_BLOCK
    resample = x0 is not None
    if n_steps < 1 or S < 1:
        raise ValueError(f"a call reads at least one step of one quantum, not {n_steps} x {S}")
    if n_steps * T >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"{n_steps} steps of {T} frames from a feed of {n} outgrow the "
                         "kernel's 32-bit indices")
    if resample and not (0 < rate < 2 ** 19 and 0 <= x0 + n_steps * T * rate < 2 ** 31 - 4):
        raise ValueError(f"rate {rate} from {x0} over {n_steps * T} frames is outside the "
                         "kernel's range (in-chunk offsets below 2^23, positions below 2^31)")
    if not resample and n < n_steps * T:
        raise ValueError(f"{n_steps} steps of {T} frames outrun the feed of {n}")
    if n % 4 or feed.data_ptr() % 16:
        raise ValueError(f"the feed's rows must be 16-byte aligned (N = {n})")
    out = torch.empty((n_steps, C, T), dtype=torch.float32, device=feed.device)
    status = cudabuild.launcher("ga_stream_feed_call")(
        feed.data_ptr(), C, n, n_steps, S, float(x0) if resample else 0.0,
        float(rate) if resample else 1.0, int(resample), out.data_ptr(),
        cudabuild.stream_of(feed))
    cudabuild.check(status, "ga_stream_feed_call")
    cudabuild.launches["stream_feed"] += 1
    cudabuild.launches["stream_feed/resample" if resample else "stream_feed/unity"] += 1
    return out
