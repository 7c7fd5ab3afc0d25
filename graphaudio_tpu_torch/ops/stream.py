"""K15: the stream node's read of its per-call feed.

The decoder stream node (io/stream.py) stages a feed f32[C, N] of upcoming
source samples at each render call; every step then reads its superblock
of T = S*128 output frames from it. The JAX package computes this inside
its jitted step (graphaudio_tpu/io/stream.py:304-325), not in a Pallas
kernel; ``stream_feed`` launches csrc/stream.cu on CUDA tensors and
``stream_feed_plain`` is its plain version:

* unity (the source at the context rate, playbackRate untouched):
  ``out[c, i] = feed[c, j0 + i]``;
* resample: quantum s starts at the f64 position
  ``x0 + (j0 + 128 s) * rate``, expanded per sample by ``split_positions``
  and interpolated over four taps clamped to ``[0, N - 1]`` (``N`` the
  padded feed length: taps past the data read the padding's zeros).

j0 = frame0 - base is the step's first frame within the call (host ints);
x0 and rate are the stage's f64 state (0-d tensors on the feed's device).

Rounding, as XLA compiles the stream node's ``process`` (measured against
the jitted JAX node on the CPU): the block positions are one f64 fma
(``block_positions``), the anchors and the in-chunk offsets are rounded
product by product (``split_positions(..., contract=False)``), and of the
Catmull-Rom polynomial's multiply-adds three are single fmas
(``catmull_rom_stream``).
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
    """f64[S]: the first position of each quantum of the step,
    ``x0 + (j0 + 128 s) * rate``, one fma (XLA contracts it)."""
    blk = j0 + torch.arange(S, dtype=torch.float64, device=x0.device) * FRAMES_PER_BLOCK
    return xla_rounding.fma64(blk, rate.expand(S), x0.expand(S))


def stream_feed_plain(feed, j0: int, S: int, x0=None, rate=None):
    """Plain torch K15. feed f32[C, N]; j0 the step's first frame in the
    feed; x0 and rate (f64 0-d) select the resample mode, None the unity
    copy. Returns a fresh contiguous f32[C, S*128]."""
    T = S * FRAMES_PER_BLOCK
    if x0 is None:
        return feed[:, j0:j0 + T].clone()
    xb = block_positions(x0, rate, j0, S)
    base, frac = split_positions(xb, rate.expand(S), FRAMES_PER_BLOCK, contract=False)
    n = feed.shape[1]
    return gather_resample(feed, base, frac, False, 0, n, n, length=n,
                           interp=catmull_rom_stream).reshape(feed.shape[0], T)


def stream_feed(feed, j0: int, S: int, x0=None, rate=None):
    """K15: one launch of csrc/stream.cu, grid (S, C), on CUDA tensors,
    counted as ``stream_feed`` and by its mode (``stream_feed/resample`` or
    ``stream_feed/unity``); the plain version on CPU tensors. Arguments and
    result as ``stream_feed_plain``."""
    if feed.device.type == "cpu":
        return stream_feed_plain(feed, j0, S, x0, rate)
    cudabuild.require(feed, "feed", torch.float32, ndim=2)
    C, n = feed.shape
    T = S * FRAMES_PER_BLOCK
    resample = x0 is not None
    if resample:
        cudabuild.require(x0, "x0", torch.float64, shape=())
        cudabuild.require(rate, "rate", torch.float64, shape=())
    elif not 0 <= j0 <= n - T:
        raise ValueError(f"frames [{j0}, {j0 + T}) lie outside the feed of {n}")
    out = torch.empty((C, T), dtype=torch.float32, device=feed.device)
    status = cudabuild.launcher("ga_stream_feed")(
        feed.data_ptr(), C, n, j0, S,
        x0.data_ptr() if resample else None, rate.data_ptr() if resample else None,
        int(resample), out.data_ptr(), cudabuild.stream_of(feed))
    cudabuild.check(status, "ga_stream_feed")
    cudabuild.launches["stream_feed"] += 1
    cudabuild.launches["stream_feed/resample" if resample else "stream_feed/unity"] += 1
    return out
