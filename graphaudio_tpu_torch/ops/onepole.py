"""Static-coefficient one-pole lowpass and the panner's band split (K9).

The port of graphaudio_tpu/ops/onepole.py, and of the 3-band combine that
the spatial panner builds on it (graphaudio_tpu/nodes/spatial.py:350-367,
:380-386). A first-order recurrence y[n] = a*y[n-1] + (1-a)*x[n] with a
constant coefficient has the closed form

    y[n] = a^(n+1) * y_in + sum_{k<=n} a^(n-k) * (1-a) * x[k]

so one 128-frame block is a lower-triangular decay matrix and the block to
block carry a tiny matrix over the superblock axis. The JAX package writes
both as matmuls (``_matrices`` :33, ``onepole_lowpass`` :62); the plain
version here does the same in torch.

The CUDA kernel (csrc/onepole.cu, ``ga_onepole_split``) runs the
recurrence as a chunked two-level scan in f64, 16 samples a thread, one
block per (voice, channel) row. ``band_split`` launches it once for both
crossovers and the band combine, ``onepole_lowpass`` for one pole alone.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.utils import cudabuild

_matrix_cache = {}

#: Samples a kernel thread owns (csrc/onepole.cu kChunk).
CHUNK = 16


def _matrices(a: float, S: int):
    """Per-block decay matrix and carry weights for coefficient ``a``
    (the JAX package's ``_matrices``, copied).

    Returns M f32[128, 128] (M[n, k] = a^(n-k)*(1-a), k <= n), apow f32[128]
    (a^(n+1)), pows f32[S] ((a^128)^b) and W f32[S, S] (W[b, j] =
    (a^128)^(b-1-j), j < b).
    """
    key = (float(a), int(S))
    got = _matrix_cache.get(key)
    if got is not None:
        return got
    n = np.arange(FRAMES_PER_BLOCK)
    d = n[:, None] - n[None, :]
    M = np.where(d >= 0, np.exp(d * np.log(a)) * (1.0 - a), 0.0).astype(np.float32)
    apow = (a ** (n + 1.0)).astype(np.float32)
    a128 = float(a) ** FRAMES_PER_BLOCK
    b = np.arange(S)
    pows = (a128 ** b).astype(np.float32)
    e = b[:, None] - 1 - b[None, :]
    W = np.where(e >= 0, a128 ** np.maximum(e, 0), 0.0).astype(np.float32)
    got = (M, apow, pows, W)
    _matrix_cache[key] = got
    return got


def onepole_lowpass_plain(x, a: float, y0):
    """Plain torch K9: x f32[..., T] (T a multiple of 128), y0 f32[...]
    (y at sample -1). Returns (y f32[..., T], carry f32[...])."""
    T = x.shape[-1]
    S = T // FRAMES_PER_BLOCK
    lead = x.shape[:-1]
    xb = x.reshape(lead + (S, FRAMES_PER_BLOCK))
    M, apow, pows, W = (torch.from_numpy(m).to(x.device) for m in _matrices(a, S))
    part = torch.einsum("nk,...sk->...sn", M, xb)
    last = part[..., -1]  # [..., S] block tails ignoring the carry
    carry = pows * y0[..., None] + torch.einsum("bj,...j->...b", W, last)
    y = part + apow * carry[..., None]
    return y.reshape(lead + (T,)), y[..., -1, -1]


def _chunk_power(a: float) -> float:
    """a^16 in f64, the kernel's chunk multiplier."""
    return float(a) ** CHUNK


def _check_rows(x, y0, name):
    """The kernel's checks on x f32[..., T] and a carry f32[...]: returns
    (rows, T)."""
    T = x.shape[-1]
    if T % FRAMES_PER_BLOCK or not 1 <= T // FRAMES_PER_BLOCK <= 1024:
        raise ValueError(f"T must be a multiple of 128 with 1 to 1024 blocks, got {T}")
    cudabuild.require(x, "x", torch.float32)
    cudabuild.require(y0, name, torch.float32, shape=x.shape[:-1])
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel loads float4s)")
    return int(np.prod(x.shape[:-1], dtype=np.int64)), T


def onepole_lowpass(x, a: float, y0):
    """K9 for one pole: the lowpass over ``x`` with static pole ``a``
    (0 < a < 1) from carry-in ``y0``. CPU tensors take the plain version;
    CUDA tensors launch csrc/onepole.cu in its one-pole mode. Returns
    (y f32[..., T], carry f32[...])."""
    if x.device.type == "cpu":
        return onepole_lowpass_plain(x, a, y0)
    x, y0 = x.contiguous(), y0.contiguous()
    rows, T = _check_rows(x, y0, "y0")
    y = torch.empty_like(x)
    carry = torch.empty_like(y0)
    status = cudabuild.launcher("ga_onepole_split")(
        x.data_ptr(), y0.data_ptr(), None, float(a), _chunk_power(a), 0.0, 0.0, None, None,
        None, rows, 1, T, 0, y.data_ptr(), carry.data_ptr(), None, cudabuild.stream_of(x))
    cudabuild.check(status, "ga_onepole_split")
    cudabuild.launches["onepole_lowpass"] += 1
    return y, carry


def band_combine_plain(x, low, lowmid, gl, gm, gh):
    """The panner's 3-band combine: ``low * gl + (lowmid - low) * gm +
    (x - lowmid) * gh`` with the gains f32[V, S] held over each quantum of
    x f32[V, C, T] (the JAX package's ``(low*gl + mid*gm) + high*gh``)."""

    def expand(g):  # [V, S] -> [V, 1, T]
        return torch.repeat_interleave(g, FRAMES_PER_BLOCK, dim=-1)[:, None, :]

    return low * expand(gl) + (lowmid - low) * expand(gm) + (x - lowmid) * expand(gh)


def band_split_plain(x, a_low, a_high, y0_low, y0_high, gl, gm, gh):
    """Plain torch band split: the two crossovers (``onepole_lowpass_plain``
    at poles ``a_low``, ``a_high`` from carry-ins ``y0_low``, ``y0_high``
    f32[V, C]) and ``band_combine_plain``. Returns (direct f32[V, C, T],
    new y0_low, new y0_high)."""
    low, xlow = onepole_lowpass_plain(x, a_low, y0_low)
    lowmid, xhigh = onepole_lowpass_plain(x, a_high, y0_high)
    return band_combine_plain(x, low, lowmid, gl, gm, gh), xlow, xhigh


def band_split(x, a_low, a_high, y0_low, y0_high, gl, gm, gh):
    """K9: the occluded panner's band split of x f32[V, C, T] (T a multiple
    of 128, at most 1024 quanta) with the band gains gl, gm, gh f32[V, S].
    CPU tensors take ``band_split_plain``; CUDA tensors launch
    csrc/onepole.cu once for both crossovers and the combine. Returns
    (direct f32[V, C, T], new y0_low, new y0_high)."""
    if x.device.type == "cpu":
        return band_split_plain(x, a_low, a_high, y0_low, y0_high, gl, gm, gh)
    if x.dim() != 3:
        raise ValueError(f"x must be [V, C, T], got shape {tuple(x.shape)}")
    x, y0_low, y0_high = x.contiguous(), y0_low.contiguous(), y0_high.contiguous()
    gl, gm, gh = gl.contiguous(), gm.contiguous(), gh.contiguous()
    rows, T = _check_rows(x, y0_low, "y0_low")
    cudabuild.require(y0_high, "y0_high", torch.float32, shape=x.shape[:-1])
    for g, name in ((gl, "gl"), (gm, "gm"), (gh, "gh")):
        cudabuild.require(g, name, torch.float32, shape=(x.shape[0], T // FRAMES_PER_BLOCK))
    direct = torch.empty_like(x)
    xlow, xhigh = torch.empty_like(y0_low), torch.empty_like(y0_high)
    status = cudabuild.launcher("ga_onepole_split")(
        x.data_ptr(), y0_low.data_ptr(), y0_high.data_ptr(), float(a_low), _chunk_power(a_low),
        float(a_high), _chunk_power(a_high), gl.data_ptr(), gm.data_ptr(), gh.data_ptr(), rows,
        x.shape[1], T, 1, direct.data_ptr(), xlow.data_ptr(), xhigh.data_ptr(),
        cudabuild.stream_of(x))
    cudabuild.check(status, "ga_onepole_split")
    cudabuild.launches["band_split"] += 1
    return direct, xlow, xhigh
