"""Static-coefficient one-pole lowpass (K9).

The port of graphaudio_tpu/ops/onepole.py. A first-order recurrence
y[n] = a*y[n-1] + (1-a)*x[n] with a constant coefficient has the closed form

    y[n] = a^(n+1) * y_in + sum_{k<=n} a^(n-k) * (1-a) * x[k]

so one 128-frame block is a lower-triangular decay matrix and the block to
block carry a tiny matrix over the superblock axis. The JAX package writes
both as matmuls (``_matrices`` :33, ``onepole_lowpass`` :62); the plain
version here does the same in torch. The CUDA kernel (csrc/onepole.cu) runs
the blocked form one thread per (row, 128-frame block): the within-block
recurrence, a carry pass over the S blocks, then the block again from its
carry (its part plus ``a^(n+1) * carry``), in f64. It serves the spatial
panner's occlusion band split (two crossovers).
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.utils import cudabuild

_matrix_cache = {}


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


def onepole_lowpass(x, a: float, y0):
    """K9: the one-pole lowpass over ``x`` with static pole ``a`` (0 < a < 1)
    from carry-in ``y0``. CPU tensors take the plain version; CUDA tensors
    launch csrc/onepole.cu. Returns (y f32[..., T], carry f32[...])."""
    if x.device.type == "cpu":
        return onepole_lowpass_plain(x, a, y0)
    T = x.shape[-1]
    S = T // FRAMES_PER_BLOCK
    if T % FRAMES_PER_BLOCK or S > 1024:
        raise ValueError(f"T must be a multiple of 128 with at most 1024 blocks, got {T}")
    rows = int(np.prod(x.shape[:-1], dtype=np.int64))
    x = x.contiguous()
    y0 = y0.contiguous()
    cudabuild.require(x, "x", torch.float32)
    cudabuild.require(y0, "y0", torch.float32, shape=x.shape[:-1])
    y = torch.empty_like(x)
    carry = torch.empty_like(y0)
    status = cudabuild.load().ga_onepole(
        x.data_ptr(), y0.data_ptr(), float(a), rows, S, y.data_ptr(), carry.data_ptr(),
        cudabuild.stream_of(x))
    cudabuild.check(status, "ga_onepole")
    cudabuild.launches["onepole_lowpass"] += 1
    return y, carry
