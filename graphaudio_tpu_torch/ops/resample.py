"""Catmull-Rom resampling: host tables and the polyphase kernel (K1).

The reference's ``CubicResampler`` (GraphAudio.Core/CubicResampler.cs:19)
interpolates each output from a 4-sample window with a Catmull-Rom
polynomial. For a constant rational rate p/q the position stream
x_j = x_0 + j*p/q lives on the 1/q grid, so the tap weights cycle with
period q. ``poly_matrix`` (numpy, copied from the JAX package) bakes them,
computed in f64 and rounded once to f32; ``poly_taps`` compacts it to the
four weights and base offset per phase that the kernel reads.

``poly_resample`` is K1: it evaluates every output sample of a voice group
straight from the packed sample arena (csrc/poly_resample.cu on a CUDA
tensor, plain torch gathers on a CPU tensor). The f64 per-voice
bookkeeping that feeds it lives in nodes/sources.process_poly_group.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.utils import cudabuild


def cr_weights(t):
    """Catmull-Rom tap weights (w0..w3) for fraction t (f32 tensor).

    Expansion of the reference polynomial (CubicResampler.cs:52-57) in terms
    of the four taps.
    """
    t = t.to(torch.float32)
    w0 = t * (-0.5 + t * (1.0 - 0.5 * t))
    w1 = 1.0 + t * t * (-2.5 + 1.5 * t)
    w2 = t * (0.5 + t * (2.0 - 1.5 * t))
    w3 = t * t * (-0.5 + 0.5 * t)
    return w0, w1, w2, w3


def poly_matrix(p: int, q: int) -> np.ndarray:
    """Static polyphase Catmull-Rom matrix for a constant rational rate p/q.

    Output j' = n*q + r of the canonical (phase-0) stream interpolates at
    (j'*p)/q:  out[n*q + r] = sum_m window[n*p + m] * H[m, r], where H[m, r]
    holds the 4 tap weights of phase r at rows base_r + k
    (base_r = (r*p)//q, taps at floor(x)-1..+2).

    Returns f32[p+4, q].
    """
    r = np.arange(q, dtype=np.int64)
    t = ((r * p) % q).astype(np.float64) / q
    base = (r * p) // q
    # Catmull-Rom tap weights (same expansion as cr_weights, in numpy f64).
    w0 = t * (-0.5 + t * (1.0 - 0.5 * t))
    w1 = 1.0 + t * t * (-2.5 + 1.5 * t)
    w2 = t * (0.5 + t * (2.0 - 1.5 * t))
    w3 = t * t * (-0.5 + 0.5 * t)
    H = np.zeros((p + 4, q), np.float32)
    for k, wk in enumerate((w0, w1, w2, w3)):
        H[base + k, r] = wk.astype(np.float32)
    return H


def poly_taps(p: int, q: int):
    """(wtab f32[q, 4], btab i32[q]): the nonzero entries of poly_matrix per
    phase r — weight k sits at window offset btab[r] + k."""
    H = poly_matrix(p, q)
    r = np.arange(q, dtype=np.int64)
    base = (r * p) // q
    wtab = np.stack([H[base + k, r] for k in range(4)], axis=1)
    return np.ascontiguousarray(wtab, np.float32), base.astype(np.int32)


def poly_resample_plain(arena, win_start, j0, bidx, blk_ok, jlim, looping,
                        wtab, btab, p: int, q: int):
    """Plain torch K1. Shapes: arena f32[C, W]; win_start i64[V]; j0 i32[V];
    bidx i32[V, S]; blk_ok bool[V, S]; jlim f32[V]; looping bool[V];
    wtab f32[q, 4]; btab i32[q]. Returns f32[V, C, S*128]."""
    V, S = bidx.shape
    C = arena.shape[0]
    i = torch.arange(FRAMES_PER_BLOCK, device=arena.device, dtype=torch.int64)
    jpos = bidx.to(torch.int64)[:, :, None] * FRAMES_PER_BLOCK + i  # [V, S, 128]
    k = j0.to(torch.int64)[:, None, None] + jpos
    n = torch.div(k, q, rounding_mode="floor")
    r = k - n * q
    base = win_start[:, None, None] + n * p + btab.to(torch.int64)[r]  # [V, S, 128]
    w = wtab[r]  # [V, S, 128, 4]
    y = None
    for tap in range(4):
        s = arena[:, (base + tap).reshape(-1)].reshape(C, V, S, FRAMES_PER_BLOCK)
        term = w[..., tap] * s
        y = term if y is None else y + term  # [C, V, S, 128]
    ok = blk_ok[:, :, None] & (
        looping[:, None, None] | (jpos.to(torch.float32) < jlim[:, None, None])
    )
    y = torch.where(ok[None], y, torch.zeros((), dtype=y.dtype, device=y.device))
    return y.permute(1, 0, 2, 3).reshape(V, C, S * FRAMES_PER_BLOCK)


def poly_resample(arena, win_start, j0, bidx, blk_ok, jlim, looping,
                  wtab, btab, p: int, q: int):
    """K1: the polyphase outputs of a voice group, f32[V, C, S*128].

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Window reads stay inside the arena by construction: the caller clips
    each window start to its voice's region (process_poly_group).
    """
    if arena.device.type == "cpu":
        return poly_resample_plain(arena, win_start, j0, bidx, blk_ok, jlim,
                                   looping, wtab, btab, p, q)
    V, S = bidx.shape
    C, W = arena.shape
    req = cudabuild.require
    req(arena, "arena", torch.float32, ndim=2)
    req(win_start, "win_start", torch.int64, shape=(V,))
    req(j0, "j0", torch.int32, shape=(V,))
    req(bidx, "bidx", torch.int32, shape=(V, S))
    req(blk_ok, "blk_ok", torch.bool, shape=(V, S))
    req(jlim, "jlim", torch.float32, shape=(V,))
    req(looping, "looping", torch.bool, shape=(V,))
    req(wtab, "wtab", torch.float32, shape=(q, 4))
    req(btab, "btab", torch.int32, shape=(q,))
    out = torch.empty((V, C, S * FRAMES_PER_BLOCK), dtype=torch.float32,
                      device=arena.device)
    lib = cudabuild.load()
    # bool tensors are one byte per element: passed as uint8 pointers.
    status = lib.ga_poly_resample(
        arena.data_ptr(), W, C, V, S, win_start.data_ptr(), j0.data_ptr(),
        bidx.data_ptr(), blk_ok.data_ptr(), jlim.data_ptr(), looping.data_ptr(),
        wtab.data_ptr(), btab.data_ptr(), p, q, out.data_ptr(),
        cudabuild.stream_of(arena),
    )
    cudabuild.check(status, "ga_poly_resample")
    cudabuild.launches["poly_resample"] += 1
    return out
