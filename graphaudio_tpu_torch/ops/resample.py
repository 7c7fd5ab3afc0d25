"""Catmull-Rom resampling: host tables and the polyphase kernel (K1).

The reference's ``CubicResampler`` (GraphAudio.Core/CubicResampler.cs:19)
interpolates each output from a 4-sample window with a Catmull-Rom
polynomial. For a constant rational rate p/q the position stream
x_j = x_0 + j*p/q lives on the 1/q grid, so the tap weights cycle with
period q. ``poly_matrix`` (numpy, copied from the JAX package) bakes them,
computed in f64 and rounded once to f32; ``poly_taps`` compacts it to the
four weights and base offset per phase that the kernel reads.

K1 is one whole step of a polyphase voice group: the f64 per-voice
bookkeeping (nodes/sources.AudioBufferSourceNode.poly_group_plan) and every
output sample read straight from the packed sample arena
(``poly_resample_plain``). ``poly_group_step`` launches it as one kernel on
the card (csrc/poly_resample.cu); on the CPU the plan and
``poly_resample_plain`` are the path.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.ops import voice_group
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
    """The gather of K1's plain version, in torch. Shapes: arena f32[C, W];
    win_start i64[V]; j0 i32[V]; bidx i32[V, S]; blk_ok bool[V, S];
    jlim f32[V]; looping bool[V]; wtab f32[q, 4]; btab i32[q]. Returns
    f32[V, C, S*128]."""
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


# The group's stacked [V] states the fused step reads, in the kernel's
# argument order, with their dtypes.
POLY_STATE_FIELDS = (("started", torch.int32), ("start_time", torch.float64),
                     ("stop_time", torch.float64), ("offset", torch.float64),
                     ("duration", torch.float64), ("pos", torch.float64),
                     ("x", torch.float64), ("primed", torch.int32))


def poly_group_step(states, arena, gtab, block_times, block_end_times, wtab, btab):
    """K1: one step of a polyphase voice group in one launch on the card
    (csrc/poly_resample.cu). Returns (x, primed, stop_time, out f32[V, C,
    S*128]); the new states are fresh tensors, x and stop_time two rows of
    one f64[2, V]. CUDA tensors only: the plain composition
    (AudioBufferSourceNode.poly_group_step_plain) is the CPU path.

    gtab is the group's packed geometry table
    (ops/voice_group.pack_group_table: f64[V + 1, GEOM_COLS], the last
    row the group constants p, q, ...); wtab f32[q, 4] and btab i32[q] from
    ``poly_taps``.
    """
    V, S = voice_group.check_group_inputs(states, POLY_STATE_FIELDS, arena, gtab,
                                          block_times, block_end_times)
    C, W = arena.shape
    q = btab.shape[0]
    if not (wtab.is_cuda and wtab.dtype == torch.float32 and wtab.is_contiguous()
            and tuple(wtab.shape) == (q, 4) and btab.is_cuda and btab.dtype == torch.int32
            and btab.is_contiguous()):
        cudabuild.require(wtab, "wtab", torch.float32, shape=(q, 4))
        cudabuild.require(btab, "btab", torch.int32, ndim=1)
    out = arena.new_empty((V, C, S * FRAMES_PER_BLOCK))
    st_out = gtab.new_empty((2, V))
    primed = states["primed"].new_empty((V,))
    ptr = [states[name].data_ptr() for name, _ in POLY_STATE_FIELDS]
    status = cudabuild.launcher("ga_poly_group_step")(
        arena.data_ptr(), W, C, V, S, gtab.data_ptr(), *ptr, block_times.data_ptr(),
        block_end_times.data_ptr(), wtab.data_ptr(), btab.data_ptr(), out.data_ptr(),
        st_out.data_ptr(), primed.data_ptr(), cudabuild.stream_of(arena))
    if status:
        cudabuild.check(status, "ga_poly_group_step")
    cudabuild.launches["poly_group_step"] += 1
    return st_out[0], primed, st_out[1], out
