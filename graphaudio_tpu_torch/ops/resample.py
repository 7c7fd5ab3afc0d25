"""Catmull-Rom resampling: host tables, the polyphase kernel (K1) and the
time-varying one (K7).

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

K7 is one whole step of a time-varying-rate voice group (per-quantum
rates, f64 positions): ``resample_group_step`` launches csrc/resample.cu;
its plain version is nodes/sources.AudioBufferSourceNode
.resample_group_step_plain, built from ``split_positions``,
``cr_weights_fma`` and the XLA-ordered sums here (``xla_cumsum``,
``xla_sum``). ``gather_resample`` is the reference's loop-wrapped gather,
the stream resampler's plain version (ops/stream.py).
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.ops import voice_group, xla_rounding
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


def cr_weights_fma(t):
    """``cr_weights`` as the jitted JAX package rounds it: XLA contracts
    each multiply-add into one fma, w0 = t*fma(t, fma(-0.5, t, 1), -0.5),
    w1 = fma(t*t, fma(1.5, t, -2.5), 1), w2 = t*fma(t, fma(-1.5, t, 2),
    0.5), w3 = (t*t)*fma(0.5, t, -0.5). K7 computes these (``fmaf``)."""
    t = t.to(torch.float32)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=t.device)  # noqa: E731
    fma = xla_rounding.fma
    tt = t * t
    w0 = t * fma(t, fma(f(-0.5), t, f(1.0)), f(-0.5))
    w1 = fma(tt, fma(f(1.5), t, f(-2.5)), f(1.0))
    w2 = t * fma(t, fma(f(-1.5), t, f(2.0)), f(0.5))
    w3 = tt * fma(f(0.5), t, f(-0.5))
    return w0, w1, w2, w3


def catmull_rom(s0, s1, s2, s3, t):
    """The reference's cubic kernel (CubicResampler.cs:52-57), float32, as
    the JAX package writes it (its multiply-adds left to the caller's
    rounding: plain torch ops here)."""
    t = t.to(torch.float32)
    return s1 + t * (
        0.5 * (s2 - s0)
        + t * ((s0 - 2.5 * s1 + 2.0 * s2 - 0.5 * s3) + t * (0.5 * (s3 - s0) + 1.5 * (s1 - s2)))
    )


#: Samples between two f64 anchors of ``split_positions``.
SUB_CHUNK = 16


def xla_cumsum(x, dim=-1):
    """Inclusive cumulative sum along ``dim`` in the order XLA's CPU
    backend sums a ``jnp.cumsum``: sequential runs of 16, then each run
    plus the sequential sum of the runs before it."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    out, carry = [], torch.zeros_like(x[..., :1])
    for r0 in range(0, n, 16):
        acc, part = None, []
        for i in range(r0, min(n, r0 + 16)):
            acc = x[..., i:i + 1] if acc is None else acc + x[..., i:i + 1]
            part.append(acc)
        out.append(torch.cat(part, dim=-1) + carry)
        carry = carry + acc
    return torch.cat(out, dim=-1).movedim(-1, dim)


def xla_sum(x, dim=-1):
    """Sum along ``dim`` in the order XLA's CPU backend reduces an f64
    ``jnp.sum`` of up to 32 elements, or of a multiple of 32: sequential
    runs of 32, then the runs' sums in order (other lengths may differ
    from XLA in the last bit)."""
    x = x.movedim(dim, -1)
    total = None
    for r0 in range(0, x.shape[-1], 32):
        acc = x[..., r0]
        for i in range(r0 + 1, min(x.shape[-1], r0 + 32)):
            acc = acc + x[..., i]
        total = acc if total is None else total + acc
    return total


def split_positions(xb, rate_b, frames_per_block: int = FRAMES_PER_BLOCK, contract=True):
    """Per-block f64 positions expanded to per-sample (i32 base, f32 frac),
    the JAX package's ``split_positions`` (graphaudio_tpu/ops/resample.py:
    99-127) over any leading dims. xb, rate_b f64[..., S]: block-start
    positions and per-block rates. f64 anchors every ``SUB_CHUNK`` samples,
    ``xb + k*(16*rate)`` as one fma (XLA contracts it), then f32 offsets
    ``a_frac + j*fl32(rate)`` within the chunk, also one fma, as XLA
    compiles them inside ``_process_resample`` and K7 computes them. With
    ``contract=False`` each product is rounded before its add, as XLA
    compiles the function alone and inside the stream node's ``process``
    (K15).

    Returns (base i32[..., S, fpb], frac f32[..., S, fpb])."""
    n_sub = frames_per_block // SUB_CHUNK
    dev = xb.device
    k = torch.arange(n_sub, dtype=torch.float64, device=dev)
    step = (SUB_CHUNK * rate_b)[..., None].expand(*rate_b.shape, n_sub)
    if contract:
        anchors = xla_rounding.fma64(k.expand_as(step), step, xb[..., None].expand_as(step))
    else:
        anchors = xb[..., None] + k * step
    a_int = torch.floor(anchors)
    a_frac = (anchors - a_int).float()  # [..., S, n_sub]
    j = torch.arange(SUB_CHUNK, dtype=torch.float32, device=dev)
    rf = rate_b.float()[..., None, None].expand(*a_frac.shape, SUB_CHUNK)
    if contract:
        local = xla_rounding.fma(j.expand_as(rf), rf, a_frac[..., None].expand_as(rf))
    else:
        local = a_frac[..., None] + j * rf
    base_local = torch.floor(local)
    lead = xb.shape
    frac = (local - base_local).reshape(*lead, frames_per_block)
    base = (a_int.to(torch.int32)[..., None] + base_local.to(torch.int32)).reshape(
        *lead, frames_per_block)
    return base, frac


def gather_resample(data, base, frac, loop_active, loop_start, loop_end, loop_len,
                    arena_offset=0, length=None, interp=None):
    """Resample ``data`` f32[C, A] at positions base + frac, the JAX
    package's ``gather_resample`` (graphaudio_tpu/ops/resample.py:130-176):
    the four taps at base + {-1, 0, 1, 2}, wrapped into the loop region
    when ``loop_active`` (both directions, so the window stays continuous
    across the seam), clipped to [0, length) and offset by
    ``arena_offset``, then ``catmull_rom`` (or ``interp``, a function of
    the four taps and the fraction rounded as its caller's XLA program
    rounds it). ``loop_end`` is unused, as in the reference. Returns
    f32[C, *base.shape]."""
    del loop_end
    if length is None:
        length = data.shape[1]
    base = base.to(torch.int64)
    loop_start = torch.as_tensor(loop_start, dtype=torch.int64, device=base.device)
    safe_len = torch.clamp(torch.as_tensor(loop_len, dtype=torch.int64, device=base.device),
                           min=1)
    active = torch.as_tensor(loop_active, device=base.device)
    taps = []
    for k in (-1, 0, 1, 2):
        tk = base + k
        tk = torch.where(active, loop_start + torch.remainder(tk - loop_start, safe_len), tk)
        tk = torch.clamp(tk, 0, int(length) - 1) + int(arena_offset)
        taps.append(data[:, tk.reshape(-1)].reshape(data.shape[0], *base.shape))
    return (interp or catmull_rom)(*taps, frac)


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


def resample_group_step(states, arena, gtab, rate_pb, block_times, block_end_times):
    """K7: one step of a time-varying-rate voice group in one launch on the
    card (csrc/resample.cu). Returns (x, primed, stop_time, out f32[V, C,
    S*128]); x and stop_time are two rows of one f64[2, V]. CUDA tensors
    only: AudioBufferSourceNode.resample_group_step_plain is the CPU path.

    gtab: the group's packed geometry (ops/voice_group.pack_group_table:
    f64[V + 1, RESAMPLE_COLS], each voice's rate / sample_rate in the last
    column, the last row the constants w, cap, tile, n_tiles and the
    context's sample rate); rate_pb: the playbackRate f32[V, S] a quantum,
    rows, or one base value a voice as a stride-0 view along S (the kernel
    then reads the base values, nothing is copied).
    """
    V, S = voice_group.check_group_inputs(states, POLY_STATE_FIELDS, arena, gtab,
                                          block_times, block_end_times,
                                          voice_group.RESAMPLE_COLS)
    C, W = arena.shape
    if tuple(rate_pb.shape) != (V, S):
        raise ValueError(f"rate_pb must be [{V}, {S}], got {tuple(rate_pb.shape)}")
    if rate_pb.stride(-1) == 0 and rate_pb.select(-1, 0).is_contiguous():
        rates, rows = rate_pb.select(-1, 0), 0
    else:
        rates, rows = rate_pb, 1
    cudabuild.require(rates, "rate_pb", torch.float32)
    out = arena.new_empty((V, C, S * FRAMES_PER_BLOCK))
    st_out = gtab.new_empty((2, V))
    primed = states["primed"].new_empty((V,))
    ptr = [states[name].data_ptr() for name, _ in POLY_STATE_FIELDS]
    status = cudabuild.launcher("ga_resample_group_step")(
        arena.data_ptr(), W, C, V, S, gtab.data_ptr(), *ptr, rates.data_ptr(), rows,
        block_times.data_ptr(), block_end_times.data_ptr(), out.data_ptr(), st_out.data_ptr(),
        primed.data_ptr(), cudabuild.stream_of(arena))
    if status:
        cudabuild.check(status, "ga_resample_group_step")
    cudabuild.launches["resample_group_step"] += 1
    return st_out[0], primed, st_out[1], out
