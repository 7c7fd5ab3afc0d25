"""Biquad IIR filtering: RBJ coefficients (K8) and the pole-split cascade (P2).

The reference runs a per-sample transposed direct-form II recurrence
(GraphAudio.Core/Nodes/BiQuadFilterNode.cs:136-141). The JAX package
(graphaudio_tpu/ops/biquad.py) factors the denominator 1 + a1 z^-1 + a2 z^-2
into complex poles p1, p2 and solves two first-order complex recurrences in
cascade,

    v_t = p1_t v_{t-1} + x_t
    w_t = p2_t w_{t-1} + v_t,

with parallel prefix scans (time-varying poles) or a blocked closed form
(constant poles). For time-varying poles the composed recurrence lags the
a2 term by one sample; a second pass injects the correction
-p1_t (p2_t - p2_{t-1}) w_{t-2}, taken from the first pass. The output is
y_t = b0 w_t + b1 w_{t-1} + b2 w_{t-2}.

The port keeps that algorithm and its pole order:

* ``biquad_coefficients`` is K8 (csrc/biquad.cu): param clamps, the k-rate
  gain expansion, the RBJ formulas of the static type, the 1/a0
  normalisation and the pole split, elementwise per sample. Its plain
  version is ``biquad_coefficients_plain`` around ``rbj_coefficients``.
* ``biquad_apply`` is P2 (csrc/first_order.cu), the port of the Pallas
  first-order recurrence ``fo_kernel`` (benchmarks/probes/hrtf_fir_pallas.py
  :276, :290): one thread per (lane, channel) walks time sequentially
  through both cascaded recurrences, with the correction pass run in the
  same sweep two samples behind the first. Its plain version,
  ``biquad_apply_plain``, mirrors the JAX functions' association order:
  the two-level Hillis-Steele prefix ``_first_order_scan`` for
  time-varying poles and the blocked closed form ``_first_order_const``
  for constant ones.
* ``first_order_tb`` is the probe's own form of P2 (constant pole per
  column, [T, B] layout), kept to hold the kernel against ``fo_kernel``.

Both forms of the cascade keep the recurrence state in f64 (c128) on the
f32 / c64 coefficients and poles, and round the output and the carried
state to f32. Config 3's low-frequency resonant sections amplify rounding:
the golden's own f32 recurrence lies 8.4e-6 from an f64 mirror of the
algorithm, most of the 1e-5 bar, and an f32 recurrence rounded otherwise
than XLA's lands 1.16e-5 from the golden. With f64 state the port's error
is that of its f32 coefficients alone (6.8e-6 from the golden, 5.1e-6 from
the mirror). The coefficients follow XLA's rounding (ops/xla_rounding.py).
"""

from __future__ import annotations


import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.ops import xla_rounding
from graphaudio_tpu_torch.utils import cudabuild

#: index order of the filter types (matches FilterType declaration order and
#: the type code of csrc/biquad.cu)
FILTER_TYPES = (
    "lowpass", "highpass", "bandpass", "notch",
    "allpass", "peaking", "lowshelf", "highshelf",
)


def _w0_scale(sample_rate: float) -> np.float32:
    """f32(2*pi) / f32(sr), rounded in f32: XLA folds the constant pair of
    ``f32(2*pi) * f / f32(sr)`` into one multiplier."""
    return np.float32(np.float32(2.0 * np.pi) / np.float32(sample_rate))


def rbj_coefficients(filter_type: str, freq, q, gain_db, sample_rate: float):
    """Normalized biquad coefficients (b0, b1, b2, a1, a2), each f32 shaped
    like ``freq``. Parity: BiQuadFilterNode.UpdateCoefficients (:149-258),
    the JAX ``rbj_coefficients`` (ops/biquad.py:43-121) with XLA's rounding
    (constant divisions as reciprocal multiplies, correctly rounded
    sin/cos/pow)."""
    f = freq.float()
    q = q.float()
    g = torch.as_tensor(gain_db, dtype=torch.float32, device=f.device)
    w0 = f * torch.tensor(_w0_scale(sample_rate), device=f.device)
    cosw = xla_rounding.cos(w0)
    sinw = xla_rounding.sin(w0)
    alpha = sinw / (2.0 * q)

    def gain_a():
        return xla_rounding.pow(torch.full_like(g, 10.0), g * np.float32(1.0 / 40.0))

    if filter_type == "lowpass":
        b0 = (1.0 - cosw) * 0.5
        b1 = 1.0 - cosw
        b2 = b0
        a0 = 1.0 + alpha
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha
    elif filter_type == "highpass":
        b0 = (1.0 + cosw) * 0.5
        b1 = -(1.0 + cosw)
        b2 = b0
        a0 = 1.0 + alpha
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha
    elif filter_type == "bandpass":
        b0 = alpha
        b1 = torch.zeros_like(alpha)
        b2 = -alpha
        a0 = 1.0 + alpha
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha
    elif filter_type == "notch":
        b0 = torch.ones_like(alpha)
        b1 = -2.0 * cosw
        b2 = torch.ones_like(alpha)
        a0 = 1.0 + alpha
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha
    elif filter_type == "allpass":
        b0 = 1.0 - alpha
        b1 = -2.0 * cosw
        b2 = 1.0 + alpha
        a0 = 1.0 + alpha
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha
    elif filter_type == "peaking":
        A = gain_a()
        b0 = 1.0 + alpha * A
        b1 = -2.0 * cosw
        b2 = 1.0 - alpha * A
        a0 = 1.0 + alpha / A
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha / A
    elif filter_type == "lowshelf":
        A = gain_a()
        beta = torch.sqrt(A) / q
        b0 = A * ((A + 1.0) - (A - 1.0) * cosw + beta * sinw)
        b1 = 2.0 * A * ((A - 1.0) - (A + 1.0) * cosw)
        b2 = A * ((A + 1.0) - (A - 1.0) * cosw - beta * sinw)
        a0 = (A + 1.0) + (A - 1.0) * cosw + beta * sinw
        a1 = -2.0 * ((A - 1.0) + (A + 1.0) * cosw)
        a2 = (A + 1.0) + (A - 1.0) * cosw - beta * sinw
    elif filter_type == "highshelf":
        A = gain_a()
        beta = torch.sqrt(A) / q
        b0 = A * ((A + 1.0) + (A - 1.0) * cosw + beta * sinw)
        b1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cosw)
        b2 = A * ((A + 1.0) + (A - 1.0) * cosw - beta * sinw)
        a0 = (A + 1.0) - (A - 1.0) * cosw + beta * sinw
        a1 = 2.0 * ((A - 1.0) - (A + 1.0) * cosw)
        a2 = (A + 1.0) - (A - 1.0) * cosw - beta * sinw
    else:
        raise ValueError(f"unknown filter type {filter_type!r}")

    inv_a0 = 1.0 / a0
    return (b0 * inv_a0, b1 * inv_a0, b2 * inv_a0, a1 * inv_a0, a2 * inv_a0)


def split_poles(a1, a2):
    """Complex poles (p1, p2) of 1 + a1 z^-1 + a2 z^-2, c64 shaped like a1.

    The JAX package computes ``0.5 * (-a1 -/+ sqrt(a1*a1 - 4*a2))`` in
    complex64; XLA contracts the discriminant into one fma and its complex
    sqrt returns sqrt(|d|) on the real axis (d >= 0) or on the POSITIVE
    imaginary axis (d < 0, whatever the sign of the zero imaginary part), so
    Im(p1) >= 0. A plain complex sqrt of (d, -0) would return the conjugate
    and swap the poles; the correction pass is not symmetric in them.
    """
    d = xla_rounding.fma(a1, a1, -(4.0 * a2))
    s = torch.sqrt(torch.abs(d))
    real = d >= 0.0
    zero = torch.zeros_like(a1)
    p1 = torch.complex(torch.where(real, 0.5 * (-a1 + s), 0.5 * -a1),
                       torch.where(real, zero, 0.5 * s))
    p2 = torch.complex(torch.where(real, 0.5 * (-a1 - s), 0.5 * -a1),
                       torch.where(real, zero, -(0.5 * s)))
    return p1, p2


# ---- K8: per-sample coefficients and poles ----------------------------------


def biquad_coefficients_plain(filter_type: str, freq, q, gain_blocks, sample_rate):
    """Plain torch K8. freq, q f32[V, T] (a-rate values), gain_blocks
    f32[V, S] (k-rate, one value per quantum). Returns (b0, b1, b2 f32[V, T],
    p1, p2 c64[V, T])."""
    f = torch.clamp(freq, 1.0, sample_rate / 2.0)
    qq = torch.clamp(q, min=0.001)
    g = torch.repeat_interleave(gain_blocks, FRAMES_PER_BLOCK, dim=-1)
    b0, b1, b2, a1, a2 = rbj_coefficients(filter_type, f, qq, g, sample_rate)
    p1, p2 = split_poles(a1, a2)
    return b0, b1, b2, p1, p2


def biquad_coefficients(filter_type: str, freq, q, gain_blocks, sample_rate):
    """K8: the per-sample biquad coefficients and poles of a group, see
    ``biquad_coefficients_plain``. CPU tensors take the plain version; CUDA
    tensors launch csrc/biquad.cu."""
    if freq.device.type == "cpu":
        return biquad_coefficients_plain(filter_type, freq, q, gain_blocks, sample_rate)
    V, T = freq.shape
    S = T // FRAMES_PER_BLOCK
    freq, q, gain_blocks = (t.contiguous() for t in (freq, q, gain_blocks))
    req = cudabuild.require
    req(freq, "freq", torch.float32, shape=(V, T))
    req(q, "q", torch.float32, shape=(V, T))
    req(gain_blocks, "gain_blocks", torch.float32, shape=(V, S))
    dev = freq.device
    b = torch.empty((3, V, T), dtype=torch.float32, device=dev)
    p = torch.empty((2, V, T), dtype=torch.complex64, device=dev)
    status = cudabuild.load().ga_biquad_coeffs(
        freq.data_ptr(), q.data_ptr(), gain_blocks.data_ptr(), V, T,
        FILTER_TYPES.index(filter_type), float(sample_rate) / 2.0,
        float(_w0_scale(sample_rate)), b.data_ptr(), p.data_ptr(),
        cudabuild.stream_of(freq),
    )
    cudabuild.check(status, "ga_biquad_coeffs")
    cudabuild.launches["biquad_coefficients"] += 1
    return b[0], b[1], b[2], p[0], p[1]


# ---- P2: first-order recurrences --------------------------------------------


def _shift(t, k, fill):
    """``t`` shifted right by k along the last axis, ``fill`` shifted in."""
    pad = torch.full((*t.shape[:-1], k), fill, dtype=t.dtype, device=t.device)
    return torch.cat([pad, t[..., : t.shape[-1] - k]], dim=-1)


def _hs_prefix(p, b):
    """Inclusive prefix composition of affine ops (p, b) along the last
    axis by Hillis-Steele doubling (JAX ops/biquad.py:203-231)."""
    n = p.shape[-1]
    k = 1
    while k < n:
        ps = _shift(p, k, 1.0)
        bs = _shift(b, k, 0.0)
        p, b = p * ps, p * bs + b
        k *= 2
    return p, b


def _first_order_scan(p, u, s_init):
    """Solve s_t = p_t s_{t-1} + u_t (complex64) with the JAX package's
    two-level prefix (ops/biquad.py:153-200): time tiled into 128-sample
    blocks, a prefix within blocks, then one over the block totals.

    p: c64[..., T] (shared by the channels), u: c64[..., C, T],
    s_init: c64[..., C]. Returns c64[..., C, T]."""
    *lead, C, T = u.shape
    B = 128 if T % 128 == 0 and T > 128 else T
    S = T // B
    pc = p.unsqueeze(-2).expand(*lead, C, T).reshape(*lead, C, S, B)
    u3 = u.reshape(*lead, C, S, B)
    cp, cb = _hs_prefix(pc, u3)
    if S == 1:
        return (cp * s_init[..., None, None] + cb).reshape(*lead, C, T)
    bp, bb = _hs_prefix(cp[..., -1], cb[..., -1])  # [..., C, S]
    carry = torch.cat(
        [s_init[..., None], bp[..., :-1] * s_init[..., None] + bb[..., :-1]], dim=-1
    )  # [..., C, S] carry INTO each block
    return (cp * carry[..., None] + cb).reshape(*lead, C, T)


def _first_order_const(p, u, s_init):
    """``_first_order_scan`` for a constant pole per lane, by the JAX
    package's blocked closed form (ops/biquad.py:387-442): each 128-sample
    block is a matmul against the decay matrix p^(n-k), the block-to-block
    carry a second one over the superblock axis.

    p: c64[...] (one pole per lane), u: c64[..., C, T], s_init: c64[..., C].
    """
    *lead, C, T = u.shape
    B = 128
    S = T // B
    dev = u.device
    rdt = p.real.dtype
    pr, pim = p.real, p.imag
    logr = 0.5 * torch.log(torch.clamp(pr * pr + pim * pim, min=1e-38))
    th = torch.atan2(pim, pr)
    lead1 = (...,) + (None,) * 2

    def pole_pow(d, mask, lr, t):
        """(re, im) of p^d * mask over an integer grid d; lr, t per lane."""
        mag = torch.exp(d * lr[lead1]) * mask
        return mag * torch.cos(d * t[lead1]), mag * torch.sin(d * t[lead1])

    def cmatmul(spec, ar, ai, br, bi):
        rr = torch.einsum(spec, ar, br) - torch.einsum(spec, ai, bi)
        ri = torch.einsum(spec, ar, bi) + torch.einsum(spec, ai, br)
        return rr, ri

    n = torch.arange(B, dtype=rdt, device=dev)
    d = n[:, None] - n[None, :]
    Mr, Mi = pole_pow(torch.clamp(d, min=0.0), (d >= 0).to(rdt), logr, th)  # [..., B, B]
    ub = u.reshape(*lead, C, S, B)
    pr_, pi_ = cmatmul("...nk,...csk->...csn", Mr, Mi, ub.real, ub.imag)
    last_r, last_i = pr_[..., -1], pi_[..., -1]  # [..., C, S] block tails

    b = torch.arange(S, dtype=rdt, device=dev)
    e = b[:, None] - 1.0 - b[None, :]
    lr128, th128 = B * logr, B * th
    Wr, Wi = pole_pow(torch.clamp(e, min=0.0), (e >= 0).to(rdt), lr128, th128)
    tr, ti = cmatmul("...bj,...cj->...cb", Wr, Wi, last_r, last_i)
    powr, powi = pole_pow(b[None, :], torch.ones((), dtype=rdt, device=dev), lr128, th128)
    powr, powi = powr[..., 0, :], powi[..., 0, :]  # [..., S]: (p^128)^b
    s0r, s0i = s_init.real[..., None], s_init.imag[..., None]
    cr = powr[..., None, :] * s0r - powi[..., None, :] * s0i + tr  # [..., C, S]
    ci = powr[..., None, :] * s0i + powi[..., None, :] * s0r + ti
    ar, ai = pole_pow((n + 1.0)[None, :], torch.ones((), dtype=rdt, device=dev), logr, th)
    ar, ai = ar[..., 0, None, None, :], ai[..., 0, None, None, :]  # p^(n+1)
    sr = pr_ + ar * cr[..., None] - ai * ci[..., None]
    si = pi_ + ar * ci[..., None] + ai * cr[..., None]
    return torch.complex(sr, si).reshape(*lead, C, T)


def biquad_apply_plain(x, b0, b1, b2, p1, p2, w1, w2, time_varying: bool):
    """Plain torch P2: the JAX ``biquad_apply`` (ops/biquad.py:445-539)
    batched over a group's lanes.

    x f32[V, C, T]; b0, b1, b2 f32[V, T]; p1, p2 c64[V, T]; w1, w2 f32[V, C]
    (carried transposed-DF2 state w_{-1}, w_{-2}). Constant poles
    (``time_varying`` False) use the blocked closed form at p[..., 0];
    time-varying ones the two-level prefix and the correction pass.
    Returns (y f32[V, C, T], new w1 f32[V, C], new w2 f32[V, C]). The
    recurrences run in c128 (see the module docstring).
    """
    c128 = torch.complex128
    xt = x.to(c128)
    p1, p2 = p1.to(c128), p2.to(c128)
    w1d, w2d = w1.double(), w2.double()
    w_init = w1d.to(c128)
    v_init = w_init - p2[:, :1] * w2d.to(c128)

    def run(inp):
        if time_varying:
            v = _first_order_scan(p1, inp, v_init)
            w = _first_order_scan(p2, v, w_init)
        else:
            v = _first_order_const(p1[:, 0], inp, v_init)
            w = _first_order_const(p2[:, 0], v, w_init)
        w_t = w.real
        w_tm1 = torch.cat([w1d[..., None], w_t[..., :-1]], dim=-1)
        w_tm2 = torch.cat([w2d[..., None], w_tm1[..., :-1]], dim=-1)
        return w_t, w_tm1, w_tm2

    w_t, w_tm1, w_tm2 = run(xt)
    if time_varying:
        # p2 at the previous sample (p2_{-1} := p2_0: no correction at t=0).
        p2_prev = torch.cat([p2[:, :1], p2[:, :-1]], dim=-1)
        corr = -(p1 * (p2 - p2_prev))[:, None, :] * w_tm2.to(c128)
        w_t, w_tm1, w_tm2 = run(xt + corr)
    y = b0.double()[:, None] * w_t + b1.double()[:, None] * w_tm1 \
        + b2.double()[:, None] * w_tm2
    return y.float(), w_t[..., -1].float(), w_tm1[..., -1].float()


def _cascade_chunk(C: int) -> int:
    """Samples per shared-memory chunk of csrc/first_order.cu: a power of
    two that keeps the chunk (two poles and three coefficients widened to
    f64, C f32 input channels per sample) within 48 KB."""
    per = 2 * 16 + 3 * 8 + 4 * C
    ch = 512
    while ch > 32 and ch * per > 48 * 1024:
        ch //= 2
    return ch


def biquad_apply(x, b0, b1, b2, p1, p2, w1, w2, time_varying: bool):
    """P2: filter a group's [V, C, T] samples through its biquads, see
    ``biquad_apply_plain``. CPU tensors take the plain version; CUDA
    tensors launch csrc/first_order.cu (sequential in time, one thread per
    (lane, channel), correction pass in the same sweep)."""
    if x.device.type == "cpu":
        return biquad_apply_plain(x, b0, b1, b2, p1, p2, w1, w2, time_varying)
    V, C, T = x.shape
    req = cudabuild.require
    req(x, "x", torch.float32, shape=(V, C, T))
    for name, t in (("b0", b0), ("b1", b1), ("b2", b2)):
        req(t, name, torch.float32, shape=(V, T))
    for name, t in (("p1", p1), ("p2", p2)):
        req(t, name, torch.complex64, shape=(V, T))
    w1, w2 = w1.contiguous(), w2.contiguous()
    req(w1, "w1", torch.float32, shape=(V, C))
    req(w2, "w2", torch.float32, shape=(V, C))
    if C > 128:
        raise ValueError(f"at most 128 channels per lane, got {C}")
    y = torch.empty_like(x)
    state = torch.empty((2, V, C), dtype=torch.float32, device=x.device)
    ch = _cascade_chunk(C)
    status = cudabuild.load().ga_biquad_cascade(
        x.data_ptr(), b0.data_ptr(), b1.data_ptr(), b2.data_ptr(), p1.data_ptr(),
        p2.data_ptr(), w1.data_ptr(), w2.data_ptr(), V, C, T, ch,
        int(bool(time_varying)), y.data_ptr(), state[0].data_ptr(),
        state[1].data_ptr(), cudabuild.stream_of(x),
    )
    cudabuild.check(status, "ga_biquad_cascade")
    cudabuild.launches["biquad_apply"] += 1
    return y, state[0], state[1]


def first_order_tb_plain(xr, xi, ar, ai):
    """Plain torch form of the Pallas ``fo_kernel``
    (benchmarks/probes/hrtf_fir_pallas.py:276): s_t = a s_{t-1} + x_t per
    column, sequential over t. xr, xi f32[T, B]; ar, ai f32[1, B]."""
    T, B = xr.shape
    sr = torch.zeros((1, B), dtype=torch.float32, device=xr.device)
    si = torch.zeros_like(sr)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    for t in range(T):
        sr, si = ar * sr - ai * si + xr[t:t + 1], ar * si + ai * sr + xi[t:t + 1]
        yr[t:t + 1], yi[t:t + 1] = sr, si
    return yr, yi


def first_order_tb(xr, xi, ar, ai):
    """P2 in the probe's form (constant pole per column, [T, B] layout):
    csrc/first_order.cu on CUDA tensors, ``first_order_tb_plain`` on CPU."""
    if xr.device.type == "cpu":
        return first_order_tb_plain(xr, xi, ar, ai)
    T, B = xr.shape
    req = cudabuild.require
    req(xr, "xr", torch.float32, shape=(T, B))
    req(xi, "xi", torch.float32, shape=(T, B))
    req(ar, "ar", torch.float32, shape=(1, B))
    req(ai, "ai", torch.float32, shape=(1, B))
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    status = cudabuild.load().ga_first_order_tb(
        xr.data_ptr(), xi.data_ptr(), ar.data_ptr(), ai.data_ptr(), T, B,
        yr.data_ptr(), yi.data_ptr(), cudabuild.stream_of(xr),
    )
    cudabuild.check(status, "ga_first_order_tb")
    cudabuild.launches["first_order_tb"] += 1
    return yr, yi
