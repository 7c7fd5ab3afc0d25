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

* ``biquad_coefficients_batch`` is K8 (csrc/biquad.cu): param clamps, the
  k-rate gain expansion, the RBJ formulas of each stage's type (as data),
  the 1/a0 normalisation and the pole split, elementwise per sample, for
  every biquad stage of a render step in one launch. Its plain version is
  ``biquad_coefficients_batch_plain`` around ``rbj_coefficients_typed``.
  ``biquad_coefficients`` (plain: ``biquad_coefficients_plain``) is the
  same kernel on one stage's frequency, Q and gain tensors.
* ``biquad_apply`` is P2 (csrc/first_order.cu), the port of the Pallas
  first-order recurrence ``fo_kernel`` (benchmarks/probes/hrtf_fir_pallas.py
  :276, :290): a chunked two-level scan, one block per (lane, channel),
  16 samples per thread, both cascaded recurrences of a pass composed into
  one affine map of the state (v, w), the correction pass a second scan.
  It reassociates the f64 products, so it may differ from the plain
  version in the last f32 bit. Its plain version,
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

import functools

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.ops import xla_rounding
from graphaudio_tpu_torch.ops.param_eval import (
    SRC_ARATE,
    SRC_CONST,
    SRC_KRATE,
    source_words,
)
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


#: the types whose formulas read the gain (A = 10^(g/40)); their a1/a2 too
GAIN_TYPES = ("peaking", "lowshelf", "highshelf")


def _rbj_prelude(freq, q, gain_db, sample_rate):
    """The terms every type shares: (q, g, cos w0, sin w0, alpha), f32."""
    f = freq.float()
    q = q.float()
    g = torch.as_tensor(gain_db, dtype=torch.float32, device=f.device)
    w0 = f * torch.tensor(_w0_scale(sample_rate), device=f.device)
    sinw, cosw = xla_rounding.sincosf(w0)
    alpha = sinw / (2.0 * q)
    return q, g, cosw, sinw, alpha


def _gain_a(g):
    """A = 10^(g/40), the constant division as XLA rewrites it."""
    return xla_rounding.pow(torch.full_like(g, 10.0), g * np.float32(1.0 / 40.0))


def _rbj_terms(filter_type, q, cosw, sinw, alpha, A):
    """Unnormalized (b0, b1, b2, a0, a1, a2) of one type; ``A`` is read by
    the types of ``GAIN_TYPES`` only."""
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
        b0 = 1.0 + alpha * A
        b1 = -2.0 * cosw
        b2 = 1.0 - alpha * A
        a0 = 1.0 + alpha / A
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha / A
    elif filter_type == "lowshelf":
        beta = xla_rounding.sqrt(A) / q
        b0 = A * ((A + 1.0) - (A - 1.0) * cosw + beta * sinw)
        b1 = 2.0 * A * ((A - 1.0) - (A + 1.0) * cosw)
        b2 = A * ((A + 1.0) - (A - 1.0) * cosw - beta * sinw)
        a0 = (A + 1.0) + (A - 1.0) * cosw + beta * sinw
        a1 = -2.0 * ((A - 1.0) + (A + 1.0) * cosw)
        a2 = (A + 1.0) + (A - 1.0) * cosw - beta * sinw
    elif filter_type == "highshelf":
        beta = xla_rounding.sqrt(A) / q
        b0 = A * ((A + 1.0) + (A - 1.0) * cosw + beta * sinw)
        b1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cosw)
        b2 = A * ((A + 1.0) + (A - 1.0) * cosw - beta * sinw)
        a0 = (A + 1.0) - (A - 1.0) * cosw + beta * sinw
        a1 = 2.0 * ((A - 1.0) - (A + 1.0) * cosw)
        a2 = (A + 1.0) - (A - 1.0) * cosw - beta * sinw
    else:
        raise ValueError(f"unknown filter type {filter_type!r}")
    return b0, b1, b2, a0, a1, a2


def _normalize(b0, b1, b2, a0, a1, a2):
    inv_a0 = 1.0 / a0
    return (b0 * inv_a0, b1 * inv_a0, b2 * inv_a0, a1 * inv_a0, a2 * inv_a0)


def rbj_coefficients(filter_type: str, freq, q, gain_db, sample_rate: float):
    """Normalized biquad coefficients (b0, b1, b2, a1, a2), each f32 shaped
    like ``freq``. Parity: BiQuadFilterNode.UpdateCoefficients (:149-258),
    the JAX ``rbj_coefficients`` (ops/biquad.py:43-121) with XLA's rounding
    (constant divisions as reciprocal multiplies, glibc's sin/cos,
    correctly rounded pow)."""
    q, g, cosw, sinw, alpha = _rbj_prelude(freq, q, gain_db, sample_rate)
    A = _gain_a(g) if filter_type in GAIN_TYPES else None
    return _normalize(*_rbj_terms(filter_type, q, cosw, sinw, alpha, A))


def rbj_coefficients_typed(type_codes, freq, q, gain_db, sample_rate: float):
    """``rbj_coefficients`` with the type as data, one code per row of
    ``freq`` (index into ``FILTER_TYPES``): each present type's formulas
    and a selection, no other arithmetic, so each row equals the static
    type's result bit for bit (the JAX ``rbj_coefficients_dyn``,
    ops/biquad.py:131-150, over the eight types)."""
    q, g, cosw, sinw, alpha = _rbj_prelude(freq, q, gain_db, sample_rate)
    present = sorted(set(type_codes.tolist()))
    A = _gain_a(g) if any(FILTER_TYPES[c] in GAIN_TYPES for c in present) else None
    out = None
    for code in present:
        cand = _normalize(*_rbj_terms(FILTER_TYPES[code], q, cosw, sinw, alpha, A))
        if out is None:
            out = cand
        else:
            sel = (type_codes == code).to(cand[0].device)[:, None]
            out = tuple(torch.where(sel, c, o) for c, o in zip(cand, out))
    return out


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
    s = xla_rounding.sqrt(torch.abs(d))
    real = d >= 0.0
    zero = torch.zeros_like(a1)
    p1 = torch.complex(torch.where(real, 0.5 * (-a1 + s), 0.5 * -a1),
                       torch.where(real, zero, 0.5 * s))
    p2 = torch.complex(torch.where(real, 0.5 * (-a1 - s), 0.5 * -a1),
                       torch.where(real, zero, -(0.5 * s)))
    return p1, p2


# ---- K8: per-sample coefficients and poles ----------------------------------
#
# A step's biquad stages share one coefficient table, packed once per
# encoding by ``pack_coefficient_table``: a row of eight int32 words per
# (stage, lane), (type code, frequency source, Q source, gain source, b0 row,
# p1 row, V, 0). A source word is ``off << 2 | mode`` (ops/param_eval.py
# ``source_words``): SRC_ARATE reads src[off + t], SRC_KRATE
# src[off + t // 128] (a k-rate param's K6 row), SRC_CONST consts[off] (the
# base value of a param without events). The
# output is two arenas, b f32[n_b, T] and p c64[n_p, T]: a stage's b0, b1,
# b2 are V consecutive rows each from its b0 row, its p1, p2 from its p1
# row, so each is a contiguous [V, T] view as P2 takes it.

_SRC_NAMES = ("frequency", "Q", "gain")


def pack_coefficient_table(stages, superblock: int):
    """The K8 table of one encoding. ``stages``: (filter type, {"frequency",
    "Q", "gain": ParamSlot}) per biquad stage, in step order; the type is
    one name for all lanes or a tuple of one a lane (a fused chain's
    members). Returns numpy ``rows`` i32[NR, 8] and ``consts`` f32, and the
    host fields ``stages`` ((b0 row, p1 row, V) each), ``n_b``, ``n_p`` and
    ``frames`` (T)."""
    rows, consts, layout = [], [], []
    n_b = n_p = 0
    for ftype, slots in stages:
        V = slots["frequency"].lanes
        words = [source_words(slots[name], consts) for name in _SRC_NAMES]
        codes = [FILTER_TYPES.index(t) for t in
                 (ftype if isinstance(ftype, tuple) else (ftype,) * V)]
        rows += [[codes[v], *(w[v] for w in words), n_b + v, n_p + v, V, 0] for v in range(V)]
        layout.append((n_b, n_p, V))
        n_b, n_p = n_b + 3 * V, n_p + 2 * V
    if rows and max(max(r[1:4]) for r in rows) >= 2 ** 31:
        raise ValueError("the K8 table's source offsets need more than 29 bits")
    return {"rows": np.asarray(rows, np.int32).reshape(-1, 8),
            "consts": np.asarray(consts or [0.0], np.float32),
            "stages": tuple(layout), "n_b": n_b, "n_p": n_p,
            "frames": superblock * FRAMES_PER_BLOCK}


def _decode_source(words, src, consts, positions):
    """Values f32[NR, len(positions)] of one source word per row: the K8
    kernel's read at each sample (or quantum start) of ``positions``."""
    mode, off = words & 3, words >> 2
    const = (mode == SRC_CONST)[:, None]
    from_const = consts[torch.where(mode == SRC_CONST, off, 0)][:, None]
    if src is None or src.numel() == 0:
        return from_const.expand(-1, positions.shape[0])
    at = off[:, None] + torch.where((mode == SRC_ARATE)[:, None], positions,
                                    positions // FRAMES_PER_BLOCK)
    return torch.where(const, from_const, src[torch.where(const, 0, at)])


def _launch_k8(f_src, q_src, g_src, consts, rows, T, sample_rate, b, p):
    """csrc/biquad.cu over the rows of a table (no checks)."""
    status = cudabuild.launcher("ga_biquad_coeffs_batch")(
        f_src.data_ptr(), q_src.data_ptr(), g_src.data_ptr(), consts.data_ptr(),
        rows.data_ptr(), rows.shape[0], T // FRAMES_PER_BLOCK, float(sample_rate) / 2.0,
        float(_w0_scale(sample_rate)), b.data_ptr(), p.data_ptr(), cudabuild.stream_of(rows),
    )
    cudabuild.check(status, "ga_biquad_coeffs_batch")
    cudabuild.launches["biquad_coefficients_batch"] += 1


def _split_stages(table, b, p):
    out = []
    for brow, prow, V in table["stages"]:
        b0, b1, b2 = b.narrow(0, brow, 3 * V).view(3, V, -1).unbind(0)
        p1, p2 = p.narrow(0, prow, 2 * V).view(2, V, -1).unbind(0)
        out.append((b0, b1, b2, p1, p2))
    return out


def biquad_coefficients_batch_plain(table, arena, sample_rate):
    """Plain torch K8 over a ``pack_coefficient_table`` table (tensors),
    the sources read from ``arena`` (the step's K6 arena, None when no
    param has events): the kernel's reads, the clamps,
    ``rbj_coefficients_typed`` and the pole split. Returns one (b0, b1, b2,
    p1, p2) per stage."""
    rows, consts, T = table["rows"], table["consts"], table["frames"]
    dev = rows.device
    w = rows.long()
    t = torch.arange(T, device=dev)
    freq = _decode_source(w[:, 1], arena, consts, t)
    q = _decode_source(w[:, 2], arena, consts, t)
    gain_blocks = _decode_source(w[:, 3], arena, consts, t[::FRAMES_PER_BLOCK])
    f = torch.clamp(freq, 1.0, sample_rate / 2.0)
    qq = torch.clamp(q, min=0.001)
    g = torch.repeat_interleave(gain_blocks, FRAMES_PER_BLOCK, dim=-1)
    b0, b1, b2, a1, a2 = rbj_coefficients_typed(w[:, 0], f, qq, g, sample_rate)
    p1, p2 = split_poles(a1, a2)
    b = torch.empty((table["n_b"], T), dtype=torch.float32, device=dev)
    p = torch.empty((table["n_p"], T), dtype=torch.complex64, device=dev)
    brow, prow, V = w[:, 4], w[:, 5], w[:, 6]
    b[brow], b[brow + V], b[brow + 2 * V] = b0, b1, b2
    p[prow], p[prow + V] = p1, p2
    return _split_stages(table, b, p)


def biquad_coefficients_batch(table, arena, sample_rate):
    """K8: every biquad stage of a step in one launch of csrc/biquad.cu
    (CUDA tensors) or ``biquad_coefficients_batch_plain`` (CPU tensors).
    Returns one (b0, b1, b2 f32[V, T], p1, p2 c64[V, T]) per stage, each a
    contiguous view of the output arenas."""
    rows, consts = table["rows"], table["consts"]
    if rows.device.type == "cpu":
        return biquad_coefficients_batch_plain(table, arena, sample_rate)
    req = cudabuild.require
    req(rows, "rows", torch.int32, ndim=2)
    req(consts, "consts", torch.float32, ndim=1)
    src = consts if arena is None else arena
    req(src, "arena", torch.float32, ndim=1)
    T = table["frames"]
    b = torch.empty((table["n_b"], T), dtype=torch.float32, device=rows.device)
    p = torch.empty((table["n_p"], T), dtype=torch.complex64, device=rows.device)
    _launch_k8(src, src, src, consts, rows, T, sample_rate, b, p)
    return _split_stages(table, b, p)


@functools.lru_cache(maxsize=64)
def _stage_rows(code: int, V: int, S: int, device: torch.device):
    """The rows of one stage whose sources are separate [V, T] frequency
    and Q and [V, S] gain tensors, on the card once per shape."""
    T = S * FRAMES_PER_BLOCK
    return torch.tensor([[code, (v * T) << 2 | SRC_ARATE, (v * T) << 2 | SRC_ARATE,
                          (v * S) << 2 | SRC_KRATE, v, v, V, 0] for v in range(V)],
                        dtype=torch.int32, device=device)


def biquad_coefficients_plain(filter_type: str, freq, q, gain_blocks, sample_rate):
    """Plain torch K8 for one stage. freq, q f32[V, T] (a-rate values),
    gain_blocks f32[V, S] (k-rate, one value per quantum). Returns (b0, b1,
    b2 f32[V, T], p1, p2 c64[V, T])."""
    f = torch.clamp(freq, 1.0, sample_rate / 2.0)
    qq = torch.clamp(q, min=0.001)
    g = torch.repeat_interleave(gain_blocks, FRAMES_PER_BLOCK, dim=-1)
    b0, b1, b2, a1, a2 = rbj_coefficients(filter_type, f, qq, g, sample_rate)
    p1, p2 = split_poles(a1, a2)
    return b0, b1, b2, p1, p2


def biquad_coefficients(filter_type: str, freq, q, gain_blocks, sample_rate):
    """K8 for one stage, see ``biquad_coefficients_plain``. CPU tensors
    take the plain version; CUDA tensors launch csrc/biquad.cu as a
    one-stage batch whose sources are the given tensors."""
    if freq.device.type == "cpu":
        return biquad_coefficients_plain(filter_type, freq, q, gain_blocks, sample_rate)
    V, T = freq.shape
    S = T // FRAMES_PER_BLOCK
    freq, q, gain_blocks = (t.contiguous() for t in (freq, q, gain_blocks))
    req = cudabuild.require
    req(freq, "freq", torch.float32, shape=(V, T))
    req(q, "q", torch.float32, shape=(V, T))
    req(gain_blocks, "gain_blocks", torch.float32, shape=(V, S))
    rows = _stage_rows(FILTER_TYPES.index(filter_type), V, S, freq.device)
    b = torch.empty((3, V, T), dtype=torch.float32, device=freq.device)
    p = torch.empty((2, V, T), dtype=torch.complex64, device=freq.device)
    _launch_k8(freq, q, gain_blocks, freq, rows, T, sample_rate, b, p)
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


#: Samples per thread of csrc/first_order.cu's scan (kChunk there).
CASCADE_CHUNK = 16


def biquad_apply(x, b0, b1, b2, p1, p2, w1, w2, time_varying: bool):
    """P2: filter a group's [V, C, T] samples through its biquads, see
    ``biquad_apply_plain``. CPU tensors take the plain version; CUDA
    tensors launch csrc/first_order.cu (a chunked two-level scan), which
    needs T a multiple of ``CASCADE_CHUNK`` and 16-byte-aligned inputs."""
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
    ptrs = [t.data_ptr() for t in (x, b0, b1, b2, p1, p2)]
    if T % CASCADE_CHUNK or any(p % 16 for p in ptrs):
        raise ValueError(f"the cascade needs T % {CASCADE_CHUNK} == 0 and 16-byte-aligned "
                         f"x, b0, b1, b2, p1, p2; got T={T}, addresses {ptrs}")
    y = torch.empty_like(x)
    state = torch.empty((2, V, C), dtype=torch.float32, device=x.device)
    status = cudabuild.launcher("ga_biquad_cascade")(
        *ptrs, w1.data_ptr(), w2.data_ptr(), V, C, T, int(bool(time_varying)),
        y.data_ptr(), state[0].data_ptr(), state[1].data_ptr(), cudabuild.stream_of(x),
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
    status = cudabuild.launcher("ga_first_order_tb")(
        xr.data_ptr(), xi.data_ptr(), ar.data_ptr(), ai.data_ptr(), T, B,
        yr.data_ptr(), yi.data_ptr(), cudabuild.stream_of(xr),
    )
    cudabuild.check(status, "ga_first_order_tb")
    cudabuild.launches["first_order_tb"] += 1
    return yr, yi
