"""Arithmetic rounded the way the JAX reference rounds it.

The reference's goldens are XLA CPU renders. Two things there decide the
last bit of a result, and a port that must land within 1e-5 of a resonant
filter's output, or classify an automation event that falls exactly on a
sample instant, has to follow both (measured against jax 0.9 on x86 with
FMA):

* XLA contracts a multiply whose only use is an add or a subtract into one
  fused multiply-add (``fma``), in f32 and in f64: ``a1*a1 - 4*a2`` is
  ``fma(a1, a1, -4*a2)``, and a sample's clock ``t0 + i*dt`` is
  ``fma(i, dt, t0)``, each rounded once. PyTorch has no fma op. ``fma``
  forms an f32 product and sum in f64 (the product of two f32 values is
  exact there) and rounds once to f32; ``fma64`` splits the f64 product
  into its rounded value and exact error (Dekker) and adds the three
  without an intermediate rounding. The CUDA kernels call ``fmaf``/``fma``
  at the same places.
* XLA's CPU build calls glibc's f32 ``cosf``, ``sinf`` and ``powf`` (the
  x86-64 build for FMA hardware, measured against glibc 2.36: no
  difference over 3.2 million inputs). Those agree with the correctly
  rounded value (computed in f64, rounded once) on 98.7 % / 99.9 % of
  inputs, torch's f32 versions on 95 % / 98 %. ``cos``, ``sin``, ``pow``
  and ``exp`` here evaluate in f64 and round once; the kernels call the
  f64 functions and round the same way. ``sincosf`` is glibc's algorithm
  itself (below), bit for bit, for the biquad's RBJ terms, where an ulp
  of cos w0 at a low cutoff moves the output past 1e-5.
* XLA's f32 ``sqrt`` is correctly rounded, as is the kernels'
  ``__fsqrt_rn``; torch's f32 ``sqrt`` on an AVX-512 CPU is not (0.65 % of
  uniform inputs on [0, 4) land one ulp off). ``sqrt`` evaluates in f64 and
  rounds once, which is the correctly rounded f32 square root.
"""

from __future__ import annotations

import torch

_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's splitter for f64


def fma(a, b, c):
    """fl32(a*b + c), one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _split(x):
    t = _SPLIT * x
    hi = t - (t - x)
    return hi, x - hi


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma64(a, b, c):
    """fl64(a*b + c) for f64 tensors, rounded once, as the card's ``fma``.
    a*b + c is split exactly into s + u + v (Dekker's product, Knuth's
    sums), and s + u into its rounded sum r and error w; r is then the
    result unless s + u fell on a tie that v breaks, which ``nextafter``
    moves w off before the last rounding. Exact for finite operands
    without overflow or underflow."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl  # a*b == p + e exactly
    s, t = _two_sum(p, c)  # p + c == s + t exactly
    u, v = _two_sum(t, e)
    r, w = _two_sum(s, u)
    inf = torch.full_like(v, float("inf"))
    w = torch.where(v != 0, torch.nextafter(w, torch.copysign(inf, v)), w)
    return r + w


def cos(x):
    return torch.cos(x.double()).float()


def sin(x):
    return torch.sin(x.double()).float()


def exp(x):
    return torch.exp(x.double()).float()


def pow(x, y):
    return torch.pow(x.double(), y.double()).float()


def sqrt(x):
    return torch.sqrt(x.double()).float()


# glibc's sinf/cosf (sysdeps/ieee754/flt-32/sincosf.h, s_sinf.c, s_cosf.c;
# from Arm's optimized-routines): range reduction by one multiply-subtract
# in f64 and a short f64 polynomial, rounded once to f32. The x86-64 FMA
# build contracts each polynomial step a*b + c into an fma.
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")  # 2/pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p+0")  # pi/2
_COS = tuple(float.fromhex(h) for h in (
    "0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))


def sincosf(x):
    """(sinf(x), cosf(x)) of an f32 tensor as glibc computes them, bit for
    bit for |x| < 120 (held against the library over every f32 in [2^-16,
    4) and 3.2 million random inputs up to 120). Elsewhere glibc reduces the
    argument with 2/pi to 190 bits; this falls back to the f64 functions
    rounded once (``cos``, ``sin``), which no caller reaches: the biquad's
    w0 lies in (0, pi]. ``csrc/biquad.cu`` ``glibc_sincosf`` is the same
    sequence of f64 operations."""
    y = x.float()
    d = y.double()
    # The branches test the top 12 bits of |x| (glibc's abstop12): 0x3f4
    # is |x| < 0.75, 0x398 is |x| < 2^-12, 0x42f is |x| < 120.
    top = (y.view(torch.int32) >> 20) & 0x7FF
    small = top < 0x3F4
    # reduce_fast: the quadrant n from the f64 product scaled by 2^24.
    n = ((d * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    n = torch.where(small, torch.zeros_like(n), n)
    r = torch.where(small, d, fma64(-n.double(), _HPI, d))
    r2 = r * r
    sign = torch.where(((n + 1) & 2) == 0, 1.0, -1.0).double()  # sign[n & 3]
    xs = r * sign
    # Quadrants 2 and 3 take the table with the cosine terms negated.
    cneg = torch.where((n & 2) != 0, -1.0, 1.0).double()
    x3 = xs * r2
    s1 = fma64(r2, _SIN[2], _SIN[1])
    x7 = x3 * r2
    sp = fma64(x7, s1, fma64(x3, _SIN[0], xs))
    c = [k * cneg for k in _COS]
    r4 = r2 * r2
    c2 = fma64(r2, c[4], c[3])
    c1 = fma64(r2, c[1], c[0])
    r6 = r4 * r2
    cp = fma64(r6, c2, fma64(r4, c[2], c1))
    odd = (n & 1) == 1
    s = torch.where(odd, cp, sp).float()
    co = torch.where(odd, sp, cp).float()
    tiny = top < 0x398
    s = torch.where(tiny, y, s)
    co = torch.where(tiny, torch.ones_like(y), co)
    far = top >= 0x42F
    return torch.where(far, sin(y), s), torch.where(far, cos(y), co)
