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
* XLA's f32 ``cos``/``sin``/``pow`` agree with the correctly rounded value
  (computed in f64, rounded once) on 98.7 % / 99.9 % of inputs, torch's
  f32 versions on 95 % / 98 %. ``cos``, ``sin``, ``pow`` and ``exp`` here
  evaluate in f64 and round once; the kernels call the f64 functions and
  round the same way.
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
