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


def fma64(a, b, c):
    """fl64(a*b + c) for f64 tensors, rounded once (Dekker's exact product
    and Knuth's exact sum; exact for finite operands without overflow)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl  # a*b == p + e exactly
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)  # p + c == s + t exactly
    return s + (t + e)


def cos(x):
    return torch.cos(x.double()).float()


def sin(x):
    return torch.sin(x.double()).float()


def exp(x):
    return torch.exp(x.double()).float()


def pow(x, y):
    return torch.pow(x.double(), y.double()).float()
