"""Plain helpers the references share: the working precision, linear
convolution by FFT and the convolver's IR normalization.

Written from GraphAudio.Core's semantics as the port's and the JAX
package's sources state them, read as a specification and never imported:
this package imports torch and numpy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: Precisions a reference computes in: its own (float64) and the control's
#: (bfloat16: every array rounded to bfloat16 where a stage hands it on, the
#: arithmetic between in float32; torch's FFTs take no bfloat16).
PRECISIONS = ("float64", "bfloat16")

#: The convolver's equal-power normalization (PartitionedConvolver.cs:93-102,
#: as graphaudio_tpu/ops/convolve.py states it): -58 dB over the IR's RMS,
#: the RMS held at no less than MIN_POWER.
GAIN_CALIBRATION_DB = -58.0
MIN_POWER = 0.000125


class Precision:
    """The dtype a reference computes in and the rounding it applies where
    one stage hands an array to the next."""

    def __init__(self, name: str, device="cpu"):
        if name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {name!r}")
        self.name = name
        self.device = torch.device(device)
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def __call__(self, x):
        """``x`` as a tensor of the working dtype, rounded to the stored
        precision."""
        t = torch.as_tensor(x, device=self.device).to(self.dtype)
        if self.name == "bfloat16":
            t = t.to(torch.bfloat16).to(self.dtype)
        return t


def normalization_scale(ir) -> float:
    """The factor a normalizing convolver multiplies an IR channel by:
    10^(-58/20) / max(rms(ir), MIN_POWER)."""
    ir = np.asarray(ir, np.float64)
    rms = math.sqrt(float(np.mean(ir * ir))) if ir.size else 0.0
    return 10.0 ** (GAIN_CALIBRATION_DB / 20.0) / max(rms, MIN_POWER)


def fft_size(n: int) -> int:
    """The smallest power of two at least ``n``."""
    return 1 << max(0, (n - 1).bit_length())


def convolve_valid(x, h, n: int):
    """The last ``n`` outputs of the linear convolution of ``x`` [..., L]
    with ``h`` [..., M] (broadcast over the leading dims), where x holds the
    M - 1 inputs before those outputs and the n under them (L = n + M - 1):
    y[i] = sum_k h[k] x[M - 1 + i - k], i < n."""
    L, M = x.shape[-1], h.shape[-1]
    if L != n + M - 1:
        raise ValueError(f"x must hold n + M - 1 = {n + M - 1} samples, got {L}")
    size = fft_size(L)
    y = torch.fft.irfft(torch.fft.rfft(x, n=size) * torch.fft.rfft(h, n=size), n=size)
    return y[..., M - 1:M - 1 + n]
