"""Plain reference of config 4, the convolution reverb, in float64.

The scene (``portbench/configs/config4_conv_reverb.py``): V looped mono
voices at 44.1 kHz, each resampled to 48 kHz by GraphAudio.Core's
CubicResampler at playbackRate 1, summed, convolved with each channel of a
stereo IR (normalized), times the master gain.

Semantics, from the port's and the JAX package's sources read as a
specification (never imported):

* a voice started at frame 0 reads its output frame j at the source
  position x_j = 1 + j * r, r = voice_rate / sample_rate (p / q = 147 / 160
  here), exact on the 1/q grid; with i = floor(x_j) and t = x_j - i the
  output is the Catmull-Rom sum w0 s[i-1] + w1 s[i] + w2 s[i+1] + w3 s[i+2]
  (CubicResampler.cs:52-57), every index wrapped into the looped buffer;
* the mono sum is up-mixed to the IR's channel count (each channel the
  sum) and channel c is convolved with IR channel c times the
  normalization scale (``plain.normalization_scale``), no latency;
* the destination gets the master gain times that.

``render_blocks`` computes any blocks of that stream from scratch: a block
needs the IR's length of dry signal before it, which it recomputes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.plain import Precision, convolve_valid, normalization_scale

#: Voices resampled at once (bounds the gather's memory).
VOICE_CHUNK = 16


def _weights(t):
    """Catmull-Rom tap weights for the fraction t (CubicResampler.cs:52-57
    expanded in the four taps)."""
    w0 = t * (-0.5 + t * (1.0 - 0.5 * t))
    w1 = 1.0 + t * t * (-2.5 + 1.5 * t)
    w2 = t * (0.5 + t * (2.0 - 1.5 * t))
    w3 = t * t * (-0.5 + 0.5 * t)
    return w0, w1, w2, w3


def dry_mix(cfg: dict, voices, j0: int, n: int, prec: Precision):
    """The voices' resampled sum at output frames j0 .. j0 + n - 1 (zero
    before frame 0)."""
    g = math.gcd(cfg["voice_rate"], cfg["sample_rate"])
    p, q = cfg["voice_rate"] // g, cfg["sample_rate"] // g
    dev = prec.device
    j = torch.arange(j0, j0 + n, dtype=torch.int64, device=dev)
    live = j >= 0
    jj = torch.clamp(j, min=0)
    num = q + jj * p  # q * x_j, exact
    i = torch.div(num, q, rounding_mode="floor")
    t = prec((num - i * q).to(torch.float64) / q)
    w = [prec(wk) for wk in _weights(t)]
    voices = prec(voices)
    N = voices.shape[-1]
    total = torch.zeros(n, dtype=prec.dtype, device=dev)
    for v0 in range(0, voices.shape[0], VOICE_CHUNK):
        vs = voices[v0:v0 + VOICE_CHUNK]
        y = None
        for k in range(4):
            term = w[k] * vs[:, torch.remainder(i - 1 + k, N)]
            y = term if y is None else y + term
        total = total + prec(y).sum(0)
    return prec(torch.where(live, total, torch.zeros((), dtype=prec.dtype, device=dev)))


def render_blocks(cfg: dict, inputs: dict, blocks, precision: str = "float64", device="cpu",
                  edits=None):
    """The destination's audio in each block (frame0, n) of the stream:
    a list of f64 numpy arrays [channels, n]. ``edits`` is unused (the
    scene takes none)."""
    prec = Precision(precision, device)
    ir = np.asarray(inputs["ir"], np.float64)
    M = ir.shape[-1]
    h = prec(np.stack([ch * normalization_scale(ch) for ch in ir]))
    gain = cfg["master_gain"]
    out = []
    for frame0, n in blocks:
        dry = dry_mix(cfg, inputs["voices"], frame0 - (M - 1), n + M - 1, prec)
        wet = prec(convolve_valid(dry[None, :], h, n))
        out.append(prec(gain * wet).double().cpu().numpy())
    return out
