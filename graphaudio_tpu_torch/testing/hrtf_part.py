"""Inputs of the partitioned HRTF filter's kernels (K10p-a, K10p-b), shared
by the card tests (tests/test_torch_kernels_cuda.py) and chip_smoke.py.

``seeded_case`` makes the arguments of ``ops.hrtf.hrtf_fir_partitioned``
for a group of V voices from a seed: a 7 x 24 grid of L-tap HRIRs, the
directions moving every quantum, a carried ring, its directions and tail
that are not zero; ``kernel_inputs`` splits a call's arguments into
K10p-a's and K10p-b's, as the wrapper computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.ops import hrtf as th

#: Seeded cases beside config5_measured's step: (V, C, S, P, with gain).
#: S = 1 and 4 at P = 8 keep a ring longer than the superblock; no gain is
#: the occluded route (the band split applied the gains).
PART_CASES = {
    "S=1 P=8": (128, 1, 1, 8, True),
    "S=4 P=8": (128, 1, 4, 8, True),
    "V=1 P=8": (1, 1, 32, 8, True),
    "stereo P=2": (32, 2, 32, 2, True),
    "occluded P=2": (128, 1, 32, 2, False),
    "P=3 ragged": (16, 1, 8, 3, True),
}


def seeded_case(dev, V, C, S, P, with_gain, seed=23):
    """The 11 arguments of ``hrtf_fir_partitioned`` on ``dev``: x f32[V, C,
    S*128], gain f32[V, S] or None, az, el, blend f32[V, S], the grid's
    partition spectra (L = 128 P taps, 91 fewer at odd P: a zero-padded
    last partition), hx, haz, hel, ola."""
    rng = np.random.default_rng(seed + 100 * P + S)
    L = 128 * P - 91 * (P % 2)
    grid = (rng.standard_normal((7, 24, 2, L)) * np.exp(-np.arange(L) / (L / 4.0)) * 0.2
            ).astype(np.float32)
    sr, si = th.hrir_grid_spectra(grid)
    q = np.arange(S)[None, :]
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    return [f32(rng.standard_normal((V, C, S * 128)) * 0.1),
            f32(rng.uniform(0.1, 1.0, (V, S))) if with_gain else None,
            f32(rng.uniform(-np.pi, np.pi, (V, 1)) + 0.17 * q),
            f32(np.sin(0.2 * q + rng.uniform(0, 6, (V, 1))) * 1.3),
            f32(rng.uniform(0.0, 1.0, (V, S))), f32(sr), f32(si),
            f32(rng.standard_normal((V, P - 1, 258)) * 2.0),
            f32(rng.uniform(-np.pi, np.pi, (V, P - 1))), f32(rng.uniform(-1.5, 1.5, (V, P - 1))),
            f32(rng.standard_normal((V, 2, 128)) * 0.01)]


def kernel_inputs(args):
    """(K10p-a's arguments, K10p-b's arguments) of one
    ``hrtf_fir_partitioned`` call: (X, hx, haz, hel, az, el, spec_r,
    spec_i) and (y, ola, x, gain, blend), y the inverse DFT of the plain
    K10p-a's spectra, as the wrapper computes them."""
    x, gain, az, el, blend, sr, si, hx, haz, hel, ola = args
    X = th.partitioned_input_spectra(x, gain)
    mac = (X, hx, haz, hel, az, el, sr, si)
    y = torch.fft.irfft(th.partitioned_mac_plain(*mac)[0], n=256, dim=-1)
    return mac, (y, ola, x, gain, blend)
