"""Inputs of the partitioned HRTF filter's kernels (the input pass, K10p-a,
K10p-b), shared by the card tests (tests/test_torch_kernels_cuda.py),
chip_smoke.py and the CPU walk of K10p-a's schedule
(tests/test_torch_hrtf_part_walk.py).

``seeded_case`` makes the arguments of ``ops.hrtf.hrtf_fir_partitioned``
for a group of V voices from a seed: a 7 x 24 grid of L-tap HRIRs, a
carried ring, its directions and tail that are not zero, and directions
that move every quantum, stand still (the ring's too), or hold for runs of
1-5 quanta across the ring boundary; ``kernel_inputs`` splits a call's
arguments into each kernel's, as the wrapper computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.ops import hrtf as th

#: Seeded cases beside config5_measured's step: (V, C, S, P, with gain,
#: motion). S = 1 and 4 at P = 8 keep a ring longer than the superblock; no
#: gain is the occluded route (the band split applied the gains); "static"
#: and "runs" are the direction runs K10p-a reuses its spectra over.
PART_CASES = {
    "S=1 P=8": (128, 1, 1, 8, True, "moving"),
    "S=4 P=8": (128, 1, 4, 8, True, "moving"),
    "V=1 P=8": (1, 1, 32, 8, True, "moving"),
    "stereo P=2": (32, 2, 32, 2, True, "moving"),
    "occluded P=2": (128, 1, 32, 2, False, "moving"),
    "P=3 ragged": (16, 1, 8, 3, True, "moving"),
    "static P=8": (128, 2, 32, 8, True, "static"),
    "static P=2": (128, 2, 32, 2, True, "static"),
    "runs P=8": (128, 1, 32, 8, True, "runs"),
    "runs P=2": (128, 1, 32, 2, True, "runs"),
}


def directions(rng, V, n, motion, first=0):
    """(az, el) f64[V, n] over a concatenated timeline of n quanta, the
    first numbered ``first``:
    "moving" turns 0.17 rad a quantum (a new cell every 1-2 quanta),
    "static" holds one direction, "runs" holds each direction for 1-5
    quanta, each run a step of 0.01-0.3 rad from the last (so the four
    corners stay or move)."""
    q = np.arange(first, first + n)[None, :]
    az0, ph = rng.uniform(-np.pi, np.pi, (V, 1)), rng.uniform(0, 6, (V, 1))
    if motion == "moving":
        return az0 + 0.17 * q, np.sin(0.2 * q + ph) * 1.3
    if motion == "static":
        return np.broadcast_to(az0, (V, n)), np.broadcast_to(np.sin(ph) * 1.3, (V, n))
    assert motion == "runs", motion
    run = np.zeros((V, n), np.int64)
    for v in range(V):
        i = k = 0
        while i < n:
            length = int(rng.integers(1, 6))
            run[v, i:i + length] = k
            i, k = i + length, k + 1
    step = np.cumsum(rng.uniform(0.01, 0.3, (V, n)), axis=1)
    az = az0 + np.take_along_axis(step, run, axis=1)
    return az, np.sin(0.4 * np.take_along_axis(step, run, axis=1) + ph) * 1.3


def seeded_case(dev, V, C, S, P, with_gain, motion="moving", seed=23):
    """The 11 arguments of ``hrtf_fir_partitioned`` on ``dev``: x f32[V, C,
    S*128], gain f32[V, S] or None, az, el, blend f32[V, S], the grid's
    partition spectra (L = 128 P taps, 91 fewer at odd P: a zero-padded
    last partition), hx, haz, hel, ola; the ring's directions and this
    superblock's from ``directions``, except that a moving case's ring
    points anywhere."""
    rng = np.random.default_rng(seed + 100 * P + S)
    L = 128 * P - 91 * (P % 2)
    grid = (rng.standard_normal((7, 24, 2, L)) * np.exp(-np.arange(L) / (L / 4.0)) * 0.2
            ).astype(np.float32)
    sr, si = th.hrir_grid_spectra(grid)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    x = rng.standard_normal((V, C, S * 128)) * 0.1
    gain = rng.uniform(0.1, 1.0, (V, S)) if with_gain else None
    az, el = directions(rng, V, P - 1 + S, motion, first=1 - P)
    blend = rng.uniform(0.0, 1.0, (V, S))
    hx = rng.standard_normal((V, P - 1, 258)) * 2.0
    if motion == "moving":
        haz, hel = rng.uniform(-np.pi, np.pi, (V, P - 1)), rng.uniform(-1.5, 1.5, (V, P - 1))
    else:
        haz, hel = az[:, :P - 1], el[:, :P - 1]
    return [f32(x), None if gain is None else f32(gain), f32(az[:, P - 1:]),
            f32(el[:, P - 1:]), f32(blend), f32(sr), f32(si), f32(hx), f32(haz), f32(hel),
            f32(rng.standard_normal((V, 2, 128)) * 0.01)]


def kernel_inputs(args):
    """(the input pass's arguments, K10p-a's, K10p-b's) of one
    ``hrtf_fir_partitioned`` call: (x, gain), (X, hx, haz, hel, az, el,
    spec_r, spec_i) and (y, ola, x, gain, blend), X the rfft of the plain
    input pass and y the unscaled inverse DFT of the plain K10p-a's
    spectra, as the wrapper computes them."""
    x, gain, az, el, blend, sr, si, hx, haz, hel, ola = args
    X = torch.fft.rfft(th.partitioned_input_plain(x, gain), dim=-1)
    mac = (X, hx, haz, hel, az, el, sr, si)
    y = th.partitioned_inverse(th.partitioned_mac_plain(*mac)[0])
    return (x, gain), mac, (y, ola, x, gain, blend)
