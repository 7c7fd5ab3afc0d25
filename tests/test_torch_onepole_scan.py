"""A numpy walk of K9's plan (csrc/onepole.cu), and the band split's plain
version, on the CPU.

The kernel runs each (voice, channel) row of x f32[V, C, T] as a chunked
two-level scan per crossover pole. ``_walk`` repeats it in f64 numpy in
the kernel's order: tiles of up to 512 threads x 16 samples; each chunk's
map from the zero state (A = a^16 from the host, t the chunk's tail); the
inclusive warp scan, shuffle-up rounds 1, 2, 4, 8, 16, of (A, t) after
(A', t') = (A A', A t' + t); warp 0's scan of the warp totals (rounds up
to the warp count) applied to the tile's carry-in; each chunk's carry-in
from its left neighbour's end state; the rerun. Every f64 operation is
rounded on its own, as the kernel's __dmul_rn / __dadd_rn are. Then the
f32 combine in the kernel's order.

* the walk's bands lie within 1e-6 x max of ``onepole_lowpass_plain``
  (carries too) and, before the f32 rounding, within 1e-12 of a
  sequential f64 recurrence;
* its combine is bit for bit ``band_combine_plain``'s on the same bands;
* at S = 1, 4, 32, 64 and 128 (two tiles), C = 1 and 2, nonzero carry-ins;
* ``band_split_plain`` is bit-identical to the composition the panner ran
  before it (two ``onepole_lowpass_plain`` calls and the
  ``repeat_interleave`` combine), and ``band_split`` takes it on the CPU.
"""

import math

import numpy as np
import pytest
import torch

from graphaudio_tpu_torch.ops import onepole as top

SR = 48000
CHUNK, MAX_THREADS = top.CHUNK, 512  # csrc/onepole.cu kChunk, kMaxThreads
POLES = tuple(math.exp(-2.0 * math.pi * hz / SR) for hz in (800.0, 8000.0))


def _shfl_scan(A, t, rounds):
    """Inclusive scan of the maps (A, t) over the last axis (the lanes),
    one shuffle-up round per offset: lane i >= off takes its map after
    lane i - off's map of the round before."""
    for off in rounds:
        A2, t2 = A.copy(), t.copy()
        A2[..., off:] = A[..., off:] * A[..., :-off]
        t2[..., off:] = A[..., off:] * t[..., :-off] + t[..., off:]
        A, t = A2, t2
    return A, t


def _walk(x, a, y0):
    """The kernel's f64 state at every sample of x f32[R, T] for pole
    ``a`` from carry-ins y0 f32[R], in its order. Returns f64[R, T]."""
    R, T = x.shape
    nt = min(MAX_THREADS, (T // CHUNK + 31) // 32 * 32)
    nw, tile = nt // 32, nt * CHUNK
    oma, am = 1.0 - a, top._chunk_power(a)
    seed = y0.astype(np.float64)
    y = np.empty((R, T))
    for t0 in range(0, T, tile):
        n = min(tile, T - t0)
        xs = np.zeros((R, nt * CHUNK))
        xs[:, :n] = x[:, t0:t0 + n]
        xs = xs.reshape(R, nt, CHUNK)
        active = np.arange(nt) * CHUNK < n
        p = np.zeros((R, nt))
        for k in range(CHUNK):
            p = a * p + oma * xs[:, :, k]
        A = np.broadcast_to(np.where(active, am, 1.0), (R, nt)).reshape(R, nw, 32)
        t = np.where(active, p, 0.0).reshape(R, nw, 32)
        A, t = _shfl_scan(A, t, (1, 2, 4, 8, 16))
        WA, Wt = np.ones((R, 32)), np.zeros((R, 32))
        WA[:, :nw], Wt[:, :nw] = A[:, :, 31], t[:, :, 31]
        WA, Wt = _shfl_scan(WA, Wt, [o for o in (1, 2, 4, 8, 16) if o < nw])
        start = np.empty((R, nw + 1))
        start[:, 0] = seed
        start[:, 1:] = WA[:, :nw] * seed[:, None] + Wt[:, :nw]
        s = start[:, :nw, None]
        e = A * s + t  # each chunk's end state
        c = np.concatenate([s, e[:, :, :-1]], axis=2).reshape(R, nt)
        seed = start[:, nw]
        ys = np.empty((R, nt, CHUNK))
        for k in range(CHUNK):
            c = a * c + oma * xs[:, :, k]
            ys[:, :, k] = c
        y[:, t0:t0 + n] = ys.reshape(R, -1)[:, :n]
    return y


def _sequential(x, a, y0):
    """y[n] = a y[n-1] + (1 - a) x[n] in f64, one sample after another."""
    x = x.astype(np.float64)
    y = np.empty(x.shape)
    p = y0.astype(np.float64)
    for n in range(x.shape[-1]):
        p = a * p + (1.0 - a) * x[..., n]
        y[..., n] = p
    return y


def _inputs(V, C, S, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((V, C, S * 128)) * 0.3).astype(np.float32)
    y0 = [(rng.standard_normal((V, C)) * 0.2).astype(np.float32) for _ in range(2)]
    gains = [rng.uniform(0.05, 1.0, (V, S)).astype(np.float32) for _ in range(3)]
    return x, y0, gains


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("S", [1, 4, 32, 64, 128])
def test_walk_matches_plain_and_sequential(S, C):
    V = 3
    x, y0s, gains = _inputs(V, C, S, seed=100 + S + C)
    R, T = V * C, S * 128
    bands = []
    for a, y0 in zip(POLES, y0s):
        walk = _walk(x.reshape(R, T), a, y0.reshape(R))
        seq = _sequential(x.reshape(R, T), a, y0.reshape(R))
        assert np.abs(walk - seq).max() <= 1e-12 * max(1.0, np.abs(seq).max())
        band = walk.astype(np.float32).reshape(V, C, T)
        want, want_c = top.onepole_lowpass_plain(torch.from_numpy(x), a, torch.from_numpy(y0))
        tol = 1e-6 * max(1.0, float(want.abs().max()))
        assert np.abs(band - want.numpy()).max() <= tol
        assert np.abs(band[..., -1] - want_c.numpy()).max() <= tol  # the carry-out
        bands.append(band)
    low, lowmid = bands
    gl, gm, gh = (np.repeat(g, 128, axis=-1)[:, None, :] for g in gains)
    direct = ((low * gl) + ((lowmid - low) * gm)) + ((x - lowmid) * gh)  # f32, the kernel's order
    assert direct.dtype == np.float32
    want = top.band_combine_plain(*map(torch.from_numpy, (x, low, lowmid, *gains)))
    assert np.array_equal(direct.view(np.int32), want.numpy().view(np.int32))


def test_walk_warp_scan_crosses_warps_and_tiles():
    """The warp-total scan and the tile carry: a unit impulse at sample 0
    decays as (1 - a) a^n through every chunk, warp and tile."""
    a = POLES[0]
    T = 128 * 128  # two tiles of 16 warps
    x = np.zeros((1, T), np.float32)
    x[0, 0] = 1.0
    y = _walk(x, a, np.zeros(1, np.float32))
    n = np.arange(T)
    want = (1.0 - a) * a ** n
    assert np.abs(y[0] - want).max() <= 1e-15


@pytest.mark.parametrize("V,C,S", [(4, 2, 8), (3, 1, 32), (2, 2, 1)])
def test_band_split_plain_is_the_panners_former_composition(V, C, S):
    x, y0s, gains = _inputs(V, C, S, seed=7 * S + C)
    x, y0l, y0h, gl, gm, gh = map(torch.from_numpy, (x, *y0s, *gains))
    al, ah = POLES
    # The panner's occluded branch before band_split existed.
    low, xlow = top.onepole_lowpass_plain(x, al, y0l)
    lowmid, xhigh = top.onepole_lowpass_plain(x, ah, y0h)

    def expand(g):  # [V, S] -> [V, 1, T]
        return torch.repeat_interleave(g, 128, dim=-1)[:, None, :]

    direct = low * expand(gl) + (lowmid - low) * expand(gm) + (x - lowmid) * expand(gh)
    for got in (top.band_split_plain(x, al, ah, y0l, y0h, gl, gm, gh),
                top.band_split(x, al, ah, y0l, y0h, gl, gm, gh)):
        for g, w in zip(got, (direct, xlow, xhigh)):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
