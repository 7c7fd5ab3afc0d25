"""K11's tile decomposition (csrc/oscillator.cu), walked in numpy.

The kernel cuts a lane's superblock into tiles of 8 quanta, one block each.
A block sums every quantum up to its tile's end itself, 32 quanta a pass;
per quantum, once: the gate as the samples [lo, hi) that play, the f64 sum
of the 8 run sums, and (in the tile) the runs' exclusive f32 sums. One
thread carries each pass before the tile's on in order; in the tile's
pass, thread q runs the anchor chain phase + sum_{j<q} bsum_j from that
running sum. The block owning the last quantum writes the new phase. The
walk below does the same, block by block, and must equal
``oscillator_group_step_plain`` bit for bit, over starts and stops on and
inside quantum, tile and pass edges.
"""

import math
import re

import numpy as np
import pytest
import torch

from graphaudio_tpu_torch.ops import oscillator as tosc
from graphaudio_tpu_torch.utils import cudabuild

SR = 48000
Q = 128
RUN = 16
TWO_PI = 2.0 * math.pi
TWO_PI_F = np.float32(TWO_PI)
PI_F = np.float32(math.pi)


def _kernel_constants():
    """(threads, tile, pass) as csrc/oscillator.cu defines and launches
    them: the walk reads the kernel's own geometry."""
    src = (cudabuild.CSRC_DIR / "oscillator.cu").read_text()
    val = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
           for n in ("kThreads", "kQ", "kRun", "kTile")}
    assert "constexpr int kRuns = kQ / kRun;" in src
    assert "constexpr int kPass = kThreads / kRuns;" in src
    assert val["kQ"] == Q and val["kRun"] == RUN
    return val["kThreads"], val["kTile"], val["kThreads"] // (Q // RUN)


def _jmod(x, y):
    r = np.fmod(x, y)
    return np.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _gates(started, start, stop, bt, qdur):
    """int [L, S] lo and hi: each quantum's playing samples, once."""
    t0 = bt[None, :]
    t1 = t0 + qdur
    start, stop = start[:, None], stop[:, None]
    active = (started > 0)[:, None] & (t1 > start) & (t0 < stop)
    with np.errstate(invalid="ignore"):
        sf = np.where((t0 < start) & (start < t1),
                      np.clip(np.ceil((start - t0) * SR), 0.0, 128.0), 0.0)
        ef = np.where(np.isfinite(stop) & (t0 < stop) & (stop < t1),
                      np.clip(np.floor((stop - t0) * SR), 0.0, 128.0), 128.0)
    return np.where(active, sf, 0).astype(np.int64), np.where(active, ef, 0).astype(np.int64)


def k11_walk(f, started, start, stop, phase, bt, wave):
    """numpy walk of oscillator_kernel: (out f32[L, T], new phase f64[L])."""
    L, T = f.shape
    S = bt.shape[0]
    _, tile, pass_q = _kernel_constants()
    c32, c64 = np.float32(TWO_PI / SR), TWO_PI / SR
    lo, hi = _gates(started, start, stop, bt, float(Q) / SR)  # 0. a gate a quantum
    # 1. a thread a run: f32 prefix and f64 sum of 16 samples
    f4 = f.reshape(L, S, Q // RUN, RUN)
    idx = np.arange(Q).reshape(Q // RUN, RUN)
    on = (idx[None, None] >= lo[..., None, None]) & (idx[None, None] < hi[..., None, None])
    inc = np.where(on, c32 * f4, np.float32(0))
    pre = np.empty_like(inc)
    acc = np.zeros((L, S, Q // RUN), np.float32)
    dacc = np.zeros((L, S, Q // RUN))
    for k in range(RUN):
        acc = acc + inc[..., k]
        pre[..., k] = acc
        dacc = dacc + np.where(on[..., k], f4[..., k].astype(np.float64), 0.0)
    # 2. a thread a quantum: the runs in order, and their exclusive f32 sums
    b = dacc[..., 0]
    for c in range(1, Q // RUN):
        b = b + dacc[..., c]
    bsum = b * c64  # [L, S]
    before = np.empty_like(acc)
    e = np.zeros((L, S), np.float32)
    for c in range(Q // RUN):
        before[..., c] = e
        e = e + acc[..., c]
    # 3. per block: the passes before the tile's carried on by one thread,
    #    then thread q of the tile chains its pass's sums before it
    anchor32 = np.full((L, S), np.nan, np.float32)
    new_phase = np.full(L, np.nan)
    owner = np.zeros(S, np.int64)
    for q0 in range(0, S, tile):
        q_end = min(q0 + tile, S)
        cs = np.zeros(L)
        g0 = 0
        while g0 + pass_q < q_end:
            for j in range(g0, g0 + pass_q):
                cs = cs + bsum[:, j]
            g0 += pass_q
        assert g0 <= q0  # the tile lies in the last pass
        for q in range(q0, q_end):
            owner[q] += 1
            c = cs.copy()
            for j in range(g0, q):
                c = c + bsum[:, j]
            anchor32[:, q] = _jmod(phase + c, TWO_PI).astype(np.float32)
            if q == S - 1:
                new_phase = _jmod(phase + (c + bsum[:, q]), TWO_PI)
    assert (owner == 1).all() and not np.isnan(anchor32).any()
    # 4. a thread a float4: local phase, waveform, gate
    local = (pre + before[..., None]) - inc
    ph = _jmod(anchor32[..., None, None] + local, TWO_PI_F).astype(np.float32)
    if wave == "sine":
        w = np.sin(ph.astype(np.float64)).astype(np.float32).reshape(L, S, Q)  # rounded once
    elif wave == "square":
        w = np.where(ph < PI_F, np.float32(1), np.float32(-1)).reshape(L, S, Q)
    elif wave == "sawtooth":
        w = (np.float32(2) * (ph / TWO_PI_F) - np.float32(1)).reshape(L, S, Q)
    else:
        u = ph / TWO_PI_F
        w = (np.float32(4) * np.abs(u - np.floor(u + np.float32(0.5)))
             - np.float32(1)).reshape(L, S, Q)
    out = np.where(on.reshape(L, S, Q), w, np.float32(0)).reshape(L, T)
    return out.astype(np.float32), new_phase


def _states(L, S, seed):
    """Starts and stops on quantum and tile edges and inside quanta."""
    rng = np.random.default_rng(seed)
    dt = Q / SR
    t0 = 3 * dt
    bt = t0 + np.arange(S) * dt
    edges = [0, 1, 7, 8, 9, 16, 31, 32, 33, 63, 64, 65, S - 1, S]
    start = np.array([t0 + dt * min(edges[i % len(edges)], S) + (0.3 * dt if i % 3 == 1 else 0)
                      for i in range(L)])
    stop = np.array([np.inf if i % 4 == 0 else
                     start[i] + dt * edges[(i * 5) % len(edges)] + (0.55 * dt if i % 3 == 2 else 0)
                     for i in range(L)])
    started = (np.arange(L) % 7 != 3).astype(np.int32)
    return started, start, stop, rng.uniform(0, TWO_PI, L), bt


@pytest.mark.parametrize("per_sample", [False, True], ids=["base values", "rows"])
@pytest.mark.parametrize("S", [1, 4, 8, 33, 64, 72, 100])
def test_walk_matches_plain(S, per_sample):
    L = 14
    started, start, stop, phase, bt = _states(L, S, S)
    rng = np.random.default_rng(S + 7)
    f = (rng.random((L, S * Q)) * 20000.0).astype(np.float32) if per_sample else \
        np.repeat((rng.random((L, 1)) * 20000.0).astype(np.float32), S * Q, axis=1)
    tt = [torch.from_numpy(a) for a in (started, start, stop, phase, bt)]
    for wave in tosc.WAVE_CODES:
        want, want_phase = tosc.oscillator_group_step_plain(
            torch.from_numpy(f), *tt[:4], tt[4], SR, wave)
        got, got_phase = k11_walk(f, started, start, stop, phase, bt, wave)
        np.testing.assert_array_equal(got, want.numpy(), err_msg=wave)
        np.testing.assert_array_equal(got_phase, want_phase.numpy())
        assert np.abs(got).max() > 0.5


def test_tiles_and_passes_align():
    """A tile never straddles two passes, and the kernel's tile fills its
    256 threads with a float4 each."""
    threads, tile, pass_q = _kernel_constants()
    assert pass_q % tile == 0
    assert tile * Q == 4 * threads

