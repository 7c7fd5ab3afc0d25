"""P1's tile plan (ops/hrtf.py ``fir_tile_plan``), emulated in numpy f32.

csrc/hrtf_fir.cu gives each lane R consecutive outputs of one ear and runs
their tap sums in chunks of R taps over zero-padded shared buffers. CUDA has
no CPU mode, so this file walks the same lane table in numpy, in the
kernel's order: the plan's lane words, decoded as the kernel decodes them,
the mono quanta with R zeros before and after, the
quantum's own chain and then the previous quantum's, each output in its own
accumulator in ascending tap order, taps at or past L skipped, ``ola`` in
place of the previous chain in the first quantum's block, and the carried
tail in the last quantum's block. It must equal ``hrtf_fir_plain`` bit for
bit (compared as int32 views, so a -0 for a +0 fails too).
"""

import numpy as np
import pytest
import torch

from graphaudio_tpu_torch.ops import hrtf as th

F = 128


def _lanes(words):
    """The kernel's decode of the lane words: ear, t0, chunks of the own
    chain, chunks of the previous quantum's tail."""
    w = np.asarray(words, dtype=np.int64)
    return w & 1, (w >> 1) & 0xFF, (w >> 9) & 0xFF, (w >> 17) & 0xFF


def _emulate_tiles(x, gain, az, el, blend, grid, ola, R):
    """The kernel's loops for every block (s, v), vectorized over voices
    and lanes. numpy f32 arrays round each multiply and add as the
    kernel's ``__fmul_rn`` / ``__fadd_rn``."""
    V, C, T = x.shape
    S, L, W = T // F, grid.shape[-1], ola.shape[-1]
    plan = th.fir_tile_plan(L, W, R)
    Lc = plan.taps
    ear, t0, n_first, n_tail = _lanes(plan.words)
    nl = len(plan.words)

    h = th.interp_hrir(torch.from_numpy(grid), torch.from_numpy(az),
                       torch.from_numpy(el)).numpy()  # [V, S, 2, L]
    hp = np.zeros((V, S, 2, Lc), np.float32)
    hp[..., :L] = h
    direct = x if gain is None else x * np.repeat(gain, F, axis=-1)[:, None, :]
    mono = direct[:, 0] if C == 1 else (direct[:, 0] + direct[:, 1]) * np.float32(0.5)
    mq = mono.reshape(V, S, F)
    # The block's shared buffers: ms = [R zeros | m_s | R zeros] and
    # mp = [m_{s-1} | R zeros], laid end to end so one gather serves both.
    ms = np.zeros((V, S, R + F + R), np.float32)
    ms[..., R:R + F] = mq
    mp = np.zeros((V, S, F + R), np.float32)
    mp[:, 1:, :F] = mq[:, :-1]
    MP = R + F + R  # where mp starts in the joined buffer
    lanes = np.arange(nl)

    def chunk(acc, buf, hrow, live, k0, base):
        """mac_chunk for every lane with ``live``: window buf[base + i],
        taps hrow[k0 + j], output r meeting tap j at window R + r - j."""
        w = buf[:, base[:, None] + np.arange(2 * R)]  # [V, nl, 2R]
        for j in range(R):
            ok = live & (k0 + j < L)
            hv = hrow[:, lanes, np.minimum(k0 + j, hrow.shape[-1] - 1)]  # [V, nl]
            for r in range(R):
                acc[:, ok, r] = acc[:, ok, r] + hv[:, ok] * w[:, ok, R + r - j]

    out = np.empty((V, 2, T), np.float32)
    ola_out = np.empty((V, 2, W), np.float32)
    for s in range(S):
        buf = np.concatenate([ms[:, s], mp[:, s]], axis=-1)
        h_own = hp[:, s][:, ear]  # [V, nl, Lc]
        h_prev = hp[:, max(s - 1, 0)][:, ear]
        n = n_first + (n_tail if s > 0 and L > 1 else 0)
        acc = np.zeros((V, nl, R), np.float32)
        first = np.zeros((V, nl, R), np.float32)
        for c in range(int(n.max())):
            switch = (c == n_first) & (c < n)
            first[:, switch] = acc[:, switch]
            acc[:, switch] = 0.0
            own = c < n_first
            k0 = np.where(own, c * R, t0 + (c - n_first) * R)
            base = np.where(own, t0 - k0, MP + F + t0 - k0 - R)
            hrow = np.where(own[None, :, None], h_own, h_prev)
            chunk(acc, buf, hrow, c < n, k0, base)
        no_prev = n == n_first
        first[:, no_prev] = acc[:, no_prev]
        prev = np.where(no_prev[None, :, None], np.float32(0.0), acc)
        if s == 0:
            tail_in = t0 < W
            idx = t0[tail_in][:, None] + np.arange(R)
            prev[:, tail_in] = ola[:, ear[tail_in][:, None], idx]
        b = blend[:, s][:, None, None]
        t_idx = t0[:, None] + np.arange(R)  # [nl, R]
        dry = (ms[:, s][:, R + t_idx] if C == 1
               else direct[:, ear[:, None], s * F + t_idx])
        wet = first + prev
        out[:, ear[:, None], s * F + t_idx] = wet * b + dry * (np.float32(1.0) - b)
        if s == S - 1:
            acc = np.zeros((V, nl, R), np.float32)
            for c in range(int(n_tail.max(initial=0))):
                k0 = t0 + c * R
                chunk(acc, ms[:, s], h_own, c < n_tail, k0, F + t0 - k0)
            tail_in = t0 < W
            ola_out[:, ear[tail_in][:, None], t0[tail_in][:, None] + np.arange(R)] = acc[:, tail_in]
    return out, ola_out


def _inputs(L, C, with_gain, V=3, S=3, seed=21):
    """A moving source, a non-zero carried tail over all W samples (the
    kernel adds it at every t < W of the first quantum), blend in (0, 1)."""
    rng = np.random.default_rng(seed + L)
    W = th.hrtf_fft_size(L) - F
    grid = th.build_hrir_grid(48000) if L == 64 else (
        rng.standard_normal((7, 12, 2, L)) * 0.2).astype(np.float32)
    t = np.linspace(0.0, 1.0, S, dtype=np.float32)
    az = ((0.3 + 5.0 * t)[None] * np.linspace(-1.5, 1.5, V, dtype=np.float32)[:, None])
    el = ((-1.4 + 2.8 * t)[None] * np.linspace(0.2, 1.0, V, dtype=np.float32)[:, None])
    x = (rng.standard_normal((V, C, S * F)) * 0.1).astype(np.float32)
    gain = rng.uniform(0.0, 1.0, (V, S)).astype(np.float32) if with_gain else None
    blend = rng.uniform(0.0, 1.0, (V, S)).astype(np.float32)
    ola = (rng.standard_normal((V, 2, W)) * 0.01).astype(np.float32)
    return x, gain, az.astype(np.float32), el.astype(np.float32), blend, grid, ola


@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("with_gain", [True, False], ids=["gain", "no_gain"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("L", [1, 37, 64, 128])
def test_tile_plan_emulation_matches_plain(L, C, with_gain, R):
    args = _inputs(L, C, with_gain)
    got, got_ola = _emulate_tiles(*args, R)
    want, want_ola = (t.numpy() for t in th.hrtf_fir_plain(
        *(None if a is None else torch.from_numpy(a) for a in args)))
    assert np.abs(want).max() > 1e-2
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got_ola.view(np.int32), want_ola.view(np.int32))


@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("L, W", [(1, 64), (37, 64), (64, 64), (65, 128), (128, 128)])
def test_tile_plan_lanes(L, W, R):
    """Every output of both ears is owned once; the ramp lanes come first,
    so at most one warp mixes ramp and other lanes; a ramp lane runs one
    chunk more than the rest, and every lane's own chain covers its taps."""
    plan = th.fir_tile_plan(L, W, R)
    assert plan.words.dtype == np.int32 and len(plan.words) == 2 * F // R
    ear, t0, first, prev = (a.tolist() for a in _lanes(plan.words))
    owned = sorted((e, t + r) for e, t in zip(ear, t0) for r in range(R))
    assert owned == [(e, t) for e in range(2) for t in range(F)]
    ramp = [t < L - 1 for t in t0]
    assert ramp == sorted(ramp, reverse=True)
    assert ramp == [p > 0 for p in prev]
    warps = [set(ramp[i:i + 32]) for i in range(0, len(ramp), 32)]
    assert sum(len(w) > 1 for w in warps) <= 1
    for t, f, p, rp in zip(t0, first, prev, ramp):
        assert f + p == plan.taps // R + (1 if rp else 0)
        assert f * R >= min(plan.taps, t + 1)
