"""The port's partitioned HRTF filter (HRIRs of 129-1024 taps) against the
JAX package, on the CPU (plain kernel versions).

* K10p's plain version (``hrtf_fir_partitioned_plain``) against the jitted
  JAX ``fir_freq_partitioned`` with ``interp_hrir`` of the partition
  spectra, as the JAX panner calls them: seeded inputs, P = 2, 3 and 8 at
  superblocks 1, 4 and 8 (the ring longer than the superblock at P = 8),
  directions moving every quantum, a stereo input and the occluded route
  (no gain) among them, the ring, its directions and the tail carried over
  three calls: within 1e-5 max abs, output and carried state;
* twins of tests/test_spatial.py's long-HRIR tests: the partition count,
  the loader's default keeping two partitions, a static 320-tap kernel
  equal to one long convolution (1e-4), a moving source against the JAX
  package's numpy oracle (2e-5);
* config5_measured reduced (8 voices, superblock 8, 4 steps, positions
  ramped every quantum) at P = 2 (the default: a 512-tap 44.1 kHz set cut
  to 256 taps) and P = 8 (1024 taps), side by side with the JAX render:
  within 1e-5;
* a mid-render hand-off through utils.from_jax at P = 8 and superblock 4
  (the ring longer than the superblock): JAX renders 2 steps, both
  continue 2, within 1e-5;
* a regroup (occlusion first touched mid-render) carries each moved lane's
  ``hx`` / ``haz`` / ``hel`` / ``ola``; a panner whose partition count
  changes mid-render (a per-node 320-tap set loaded beside the analytic
  64-tap default, then cleared) starts afresh, as the JAX package's does,
  within 1e-5 of its render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.ops import hrtf as jh
from graphaudio_tpu_torch.ops import hrtf as th
from graphaudio_tpu_torch.testing.configs import config5_measured
from graphaudio_tpu_torch.utils import from_jax

SR = 48000
TOL = 1e-5


def _dense_measured_set(rng, sr=SR, n=320):
    """Dense random HRIRs (every tap significant) on a 3 x 12 lattice (twin
    of tests/test_spatial.py _dense_measured_set)."""
    azs, els, irs = [], [], []
    for el_deg in (-30, 0, 30):
        for az_deg in range(0, 360, 30):
            ir = (rng.standard_normal((2, n)) * np.exp(-np.arange(n) / (n / 4.0))
                  ).astype(np.float32) * 0.2
            azs.append(az_deg)
            els.append(el_deg)
            irs.append(ir)
    return {"hrir": np.stack(irs), "azimuth_deg": np.asarray(azs, np.float64),
            "elevation_deg": np.asarray(els, np.float64), "sample_rate": sr}


@jax.jit
def _jax_group(x, gain, az, el, blend, sr, si, hx, haz, hel, ola):
    """The JAX panner's long-HRIR path for a group (nodes/spatial.py:398-441
    without the direct gains), vmapped over the voices."""
    def one(x, gain, az, el, blend, hx, haz, hel, ola):
        direct = x if gain is None else x * jnp.repeat(gain, 128)[None]
        mono = jnp.mean(direct, axis=0).reshape(-1, 128)
        az_cat, el_cat = jnp.concatenate([haz, az]), jnp.concatenate([hel, el])
        hr = jh.interp_hrir(sr, az_cat, el_cat)
        hi = jh.interp_hrir(si, az_cat, el_cat)
        wet, ring, tail = jh.fir_freq_partitioned(mono, hr, hi, hx, ola)
        wet = wet.reshape(2, -1)
        b = jnp.repeat(blend, 128)[None]
        dry = jnp.broadcast_to(direct, (2, direct.shape[1])) if direct.shape[0] == 1 else direct
        n = haz.shape[0]
        return wet * b + dry * (1.0 - b), ring, az_cat[-n:], el_cat[-n:], tail

    gain_axis = None if gain is None else 0
    return jax.vmap(one, in_axes=(0, gain_axis, 0, 0, 0, 0, 0, 0, 0))(
        x, gain, az, el, blend, hx, haz, hel, ola)


@pytest.mark.parametrize("P,S,C,with_gain", [
    (2, 1, 1, True), (2, 4, 2, True), (2, 8, 1, False),
    (3, 1, 1, True), (3, 4, 1, False), (3, 8, 2, True),
    (8, 1, 2, False), (8, 4, 1, True), (8, 8, 1, True)])
def test_plain_matches_jax(P, S, C, with_gain):
    rng = np.random.default_rng(100 * P + S)
    V, E, A = 3, 7, 12
    L = 128 * P - 19 * (P % 2)  # a zero-padded last partition at odd P
    grid = (rng.standard_normal((E, A, 2, L)) * np.exp(-np.arange(L) / (L / 3.0)) * 0.3
            ).astype(np.float32)
    sr, si = jh.hrir_grid_spectra(grid)
    tsr, tsi = th.hrir_grid_spectra(grid)
    np.testing.assert_array_equal(tsr, sr)
    np.testing.assert_array_equal(tsi, si)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    state = [np.zeros((V, P - 1, 258), np.float32), np.zeros((V, P - 1), np.float32),
             np.zeros((V, P - 1), np.float32), np.zeros((V, 2, 128), np.float32)]
    az0 = rng.uniform(-np.pi, np.pi, (V, 1))
    for call in range(3):
        q = np.arange(call * S, (call + 1) * S)[None, :]
        x = f32(rng.standard_normal((V, C, S * 128)) * 0.3)
        gain = f32(rng.uniform(0.2, 1.0, (V, S))) if with_gain else None
        az = f32(az0 + 0.21 * q)  # moving every quantum
        el = f32(np.sin(0.3 * q + np.arange(V)[:, None]) * 1.2)
        blend = f32(rng.uniform(0.0, 1.0, (V, S)))
        want = [np.asarray(a) for a in _jax_group(x, gain, az, el, blend, sr, si, *state)]
        t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
        got = th.hrtf_fir_partitioned_plain(t(x), t(gain), t(az), t(el), t(blend), t(tsr),
                                            t(tsi), *map(t, state))
        assert np.abs(want[0]).max() > 1e-2
        for name, g, w in zip(("out", "hx", "haz", "hel", "ola"), got, want):
            assert g.shape == w.shape, name
            assert np.abs(g.numpy() - w).max() < TOL, name
        state = [g.numpy() for g in got[1:]]


def test_hrir_partition_count():
    for L, P in ((32, 1), (64, 1), (100, 1), (128, 1), (129, 2), (320, 3), (1024, 8)):
        assert th.hrir_partition_count(L) == jh.hrir_partition_count(L) == P


def test_load_hrir_grid_default_keeps_two_partitions(rng):
    data = _dense_measured_set(rng, n=400)
    grid = th.load_hrir_grid(data, SR, n_azimuth=12, n_elevation=7)
    assert grid.shape[-1] == 256
    np.testing.assert_array_equal(grid, jh.load_hrir_grid(data, SR, n_azimuth=12,
                                                          n_elevation=7))


def test_partitioned_fir_static_exact(rng):
    """A static 320-tap kernel (3 partitions, state carried across two
    calls) equals one long direct convolution."""
    data = _dense_measured_set(rng, n=320)
    grid = th.load_hrir_grid(data, SR, n_azimuth=12, n_elevation=7, length=320)
    sr, si = map(torch.from_numpy, th.hrir_grid_spectra(grid))
    assert tuple(sr.shape) == grid.shape[:3] + (3, 129)
    az, el, S = 0.7, 0.2, 4
    sig = (rng.standard_normal(2 * S * 128) * 0.5).astype(np.float32)
    h = th.interp_hrir(torch.from_numpy(grid), torch.tensor([az]), torch.tensor([el]))[0]
    want = np.stack([np.convolve(sig, h[e].numpy())[:sig.shape[0]] for e in range(2)])
    state = (torch.zeros(1, 2, 258), torch.zeros(1, 2), torch.zeros(1, 2), torch.zeros(1, 2, 128))
    full = torch.full((1, S), az), torch.full((1, S), el)
    outs = []
    for half in range(2):
        x = torch.from_numpy(sig[half * S * 128:(half + 1) * S * 128]).reshape(1, 1, -1)
        out, *state = th.hrtf_fir_partitioned(x, None, *full, torch.ones(1, S), sr, si, *state)
        # the ring's directions: the static one, from the first call on
        assert torch.equal(state[1], torch.full((1, 2), az))
        outs.append(out[0].numpy())
    assert np.abs(np.concatenate(outs, axis=1) - want).max() < 1e-4


def test_partitioned_hrtf_matches_oracle_moving(rng):
    """A moving source with a 320-tap set: the port's render against the
    JAX package's numpy oracle (per-block time-domain convolution with
    input-time kernels)."""
    from graphaudio_tpu.testing.oracle import (
        OracleBufferSource, OracleContext, OracleSpatialPanner,
    )

    data = _dense_measured_set(rng, n=320)
    grid = th.load_hrir_grid(data, SR, n_azimuth=12, n_elevation=7, length=320)
    sig = (rng.standard_normal(SR // 8) * 0.3).astype(np.float32)

    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=8, device="cpu")
    src = gat.AudioBufferSourceNode(ctx)
    src.buffer = gat.PlayableAudioBuffer.from_mono_array(sig, SR)
    src.loop = True
    pan = gat.SpatialPannerNode(ctx)
    pan.load_hrir(data, n_azimuth=12, n_elevation=7, length=320)
    pan.position_x.set_value_at_time(3.0, 0.0)
    pan.position_x.linear_ramp_to_value_at_time(-3.0, 0.1)
    pan.position_z.value = -2.0
    src.connect(pan).connect(ctx.destination)
    src.start(0)
    got = ctx.render(SR // 8)

    octx = OracleContext(sample_rate=SR)
    osrc = OracleBufferSource(octx)
    osrc.set_buffer(sig, SR)
    osrc.loop = True
    opan = OracleSpatialPanner(octx, grid)
    opan.position_x.set_value_at_time(3.0, 0.0)
    opan.position_x.linear_ramp_to_value_at_time(-3.0, 0.1)
    opan.position_z.value = -2.0
    osrc.connect(opan).connect(octx.destination)
    osrc.start(0)
    want = octx.render(SR // 8)
    # Skip block 1 (the oracle's documented channel-count startup transient).
    assert np.max(np.abs(got[:, 128:] - want[:, 128:])) < 2e-5


def _measured(api, taps, superblock=8, voices=8, **kw):
    """config5_measured at a small size, every source moving along the chord
    to the point a quarter turn further round over 0.1 s."""
    ctx = config5_measured(superblock=superblock, voices=voices, api=api, taps=taps, **kw)
    for v, snd in enumerate(ctx._sounds):
        a = 2 * np.pi * v / voices
        pan = snd._spatial_panner
        for prm, fn in ((pan.position_x, np.cos), (pan.position_z, np.sin)):
            prm.set_value_at_time(float(5 * fn(a)), 0.0)
            prm.linear_ramp_to_value_at_time(float(5 * fn(a + np.pi / 2)), 0.1)
    return ctx


def _panner_states(ctx):
    return [ctx.peek_node_state(s._spatial_panner) for s in ctx._sounds]


@pytest.mark.parametrize("taps,P", [(None, 2), (1024, 8)])
def test_config5_measured_side_by_side_with_jax(taps, P):
    T = 8 * 128
    want = np.asarray(_measured(ga, taps).render(4 * T))
    tctx = _measured(None, taps, device="cpu")
    got = tctx.render(4 * T)
    groups = [sp for sp in tctx._compiled.plan
              if type(sp["rep"]).__name__ == "SpatialPannerNode"]
    assert [sp["n_lanes"] for sp in groups] == [8]
    assert tctx._consts[f"{groups[0]['key']}/hrtf_sr"].shape == (7, 24, 2, P, 129)
    st = _panner_states(tctx)[0]
    assert st["hx"].shape == (P - 1, 258) and st["haz"].shape == (P - 1,)
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL


def test_mid_render_handoff_from_jax():
    T = 4 * 128
    jctx = _measured(ga, 1024, superblock=4)
    jctx.render(2 * T)
    tctx = _measured(None, 1024, superblock=4, device="cpu")
    jstates = jax.device_get(jctx._states)
    from_jax.load_render_state(tctx, jstates, jax.device_get(jctx._consts),
                               jctx._current_frame, jctx._current_time)
    held = _panner_states(tctx)[0]
    assert held["hx"].shape == (7, 258) and np.abs(held["hx"]).max() > 0
    want = np.asarray(jctx.render(2 * T))
    got = tctx.render(2 * T)
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL


def test_regroup_carries_the_ring():
    """Occlusion first touched on two live voices mid-render: their panners
    leave the open group for an occluded one (a rebuild), each lane's ring,
    its directions and tail carried, as the JAX package carries them."""
    T = 8 * 128
    ctxs = [_measured(ga, None), _measured(None, None, device="cpu")]
    outs = [[np.asarray(c.render(2 * T))] for c in ctxs]
    before = _panner_states(ctxs[1])
    for c in ctxs:
        for v in (2, 5):
            c._sounds[v].occlusion = 0.6
    ctxs[1]._ensure_compiled()
    after = _panner_states(ctxs[1])
    groups = sorted(sp["n_lanes"] for sp in ctxs[1]._compiled.plan
                    if type(sp["rep"]).__name__ == "SpatialPannerNode")
    assert groups == [2, 8] and ctxs[1].stats.graph_builds == 2  # 6 open (padded), 2 occluded
    for b, a in zip(before, after):
        for k in ("hx", "haz", "hel", "ola"):
            np.testing.assert_array_equal(a[k], b[k])
    assert np.abs(after[2]["hx"]).max() > 0
    for c, o in zip(ctxs, outs):
        o.append(np.asarray(c.render(2 * T)))
    want, got = (np.concatenate(o, axis=1) for o in outs)
    assert np.abs(want[:, 2 * T:]).max() > 1e-2
    assert np.abs(got - want).max() < TOL


def _pans(mod, **ctx_kw):
    """Two moving voices on the analytic 64-tap default (one group)."""
    rng = np.random.default_rng(26)
    sig = (rng.standard_normal(SR // 4) * 0.2).astype(np.float32)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=4, **ctx_kw)
    pans = []
    for i in range(2):
        src = mod.AudioBufferSourceNode(ctx)
        src.buffer = mod.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        pan = mod.SpatialPannerNode(ctx)
        pan.position_x.set_value_at_time(2.0 - 4.0 * i, 0.0)
        pan.position_x.linear_ramp_to_value_at_time(4.0 * i - 2.0, 0.1)
        pan.position_z.value = -1.0
        src.connect(pan).connect(ctx.destination)
        src.start(0)
        pans.append(pan)
    return ctx, pans


def test_partition_count_change_starts_afresh(rng):
    """A per-node 320-tap set loaded mid-render on one of two panners on
    the 64-tap default (two groups of different P, the tail 64 -> 128
    wide), then cleared: the changed panner's state starts afresh each
    time, in both packages, and the renders agree."""
    data = _dense_measured_set(rng, n=320)
    T = 4 * 128
    (jctx, jpans), (tctx, tpans) = _pans(ga), _pans(gat, device="cpu")
    outs = [[np.asarray(jctx.render(2 * T))], [tctx.render(2 * T)]]
    for pans in (jpans, tpans):
        pans[0].load_hrir(data, n_azimuth=12, n_elevation=7, length=320)
    tctx._ensure_compiled()
    st = tctx.peek_node_state(tpans[0])
    assert st["hx"].shape == (2, 258) and st["ola"].shape == (2, 128)
    assert not np.abs(st["hx"]).any() and not np.abs(st["ola"]).any()
    assert tctx.peek_node_state(tpans[1])["ola"].shape == (2, 64)
    for c, o in zip((jctx, tctx), outs):
        o.append(np.asarray(c.render(2 * T)))
    for pans in (jpans, tpans):
        pans[0].clear_hrir()
    tctx._ensure_compiled()
    st = tctx.peek_node_state(tpans[0])
    assert "hx" not in st and st["ola"].shape == (2, 64) and not np.abs(st["ola"]).any()
    for c, o in zip((jctx, tctx), outs):
        o.append(np.asarray(c.render(2 * T)))
    want, got = (np.concatenate(o, axis=1) for o in outs)
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL
