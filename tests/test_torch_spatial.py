"""The port's SpatialPannerNode against the JAX package's, on the CPU.

* K10b's plain version (``spatial_gains_plain``) against the jitted JAX
  ``_direct_gains`` plus the azimuth / elevation of ``process``, for each
  distance model, with a cone, occlusion with and without transmission,
  clipped distances and a source at the listener (the ``near`` branch), a
  moved and rotated listener: direction within 1e-6 rad, gains within
  1e-6 x max;
* the panner node in a graph of 4 looped voices (superblock 4) with
  automated positions, a cone, a listener moved between renders, against
  the JAX render: within 1e-5;
* the first touch of occlusion rebuilds the stage (a new group key) and
  attenuates, as the JAX panner does, within 1e-5 of its render;
* a measured HRIR set: ``load_hrir_grid`` is exact at measurement directions; the
  context default (``set_default_hrir``) renders as a per-node
  ``load_hrir`` does, batches the voices in one group, matches JAX within
  1e-5 and reverts with None; a set past 128 taps renders through the
  partitioned filter as the JAX package's does;
* the listener is render-state data: moving it rebuilds nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.nodes import spatial as jsp
from graphaudio_tpu_torch.nodes import spatial as tsp

SR = 48000
TOL = 1e-5


def _listener(position, forward, up):
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=1)
    ctx.set_listener(position, forward, up)
    return ctx.global_state()


class _Block:
    def __init__(self, v):
        self._v = v

    def per_block(self):
        return self._v


def _param_lanes(S, rng):
    """[V, S] values per GAIN_PARAMS name, one lane per case."""
    V = 6
    p = {}
    t = np.linspace(0.0, 1.0, S)
    pos = rng.uniform(-6.0, 6.0, (3, V, 1)) + rng.uniform(-2.0, 2.0, (3, V, 1)) * t
    lp = np.array([0.5, 0.2, -1.0])[:, None, None]
    pos[:, 4, ::2] = lp[:, 0, :]  # lane 4: the source sits on the listener every other block
    for i, n in enumerate(("positionX", "positionY", "positionZ")):
        p[n] = pos[i]
    o = rng.standard_normal((3, V, 1)) * np.ones(S)
    for i, n in enumerate(("orientationX", "orientationY", "orientationZ")):
        p[n] = o[i]
    defaults = dict(refDistance=1.0, maxDistance=10000.0, rolloffFactor=1.0, coneInnerAngle=360.0,
                    coneOuterAngle=360.0, coneOuterGain=0.0, spatialBlend=1.0, occlusion=0.0,
                    transmissionLow=0.0, transmissionMid=0.0, transmissionHigh=0.0)
    for n, d in defaults.items():
        p[n] = np.full((V, S), d)
    p["coneInnerAngle"][1], p["coneOuterAngle"][1], p["coneOuterGain"][1] = 60.0, 120.0, 0.25
    p["occlusion"][2] = 0.7
    p["occlusion"][3] = 0.5
    p["transmissionLow"][3], p["transmissionMid"][3] = 0.8, 0.3
    p["refDistance"][5], p["maxDistance"][5], p["rolloffFactor"][5] = 3.0, 6.0, 2.0
    p["spatialBlend"][5] = 0.4
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("model", list(jsp.DistanceModelType))
def test_direct_gains_match_jax(model):
    S = 8
    p = _param_lanes(S, np.random.default_rng(21))
    listener = _listener([0.5, 0.2, -1.0], [0.3, 0.0, -1.0], [0.0, 1.0, 0.1])
    jctx = ga.OfflineAudioContext(sample_rate=SR, superblock=S)
    node = jsp.SpatialPannerNode(jctx)
    node.distance_model = model

    @jax.jit
    def lane(vals, lst):
        dx, dy, dz, gains, blend = node._direct_gains(
            {n: _Block(v) for n, v in vals.items()}, lst, None)
        return jnp.stack([jnp.arctan2(dx, -dz), jnp.arcsin(jnp.clip(dy, -1.0, 1.0)),
                          *gains, blend])

    want = np.stack([np.asarray(lane({n: v[i] for n, v in p.items()}, listener))
                     for i in range(6)], axis=1)  # [6, V, S]
    got = tsp.spatial_gains_plain(
        torch.from_numpy(np.stack([p[n] for n in tsp.GAIN_PARAMS])),
        {k: torch.from_numpy(np.asarray(v)) for k, v in listener.items()},
        tsp.DistanceModelType(model.value)).numpy()
    assert got.shape == want.shape == (6, 6, S)
    assert np.abs(got[:2] - want[:2]).max() < 1e-6
    assert np.abs(got[2:] - want[2:]).max() < 1e-6 * np.abs(want[2:]).max()
    assert np.ptp(want[2]) > 0.1 and (want[2] != want[3]).any()  # the cases differ


def _voices(mod, n, superblock, seed=22, **ctx_kw):
    """``n`` looped mono voices -> one SpatialPannerNode each ->
    destination, positions ramping per quantum, voice 1 with a cone."""
    rng = np.random.default_rng(seed)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **ctx_kw)
    ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    pans = []
    for v in range(n):
        sig = (rng.standard_normal(SR // 8) * 0.3).astype(np.float32)
        src = mod.AudioBufferSourceNode(ctx)
        src.buffer = mod.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        pan = mod.SpatialPannerNode(ctx)
        x0, z0 = rng.uniform(-4, 4, 2)
        pan.position_x.set_value_at_time(float(x0), 0.0)
        pan.position_x.linear_ramp_to_value_at_time(float(-x0), 0.04)
        pan.position_z.set_value_at_time(float(z0), 0.0)
        pan.position_z.linear_ramp_to_value_at_time(float(z0) + 2.0, 0.04)
        pan.position_y.value = 0.5 * v - 0.5
        if v == 1:
            pan.cone_inner_angle.value = 50.0
            pan.cone_outer_angle.value = 140.0
            pan.cone_outer_gain.value = 0.2
        src.connect(pan).connect(ctx.destination)
        src.start(0.001 * v)
        pans.append(pan)
    return ctx, pans


def test_panner_node_matches_jax():
    T = 4 * 128
    jctx, _ = _voices(ga, 4, 4)
    tctx, _ = _voices(gat, 4, 4, device="cpu")
    want = [jctx.render(2 * T)]
    got = [tctx.render(2 * T)]
    for c in (jctx, tctx):
        c.set_listener([1.0, 0.0, 0.5], [0.5, 0.0, -1.0], [0, 1, 0])
    want.append(jctx.render(T + 200))
    got.append(tctx.render(T + 200))
    want, got = np.concatenate(want, axis=1), np.concatenate(got, axis=1)
    assert tctx.stats.graph_builds == 1
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL


def _one_voice(mod, rng_seed=23, **ctx_kw):
    rng = np.random.default_rng(rng_seed)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=2, **ctx_kw)
    src = mod.AudioBufferSourceNode(ctx)
    src.buffer = mod.PlayableAudioBuffer.from_mono_array(
        (rng.standard_normal(SR // 2) * 0.3).astype(np.float32), SR)
    src.loop = True
    pan = mod.SpatialPannerNode(ctx)
    pan.position_x.value = 2.0
    src.connect(pan).connect(ctx.destination)
    src.start(0)
    return ctx, pan


def test_occlusion_first_touch_rebuilds():
    outs = []
    for mod, kw in ((ga, {}), (gat, {"device": "cpu"})):
        ctx, pan = _one_voice(mod, **kw)
        before = ctx.render(1024)
        key_before = pan.group_key([1])
        pan.occlusion.value = 0.9  # no transmission: heavy broadband cut
        after = ctx.render(1024)
        assert pan.group_key([1]) != key_before
        outs.append(np.concatenate([before, after], axis=1))
    want, got = outs
    rms = lambda a: float(np.sqrt(np.mean(a.astype(np.float64) ** 2)))  # noqa: E731
    assert rms(got[:, 1024:]) < 0.25 * rms(got[:, :1024])
    assert np.abs(got - want).max() < TOL


def _delta_set(n=64):
    """Measured-style set: per-direction deltas with direction-coded delay
    and gain (twin of tests/test_spatial.py _synthetic_measured_set)."""
    azs, els, irs = [], [], []
    for el_deg in (-30, 0, 30):
        for az_deg in range(0, 360, 30):
            ir = np.zeros((2, n), np.float32)
            d = 3 + (az_deg // 30) % 4
            ir[0, d] = 1.0
            ir[1, d + 1] = 0.8
            azs.append(az_deg)
            els.append(el_deg)
            irs.append(ir)
    return {"hrir": np.stack(irs), "azimuth_deg": np.asarray(azs, np.float64),
            "elevation_deg": np.asarray(els, np.float64), "sample_rate": SR}


def test_load_hrir_grid_exact_at_measurement_directions():
    from graphaudio_tpu_torch.ops.hrtf import load_hrir_grid

    data = _delta_set()
    grid = load_hrir_grid(data, SR, n_azimuth=12, n_elevation=7)
    assert grid.shape == (7, 12, 2, 64)
    # The grid's azimuth is CLOCKWISE, the set's counterclockwise (SOFA):
    # elevation row 3 is 0 degrees; set azimuth 60 is grid column 10.
    m = data["hrir"][np.asarray(data["elevation_deg"]) == 0]
    np.testing.assert_allclose(grid[3, 0], m[0], atol=1e-7)
    np.testing.assert_allclose(grid[3, 10], m[2], atol=1e-7)


def _two_pans(mod, **ctx_kw):
    rng = np.random.default_rng(24)
    sig = (rng.standard_normal(SR // 4) * 0.2).astype(np.float32)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=4, **ctx_kw)
    pans = []
    for i in range(2):
        src = mod.AudioBufferSourceNode(ctx)
        src.buffer = mod.PlayableAudioBuffer.from_mono_array(sig, SR)
        pan = mod.SpatialPannerNode(ctx)
        pan.position_x.value = 2.0 * (1 if i == 0 else -1)
        src.connect(pan).connect(ctx.destination)
        src.start(0)
        pans.append(pan)
    return ctx, pans


def test_context_default_hrir():
    measured = _delta_set()
    ctx1, _ = _two_pans(gat, device="cpu")
    ctx1.set_default_hrir(measured)
    got = ctx1.render(1024)
    groups = [sp for sp in ctx1._compiled.plan
              if sp["group_key"] and sp["group_key"][0] == "spatial-panner"]
    assert len(groups) == 1 and groups[0]["n_lanes"] == 2

    ctx2, pans2 = _two_pans(gat, device="cpu")
    for p in pans2:
        p.load_hrir(measured)
    np.testing.assert_allclose(got, ctx2.render(1024), atol=1e-6)

    jctx, _ = _two_pans(ga)
    jctx.set_default_hrir(measured)
    assert np.abs(got - jctx.render(1024)).max() < TOL

    ctx3, _ = _two_pans(gat, device="cpu")
    base = ctx3.render(1024)
    assert not np.allclose(got, base)  # the measured default is in use
    ctx1.set_default_hrir(None)
    reverted = ctx1.render(1024)
    # the carried tail from the measured segment decays within two quanta
    np.testing.assert_allclose(reverted[:, 256:], ctx3.render(1024)[:, 256:], atol=1e-6)


def test_hrir_past_128_taps_raises():
    """A 320-tap per-node set (3 partitions) beside the analytic 64-tap
    default, once a raise (the partitioned filter was not ported): it now
    renders through the partitioned path, as the JAX package's does."""
    rng = np.random.default_rng(25)
    data = _delta_set(n=320)
    data["hrir"] = data["hrir"] + rng.standard_normal(data["hrir"].shape).astype(np.float32) * 0.01
    ctx, pans = _two_pans(gat, device="cpu")
    pans[0].load_hrir(data, length=320)
    got = ctx.render(512)
    st = ctx.peek_node_state(pans[0])
    assert st["hx"].shape == (2, 258) and st["ola"].shape == (2, 128)
    jctx, jpans = _two_pans(ga)
    jpans[0].load_hrir(data, length=320)
    want = np.asarray(jctx.render(512))
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL


def test_listener_is_render_state():
    ctx, _ = _two_pans(gat, device="cpu")
    ctx.render(512)
    ctx.set_listener([0, 0, 1], [1, 0, 0], [0, 1, 0])
    g = ctx._states["__globals__"]
    np.testing.assert_allclose(g["listener_ahead"].numpy(), [-1, 0, 0], atol=1e-7)
    np.testing.assert_allclose(g["listener_pos"].numpy(), [0, 0, 1])
    ctx.render(512)
    assert ctx.stats.graph_builds == 1
    assert ctx.global_state()["listener_right"].tolist() == pytest.approx([0, 0, 1], abs=1e-7)
