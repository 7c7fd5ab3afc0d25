"""Modulated params that a stage's prologue request reads, on the CPU.

The biquad's frequency, Q and gain (K8) and the spatial panner's 17 params
(K10b) are read by the step's prologue, which runs before any node. A
modulated one is written by K6m into rows of the K6 arena reserved for it,
and the stage's own one-item K8 or K10b table runs at its turn:

* twins of tests/test_mod_groups.py::test_modulated_biquads_group (:198,
  atol 1e-5) and ::test_krate_modulated_spatial_panners_group (:161, atol
  1e-6): the port against the JAX render and against its own ungrouped
  subclasses, as one group stage;
* a modulated Q and peaking gain, a modulated occlusion (K9's band gains
  from the modulated rows) and a modulated positionX, against JAX;
* the reserved rows poisoned with NaN before each step: nothing reads them
  before K6m writes them;
* the unmodulated stages keep their batched prologue tables;
* ``config3_wah`` and ``config5_orbit`` (8 superblocks, 8 voices) against
  their JAX renders within 1e-5.
"""

from unittest import mock

import numpy as np
import pytest

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.core import graph as tgraph
from graphaudio_tpu_torch.testing import configs as tconfigs

SR = 48000


def _ungrouped(cls):
    return type(f"Ungrouped{cls.__name__}", (cls,), {"group_key": lambda self, ic: None})


def _biquad_scene(pkg, ctx, grouped=True, param="frequency", ftype=None, depth=300.0):
    """tests/test_mod_groups.py::test_modulated_biquads_group's scene: 3
    voices of one noise buffer through a biquad whose ``param`` takes a
    per-voice LFO (4 + v Hz) through a depth gain."""
    frames = 8 * 128
    rng = np.random.default_rng(3)
    sig = (rng.standard_normal(frames) * 0.2).astype(np.float32)
    bq, osc = pkg.BiQuadFilterNode, pkg.OscillatorNode
    if not grouped:
        bq, osc = _ungrouped(bq), _ungrouped(osc)
    for v in range(3):
        src = pkg.AudioBufferSourceNode(ctx)
        src.buffer = pkg.PlayableAudioBuffer.from_mono_array(sig, SR)
        f = bq(ctx, type=getattr(pkg.FilterType, ftype)) if ftype else bq(ctx)
        f.frequency.value = 800.0 + 200.0 * v
        lfo = osc(ctx)
        lfo.frequency.value = 4.0 + v
        g = pkg.GainNode(ctx)
        g.gain.value = depth
        lfo.connect(g).connect(f.params[param])
        src.connect(f).connect(ctx.destination)
        src.start(0)
        lfo.start(0)
    return ctx


def _spatial_scene(pkg, ctx, grouped=True, param="spatialBlend", value=0.5, depth=1.0):
    """tests/test_mod_groups.py::test_krate_modulated_spatial_panners_group's
    scene: 3 constant sources through panners whose ``param`` takes a
    per-voice LFO (1 + v Hz) through a depth gain."""
    pan_cls, osc, const = pkg.SpatialPannerNode, pkg.OscillatorNode, pkg.ConstantSourceNode
    if not grouped:
        pan_cls, osc, const = _ungrouped(pan_cls), _ungrouped(osc), _ungrouped(const)
    ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    for v in range(3):
        src = const(ctx)
        src.offset.value = 0.3
        pan = pan_cls(ctx)
        pan.position_x.value = float(v - 1)
        pan.position_z.value = -2.0
        pan.spatial_blend.value = 0.5
        pan.params[param].value = value
        lfo = osc(ctx)
        lfo.frequency.value = 1.0 + v
        if depth == 1.0:
            lfo.connect(pan.params[param])
        else:
            g = pkg.GainNode(ctx)
            g.gain.value = depth
            lfo.connect(g).connect(pan.params[param])
        src.connect(pan).connect(ctx.destination)
        src.start(0)
        lfo.start(0)
    return ctx


def _jax(build, **kw):
    return np.asarray(build(ga, ga.OfflineAudioContext(sample_rate=SR, superblock=2),
                            **kw).render(8 * 128))


def _port(build, **kw):
    ctx = build(gat, gat.OfflineAudioContext(sample_rate=SR, superblock=2, device="cpu"), **kw)
    return ctx, ctx.render(8 * 128)


def _kinds(ctx):
    return [(kind, len(nodes)) for kind, nodes, _ in ctx._compiled.stages]


def test_modulated_biquads_group():
    want = _jax(_biquad_scene)
    ctx, got = _port(_biquad_scene)
    _, single = _port(_biquad_scene, grouped=False)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, single, atol=1e-5, rtol=0)
    assert ("group", 3) in _kinds(ctx)
    # one deferred K8 table (the group stage's), no batched biquad table
    (key,) = ctx._encs[tgraph.DEFERRED]
    assert ctx._compiled.stages[int(key[2:])][2][0] == "biquad"
    assert not ctx._encs[tgraph.PROLOGUE]
    assert list(ctx._encs[tgraph.PARAM_TABLE]["reserved"]) == [f"{key}/frequency"]


def test_krate_modulated_spatial_panners_group():
    want = _jax(_spatial_scene)
    ctx, got = _port(_spatial_scene)
    _, single = _port(_spatial_scene, grouped=False)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, single, atol=1e-6, rtol=0)
    assert ("group", 3) in _kinds(ctx)
    assert len(ctx._encs[tgraph.DEFERRED]) == 1


@pytest.mark.parametrize("param,ftype,depth", [
    ("Q", None, 0.5), ("gain", "PEAKING", 6.0), ("frequency", "HIGHSHELF", 300.0)])
def test_modulated_biquad_params_against_jax(param, ftype, depth):
    """Q (a-rate) and gain (k-rate: the modulator at each quantum's start)
    and a shelving type's frequency; Q's clamp comes before K8's own."""
    kw = dict(param=param, ftype=ftype, depth=depth)
    want = _jax(_biquad_scene, **kw)
    _, got = _port(_biquad_scene, **kw)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("param,value,depth", [
    ("occlusion", 0.5, 0.4), ("positionX", 0.0, 2.0), ("transmissionMid", 0.3, 0.3)])
def test_modulated_panner_params_against_jax(param, value, depth):
    """A modulated occlusion or transmission param turns the band split on
    and K9 reads its modulated band gains; a modulated position swings the
    source past the listener."""
    kw = dict(param=param, value=value, depth=depth)
    want = _jax(_spatial_scene, **kw)
    ctx, got = _port(_spatial_scene, **kw)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    occluded = param != "positionX"
    assert ctx._compiled.stages[int(next(iter(ctx._encs[tgraph.DEFERRED]))[2:])][1][0] \
        ._occlusion_active() == occluded


@pytest.mark.parametrize("build", [_biquad_scene, _spatial_scene], ids=["biquad", "panner"])
def test_reserved_rows_poisoned(build):
    """The reserved rows hold NaN from K6's launch until K6m writes them:
    a read before that would put NaN in the render."""
    _, want = _port(build)
    real = tgraph.eval_intrinsic_batch

    def poisoned(table, block_times, dt):
        arena = real(table, block_times, dt)
        for slot in table["reserved"].values():
            arena[slot.off:slot.off + slot.lanes * slot.per_lane] = float("nan")
        return arena

    with mock.patch.object(tgraph, "eval_intrinsic_batch", poisoned):
        ctx, got = _port(build)
    assert ctx._encs[tgraph.PARAM_TABLE]["reserved"]
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_unmodulated_stages_keep_the_batch():
    """Beside a modulated biquad group, an unmodulated biquad keeps its
    batched K8 table, and the K6 table's rows and offsets are those of the
    same graph without the modulated group: the reserved rows come last."""

    def build(pkg, ctx, modulated=True):
        if modulated:
            _biquad_scene(pkg, ctx)
        src = pkg.ConstantSourceNode(ctx)
        f = pkg.BiQuadFilterNode(ctx)
        f.frequency.set_value_at_time(500.0, 0.0)
        f.frequency.linear_ramp_to_value_at_time(900.0, 0.01)
        src.connect(f).connect(ctx.destination)
        src.start(0)
        return ctx

    ctx, got = _port(build)
    base, _ = _port(build, modulated=False)
    (batch,) = ctx._encs[tgraph.PROLOGUE].values()
    (plain_batch,) = base._encs[tgraph.PROLOGUE].values()
    assert len(batch["keys"]) == 1 and len(ctx._encs[tgraph.DEFERRED]) == 1
    assert batch["table"]["rows"].tolist() == plain_batch["table"]["rows"].tolist()
    t, t0 = ctx._encs[tgraph.PARAM_TABLE], base._encs[tgraph.PARAM_TABLE]
    assert t["rows"].tolist() == t0["rows"].tolist()
    (held,) = t["reserved"].values()
    # four lanes (three padded to a power of two) of S = 2 quanta of 128
    assert held.off == t0["size"] and t["size"] == t0["size"] + 4 * 2 * 128
    np.testing.assert_allclose(got, _jax(build), atol=1e-5, rtol=0)


@pytest.mark.parametrize("builder, kw, deferred", [
    ("config3_wah", dict(superblock=4), 4),
    ("config5_orbit", dict(superblock=8, voices=8), 1),
])
def test_mod8b_paths_against_jax(builder, kw, deferred):
    """The wah's four biquads each take their K8 at their turn; the orbit's
    panner group its K10b, positionX k-rate. The orbit's depth gains share
    the voices' gain stage (one key, one wave), so its LFOs reach
    positionX lane by lane, not as a CHAIN."""
    build = getattr(tconfigs, builder)
    T = kw["superblock"] * 128
    jctx = build(api=ga, **kw)
    want = np.asarray(jctx.render(8 * T))
    ctx = build(device="cpu", **kw)
    got = ctx.render(8 * T)
    # both packages fuse the same chains (the Kit's gain chains: D = 2)
    assert ctx._compiled.pipe_delay == jctx._compiled.pipe_delay
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert len(ctx._encs[tgraph.DEFERRED]) == deferred
    if builder == "config5_orbit":
        (sp,) = [sp for sp in ctx._compiled.plan if sp["key"] in ctx._encs[tgraph.DEFERRED]]
        (modspec,) = [m for name, a_rate, _, m in sp["params"] if name == "positionX"]
        assert sp["n_lanes"] == 8 and modspec[2][0] != "CHAIN"


@pytest.mark.parametrize("builder, kw, routes", [
    ("config1_buffer_gain", {}, 0),
    ("config2_mix_bus", dict(voices=4), 0),
    ("config3_eq_chain", {}, 0),
    ("config4_conv_reverb", dict(voices=4), 0),
    ("config5_spatial_scene", dict(voices=4), 0),
    ("config6_lfo_tremolo", dict(voices=4), 0),
    ("config6_lfo_tremolo", dict(voices=4, modulated=False), 0),
    ("config4_pitched", dict(voices=4), 0),
    ("config6_swept", dict(voices=4), 0),
    ("config2_vibrato", dict(voices=4), 0),
    ("config5_steplinear", dict(voices=4), 0),
    ("config4_pingpong", dict(voices=4), 0),
    ("config3_wah", {}, 0),
    ("config5_orbit", dict(voices=4), 2),
])
def test_one_gather_routes_by_path(builder, kw, routes):
    """Which paths take the step's one-gather route: the orbit's panner
    input and positionX. The wah's four depth-gain modulations read one
    lane each but feed one-lane stages, which keep the per-lane mix; no
    path older than them takes it."""
    ctx = getattr(tconfigs, builder)(device="cpu", **kw)
    ctx._ensure_compiled()
    assert len(tgraph.one_gather_routes(ctx._compiled.plan)) == routes


@pytest.mark.parametrize("builder, kw", [
    ("config5_orbit", dict(superblock=8, voices=2)),
    ("config5_orbit", dict(superblock=4, voices=4)),
])
def test_one_gather_route_bit_for_bit(builder, kw):
    """The one-gather route renders what a mix a lane and a stack render,
    bit for bit."""
    build = getattr(tconfigs, builder)
    frames = 4 * kw["superblock"] * 128
    ctx = build(device="cpu", **kw)
    got = ctx.render(frames)
    assert tgraph.one_gather_routes(ctx._compiled.plan)
    with mock.patch.object(tgraph, "one_gather_routes", lambda plan: {}):
        want = build(device="cpu", **kw).render(frames)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_array_equal(got, want)
