"""The port's scheduled sources and modulated params, on the CPU.

* ``OscillatorNode`` (K11's plain version): the four waveforms, as one
  ungrouped lane and as a group of lanes, started and stopped inside a
  quantum, with the f64 phase carried across steps and render calls,
  against the JAX package within 1e-6 (the in-quantum phase sums in XLA's
  CPU order, so only the sine's and the f64 sums' last bits differ);
* ``ConstantSourceNode`` against the JAX package, bit for bit lane by lane,
  and the sample gate of ``ScheduledSourceNode`` against the JAX node's;
* K6m's plain version (``apply_modulation_plain``) against the JAX
  package's clamp of intrinsic + mono modulation, bit for bit;
* twins of six tests of tests/test_mod_groups.py on the port;
* config 6 (modulated) against tests/goldens/config6_lfo_tremolo_64.npz
  within 1e-5, and both variants side by side with a JAX render at 8
  voices, superblock 32, 4 steps, within 1e-5 (the npz is the modulated
  render: the unmodulated variant has no golden);
* a ``from_jax`` hand-off of config 6 in the middle of a render;
* a modulated biquad frequency and a modulated panner param (read by the
  step's prologue; ROADMAP item 8b) against the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.configs as bc
import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.core.mixing import adapt_channels as jax_adapt_channels
from graphaudio_tpu_torch.ops import param_eval as tpe
from graphaudio_tpu_torch.testing import configs as tc
from graphaudio_tpu_torch.utils import from_jax

SR = 48000
TOL = 1e-5


def _oscillators(pkg, ctx, wave, grouped):
    """Four oscillators of one waveform to the destination: 440 Hz, 5 kHz,
    and two whose start and stop fall inside a quantum. ``grouped=False``
    gives each its own stage (group_key None)."""
    cls = pkg.OscillatorNode
    if not grouped:
        cls = type("Ungrouped", (pkg.OscillatorNode,), {"group_key": lambda self, ic: None})
    for hz, start, stop in ((440.0, 0.0, None), (5000.0, 0.0, None),
                            (1234.5, 0.00123, 0.0301), (97.0, 0.0131, None)):
        osc = cls(ctx, type=getattr(pkg.OscillatorType, wave))
        osc.frequency.value = hz
        osc.connect(ctx.destination)
        osc.start(start)
        if stop is not None:
            osc.stop(stop)
    return ctx


@pytest.mark.parametrize("grouped", [True, False], ids=["group", "one lane each"])
@pytest.mark.parametrize("wave", ["SINE", "SQUARE", "SAWTOOTH", "TRIANGLE"])
def test_oscillator_against_jax(wave, grouped):
    superblock = 4
    frames = 5 * superblock * 128
    jctx = _oscillators(ga, ga.OfflineAudioContext(sample_rate=SR, superblock=superblock),
                        wave, grouped)
    tctx = _oscillators(gat, gat.OfflineAudioContext(sample_rate=SR, superblock=superblock,
                                                     device="cpu"), wave, grouped)
    want = jctx.render(frames)
    got = np.concatenate([tctx.render(700), tctx.render(frames - 700)], axis=1)
    groups = [len(n) for k, n, _ in tctx._compiled.stages if k == "group"]
    assert groups == ([4] if grouped else [])
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the phase state carried across steps: f64, as the JAX package's
    jst = jax.device_get(jctx._states)
    for key, st in tctx._states.items():
        if "phase" in st:
            np.testing.assert_allclose(st["phase"].numpy(), np.asarray(jst[key]["phase"]),
                                       rtol=0, atol=1e-12)


_CONSTANTS = ((0.0, None), (0.00123, 0.0301), (0.0131, 0.02))  # (start, stop)


def _constants(pkg, ctx, grouped, only=None):
    """Three constant sources to the destination (or source ``only``
    alone), one with an automated offset (K6's rows), two started or
    stopped inside a quantum. Returns (ctx, nodes)."""
    cls = pkg.ConstantSourceNode
    if not grouped:
        cls = type("Ungrouped", (pkg.ConstantSourceNode,), {"group_key": lambda self, ic: None})
    nodes = []
    for v, (start, stop) in enumerate(_CONSTANTS):
        if only is not None and v != only:
            continue
        src = cls(ctx)
        src.offset.value = 0.25 + 0.1 * v
        if v == 0:
            src.offset.set_value_at_time(0.5, 0.004)
            src.offset.linear_ramp_to_value_at_time(-0.75, 0.03)
        src.connect(ctx.destination)
        src.start(start)
        if stop is not None:
            src.stop(stop)
        nodes.append(src)
    return ctx, nodes


def test_constant_sources_against_jax():
    """Three sources mixed at the destination, grouped and one lane each.
    The two packages sum a group's lanes in another order, so the mix is
    held within 2 f32 ulps of its level; each lane is bit for bit below."""
    frames = 5 * 4 * 128
    for grouped in (True, False):
        want = _constants(ga, ga.OfflineAudioContext(sample_rate=SR, superblock=4),
                          grouped)[0].render(frames)
        got = _constants(gat, gat.OfflineAudioContext(sample_rate=SR, superblock=4,
                                                      device="cpu"), grouped)[0].render(frames)
        assert np.abs(want).max() > 0.5
        np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("v", range(len(_CONSTANTS)))
def test_constant_source_lane_bit_for_bit(v):
    """Lane ``v`` of the port's three-lane group, captured from K11's
    wrapper, against the JAX render of that source alone."""
    from unittest import mock

    from graphaudio_tpu_torch.nodes import sources as tsrc

    frames = 5 * 4 * 128
    seen = []
    real = tsrc.constant_group_step

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    tctx, nodes = _constants(gat, gat.OfflineAudioContext(sample_rate=SR, superblock=4,
                                                          device="cpu"), True)
    with mock.patch.object(tsrc, "constant_group_step", side_effect=spy):
        tctx.render(frames)
    lane = tctx._compiled.state_ref[nodes[v].node_id][1]
    got = torch.cat(seen, dim=1)[lane].numpy()
    jctx, _ = _constants(ga, ga.OfflineAudioContext(sample_rate=SR, superblock=4), True, only=v)
    want = jctx.render(frames)[0]
    assert np.abs(want).max() > 0.2
    np.testing.assert_array_equal(got, want)


def test_sample_gate_against_jax():
    """``ScheduledSourceNode._sample_gate`` over stacked lanes against the
    JAX node's, lane by lane: starts and stops inside, on and between
    quantum edges, never started, never stopped."""
    from types import SimpleNamespace

    dt = 128 / SR
    S = 4
    bt = (9 + np.arange(S)) * dt
    starts = np.array([0.0, bt[1] + 0.3 * dt, bt[2], np.inf, bt[0] - 5 * dt, bt[3] + 0.999 * dt])
    stops = np.array([np.inf, bt[2] + 0.5 * dt, bt[3], np.inf, bt[1] + 1e-9, np.inf])
    started = np.array([1, 1, 1, 0, 1, 1], np.int32)
    tst = {"started": torch.from_numpy(started), "start_time": torch.from_numpy(starts),
           "stop_time": torch.from_numpy(stops)}
    trc = SimpleNamespace(block_times=torch.from_numpy(bt), sample_rate=SR)
    got = gat.nodes.ScheduledSourceNode._sample_gate(tst, trc).numpy()
    jrc = SimpleNamespace(block_times=jnp.asarray(bt), block_end_times=jnp.asarray(bt + dt),
                          sample_rate=SR)
    node = ga.ConstantSourceNode(ga.OfflineAudioContext(sample_rate=SR, superblock=S))
    for v in range(len(starts)):
        st = {"started": jnp.int32(started[v]), "start_time": jnp.float64(starts[v]),
              "stop_time": jnp.float64(stops[v])}
        np.testing.assert_array_equal(got[v], np.asarray(node._sample_gate(st, jrc)))
    assert got.any() and not got.all()


@pytest.mark.parametrize("a_rate", [True, False], ids=["a-rate", "k-rate"])
@pytest.mark.parametrize("Cm", [1, 2])
def test_k6m_plain_against_jax(Cm, a_rate):
    """clamp(intrinsic + mono(mod), lo, hi): the JAX graph's group form
    (vmapped adapt_channels to mono, k-rate reads sample 0 of each
    quantum), bit for bit; also over a broadcast base-value view."""
    rng = np.random.default_rng(11 + Cm)
    V, S = 5, 4
    T = S * 128
    L = T if a_rate else S
    intr = rng.standard_normal((V, L)).astype(np.float32)
    mod = rng.standard_normal((V, Cm, T)).astype(np.float32)
    lo, hi = -0.75, 1.5

    @jax.jit
    def ref(intr, mod):
        m = jax.vmap(lambda x: jax_adapt_channels(x, 1))(mod)[:, 0]
        if not a_rate:
            m = m.reshape(V, S, 128)[:, :, 0]
        return jnp.clip(intr + m, jnp.float32(lo), jnp.float32(hi))

    want = np.asarray(ref(intr, mod))
    got = tpe.apply_modulation(torch.from_numpy(intr), torch.from_numpy(mod), lo, hi, a_rate)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == lo).any() and (want == hi).any()
    base = torch.from_numpy(intr[:, 0].copy())
    view = base[:, None].expand(V, L)
    got = tpe.apply_modulation(view, torch.from_numpy(mod), lo, hi, a_rate)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref(np.broadcast_to(intr[:, :1], (V, L)).copy(), mod)))


# ---- twins of tests/test_mod_groups.py ---------------------------------------------


class UngroupedGain(gat.GainNode):
    def group_key(self, input_channels):
        return None


class UngroupedOscillator(gat.OscillatorNode):
    def group_key(self, input_channels):
        return None


class UngroupedConstant(gat.ConstantSourceNode):
    def group_key(self, input_channels):
        return None


def _ctx(superblock):
    return gat.OfflineAudioContext(sample_rate=SR, superblock=superblock, device="cpu")


def _lfo_gain_scene(ctx, voices, gain_cls=gat.GainNode, osc_cls=gat.OscillatorNode,
                    const_cls=gat.ConstantSourceNode, depth=0.25):
    """voices x (const source -> gain; LFO -> gain.gain) -> destination."""
    for v in range(voices):
        src = const_cls(ctx)
        src.offset.value = 0.5 + 0.05 * v
        lfo = osc_cls(ctx)
        lfo.frequency.value = 2.0 + v  # per-voice rate: lanes must differ
        g = gain_cls(ctx)
        g.gain.value = depth
        lfo.connect(g.gain)
        src.connect(g).connect(ctx.destination)
        src.start(0)
        lfo.start(0)


def _stage_kinds(ctx):
    ctx._ensure_compiled()
    return [(kind, len(nodes)) for kind, nodes, _ in ctx._compiled.stages]


def test_lfo_gain_groups_into_constant_stage_count():
    counts = {}
    for voices in (2, 8):
        ctx = _ctx(2)
        _lfo_gain_scene(ctx, voices)
        kinds = _stage_kinds(ctx)
        counts[voices] = len(kinds)
        # consts group + lfos group + gains group + dest
        groups = [k for k in kinds if k[0] == "group"]
        assert len(groups) == 3, kinds
        assert {n for _k, n in groups} == {voices}
    assert counts[2] == counts[8]  # O(1) stages in voice count


def test_lfo_gain_mod_routing_canonicalizes_to_chain():
    ctx = _ctx(2)
    _lfo_gain_scene(ctx, 4)
    ctx._ensure_compiled()
    gain_stages = [
        sp for sp in ctx._compiled.plan
        if sp["kind"] == "group" and sp["group_key"][0] == "gain"
    ]
    assert len(gain_stages) == 1
    (name, a_rate, _exact, modspec), = [
        p for p in gain_stages[0]["params"] if p[0] == "gain"
    ]
    assert a_rate and modspec is not None
    _mn, _mx, routing = modspec
    assert routing[0] == "CHAIN"  # 1:1 per-voice LFO -> param fast path


def test_lfo_gain_matches_ungrouped_singles():
    frames = 16 * 128
    a = _ctx(4)
    _lfo_gain_scene(a, 6)
    b = _ctx(4)
    _lfo_gain_scene(b, 6, gain_cls=UngroupedGain, osc_cls=UngroupedOscillator,
                    const_cls=UngroupedConstant)
    got = a.render(frames)
    want = b.render(frames)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_mixed_modulated_and_plain_gains_split_groups():
    """Voices with and without a modulator take different group keys."""
    ctx = _ctx(2)
    _lfo_gain_scene(ctx, 3)
    for _ in range(2):  # plain, unmodulated voices
        src = gat.ConstantSourceNode(ctx)
        src.offset.value = 0.25
        g = gat.GainNode(ctx)
        src.connect(g).connect(ctx.destination)
        src.start(0)
    kinds = _stage_kinds(ctx)
    group_sizes = sorted(n for k, n in kinds if k == "group")
    # 5 const sources (all one group), 3 LFOs, 3 modulated gains, 2 plain
    # gains — the gain groups SPLIT on the mod signature.
    assert group_sizes == [2, 3, 3, 5], kinds


def test_fan_in_modulators_group_without_chain():
    """Two LFOs summing into ONE param (and a shared LFO feeding three
    voices) exercise the explicit per-lane routing."""
    frames = 8 * 128

    def build(ctx, gain_cls, osc_cls, const_cls):
        shared = osc_cls(ctx)
        shared.frequency.value = 3.0
        shared.start(0)
        for v in range(3):
            src = const_cls(ctx)
            src.offset.value = 0.4
            g = gain_cls(ctx)
            g.gain.value = 0.5
            shared.connect(g.gain)
            if v == 1:  # second modulator fans into the same param
                extra = osc_cls(ctx)
                extra.frequency.value = 7.0
                extra.connect(g.gain)
                extra.start(0)
            src.connect(g).connect(ctx.destination)
            src.start(0)

    a = _ctx(2)
    build(a, gat.GainNode, gat.OscillatorNode, gat.ConstantSourceNode)
    b = _ctx(2)
    build(b, UngroupedGain, UngroupedOscillator, UngroupedConstant)
    got = a.render(frames)
    want = b.render(frames)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    kinds = _stage_kinds(a)
    assert ("group", 3) in kinds, kinds


def test_lfo_gain_matches_numpy_oracle():
    """The grouped modulated render against the transliterated reference
    oracle (per-block pull, per-sample walk)."""
    from graphaudio_tpu.testing.oracle import (
        OracleConstantSource,
        OracleContext,
        OracleGain,
        OracleOscillator,
    )

    frames = 8 * 128
    voices = 4
    ctx = _ctx(2)
    _lfo_gain_scene(ctx, voices)
    got = ctx.render(frames)

    octx = OracleContext(sample_rate=SR)
    for v in range(voices):
        src = OracleConstantSource(octx)
        src.offset.value = 0.5 + 0.05 * v
        lfo = OracleOscillator(octx)
        lfo.frequency.value = 2.0 + v
        g = OracleGain(octx)
        g.gain.value = 0.25
        lfo.connect(g.gain)
        src.connect(g)
        g.connect(octx.destination)
        src.start(0)
        lfo.start(0)
    want = octx.render(frames)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---- config 6 ----------------------------------------------------------------------


def test_config6_golden():
    out = tc.config6_lfo_tremolo(superblock=4, device="cpu").render(8192)
    golden = np.load("tests/goldens/config6_lfo_tremolo_64.npz")["out"]
    assert out.shape == golden.shape and out.dtype == np.float32
    assert np.isfinite(out).all()
    assert np.abs(out.astype(np.float64) - golden).max() < TOL


@pytest.mark.parametrize("modulated", [True, False])
def test_config6_side_by_side_with_jax(modulated):
    T = 32 * 128
    want = bc.config6_lfo_tremolo(superblock=32, voices=8, modulated=modulated).render(4 * T)
    tctx = tc.config6_lfo_tremolo(superblock=32, voices=8, modulated=modulated, device="cpu")
    got = np.concatenate([tctx.render(3000), tctx.render(4 * T - 3000)], axis=1)
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL


def _tremolo(pkg, voices=4, **ctx_kw):
    """Config 6's voice at a small size, in either package."""
    rng = np.random.default_rng(6)
    ctx = pkg.OfflineAudioContext(sample_rate=SR, superblock=4, **ctx_kw)
    master = pkg.GainNode(ctx)
    master.gain.value = 1.0 / voices
    master.connect(ctx.destination)
    for v in range(voices):
        sig = (rng.standard_normal(SR) * 0.2).astype(np.float32)
        src = pkg.AudioBufferSourceNode(ctx)
        src.buffer = pkg.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        g = pkg.GainNode(ctx)
        g.gain.value = 0.6
        lfo = pkg.OscillatorNode(ctx)
        lfo.frequency.value = 1.0 + 0.25 * v
        depth = pkg.GainNode(ctx)
        depth.gain.value = 0.35
        lfo.connect(depth)
        depth.connect(g.gain)
        lfo.start(0.0007 * v)
        src.connect(g).connect(master)
        src.start(0)
    return ctx


def test_config6_mid_render_handoff_from_jax():
    T = 4 * 128
    jctx = _tremolo(ga, pipeline_chains=False)
    jctx.render(3 * T)
    tctx = _tremolo(gat, device="cpu")
    from_jax.load_render_state(
        tctx, jax.device_get(jctx._states), jax.device_get(jctx._consts),
        jctx._current_frame, jctx._current_time,
    )
    phases = [st["phase"] for st in tctx._states.values() if "phase" in st]
    assert len(phases) == 1 and phases[0].dtype == torch.float64
    assert (phases[0][:4] > 0).all()  # the LFOs' running phase came across
    want = jctx.render(3 * T)
    got = tctx.render(3 * T)
    assert tctx.current_time == jctx.current_time
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL


# ---- modulated params the prologue reads -----------------------------------------


def _modulated_prologue_scene(pkg, ctx, panner):
    """A constant source through a biquad whose frequency, or a spatial
    panner whose spatialBlend, an oscillator modulates; the step's prologue
    reads either param, so the stage's K8 or K10b runs at its turn."""
    src = pkg.ConstantSourceNode(ctx)
    lfo = pkg.OscillatorNode(ctx)
    if panner:
        ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
        node = pkg.SpatialPannerNode(ctx)
        node.position_z.value = -2.0
        lfo.connect(node.spatial_blend)
    else:
        node = pkg.BiQuadFilterNode(ctx)
        lfo.connect(node.frequency)
    src.connect(node).connect(ctx.destination)
    src.start(0)
    lfo.start(0)
    return ctx


def test_modulated_biquad_frequency_raises():
    """Once a raise naming ROADMAP item 8b; now a render against JAX."""
    want = np.asarray(_modulated_prologue_scene(
        ga, ga.OfflineAudioContext(sample_rate=SR, superblock=2), False).render(1024))
    got = _modulated_prologue_scene(gat, _ctx(2), False).render(1024)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_modulated_panner_param_raises():
    """Once a raise naming ROADMAP item 8b; now a render against JAX."""
    want = np.asarray(_modulated_prologue_scene(
        ga, ga.OfflineAudioContext(sample_rate=SR, superblock=2), True).render(1024))
    got = _modulated_prologue_scene(gat, _ctx(2), True).render(1024)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
