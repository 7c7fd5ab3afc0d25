"""The port's config-5 slice end to end, on the CPU (plain kernel versions).

* the port's config 5 (128 spatialized voices -> sfx bus -> reverb send
  with a 1 s mono normalized IR -> master, 8192 frames) against
  tests/goldens/config5_spatial_scene_128.npz (a JAX CPU render at
  superblock 4), within 1e-5 (the golden peaks at 0.173): at superblock 4
  (the convolver's 128 grain) and 32 (its 1024 grain);
* a reduced config 5 (8 voices, superblock 8, 4 steps, a 0.25 s IR) side
  by side with the JAX render: positions ramping every quantum, occlusion
  and transmission set on two voices (their own panner group) from the
  start or first touched between renders (a regroup whose running states
  migrate member by member), the listener moved between renders; within
  1e-5;
* a mid-render hand-off through utils.from_jax, including ``__globals__``
  (the JAX context's listener differs from the one the port's builder
  sets): JAX renders 2 steps, both continue 2 steps, within 1e-5. Both
  contexts fuse the Kit's gain chains into pipelined stages (their
  default), and the hand-off carries the pipes' register banks and clock
  ring;
* the Kit layer on the port: bus paths, gain and mute, one-shot reaping,
  restart and seek, fades, effect-chain rebuilds, the reverb effect, the
  buffer cache, anchors, the step-linear calculator and blend controllers
  (twins of the cheap cases of tests/test_kit.py).
"""

import jax
import numpy as np
import pytest

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu import kit as jkit
from graphaudio_tpu_torch import kit as tkit
from graphaudio_tpu_torch.testing.configs import config5_spatial_scene
from graphaudio_tpu_torch.utils import from_jax

SR = 48000
TOL = 1e-5


@pytest.mark.parametrize("superblock", [4, 32])
def test_config5_golden(superblock):
    out = config5_spatial_scene(superblock=superblock, device="cpu").render(8192)
    golden = np.load("tests/goldens/config5_spatial_scene_128.npz")["out"]
    assert out.shape == golden.shape and out.dtype == np.float32
    assert np.isfinite(out).all()
    assert np.abs(out.astype(np.float64) - golden).max() < TOL


def _occlude(sounds):
    """Occlusion on voices 2 and 5 (those there are), transmission on 5."""
    for v in (2, 5):
        if v < len(sounds):
            sounds[v].occlusion = 0.6
            if v == 5:
                sounds[v].set_transmission(0.7, 0.3, 0.0)


def _reduced_config5(mod, kit, voices=8, superblock=8, occluded=True, **ctx_kw):
    """Config 5's Kit topology at a small size, with per-quantum motion and
    (``occluded``) two occluded voices. Returns (context, engine, sounds)."""
    rng = np.random.default_rng(55)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **ctx_kw)
    engine = kit.AudioEngine(ctx)
    engine.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    sfx = engine.get_bus("sfx")
    rev = kit.ReverbEffect(engine)
    n = SR // 4
    ir = (rng.standard_normal(n) * np.exp(-np.arange(n) / (0.05 * SR))).astype(np.float32)
    rev.set_impulse_response(mod.PlayableAudioBuffer.from_mono_array(ir, SR))
    rev.wet.value = 0.3
    sfx.effects.add(rev)
    sounds = []
    for v in range(voices):
        sig = (rng.standard_normal(SR // 4) * 0.1).astype(np.float32)
        s = engine.create_sound_from_buffer(
            mod.PlayableAudioBuffer.from_mono_array(sig, SR),
            mix_state=kit.SoundMixState.BINAURAL_SPATIALIZED, bus=sfx)
        s.is_looping = True
        angle = 2 * np.pi * v / voices
        s.position = (3 * np.cos(angle), 0.2 * v - 0.5, 3 * np.sin(angle))
        pan = s._spatial_panner
        pan.position_x.set_value_at_time(float(3 * np.cos(angle)), 0.0)
        pan.position_x.linear_ramp_to_value_at_time(float(-2 * np.cos(angle)), 0.08)
        pan.position_z.set_value_at_time(float(3 * np.sin(angle)), 0.0)
        pan.position_z.linear_ramp_to_value_at_time(float(1.5 - np.sin(angle)), 0.08)
        s.play()
        sounds.append(s)
    if occluded:
        _occlude(sounds)
    return ctx, engine, sounds


def test_reduced_config5_side_by_side_with_jax():
    T = 8 * 128
    jctx, jeng, _ = _reduced_config5(ga, jkit)
    tctx, teng, _ = _reduced_config5(gat, tkit, device="cpu")
    want, got = [jctx.render(2 * T)], [tctx.render(2 * T)]
    for e in (jeng, teng):
        e.set_listener([0.5, 0.0, 0.5], [0.3, 0.0, -1.0], [0, 1, 0])
    want.append(jctx.render(2 * T))
    got.append(tctx.render(2 * T))
    want, got = np.concatenate(want, axis=1), np.concatenate(got, axis=1)
    panner_groups = [sp for sp in tctx._compiled.plan
                     if type(sp["rep"]).__name__ == "SpatialPannerNode"]
    assert sorted(sp["n_lanes"] for sp in panner_groups) == [2, 8]  # 6 open, 2 occluded
    assert tctx.stats.graph_builds == 1
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL


def test_reduced_config5_occlusion_touched_mid_render():
    """Occlusion first touched on two live voices between renders, with the
    listener moved: their panners leave the open group for an occluded one
    (a graph rebuild), and the running state of every member (voice
    playheads, panner tails, the reverb's convolver ring) carries across
    the regroup, as in the JAX package."""
    T = 8 * 128
    jctx, jeng, jsounds = _reduced_config5(ga, jkit, occluded=False)
    tctx, teng, tsounds = _reduced_config5(gat, tkit, occluded=False, device="cpu")
    want, got = [jctx.render(2 * T)], [tctx.render(2 * T)]
    for e, sounds in ((jeng, jsounds), (teng, tsounds)):
        _occlude(sounds)
        e.set_listener([0.5, 0.0, 0.5], [0.3, 0.0, -1.0], [0, 1, 0])
    want.append(jctx.render(2 * T))
    got.append(tctx.render(2 * T))
    want, got = np.concatenate(want, axis=1), np.concatenate(got, axis=1)
    panner_groups = [sp for sp in tctx._compiled.plan
                     if type(sp["rep"]).__name__ == "SpatialPannerNode"]
    assert sorted(sp["n_lanes"] for sp in panner_groups) == [2, 8]  # 6 open, 2 occluded
    assert tctx.stats.graph_builds == 2
    assert np.abs(want[:, 2 * T:]).max() > 1e-2
    assert np.abs(got - want).max() < TOL


def test_mid_render_handoff_from_jax():
    T = 8 * 128
    jctx, jeng, _ = _reduced_config5(ga, jkit, voices=4)
    jeng.set_listener([0.0, 0.5, 1.0], [1.0, 0.0, -1.0], [0, 1, 0])  # the port's ctx keeps its own
    jctx.render(2 * T)
    tctx, _, _ = _reduced_config5(gat, tkit, voices=4, device="cpu")
    jstates = jax.device_get(jctx._states)
    from_jax.load_render_state(tctx, jstates, jax.device_get(jctx._consts),
                               jctx._current_frame, jctx._current_time)
    assert tctx._compiled.pipe_delay == jctx._compiled.pipe_delay == 2
    np.testing.assert_array_equal(tctx._states["__globals__"]["listener_ahead"].numpy(),
                                  jstates["__globals__"]["listener_ahead"])
    want = jctx.render(2 * T)
    got = tctx.render(2 * T)
    assert tctx.current_time == jctx.current_time
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL


# ---- the Kit layer on the port ----------------------------------------------


@pytest.fixture
def engine():
    return tkit.AudioEngine(gat.OfflineAudioContext(sample_rate=SR, superblock=2, device="cpu"))


def _mono(data):
    return gat.PlayableAudioBuffer.from_mono_array(np.asarray(data, np.float32), SR)


def test_kit_bus_hierarchy(engine):
    bus = engine.get_bus("sfx/player/steps")
    assert engine.has_bus("sfx") and engine.has_bus("sfx/player")
    assert bus.parent.parent.path == "sfx"
    assert bus.parent.parent.parent is engine.master_bus
    assert engine.get_bus("sfx/player/steps") is bus
    assert engine.get_bus("  MASTER ") is engine.master_bus
    with pytest.raises(ValueError):
        engine.get_bus("   ")


def test_kit_bus_gain_and_mute(engine, rng):
    buf = _mono(rng.standard_normal(4096))
    bus = engine.get_bus("sfx")
    engine.create_sound_from_buffer(buf, bus=bus).play()
    bus.gain = 0.5
    out = engine.context.render(1024)
    assert np.abs(out[0] - buf.data[0][:1024] * np.float32(0.5)).max() < 1e-6
    bus.muted = True
    engine.context.render(1024)
    assert np.allclose(engine.context.render(1024), 0.0)
    bus.muted = False
    assert bus.gain == 0.5


def test_kit_one_shot_reaped(engine, rng):
    buf = _mono(rng.standard_normal(2048))
    sound = engine.create_sound_from_buffer(buf)
    sound.is_one_shot = True
    sound.play()
    assert sound.is_playing
    out = engine.context.render(1024)
    assert np.abs(out[0] - buf.data[0][:1024]).max() < 1e-6
    engine.context.render(2048)  # past the end: the source ends
    engine.update()
    assert sound.is_disposed and sound not in engine.active_sounds


def test_kit_restart_and_seek(engine):
    data = np.arange(1, 8001, dtype=np.float32)
    sound = engine.create_sound_from_buffer(_mono(data))
    sound.play()
    assert np.array_equal(engine.context.render(512)[0], data[:512])
    sound.seek(1000.0 / SR)
    assert np.array_equal(engine.context.render(512)[0], data[1000:1512])
    sound.play()
    assert np.array_equal(engine.context.render(512)[0], data[:512])
    sound.stop()
    assert np.allclose(engine.context.render(512), 0.0)


def test_kit_sound_gain_and_set_bus(engine):
    sound = engine.create_sound_from_buffer(_mono(np.ones(8192)))
    sound.gain = 0.5
    sfx = engine.get_bus("sfx")
    sound.set_bus("sfx")
    assert sound.bus is sfx
    sfx.gain = 0.5
    sound.play()
    assert np.allclose(engine.context.render(1024)[0], 0.25, atol=1e-6)


def test_kit_fades(engine):
    buf = _mono(np.ones(48000))
    sound = engine.create_sound_from_buffer(buf)
    sound.play(fade_in_duration=0.01)
    out = engine.context.render(960)[0]
    assert abs(out[2]) < 0.01 and out[900] > 0.9
    sound2 = engine.create_sound_from_buffer(buf)
    sound2.play()
    sound2.stop(fade_out_duration=0.005)
    engine.context.render(480)
    engine.update()  # the deadline passed: the deferred stop runs
    assert not sound2.is_playing


def test_kit_effect_chain_rebuild(engine):
    sound = engine.create_sound_from_buffer(_mono(np.ones(48000)))
    g1 = gat.GainNode(engine.context)
    g1.gain.value = 0.5
    sound.effects.add(tkit.NodeEffect(engine, g1))
    sound.play()
    assert np.allclose(engine.context.render(1024)[0], 0.5, atol=1e-6)
    g2 = gat.GainNode(engine.context)
    g2.gain.value = 0.5
    sound.effects.insert(1, tkit.NodeEffect(engine, g2))
    assert sound.effects.count == 2
    assert np.allclose(engine.context.render(1024)[0], 0.25, atol=1e-6)
    sound.effects.remove_at(0)
    assert np.allclose(engine.context.render(1024)[0], 0.5, atol=1e-6)
    sound.effects.clear()
    assert np.allclose(engine.context.render(1024)[0], 1.0, atol=1e-6)


def test_kit_reverb_effect(engine, rng):
    sound = engine.create_sound_from_buffer(_mono(rng.standard_normal(48000) * 0.2))
    rev = tkit.ReverbEffect(engine)
    rev.set_impulse_response(_mono(rng.standard_normal(2000) * np.exp(-np.arange(2000) / 500)))
    rev.dry.value = 0.0
    sound.effects.add(rev)
    sound.play()
    out = engine.context.render(4096)
    assert np.isfinite(out).all() and np.abs(out).max() > 0
    rev.wet.value = 0.0
    engine.context.render(2048)
    assert np.allclose(engine.context.render(2048), 0.0, atol=1e-7)


def test_kit_cache_and_unported_modes(engine, tmp_path):
    cache = tkit.AudioBufferCache(tkit.AudioBufferCacheOptions(max_cached_buffers=2))
    cache.add("a", 1)
    cache.add("b", 2)
    assert cache.try_get("a") == 1
    cache.add("c", 3)  # evicts b, the least recently used
    assert cache.contains("a") and cache.contains("c") and not cache.contains("b")
    # The step-linear mode (once a raise naming item 10) renders as the
    # JAX package's: a sound to the right, panned by update().
    jengine = jkit.AudioEngine(ga.OfflineAudioContext(sample_rate=SR, superblock=2))
    for eng, pkg, kit in ((engine, gat, tkit), (jengine, ga, jkit)):
        s = eng.create_sound_from_buffer(
            pkg.PlayableAudioBuffer.from_mono_array(np.ones(4096, np.float32), SR),
            mix_state=kit.SoundMixState.STEP_LINEAR_SPATIALIZED)
        s.position = (3.0, 0.0, 0.0)
        s.play()
        eng.update()
    want = np.asarray(jengine.context.render(1024))
    got = engine.context.render(1024)
    assert want[1].max() > want[0].max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # The streaming sound (once a raise naming item 12) renders as the JAX
    # package's: a 44.1 kHz file streamed through the Kit's data provider.
    sig = (np.random.default_rng(12).standard_normal((2, 6000)) * 0.3).astype(np.float32)
    gat.io.write_wav(tmp_path / "x.wav", sig, 44100, float32=True)
    for eng, kit in ((engine, tkit), (jengine, jkit)):
        eng.data_provider = kit.FileSystemDataProvider(str(tmp_path))
        eng.create_streaming_sound("x.wav").play()
    want = np.asarray(jengine.context.render(2048))
    got = engine.context.render(2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() > 0.1


def test_kit_anchor_moves_binaural_sound(engine):
    sound = engine.create_sound_from_buffer(
        _mono(np.ones(48000)), mix_state=tkit.SoundMixState.BINAURAL_SPATIALIZED)
    anchor = tkit.SpatialAnchor((1.0, 0.0, 0.0))
    sound.anchor = anchor
    sound.position = (0.0, 0.0, -1.0)
    engine.update()
    assert sound._spatial_panner.position_x.value == 1.0
    anchor.position = (10.0, 0.0, 0.0)
    engine.update()
    assert sound._spatial_panner.position_x.value == 10.0
    assert sound._spatial_panner.position_z.value == -1.0


def test_kit_step_linear_and_blend():
    cfg = tkit.StepLinearConfig(pan_step=0.1, gain_step=0.05,
                                behind_pitch_decrease=0.015, pitch_lower_limit=0.1)
    r = tkit.step_linear_calculate((0, 0, 0), (3, 0, 0), cfg, 0.0, 1.0, 1.0)
    assert abs(r.pan - 0.3) < 1e-6 and abs(r.gain - 0.85) < 1e-6 and r.pitch == 1.0
    r = tkit.step_linear_calculate((0, 0, 0), (-50, 0, 0), cfg, 0.0, 1.0, 1.0)
    assert r.pan == -1.0 and r.gain == -1.0
    c = tkit.LinearSpatialBlendController(2.0, 12.0, 0.0, 1.0)
    assert c.get_blend(1.0) == 0.0 and c.get_blend(20.0) == 1.0
    assert abs(c.get_blend(7.0) - 0.5) < 1e-6
    with pytest.raises(ValueError):
        tkit.LinearSpatialBlendController(5.0, 5.0)
