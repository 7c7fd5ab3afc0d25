"""Config 5, the Kit's spatial scene: the scene builder of the benchmark.

A frozen copy of ``graphaudio_tpu_torch/testing/configs.py`` ``_kit_scene``
in the binaural mode (the wiring of ``benchmarks/configs.py:114-145``) whose
inputs come from ``make_inputs(cfg, seed)`` instead of a fixed
``default_rng(5)``: an ``AudioEngine`` with the listener at the origin, an
``sfx`` bus whose effect chain holds a ``ReverbEffect`` (a 1 s mono IR, wet
0.3), and 128 looped mono sounds on a circle of 5 m, each through its gain
and HRTF spatial panner into the bus.

``positions`` places sounds on the circle and ``move`` sets them: the
realtime mix that moves the sounds calls it once a game frame. The sizes
are in ``config5_spatial_scene.json``; the plain reference is
``portbench/reference/config5_spatial_scene.py``.
"""

from __future__ import annotations

import numpy as np


def make_inputs(cfg: dict, seed: int) -> dict:
    """Every input of the scene from ``seed``: ``voices`` f32[V, N] at the
    sample rate, ``ir`` f32[1, M] and the sounds' starting ``angles``
    f64[V] (rad) on the circle."""
    rng = np.random.default_rng([seed % 2**63, 5])
    sr = cfg["sample_rate"]
    m = int(round(cfg["ir_seconds"] * sr))
    ir = (rng.standard_normal((1, m)) * np.exp(-np.arange(m) / (cfg["ir_decay_seconds"] * sr)))
    n = int(round(cfg["voice_seconds"] * sr))
    voices = (rng.standard_normal((cfg["voices"], n)) * cfg["voice_std"]).astype(np.float32)
    angles = 2 * np.pi * np.arange(cfg["voices"]) / cfg["voices"]
    return {"voices": voices, "ir": ir.astype(np.float32), "angles": angles}


def positions(cfg: dict, angles) -> np.ndarray:
    """f32[..., 3] places on the circle of ``radius`` in the horizontal
    plane at ``angles`` (rad), as a Kit sound stores its position."""
    a = np.asarray(angles, np.float64)
    r = cfg["radius"]
    return np.stack([r * np.cos(a), np.zeros_like(a), r * np.sin(a)], axis=-1).astype(np.float32)


def build(cfg: dict, inputs: dict, ctx) -> dict:
    """Wire the scene into ``ctx`` (an offline or realtime context of the
    port). Returns the scene's handles (``engine``, ``sounds``)."""
    import graphaudio_tpu_torch as ga
    from graphaudio_tpu_torch import kit

    sr = cfg["sample_rate"]
    engine = kit.AudioEngine(ctx)
    lst = cfg["listener"]
    engine.set_listener(lst["position"], lst["forward"], lst["up"])
    sfx = engine.get_bus("sfx")
    rev = kit.ReverbEffect(engine)
    rev.set_impulse_response(ga.PlayableAudioBuffer.from_mono_array(inputs["ir"][0], sr))
    rev.wet.value = cfg["reverb_wet"]
    sfx.effects.add(rev)
    places = positions(cfg, inputs["angles"])
    sounds = []
    for sig, place in zip(inputs["voices"], places):
        s = engine.create_sound_from_buffer(
            ga.PlayableAudioBuffer.from_mono_array(sig, sr),
            mix_state=kit.SoundMixState.BINAURAL_SPATIALIZED, bus=sfx)
        s.is_looping = True
        s.position = place
        s.play()
        sounds.append(s)
    return {"engine": engine, "sounds": sounds}


def move(scene: dict, places) -> None:
    """Set every sound's position (f32[V, 3]), as a game does each frame."""
    for s, place in zip(scene["sounds"], places):
        s.position = place
