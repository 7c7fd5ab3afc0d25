"""Benchmark graph builders of the port.

Each builds the BASELINE configuration of the same name with the same
signature, the same RNG draws and the same wiring as benchmarks/configs.py,
so the two packages render the same graph from the same seed; ``device`` is
the port's explicit render device.
"""

from __future__ import annotations

import numpy as np

import graphaudio_tpu_torch as ga
from graphaudio_tpu_torch.kit import AudioEngine, ReverbEffect, SoundMixState

SR = 48000


def config1_buffer_gain(superblock=32, device="cuda"):
    """1 AudioBufferSource -> GainNode -> destination, 30 s stereo."""
    rng = np.random.default_rng(1)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock, device=device)
    n = 30 * SR
    buf = ga.PlayableAudioBuffer.from_stereo_arrays(
        (rng.standard_normal(n) * 0.3).astype(np.float32),
        (rng.standard_normal(n) * 0.3).astype(np.float32),
        SR,
    )
    src = ga.AudioBufferSourceNode(ctx)
    src.buffer = buf
    g = ga.GainNode(ctx)
    g.gain.value = 0.8
    src.connect(g).connect(ctx.destination)
    src.start(0)
    return ctx


def config2_mix_bus(superblock=32, voices=8, device="cuda"):
    """8-voice mix bus with linear/exponential AudioParam ramps."""
    rng = np.random.default_rng(2)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock, device=device)
    for v in range(voices):
        sig = (rng.standard_normal(2 * SR) * 0.1).astype(np.float32)
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        g = ga.GainNode(ctx)
        for t in range(0, 30, 2):
            g.gain.set_value_at_time(0.05, float(t))
            if v % 2 == 0:
                g.gain.linear_ramp_to_value_at_time(0.8, t + 1.0)
            else:
                g.gain.exponential_ramp_to_value_at_time(0.8, t + 1.0)
        src.connect(g).connect(ctx.destination)
        src.start(0)
    return ctx


def config3_eq_chain(superblock=32, device="cuda"):
    """4 cascaded biquads with automated frequency/Q."""
    rng = np.random.default_rng(3)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock, device=device)
    sig = (rng.standard_normal(2 * SR) * 0.2).astype(np.float32)
    src = ga.AudioBufferSourceNode(ctx)
    src.buffer = ga.PlayableAudioBuffer.from_stereo_arrays(sig, sig[::-1].copy(), SR)
    src.loop = True
    node = src
    types = [
        ga.FilterType.LOWPASS,
        ga.FilterType.PEAKING,
        ga.FilterType.PEAKING,
        ga.FilterType.HIGHPASS,
    ]
    for i, t in enumerate(types):
        flt = ga.BiQuadFilterNode(ctx, type=t)
        flt.gain.value = 3.0 if t == ga.FilterType.PEAKING else 0.0
        for sec in range(0, 30, 3):
            flt.frequency.set_value_at_time(200.0 * (i + 1), float(sec))
            flt.frequency.linear_ramp_to_value_at_time(
                2000.0 * (i + 1), sec + 2.5
            )
            flt.q.set_value_at_time(0.5, float(sec))
            flt.q.linear_ramp_to_value_at_time(4.0, sec + 2.5)
        node = node.connect(flt)
    node.connect(ctx.destination)
    src.start(0)
    return ctx


def config4_conv_reverb(superblock=32, voices=64, device="cuda"):
    """64 voices -> cubic resampler (44.1->48k) -> 2 s IR convolver -> gain."""
    rng = np.random.default_rng(4)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock, device=device)
    master = ga.GainNode(ctx)
    master.gain.value = 0.5
    conv = ga.ConvolverNode(ctx)
    ir_len = 2 * SR
    decay = np.exp(-np.arange(ir_len) / (0.4 * SR))
    conv.buffer = ga.PlayableAudioBuffer.from_stereo_arrays(
        (rng.standard_normal(ir_len) * decay).astype(np.float32),
        (rng.standard_normal(ir_len) * decay).astype(np.float32),
        SR,
    )
    conv.connect(master).connect(ctx.destination)
    for _ in range(voices):
        sig = (rng.standard_normal(2 * 44100) * 0.05).astype(np.float32)
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, 44100)
        src.loop = True
        src.playback_rate.value = 1.0  # resampler path
        src.connect(conv)
        src.start(0)
    return ctx


def config5_spatial_scene(superblock=32, voices=128, device="cuda"):
    """128 moving spatialized sources with a shared reverb send
    (Kit AudioBus / EffectChain topology)."""
    rng = np.random.default_rng(5)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock, device=device)
    engine = AudioEngine(ctx)
    engine.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])

    sfx = engine.get_bus("sfx")
    rev = ReverbEffect(engine)
    ir = (
        rng.standard_normal(SR) * np.exp(-np.arange(SR) / (0.25 * SR))
    ).astype(np.float32)
    rev.set_impulse_response(ga.PlayableAudioBuffer.from_mono_array(ir, SR))
    rev.wet.value = 0.3
    sfx.effects.add(rev)

    sounds = []
    for v in range(voices):
        sig = (rng.standard_normal(SR) * 0.03).astype(np.float32)
        buf = ga.PlayableAudioBuffer.from_mono_array(sig, SR)
        s = engine.create_sound_from_buffer(
            buf, mix_state=SoundMixState.BINAURAL_SPATIALIZED, bus=sfx
        )
        s.is_looping = True
        angle = 2 * np.pi * v / voices
        s.position = (5 * np.cos(angle), 0.0, 5 * np.sin(angle))
        s.play()
        sounds.append(s)
    ctx._engine = engine  # keep alive; callers may move sounds via engine
    ctx._sounds = sounds
    return ctx
