"""Benchmark graph builders of the port.

Each builds the BASELINE configuration of the same name with the same
signature, the same RNG draws and the same wiring as benchmarks/configs.py,
so the two packages render the same graph from the same seed; ``device`` is
the port's explicit render device.

Three more paths automate a rate that a consumer integrates (the exact
f64 curves and the time-varying resampler): ``config4_pitched`` and
``config6_swept`` add playbackRate and LFO-frequency ramps to configs 4
and 6, ``config2_vibrato`` an LFO on each voice's playbackRate. Four
modulate a param that a stage's prologue reads or run the delay and the
stereo panner: ``config3_wah`` (an LFO on each biquad's frequency),
``config5_orbit`` (an LFO on each panner's positionX),
``config5_steplinear`` (config 5's sounds in the Kit's step-linear mode)
and ``config4_pingpong`` (config 4 with a ping-pong delay send).
``config5_streamed`` adds a streamed music track and a looping ambience to
config 5 (the stream node's K15, through the Kit's data provider);
``config5_measured`` renders config 5 on a measured-like HRIR set past 128
taps (the partitioned filter, K10p). Their
``api`` argument names the package whose classes build the graph (the
port by default; a test passes the JAX package to build the same graph
there), so one definition serves both. Configs 4 and 5 also take a
``context`` factory, ``context(sample_rate=, superblock=)``, to build the
same graph into another context, a ``RealtimeAudioContext`` of either
package for one.
"""

from __future__ import annotations

import importlib

import numpy as np

import graphaudio_tpu_torch as ga

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


def config4_conv_reverb(superblock=32, voices=64, device="cuda", api=None, context=None):
    """64 voices -> cubic resampler (44.1->48k) -> 2 s IR convolver -> gain."""
    rng = np.random.default_rng(4)
    api, ctx = _context(api, superblock, device, context)
    master = api.GainNode(ctx)
    master.gain.value = 0.5
    conv = api.ConvolverNode(ctx)
    ir_len = 2 * SR
    decay = np.exp(-np.arange(ir_len) / (0.4 * SR))
    conv.buffer = api.PlayableAudioBuffer.from_stereo_arrays(
        (rng.standard_normal(ir_len) * decay).astype(np.float32),
        (rng.standard_normal(ir_len) * decay).astype(np.float32),
        SR,
    )
    conv.connect(master).connect(ctx.destination)
    for _ in range(voices):
        sig = (rng.standard_normal(2 * 44100) * 0.05).astype(np.float32)
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = api.PlayableAudioBuffer.from_mono_array(sig, 44100)
        src.loop = True
        src.playback_rate.value = 1.0  # resampler path
        src.connect(conv)
        src.start(0)
    return ctx


def config5_spatial_scene(superblock=32, voices=128, device="cuda", api=None, context=None):
    """128 moving spatialized sources with a shared reverb send
    (Kit AudioBus / EffectChain topology)."""
    return _kit_scene(api, superblock, voices, device, "BINAURAL_SPATIALIZED", context)[1]


def config6_lfo_tremolo(superblock=32, voices=64, modulated=True, device="cuda"):
    """64 voices with PER-VOICE LFO -> gain modulation (tremolo). With
    ``modulated=False`` the LFO -> depth chains are kept but routed to a
    silent audio sink instead of the params, so the two variants differ by
    the modulation plumbing alone."""
    rng = np.random.default_rng(6)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock, device=device)
    master = ga.GainNode(ctx)
    master.gain.value = 1.0 / voices
    master.connect(ctx.destination)
    sink = None
    if not modulated:
        sink = ga.GainNode(ctx)
        sink.gain.value = 0.0
        sink.connect(master)
    for v in range(voices):
        sig = (rng.standard_normal(SR) * 0.2).astype(np.float32)
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        g = ga.GainNode(ctx)
        g.gain.value = 0.6
        lfo = ga.OscillatorNode(ctx)
        lfo.frequency.value = 1.0 + 0.25 * v  # per-voice tremolo rate
        depth = ga.GainNode(ctx)
        depth.gain.value = 0.35
        lfo.connect(depth)
        depth.connect(g.gain if modulated else sink)
        lfo.start(0)
        src.connect(g).connect(master)
        src.start(0)
    return ctx


def _context(api, superblock, device, context=None):
    """(api, a context of ``api``): ``context(sample_rate=, superblock=)``
    where a factory is given (a ``RealtimeAudioContext`` of either package,
    say; it picks its own device), else an OfflineAudioContext (the port's
    on ``device`` unless ``api`` names another package)."""
    api = ga if api is None else api
    if context is not None:
        return api, context(sample_rate=SR, superblock=superblock)
    if api is ga:
        return ga, ga.OfflineAudioContext(sample_rate=SR, superblock=superblock, device=device)
    return api, api.OfflineAudioContext(sample_rate=SR, superblock=superblock)


def config4_pitched(superblock=64, voices=64, device="cuda", api=None):
    """Config 4 (the same draws and graph) with each voice's playbackRate
    alternating between linear ramps to 0.84 and to 1.19 (-3 and +3
    semitones), one ending every 2 s from a per-voice offset phi_v in [0,
    2) s drawn after the voices' samples: 16 ramps a voice, the pitch
    variation of a game engine's voice or a doppler shift. The effective
    rate stays under 0.91875 x 1.19 < 2, so every voice has rate bound 2
    and the voices form one time-varying resample stage."""
    api, ctx = _context(api, superblock, device)
    rng = np.random.default_rng(4)
    master = api.GainNode(ctx)
    master.gain.value = 0.5
    conv = api.ConvolverNode(ctx)
    ir_len = 2 * SR
    decay = np.exp(-np.arange(ir_len) / (0.4 * SR))
    conv.buffer = api.PlayableAudioBuffer.from_stereo_arrays(
        (rng.standard_normal(ir_len) * decay).astype(np.float32),
        (rng.standard_normal(ir_len) * decay).astype(np.float32),
        SR,
    )
    conv.connect(master).connect(ctx.destination)
    sources = []
    for _ in range(voices):
        sig = (rng.standard_normal(2 * 44100) * 0.05).astype(np.float32)
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = api.PlayableAudioBuffer.from_mono_array(sig, 44100)
        src.loop = True
        src.playback_rate.value = 1.0
        src.connect(conv)
        src.start(0)
        sources.append(src)
    phi = rng.uniform(0.0, 2.0, voices)
    for src, p in zip(sources, phi):
        for k in range(16):
            src.playback_rate.linear_ramp_to_value_at_time(0.84 if k % 2 == 0 else 1.19,
                                                           float(p) + 2.0 * k)
    return ctx


def config6_swept(superblock=32, voices=64, device="cuda", api=None):
    """Config 6 (the same draws and graph, modulated) with each LFO's
    frequency swept from its own f_v = 1 + 0.25 v Hz to 2 f_v and back in
    linear ramps every 3 s (a tremolo-rate sweep): a set value at 0, then
    ten ramps, so the frequency takes the exact a-rate rows."""
    api, ctx = _context(api, superblock, device)
    rng = np.random.default_rng(6)
    master = api.GainNode(ctx)
    master.gain.value = 1.0 / voices
    master.connect(ctx.destination)
    for v in range(voices):
        sig = (rng.standard_normal(SR) * 0.2).astype(np.float32)
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = api.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        g = api.GainNode(ctx)
        g.gain.value = 0.6
        lfo = api.OscillatorNode(ctx)
        f_v = 1.0 + 0.25 * v
        lfo.frequency.value = f_v
        lfo.frequency.set_value_at_time(f_v, 0.0)
        for k in range(1, 11):
            lfo.frequency.linear_ramp_to_value_at_time(2.0 * f_v if k % 2 else f_v, 3.0 * k)
        depth = api.GainNode(ctx)
        depth.gain.value = 0.35
        lfo.connect(depth)
        depth.connect(g.gain)
        lfo.start(0)
        src.connect(g).connect(master)
        src.start(0)
    return ctx


def config2_vibrato(superblock=32, voices=8, device="cuda", api=None):
    """Config 2's voices (the same draws and gain ramps) with a vibrato:
    each voice's playbackRate modulated by a sine LFO at 5 + v Hz through a
    0.02 depth gain, so every voice is its own ungrouped stage (a
    modulated playbackRate). The resampler integrates the rate into the
    playhead, so an ulp of the sine grows over a render: K11's sine is
    correctly rounded on both devices for that reason. The last voice's
    rate also takes a constant 1.5 (a ConstantSourceNode, as
    tests/test_resample.py:278-302 pushes one): 2.5 +- 0.02, past its
    window's bound of 2, where it clamps."""
    api, ctx = _context(api, superblock, device)
    rng = np.random.default_rng(2)
    for v in range(voices):
        sig = (rng.standard_normal(2 * SR) * 0.1).astype(np.float32)
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = api.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        g = api.GainNode(ctx)
        for t in range(0, 30, 2):
            g.gain.set_value_at_time(0.05, float(t))
            if v % 2 == 0:
                g.gain.linear_ramp_to_value_at_time(0.8, t + 1.0)
            else:
                g.gain.exponential_ramp_to_value_at_time(0.8, t + 1.0)
        lfo = api.OscillatorNode(ctx)
        lfo.frequency.value = 5.0 + v
        depth = api.GainNode(ctx)
        depth.gain.value = 0.02
        lfo.connect(depth)
        depth.connect(src.playback_rate)
        lfo.start(0)
        if v == voices - 1:
            push = api.ConstantSourceNode(ctx)
            push.offset.value = 1.5
            push.connect(src.playback_rate)
            push.start(0)
        src.connect(g).connect(ctx.destination)
        src.start(0)
    return ctx


def config3_wah(superblock=32, device="cuda", api=None):
    """Config 3 (the same draws and graph) with each biquad's frequency
    modulated by its own sine LFO at 4 + i Hz through a 150 Hz depth gain,
    on top of its ramps: an auto-wah or filter sweep on a bus. Each biquad
    stage takes its K8 at its turn in the step (four a step) and P2 its
    time-varying path."""
    api, ctx = _context(api, superblock, device)
    rng = np.random.default_rng(3)
    sig = (rng.standard_normal(2 * SR) * 0.2).astype(np.float32)
    src = api.AudioBufferSourceNode(ctx)
    src.buffer = api.PlayableAudioBuffer.from_stereo_arrays(sig, sig[::-1].copy(), SR)
    src.loop = True
    node = src
    types = [api.FilterType.LOWPASS, api.FilterType.PEAKING, api.FilterType.PEAKING,
             api.FilterType.HIGHPASS]
    for i, t in enumerate(types):
        flt = api.BiQuadFilterNode(ctx, type=t)
        flt.gain.value = 3.0 if t == api.FilterType.PEAKING else 0.0
        for sec in range(0, 30, 3):
            flt.frequency.set_value_at_time(200.0 * (i + 1), float(sec))
            flt.frequency.linear_ramp_to_value_at_time(2000.0 * (i + 1), sec + 2.5)
            flt.q.set_value_at_time(0.5, float(sec))
            flt.q.linear_ramp_to_value_at_time(4.0, sec + 2.5)
        lfo = api.OscillatorNode(ctx)
        lfo.frequency.value = 4.0 + i
        depth = api.GainNode(ctx)
        depth.gain.value = 150.0
        lfo.connect(depth).connect(flt.frequency)
        lfo.start(0)
        node = node.connect(flt)
    node.connect(ctx.destination)
    src.start(0)
    return ctx


def _kit_scene(api, superblock, voices, device, mix_state, context=None):
    """Config 5's Kit scene (the same draws and graph: a reverb send on the
    sfx bus, ``voices`` looped mono sounds on a circle of 5 m) with every
    sound in the ``SoundMixState`` named ``mix_state``, in a context of
    ``_context``. Returns (api, ctx, engine, sounds)."""
    api, ctx = _context(api, superblock, device, context)
    kit = importlib.import_module(f"{api.__name__}.kit")
    mix_state = getattr(kit.SoundMixState, mix_state)
    rng = np.random.default_rng(5)
    engine = kit.AudioEngine(ctx)
    engine.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    sfx = engine.get_bus("sfx")
    rev = kit.ReverbEffect(engine)
    ir = (rng.standard_normal(SR) * np.exp(-np.arange(SR) / (0.25 * SR))).astype(np.float32)
    rev.set_impulse_response(api.PlayableAudioBuffer.from_mono_array(ir, SR))
    rev.wet.value = 0.3
    sfx.effects.add(rev)
    sounds = []
    for v in range(voices):
        sig = (rng.standard_normal(SR) * 0.03).astype(np.float32)
        s = engine.create_sound_from_buffer(
            api.PlayableAudioBuffer.from_mono_array(sig, SR), mix_state=mix_state, bus=sfx)
        s.is_looping = True
        angle = 2 * np.pi * v / voices
        s.position = (5 * np.cos(angle), 0.0, 5 * np.sin(angle))
        s.play()
        sounds.append(s)
    ctx._engine = engine  # keep alive; callers may move sounds via engine
    ctx._sounds = sounds
    return api, ctx, engine, sounds


def config5_orbit(superblock=32, voices=128, device="cuda", api=None):
    """Config 5 (the same draws and graph) with each sound's panner
    positionX modulated by its own sine LFO at 0.1 + 0.003 v Hz through a 2 m
    depth gain: 128 sources swaying past the listener. The depth gains
    share the voices' gain stage (one key, one wave), so the panners' input
    and positionX read one lane each of that stage: both are one-gather
    routes (``core.graph.one_gather_routes``), positionX k-rate, and the
    panner stage takes its K10b at its turn in the step."""
    api, ctx, engine, sounds = _kit_scene(
        api, superblock, voices, device, "BINAURAL_SPATIALIZED")
    for v, s in enumerate(sounds):
        lfo = api.OscillatorNode(ctx)
        lfo.frequency.value = 0.1 + 0.003 * v
        depth = api.GainNode(ctx)
        depth.gain.value = 2.0
        lfo.connect(depth).connect(s._spatial_panner.position_x)
        lfo.start(0)
    return ctx


def config5_steplinear(superblock=32, voices=128, device="cuda", api=None):
    """Config 5 (the same draws and graph) with every sound in the Kit's
    step-linear mode (a StereoPannerNode, K13 over the mono lanes, in place
    of the HRTF panner), updated once after placing the sounds, as a game
    does each frame: pan, gain and pitch from the listener-relative
    position. The sounds behind the listener play at a pitch below 1 (the
    time-varying resampler's route)."""
    api, ctx, engine, sounds = _kit_scene(
        api, superblock, voices, device, "STEP_LINEAR_SPATIALIZED")
    engine.update()
    return ctx


def config4_pingpong(superblock=64, voices=64, device="cuda", api=None):
    """Config 4 (the same draws and graph) plus a ping-pong send from the
    master gain: a 2-way channel splitter, a 0.1 s delay on the left (4800
    samples, under a superblock: input and ring reads) and on the right a
    delay ramped linearly between 0.25 and 0.5 s every 2 s (exact a-rate
    rows, ring reads), a channel merger, a stereo panner whose pan ramps
    between -0.5 and 0.5 every 2 s, and a 0.3 wet gain into the
    destination: the echo send of a music or dialogue bus. Two K12 and one
    K13 a step."""
    api, ctx = _context(api, superblock, device)
    rng = np.random.default_rng(4)
    master = api.GainNode(ctx)
    master.gain.value = 0.5
    conv = api.ConvolverNode(ctx)
    ir_len = 2 * SR
    decay = np.exp(-np.arange(ir_len) / (0.4 * SR))
    conv.buffer = api.PlayableAudioBuffer.from_stereo_arrays(
        (rng.standard_normal(ir_len) * decay).astype(np.float32),
        (rng.standard_normal(ir_len) * decay).astype(np.float32),
        SR,
    )
    conv.connect(master).connect(ctx.destination)
    for _ in range(voices):
        sig = (rng.standard_normal(2 * 44100) * 0.05).astype(np.float32)
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = api.PlayableAudioBuffer.from_mono_array(sig, 44100)
        src.loop = True
        src.playback_rate.value = 1.0
        src.connect(conv)
        src.start(0)
    split = api.ChannelSplitterNode(ctx, 2)
    merge = api.ChannelMergerNode(ctx, 2)
    left = api.DelayNode(ctx, max_delay_time=1.0)
    right = api.DelayNode(ctx, max_delay_time=1.0)
    left.delay_time.value = 0.1
    right.delay_time.set_value_at_time(0.25, 0.0)
    pan = api.StereoPannerNode(ctx)
    pan.pan.set_value_at_time(-0.5, 0.0)
    for k in range(1, 16):
        right.delay_time.linear_ramp_to_value_at_time(0.5 if k % 2 else 0.25, 2.0 * k)
        pan.pan.linear_ramp_to_value_at_time(0.5 if k % 2 else -0.5, 2.0 * k)
    wet = api.GainNode(ctx)
    wet.gain.value = 0.3
    master.connect(split)
    split.connect(left, output=0)
    split.connect(right, output=1)
    left.connect(merge, input=0)
    right.connect(merge, input=1)
    merge.connect(pan).connect(wet).connect(ctx.destination)
    return ctx


def config5_streamed(superblock=32, voices=128, device="cuda", api=None, root=None,
                     seed=12):
    """Config 5's Kit scene (the same draws and graph) plus two streamed
    sounds on a ``music`` bus, as a game mixes many short SFX voices with
    one streamed music track and one looping ambience: ``music.flac`` (30 s
    stereo at 44.1 kHz, resampled to the context's 48 kHz by the stream
    node: K15's resample mode) and ``ambience.wav`` (10 s stereo PCM16 at
    48 kHz, looped: K15's unity mode). Both files are written into the
    directory ``root`` by ``api``'s own encoders from
    ``np.random.default_rng(seed)`` and read back through the Kit's
    ``FileSystemDataProvider``; the two packages write the same bytes."""
    if root is None:
        raise ValueError("config5_streamed needs a directory for its two media files")
    api, ctx, engine, sounds = _kit_scene(
        api, superblock, voices, device, "BINAURAL_SPATIALIZED")
    io = importlib.import_module(f"{api.__name__}.io")
    kit = importlib.import_module(f"{api.__name__}.kit")
    rng = np.random.default_rng(seed)
    music = (rng.standard_normal((2, 30 * 44100)) * 0.1).astype(np.float32)
    ambience = (rng.standard_normal((2, 10 * SR)) * 0.05).astype(np.float32)
    io.write_flac(f"{root}/music.flac", music, 44100)
    io.write_wav(f"{root}/ambience.wav", ambience, SR)
    engine.data_provider = kit.FileSystemDataProvider(root)
    bus = engine.get_bus("music")
    streams = []
    for name, loop in (("music.flac", False), ("ambience.wav", True)):
        s = engine.create_streaming_sound(name, bus=bus)
        s.is_looping = loop
        s.play()
        streams.append(s)
    ctx._streams = streams
    return ctx


def config5_measured(superblock=32, voices=128, device="cuda", api=None, taps=None):
    """Config 5's Kit scene (the same draws and graph) with a measured-like
    HRIR set as the engine's default (``engine.set_default_hrir``), passed
    as a dict: ``testing.sofa.synthetic_hrir_set``'s 72 directions (seed 9)
    at 512 taps and 44.1 kHz, like a public measured set such as MIT KEMAR,
    which the loader resamples to 48 kHz and cuts to its default min(N,
    256) taps: P = 2 partitions, the common case. ``taps`` = L instead
    generates the set at 48 kHz with L taps and loads all of them (1024:
    P = 8, the most the renderer takes). Every panner runs the partitioned
    filter (K10p)."""
    from graphaudio_tpu_torch.testing.sofa import synthetic_hrir_set

    api, ctx, engine, sounds = _kit_scene(
        api, superblock, voices, device, "BINAURAL_SPATIALIZED")
    rate, length = (44100, 512) if taps is None else (SR, taps)
    hrir, az, el = synthetic_hrir_set(sample_rate=rate, n_directions=72, length=length, seed=9)
    engine.set_default_hrir({"hrir": hrir, "azimuth_deg": az, "elevation_deg": el,
                             "sample_rate": rate}, length=taps)
    return ctx


def config5_part_hrir(superblock=32, voices=128, device="cuda", api=None, panners=8,
                      context=None):
    """Config 5's Kit scene (the same draws and graph) in which the first
    ``panners`` sounds' spatial panners each load their own HRIR
    (``load_hrir``): ``config5_measured``'s synthetic 72-direction set at 48
    kHz with 1024 taps (P = 8 partitions). Under a mesh whose ``part``
    dimension has more than one rank those panners run as single stages
    whose partitions shard over ``part`` (K14b); on one device each is a
    one-lane K10p group."""
    from graphaudio_tpu_torch.testing.sofa import synthetic_hrir_set

    api, ctx, engine, sounds = _kit_scene(
        api, superblock, voices, device, "BINAURAL_SPATIALIZED", context)
    hrir, az, el = synthetic_hrir_set(sample_rate=SR, n_directions=72, length=1024, seed=9)
    hrir_set = {"hrir": hrir, "azimuth_deg": az, "elevation_deg": el, "sample_rate": SR}
    for s in sounds[:panners]:
        s._spatial_panner.load_hrir(hrir_set, length=1024)
    return ctx
