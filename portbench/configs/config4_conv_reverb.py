"""Config 4, the convolution reverb: the scene builder of the benchmark.

A frozen copy of ``graphaudio_tpu_torch/testing/configs.py``
``config4_conv_reverb`` (the wiring of ``benchmarks/configs.py:88-111``)
whose inputs come from ``make_inputs(cfg, seed)`` instead of a fixed
``default_rng(4)``: 64 looped mono voices at 44.1 kHz, each through the
static polyphase Catmull-Rom resampler to 48 kHz (playbackRate 1), summed
into a ConvolverNode with a 2 s stereo IR, then a master gain of 0.5.

The sizes are in ``config4_conv_reverb.json`` beside this file; the plain
reference of the same scene is ``portbench/reference/config4_conv_reverb.py``.
"""

from __future__ import annotations

import numpy as np


def make_inputs(cfg: dict, seed: int) -> dict:
    """Every input of the scene from ``seed``: f32 arrays on the host.
    ``voices`` f32[V, N] at ``voice_rate``; ``ir`` f32[channels, M]."""
    rng = np.random.default_rng([seed % 2**63, 4])
    sr = cfg["sample_rate"]
    m = int(round(cfg["ir_seconds"] * sr))
    decay = np.exp(-np.arange(m) / (cfg["ir_decay_seconds"] * sr))
    ir = (rng.standard_normal((cfg["ir_channels"], m)) * decay).astype(np.float32)
    n = int(round(cfg["voice_seconds"] * cfg["voice_rate"]))
    voices = (rng.standard_normal((cfg["voices"], n)) * cfg["voice_std"]).astype(np.float32)
    return {"voices": voices, "ir": ir}


def build(cfg: dict, inputs: dict, ctx) -> dict:
    """Wire the scene into ``ctx`` (an offline or realtime context of the
    port). Returns the scene's handles."""
    import graphaudio_tpu_torch as ga

    master = ga.GainNode(ctx)
    master.gain.value = cfg["master_gain"]
    conv = ga.ConvolverNode(ctx)
    ir = inputs["ir"]
    if ir.shape[0] == 2:
        conv.buffer = ga.PlayableAudioBuffer.from_stereo_arrays(ir[0], ir[1], cfg["sample_rate"])
    else:
        conv.buffer = ga.PlayableAudioBuffer.from_mono_array(ir[0], cfg["sample_rate"])
    conv.connect(master).connect(ctx.destination)
    sources = []
    for sig in inputs["voices"]:
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, cfg["voice_rate"])
        src.loop = True
        src.playback_rate.value = 1.0  # the resampler path
        src.connect(conv)
        src.start(0)
        sources.append(src)
    return {"sources": sources, "convolver": conv, "master": master}
