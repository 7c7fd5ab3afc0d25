"""Offline mixdown: synthesize a short piece and write a WAV.

The twin of examples/offline_mixdown.py on the port. Run:

    python -m graphaudio_tpu_torch.examples.offline_mixdown [out.wav]
"""

import sys

import numpy as np

import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.io import write_wav


def main(path="mixdown.wav", device="cuda"):
    ctx = gat.OfflineAudioContext(device=device)
    sr = ctx.sample_rate

    # A chord of detuned oscillators through a lowpass that opens over time.
    lp = gat.BiQuadFilterNode(ctx, type=gat.FilterType.LOWPASS)
    lp.frequency.set_value_at_time(300.0, 0.0)
    lp.frequency.exponential_ramp_to_value_at_time(8000.0, 3.0)
    lp.q.value = 1.2

    bus = gat.GainNode(ctx)
    bus.gain.value = 0.2
    lp.connect(bus)

    for i, f in enumerate([110.0, 165.0, 220.0, 277.2]):
        osc = gat.OscillatorNode(ctx, type=gat.OscillatorType.SAWTOOTH)
        osc.frequency.value = f * 1.002**i
        osc.connect(lp)
        osc.start(0.25 * i, duration=4.0 - 0.25 * i)

    # Percussive noise hits through a convolution reverb.
    rng = np.random.default_rng(7)
    ir = (rng.standard_normal(sr) * np.exp(-np.arange(sr) / (0.3 * sr))).astype(np.float32)
    reverb = gat.ConvolverNode(ctx)
    reverb.buffer = gat.PlayableAudioBuffer.from_stereo_arrays(ir, ir[::-1].copy(), sr)
    reverb.connect(ctx.destination)
    bus.connect(ctx.destination)
    bus.connect(reverb)

    hit = (rng.standard_normal(2400) * np.exp(-np.arange(2400) / 300)).astype(np.float32)
    for t in np.arange(0.0, 4.0, 0.5):
        src = gat.AudioBufferSourceNode(ctx)
        src.buffer = gat.PlayableAudioBuffer.from_mono_array(hit, sr)
        pan = gat.StereoPannerNode(ctx)
        pan.pan.value = float(np.sin(t * 2.3))
        src.connect(pan).connect(reverb)
        src.start(float(t))

    audio = ctx.render_seconds(5.0)
    write_wav(path, audio, sr)
    peak = float(np.abs(audio).max())
    print(f"wrote {path}: {audio.shape[1]} frames, peak {peak:.3f}")
    print("render stats:", ctx.stats.summary(sr))


if __name__ == "__main__":
    main(*sys.argv[1:])
