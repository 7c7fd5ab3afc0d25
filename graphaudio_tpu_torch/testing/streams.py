"""K15's arguments at the shapes the stream node gives it, for the card
tests and ``chip_smoke.py --stream``: whole render calls, taken from a
30 s call of ``config5_streamed`` and from a stream that runs out, and
seeded at other superblocks, channel counts, rates and call lengths."""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.testing import groups


def stream_calls(build, steps):
    """K15's arguments (feed, n_steps, S, x0, rate; x0 and rate None in
    the unity mode) of every stream node in one render call of ``steps``
    steps of ``build()``, in launch order."""
    from graphaudio_tpu_torch.io import stream as tstream

    calls = groups.calls_of(tstream, "stream_feed_call", build, steps)
    return [tuple(c) + (None,) * (5 - len(c)) for c in calls]


def seeded_case(dev, C=2, S=32, n_steps=8, rate=None, x0=1.0, n=None, data=None, seed=0):
    """A feed f32[C, n] (by default the call's frames, rounded up to 8192)
    whose first ``data`` frames (all by default) are seeded noise and the
    rest the padding's zeros, with K15's other arguments for a call of
    ``n_steps`` steps: the unity mode without ``rate``."""
    if n is None:
        n = 8192 * -(-n_steps * S * 128 // 8192)
    rng = np.random.default_rng(seed)
    feed = np.zeros((C, n), np.float32)
    d = n if data is None else data
    feed[:, :d] = rng.standard_normal((C, d)).astype(np.float32) * 0.3
    feed = torch.from_numpy(feed).to(dev)
    if rate is None:
        return feed, n_steps, S, None, None
    return feed, n_steps, S, x0, rate


def run_out_case(dev, root):
    """K15's arguments for a two-step call over a stream that runs out: a
    3000-frame stereo file at 44.1 kHz, not looping, in 4096-frame steps,
    so the taps past its data read the feed's padded zeros."""
    import graphaudio_tpu_torch as gat

    sig = (np.random.default_rng(3).standard_normal((2, 3000)) * 0.3).astype(np.float32)
    gat.io.write_wav(f"{root}/short.wav", sig, 44100, float32=True)

    def build():
        ctx = gat.OfflineAudioContext(sample_rate=48000, superblock=32, device=dev)
        node = gat.io.AudioDecoderStreamNode.from_file(ctx, f"{root}/short.wav")
        node.connect(ctx.destination)
        node.play()
        return ctx

    return stream_calls(build, 2)[0]


def feed_cases(dev, root, voices=128, steps=351):
    """{name: K15's arguments}: ``config5_streamed``'s two stream nodes
    (music, resampled 44100/48000; ambience, unity) in a call of ``steps``
    steps (351: its 30 s render) with ``voices`` voices (files written into
    ``root``), seeded calls at S = 1 and S = 64 and a mono one, rates 0.5
    and 3.0 (taps past the feed clamped to its last frame), and a stream
    that runs out."""
    from graphaudio_tpu_torch.testing.configs import config5_streamed

    calls = stream_calls(lambda: config5_streamed(voices=voices, device=dev, root=root), steps)
    music = next(c for c in calls if c[3] is not None)
    ambience = next(c for c in calls if c[3] is None)
    return {
        "config5_streamed music (S=32 C=2 rate 0.91875)": music,
        "config5_streamed ambience (unity, S=32 C=2)": ambience,
        "S=1 C=2 rate 0.91875": seeded_case(dev, S=1, n_steps=200, rate=44100 / 48000,
                                            x0=2.25, seed=1),
        "S=64 C=2 rate 0.91875": seeded_case(dev, S=64, n_steps=16, rate=44100 / 48000,
                                             x0=1.5, seed=2),
        "unity S=64 C=2": seeded_case(dev, S=64, n_steps=16, seed=3),
        "mono S=32 rate 0.91875": seeded_case(dev, C=1, rate=44100 / 48000, seed=4),
        "rate 0.5 S=32 C=2": seeded_case(dev, rate=0.5, x0=1.0, seed=5),
        "rate 3.0 S=32 C=2 (taps clamped at the end)": seeded_case(dev, rate=3.0, x0=1.0,
                                                                   n=32768, seed=6),
        "run out (end of stream, S=32 C=2)": run_out_case(dev, root),
    }
