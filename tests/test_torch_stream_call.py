"""K15's whole-call read (ops/stream.py ``stream_feed_call_plain``, the
plain version of csrc/stream.cu) against the per-step read it replaced, on
the CPU:

* bit for bit the per-step reads stacked, at S = 1, 32 and 64, mono and
  stereo, the unity copy and rates 0.5, 0.91875 and 3.0 (the last with
  taps clamped at the feed's end), a stream that runs out (the feed's
  padded zeros) and a stopped stream's silent feed;
* the render path: a node's call is read once, at staging, in the mode it
  was staged with, even when playbackRate is touched mid-call (the next
  call resamples).

The yardstick, ``stream_feed_plain``, shares the interpolation
(``_resample``) with the whole-call read, so these tests hold the quanta's
offsets into the call and the step-major layout. The interpolation itself
is held against the JAX node bit for bit by the twins in
tests/test_torch_stream.py, whose renders go through the whole-call read.
"""

import numpy as np
import pytest
import torch

import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.io import stream as tstream
from graphaudio_tpu_torch.ops import stream as tops

SR = 48000


def _stacked(feed, n_steps, S, x0, rate):
    """The per-step reads of a call, stacked: f32[n_steps, C, S*128]
    (the same interpolation as the whole-call read; see the module's
    docstring)."""
    T = S * 128
    f64 = dict(dtype=torch.float64)
    args = () if x0 is None else (torch.tensor(x0, **f64), torch.tensor(rate, **f64))
    return torch.stack([tops.stream_feed_plain(feed, k * T, S, *args) for k in range(n_steps)])


def _feed(C, n, data, seed):
    rng = np.random.default_rng(seed)
    feed = np.zeros((C, n), np.float32)
    feed[:, :data] = rng.standard_normal((C, data)).astype(np.float32) * 0.3
    return torch.from_numpy(feed)


@pytest.mark.parametrize("S", [1, 32, 64])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("rate", [None, 0.5, 44100 / 48000, 3.0])
def test_call_read_equals_stacked_step_reads(S, C, rate):
    n_steps = 5 if S == 1 else 3
    T = S * 128
    frames = n_steps * T
    if rate is None:
        n = frames + 8
    elif rate == 3.0:  # the later quanta's taps clamp onto the feed's last frame
        n = 4 * (int(frames * rate) // 8)
    else:
        n = 4 * (int(frames * rate) // 4 + 2)
    feed = _feed(C, n, n, seed=S + 10 * C)
    x0 = None if rate is None else 1.0 + 0.25 * C
    got = tops.stream_feed_call_plain(feed, n_steps, S, x0, rate)
    want = _stacked(feed, n_steps, S, x0, rate)
    assert got.shape == (n_steps, C, T) and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(tops.stream_feed_call(feed, n_steps, S, x0, rate), want)
    if rate == 3.0:
        assert torch.equal(got[-1, :, -1], feed[:, -1])


@pytest.mark.parametrize("rate", [None, 44100 / 48000])
def test_call_read_of_a_stream_that_runs_out(rate):
    """3000 frames of data in an 8192-frame feed, a 4096-frame call: the
    taps past the data read the padding's zeros."""
    feed = _feed(2, 8192, 3000, seed=7)
    x0 = None if rate is None else 1.0
    got = tops.stream_feed_call_plain(feed, 4, 8, x0, rate)
    assert torch.equal(got, _stacked(feed, 4, 8, x0, rate))
    assert got.abs().flatten(1).amax() > 0.1
    assert got[-1, :, -200:].abs().max() == 0.0


@pytest.mark.parametrize("rate", [None, 1.0])
def test_call_read_of_a_stopped_stream(rate):
    """A stopped node's silent feed (x0 = rate = 1 in the resample mode):
    every row zero, as the per-step reads."""
    feed = torch.zeros((2, 8192))
    x0 = None if rate is None else 1.0
    got = tops.stream_feed_call_plain(feed, 2, 32, x0, rate)
    assert torch.equal(got, _stacked(feed, 2, 32, x0, rate))
    assert got.abs().max() == 0.0


def test_playback_rate_touched_mid_call_keeps_the_calls_mode(tmp_path, rng, monkeypatch):
    """playbackRate touched between two launches of a call: the call was
    staged and read as the unity copy and stays it (one K15 read, unity
    mode, the file's samples); the next call resamples at the new rate."""
    sig = (rng.standard_normal((1, 40000)) * 0.4).astype(np.float32)
    gat.io.write_wav(tmp_path / "s.wav", sig, SR, float32=True)
    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=2, device="cpu")
    ctx.chunk_schedule = 1
    ctx.destination.set_channel_count(1)
    ctx.destination.inputs[0].set_channel_count_mode(gat.ChannelCountMode.EXPLICIT)
    node = gat.io.AudioDecoderStreamNode.from_file(ctx, str(tmp_path / "s.wav"))
    node.connect(ctx.destination)
    node.play()
    ctx._ensure_compiled()
    real_fn = ctx._render_fn
    launches = []

    def render_fn(*args):
        out = real_fn(*args)
        launches.append(1)
        if len(launches) == 1:
            node.playback_rate.value = 1.5
        return out

    ctx._render_fn = render_fn
    reads = []
    real_call = tstream.stream_feed_call

    def spy(feed, n, S, *rest):
        reads.append(rest)
        return real_call(feed, n, S, *rest)

    monkeypatch.setattr(tstream, "stream_feed_call", spy)
    first = ctx.render(2048)
    assert len(launches) == 8 and node.playback_rate.touched and not node._unity()
    assert reads == [()]
    np.testing.assert_array_equal(first, sig[:, :2048])
    second = ctx.render(1024)
    assert len(reads) == 2 and len(reads[1]) == 2 and reads[1][1] == 1.5
    assert np.isfinite(second).all() and np.abs(second).max() > 0.1
