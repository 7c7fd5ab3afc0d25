"""The port's decoder stream node (io/stream.py, K15's plain version) and
the per-call feeds, against the JAX package on the CPU.

* twins of tests/test_io.py's stream-node tests (unity, resample, end of
  stream, loop, the playbackRate automation read at call boundaries, MP3
  and Ogg Opus feeds, skipping where the JAX tests skip) and of
  ``test_tiny_buffer_extreme_downsample_renders``: the same file opened by
  both packages, the port's render against the jitted JAX render bit for
  bit (tolerance 0: the port mirrors XLA's rounding of the resampler, one
  f64 fma for the quantum's position, three f32 fmas in the polynomial;
  ops/stream.py);
* the first touch of playbackRate switches the unity copy to the
  resampler at the next call, in both packages;
* a streamed Kit sound under the Kit's gain pipes (D = 2) over several
  calls: K15 reads each call's n steps once, the stream stage runs in the
  call's rows 0 to n - 1 only (the drain rows read no feed), row r handing
  on row r of the read, and the audio equals the JAX render;
* a mid-render ``from_jax`` hand-off of the stream stage's state;
* ``config5_streamed`` reduced (8 voices, superblock 4, 8192 frames)
  against its JAX twin within 1e-5.
"""

import importlib

import numpy as np
import pytest

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.io import codec_capabilities, write_mp3, write_opus, write_wav
from graphaudio_tpu_torch.io import stream as tstream
from graphaudio_tpu_torch.io import StreamState
from graphaudio_tpu_torch.testing import configs as tconfigs
from graphaudio_tpu_torch.utils import from_jax

SR = 48000


def _contexts(superblock=2, mono=False):
    """A JAX context and a port CPU context of the same settings."""
    out = []
    for pkg, kw in ((ga, {}), (gat, {"device": "cpu"})):
        ctx = pkg.OfflineAudioContext(sample_rate=SR, superblock=superblock, **kw)
        if mono:
            ctx.destination.set_channel_count(1)
            ctx.destination.inputs[0].set_channel_count_mode(pkg.ChannelCountMode.EXPLICIT)
        out.append((pkg, ctx))
    return out


def _twin(path, calls, superblock=2, mono=False, setup=None, between=None):
    """Render ``calls`` (frames each) of a stream node on ``path`` in both
    packages: returns (JAX audio, port audio, port node), each the calls
    joined. ``setup(node)`` runs before the first call, ``between(node,
    i)`` before call i > 0."""
    renders, node = [], None
    for pkg, ctx in _contexts(superblock, mono):
        node = pkg.io.AudioDecoderStreamNode.from_file(ctx, str(path))
        node.connect(ctx.destination)
        if setup is not None:
            setup(node)
        parts = []
        for i, n in enumerate(calls):
            if i and between is not None:
                between(node, i)
            parts.append(np.asarray(ctx.render(n)))
        renders.append(np.concatenate(parts, axis=1))
    return renders[0], renders[1], node


def _wav(tmp_path, rng, frames, channels=1, rate=SR, name="s.wav"):
    sig = (rng.standard_normal((channels, frames)) * 0.4).astype(np.float32)
    path = tmp_path / name
    write_wav(path, sig, rate, float32=True)
    return path, sig


def test_stream_node_unity(tmp_path, rng):
    path, sig = _wav(tmp_path, rng, 12000, channels=2)

    def between(node, i):
        node.pause()
        assert node.state.value == StreamState.PAUSED.value
        node.play()

    want, got, node = _twin(path, (2048, 2048), setup=lambda n: n.play(), between=between)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sig[:, :4096])


@pytest.mark.parametrize("rate,playback", [(44100, None), (22050, 0.5), (SR, 3.0),
                                           (SR, 1.37)])
def test_stream_node_resample(tmp_path, rng, rate, playback):
    """44.1 kHz into 48 kHz (test_io's case), and the rates 0.5 and 3.0
    and an irrational one, over calls that end inside a superblock."""
    path, sig = _wav(tmp_path, rng, 60000, rate=rate)

    def setup(node):
        if playback is not None:
            node.playback_rate.value = playback
        node.play()

    want, got, _ = _twin(path, (2048, 1000, 4096, 2048), mono=True, setup=setup)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    np.testing.assert_array_equal(got, want)


def test_stream_node_end_stops(tmp_path, rng):
    """The end of the data, not looping: the taps past it read the feed's
    padded zeros, the node stops, and later calls are silent (a stopped
    node's feed covers the whole call)."""
    for rate in (SR, 44100):
        path, sig = _wav(tmp_path, rng, 3000, rate=rate, name=f"e{rate}.wav")
        want, got, node = _twin(path, (4096, 2048), setup=lambda n: n.play())
        np.testing.assert_array_equal(got, want)
        assert node.state == StreamState.STOPPED
        assert np.abs(got[:, 3300:]).max() == 0.0
    # a call past the JAX feed's 8192 frames while stopped: silent, not NaN
    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=4, device="cpu")
    gat.io.AudioDecoderStreamNode.from_file(ctx, str(path)).connect(ctx.destination)
    out = ctx.render(16384)
    assert np.isfinite(out).all() and np.abs(out).max() == 0.0


def test_stream_node_loop(tmp_path, rng):
    path, sig = _wav(tmp_path, rng, 3000)

    def setup(node):
        node.loop = True
        node.play()

    want, got, _ = _twin(path, (9216,), setup=setup)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], sig[0, np.arange(9216) % 3000])


def test_stream_playback_rate_automation_followed_at_call_boundaries(tmp_path, rng):
    path, data = _wav(tmp_path, rng, 48000)

    def setup(node):
        node.play()
        node.playback_rate.set_value_at_time(2.0, 0.0)

    want, got, _ = _twin(path, (1024, 1024), setup=setup)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[0, 8:1024] - data[0, 1 + 16:1 + 2 * 1024:2]).max() < 1e-3


def test_first_touch_switches_to_the_resampler(tmp_path, rng):
    """playbackRate's first touch between calls: the first call is the
    unity copy, the next ones resample at the new rate (the plan rebuilt
    by the touch), as in the JAX package."""
    path, _ = _wav(tmp_path, rng, 40000)

    def between(node, i):
        if i == 1:
            node.playback_rate.value = 1.5

    want, got, node = _twin(path, (2048, 2048, 1000), setup=lambda n: n.play(),
                            between=between)
    assert not node._unity()
    np.testing.assert_array_equal(got, want)


def test_tiny_buffer_extreme_downsample_renders():
    """A 1-sample buffer at an extreme rate ratio (test_io's regression)."""
    outs = []
    for pkg, ctx in _contexts(superblock=8):
        src = pkg.AudioBufferSourceNode(ctx)
        src.buffer = pkg.PlayableAudioBuffer.from_mono_array(np.ones(1, np.float32), 1500)
        src.playback_rate.value = 1.0
        src.connect(ctx.destination)
        src.start(0)
        outs.append(np.asarray(ctx.render(1024)))
    assert np.isfinite(outs[1]).all()
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-5)


def _tone(frames, hz=(440.0, 880.0)):
    t = np.arange(frames) / SR
    return np.stack([np.sin(2 * np.pi * h * t) for h in hz]).astype(np.float32) * 0.5


def test_mp3_stream_node(tmp_path):
    caps = codec_capabilities()
    if not (caps["mp3"] and caps["mp3_encode"]):
        pytest.skip("system mp3 codec unavailable")
    path = tmp_path / "s.mp3"
    write_mp3(path, _tone(SR), SR)
    want, got, _ = _twin(path, (8192,), setup=lambda n: n.play())
    np.testing.assert_array_equal(got, want)
    spec = np.abs(np.fft.rfft(got[0]))
    assert abs(spec.argmax() * SR / got.shape[1] - 440.0) < 10.0


def test_opus_stream_node_with_loop(tmp_path):
    caps = codec_capabilities()
    if not (caps.get("opus") and caps.get("opus_encode")):
        pytest.skip("system opus codec unavailable")
    n = 24000
    sig = (np.sin(2 * np.pi * 440 * np.arange(n) / SR) * 0.5).astype(np.float32)[None]
    path = tmp_path / "s.opus"
    write_opus(path, sig, SR)

    def setup(node):
        node.loop = True
        node.play()

    want, got, _ = _twin(path, (2 * n,), setup=setup)
    np.testing.assert_array_equal(got, want)
    assert float(np.sqrt(np.mean(got[0, n:].astype(np.float64) ** 2))) > 0.2


def test_streamed_sound_under_kit_pipes_reads_no_feed_in_drain_rows(tmp_path, rng,
                                                                    monkeypatch):
    """A streamed Kit sound (44.1 kHz, resampled) on a bus: its gain, the
    bus's and the master's are one pipe (D = 2), so each call runs n + 2 rows;
    K15 reads the call's n steps once, at staging, and the stream stage runs
    in rows 0 to n - 1 only, row r handing on row r of that read; the
    render equals the JAX package's over calls of several lengths."""
    _wav(tmp_path, rng, 30000, channels=2, rate=44100, name="m.wav")
    calls, renders = (2048, 1000, 3072, 512), []
    reads, rows = [], []
    real_call = tstream.stream_feed_call
    real_process = tstream.AudioDecoderStreamNode.process

    def spy_call(feed, n_steps, S, *rest):
        out = real_call(feed, n_steps, S, *rest)
        reads.append((n_steps, S, rest, out))
        return out

    def spy_process(self, state, inputs, params, rc):
        state, outs = real_process(self, state, inputs, params, rc)
        read = reads[-1][3]
        rows.append((outs[0].data_ptr() - read.data_ptr()) // (read[0].numel() * 4))
        return state, outs

    for pkg, ctx in _contexts(superblock=2):
        kit = importlib.import_module(f"{pkg.__name__}.kit")
        engine = kit.AudioEngine(ctx)
        engine.data_provider = kit.FileSystemDataProvider(str(tmp_path))
        sound = engine.create_streaming_sound("m.wav", bus=engine.get_bus("music"))
        sound.play()
        parts = []
        for n in calls:
            if pkg is gat:
                monkeypatch.setattr(tstream, "stream_feed_call", spy_call)
                monkeypatch.setattr(tstream.AudioDecoderStreamNode, "process", spy_process)
                reads.clear()
                rows.clear()
            parts.append(np.asarray(ctx.render(n)))
            monkeypatch.undo()
            if pkg is gat:
                steps = ctx.stats.last_breakdown["rows"] - ctx._compiled.pipe_delay
                assert ctx._compiled.pipe_delay == 2
                assert [(k, S, len(rest)) for k, S, rest, _ in reads] == [(steps, 2, 2)]
                assert reads[0][3].shape == (steps, 2, 2 * 128)
                assert rows == list(range(steps))
        renders.append(np.concatenate(parts, axis=1))
    assert np.abs(renders[1]).max() > 0.1
    np.testing.assert_array_equal(renders[1], renders[0])


def test_mid_render_handoff_from_jax(tmp_path, rng):
    """The JAX render's stream stage state (x0, rate) carried into the port
    mid-render: each package's node keeps its own decoder queue, both at
    the same point after the first call."""
    import jax

    path, _ = _wav(tmp_path, rng, 30000, rate=44100)
    (jpkg, jctx), (tpkg, tctx) = _contexts(superblock=2, mono=True)
    nodes = []
    for pkg, ctx in ((jpkg, jctx), (tpkg, tctx)):
        node = pkg.io.AudioDecoderStreamNode.from_file(ctx, str(path))
        node.connect(ctx.destination)
        node.play()
        ctx.render(1536)
        nodes.append(node)
    from_jax.load_render_state(tctx, jax.device_get(jctx._states),
                               jax.device_get(jctx._consts), jctx._current_frame,
                               jctx._current_time)
    np.testing.assert_array_equal(np.asarray(tctx.render(2048)), np.asarray(jctx.render(2048)))


def test_reduced_config5_streamed_side_by_side_with_jax(tmp_path):
    port = tconfigs.config5_streamed(superblock=4, voices=8, device="cpu", root=str(tmp_path))
    data = {p: (tmp_path / p).read_bytes() for p in ("music.flac", "ambience.wav")}
    jax_ctx = tconfigs.config5_streamed(superblock=4, voices=8, api=ga, root=str(tmp_path))
    assert {p: (tmp_path / p).read_bytes() for p in data} == data  # same bytes
    got = port.render(8192)
    want = np.asarray(jax_ctx.render(8192))
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for s in port._streams:
        assert s.is_playing


def test_config5_streamed_gain_group_is_one_gather(tmp_path, monkeypatch):
    """The streamed sounds' gains join the voices' gain group (10 lanes
    padded to 16 here: 8 read one lane of the voice group, 2 a stream
    stage's whole output, 6 nothing); its input is one gather from the
    sources joined (a route of three sources), bit for bit the per-lane mix."""
    from graphaudio_tpu_torch.core import graph

    build = lambda: tconfigs.config5_streamed(  # noqa: E731
        superblock=4, voices=8, device="cpu", root=str(tmp_path))
    ctx = build()
    ctx._ensure_compiled()
    multi = [g for g in graph.one_gather_routes(ctx._compiled.plan).values()
             if len(g[0]) > 1]
    assert len(multi) == 1
    sources, lanes = multi[0]
    assert sorted(grouped for _, _, grouped, _ in sources) == [False, False, True]
    assert len(lanes) == 16 and lanes.count(None) == 6
    got = ctx.render(4096)
    monkeypatch.setattr(graph, "one_gather_routes", lambda plan: {})
    np.testing.assert_array_equal(got, build().render(4096))
