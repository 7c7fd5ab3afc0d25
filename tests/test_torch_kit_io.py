"""The Kit's data providers and streaming sounds in the port, on the CPU:
twins of tests/test_kit.py's provider, cache, one-shot, preload, async and
streaming-sound tests, each render held against the JAX package's.
"""

import asyncio
import os

import numpy as np
import pytest

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu import kit as jkit
from graphaudio_tpu_torch import kit as tkit
from graphaudio_tpu_torch.io import AudioDecoder, write_wav

SR = 48000


def _engines():
    """(JAX engine, port engine) over contexts of the same settings."""
    return (jkit.AudioEngine(ga.OfflineAudioContext(sample_rate=SR, superblock=2)),
            tkit.AudioEngine(gat.OfflineAudioContext(sample_rate=SR, superblock=2,
                                                     device="cpu")))


@pytest.fixture
def engine():
    return _engines()[1]


@pytest.fixture
def assets(tmp_path, rng):
    sig = (rng.standard_normal(8000) * 0.4).astype(np.float32)
    write_wav(tmp_path / "beep.wav", sig[None], SR, float32=True)
    return str(tmp_path), sig


def _both(assets, play, frames):
    """Render ``frames`` after ``play(engine, kit)`` in both packages."""
    outs = []
    for engine, kit in zip(_engines(), (jkit, tkit)):
        engine.data_provider = kit.FileSystemDataProvider(assets[0])
        play(engine, kit)
        outs.append(np.asarray(engine.context.render(frames)))
    return outs


def test_streaming_sound(assets):
    sounds = []

    def play(engine, kit):
        sound = engine.create_streaming_sound("beep.wav")
        sound.play()
        assert sound.is_playing
        sounds.append(sound)

    want, got = _both(assets, play, 2048)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[0] - assets[1][:2048]).max() < 1e-6
    sound = sounds[1]
    assert isinstance(sound, tkit.StreamingSound)
    assert sound.duration == pytest.approx(8000 / SR) and sound.sample_rate == SR
    sound.pause()
    assert not sound.is_playing
    sound.is_looping = True
    assert sound._stream.loop
    sound.dispose()
    assert not sound._stream._thread.is_alive()


def test_play_one_shot(assets):
    def play(engine, kit):
        sound = engine.play_one_shot("beep.wav")
        assert sound is not None and sound.is_one_shot

    want, got = _both(assets, play, 1024)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[0] - assets[1][:1024]).max() < 1e-6


def test_play_one_shot_without_provider_logs(engine, capsys):
    assert engine.play_one_shot("missing.wav") is None
    assert "data_provider is None" in capsys.readouterr().out


def test_cache_get_or_load(engine, assets):
    provider = tkit.FileSystemDataProvider(assets[0])
    b1 = engine.buffer_cache.get_or_load("beep.wav", provider)
    b2 = engine.buffer_cache.get_or_load("beep.wav", provider)
    assert b1 is b2
    np.testing.assert_array_equal(np.asarray(b1.data)[0], assets[1])
    assert isinstance(provider, tkit.DataProvider)


def test_provider_path_escape_guard(assets):
    provider = tkit.FileSystemDataProvider(assets[0])
    with pytest.raises((PermissionError, FileNotFoundError)):
        provider.get_bytes("../../etc/passwd")
    with pytest.raises(FileNotFoundError):
        provider.get_bytes("missing.wav")
    with pytest.raises(FileNotFoundError):
        tkit.FileSystemDataProvider(os.path.join(assets[0], "no-such-dir"))


def test_preload_buffers_parallel(engine, tmp_path, rng):
    paths = []
    for i in range(12):
        sig = (rng.standard_normal(4000) * 0.2).astype(np.float32)
        write_wav(tmp_path / f"p{i}.wav", sig[None], SR, float32=True)
        paths.append(f"p{i}.wav")
    engine.data_provider = tkit.FileSystemDataProvider(str(tmp_path))
    engine.preload_buffers(paths)
    for p in paths:
        assert engine.buffer_cache.contains(p)


def test_preload_buffers_parallel_propagates_errors(engine, tmp_path):
    engine.data_provider = tkit.FileSystemDataProvider(str(tmp_path))
    with pytest.raises(Exception):
        engine.preload_buffers(["missing1.wav", "missing2.wav"])


def test_async_loading_surface(engine, assets):
    base, sig = assets
    engine.data_provider = tkit.FileSystemDataProvider(base)

    async def run():
        await engine.preload_buffers_async(["beep.wav"])
        sound = await engine.create_buffered_sound_async("beep.wav")
        buf = await AudioDecoder.load_from_file_async(os.path.join(base, "beep.wav"))
        return sound, buf

    sound, buf = asyncio.run(run())
    assert engine.buffer_cache.contains("beep.wav")
    assert buf.length == len(sig)
    sound.play()
    out = engine.context.render(1024)
    assert np.abs(out[0] - sig[:1024]).max() < 1e-6
