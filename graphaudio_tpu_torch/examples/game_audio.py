"""Game audio: the Kit layer driving a moving 3-D scene.

The twin of examples/game_audio.py on the port: 60 game ticks of 50 ms
(2400 frames, not a whole number of superblocks), a looping binaural sound
on a moving ``SpatialAnchor``, one-shots every 20 ticks and an ``sfx`` bus
with a reverb send. Run:

    python -m graphaudio_tpu_torch.examples.game_audio [out.wav]
"""

import os
import sys
import tempfile

import numpy as np

import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.io import write_wav
from graphaudio_tpu_torch.kit import (
    AudioEngine,
    FileSystemDataProvider,
    ReverbEffect,
    SoundMixState,
    SpatialAnchor,
)


def main(path="game_scene.wav", device="cuda"):
    sr = 48000
    rng = np.random.default_rng(3)

    with tempfile.TemporaryDirectory() as assets:  # a stand-in asset directory
        engine_hum = np.sin(2 * np.pi * 75 * np.arange(sr) / sr).astype(np.float32) * 0.4
        write_wav(os.path.join(assets, "engine.wav"), engine_hum[None], sr, float32=True)
        chirp = (
            np.sin(2 * np.pi * (900 + 500 * np.linspace(0, 1, 6000) ** 2)
                   * np.arange(6000) / sr)
            * np.exp(-np.arange(6000) / 2000)
        ).astype(np.float32)
        write_wav(os.path.join(assets, "chirp.wav"), chirp[None], sr, float32=True)

        engine = AudioEngine(gat.OfflineAudioContext(sample_rate=sr, superblock=4,
                                                     device=device))
        engine.data_provider = FileSystemDataProvider(assets)
        engine.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])

        # Bus tree with a reverb send on sfx.
        sfx = engine.get_bus("sfx")
        rev = ReverbEffect(engine)
        ir = (rng.standard_normal(sr // 2) * np.exp(-np.arange(sr // 2) / 6000)).astype(
            np.float32)
        rev.set_impulse_response(gat.PlayableAudioBuffer.from_mono_array(ir, sr))
        rev.wet.value = 0.4
        sfx.effects.add(rev)

        # A vehicle circling the listener, followed through a SpatialAnchor.
        vehicle = SpatialAnchor((6.0, 0.0, 0.0))
        hum = engine.create_buffered_sound(
            "engine.wav", mix_state=SoundMixState.BINAURAL_SPATIALIZED, bus=sfx
        )
        hum.is_looping = True
        hum.anchor = vehicle
        hum.play()

        frames = []
        for step in range(60):  # 3 seconds, 50 ms game ticks
            t = step * 0.05
            angle = t * 1.5
            vehicle.position = (6 * np.cos(angle), 0.0, -6 * np.sin(angle))
            if step % 20 == 10:
                engine.play_one_shot("chirp.wav", bus=sfx)
            engine.update()
            frames.append(engine.context.render(int(0.05 * sr)))
    audio = np.concatenate(frames, axis=1)
    write_wav(path, audio, sr)
    print(f"wrote {path}: {audio.shape[1]} frames, peak {np.abs(audio).max():.3f}")
    print("render stats:", engine.context.stats.summary(sr))


if __name__ == "__main__":
    main(*sys.argv[1:])
