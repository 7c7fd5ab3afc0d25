"""Wire-format PCM delivery and Ogg Opus assets.

The twin of examples/pcm_delivery_opus.py on the port:
  1. install a measured HRIR set as the CONTEXT default, so every spatial
     voice takes it (``set_default_hrir``),
  2. render the scene to interleaved int16 PCM packed on the card
     (``render_pcm16``: 2 bytes a sample leave the device),
  3. encode the mix as Ogg Opus (RFC 7845; dlopen'd libopus and libogg)
     and decode it back, checking the duration; where the machine has no
     Opus encoder the example says so and stops after step 2.

Run:

    python -m graphaudio_tpu_torch.examples.pcm_delivery_opus [out.opus]
"""

import os
import sys
import tempfile

import numpy as np

import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.io import AudioDecoder, codec_capabilities, write_opus
from graphaudio_tpu_torch.ops.hrtf import build_hrir_grid

SR = 48000


def synthetic_measured_set():
    """Stand-in for a real SOFA file: the analytic grid repackaged through
    the measured-HRIR import path."""
    grid = build_hrir_grid(SR, n_azimuth=12, n_elevation=5)
    az = np.repeat(np.arange(12) * 30.0, 5)
    el = np.tile(np.linspace(-90, 90, 5), 12)
    hrirs = np.stack([grid[ei, ai] for ai in range(12) for ei in range(5)])
    return {"hrir": hrirs, "azimuth_deg": az, "elevation_deg": el, "sample_rate": SR}


def main(out_path=None, device="cuda"):
    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=16, device=device)
    ctx.set_default_hrir(synthetic_measured_set())
    ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])

    rng = np.random.default_rng(3)
    for v in range(8):
        src = gat.AudioBufferSourceNode(ctx)
        tone = (np.sin(2 * np.pi * 220 * (v + 1) / 8 * np.arange(SR) / SR)
                * np.exp(-np.arange(SR) / (0.3 * SR)) * 0.2)
        src.buffer = gat.PlayableAudioBuffer.from_mono_array(
            (tone + rng.standard_normal(SR) * 0.01).astype(np.float32), SR)
        src.loop = True
        pan = gat.SpatialPannerNode(ctx)
        ang = 2 * np.pi * v / 8
        pan.position_x.value = 4 * np.cos(ang)
        pan.position_z.value = 4 * np.sin(ang)
        src.connect(pan).connect(ctx.destination)
        src.start(0)

    seconds = 2.0
    pcm = ctx.render_pcm16(int(seconds * SR))  # int16, packed on the device
    print(f"rendered {pcm.shape[0] // 2} frames as int16 PCM "
          f"({pcm.nbytes} bytes on the wire vs {pcm.shape[0] * 4} as f32)")

    caps = codec_capabilities()
    if not (caps.get("opus") and caps.get("opus_encode")):
        print("opus codec unavailable on this machine; skipping encode")
        return
    out = out_path or os.path.join(tempfile.gettempdir(), "scene.opus")
    planar = pcm.reshape(-1, 2).T.astype(np.float32) / 32767.0
    write_opus(out, planar, SR, bitrate_bps=128000)
    with AudioDecoder(out) as dec:
        print(f"wrote {out}: {dec.channels} ch, {dec.frames} frames "
              f"@ {dec.sample_rate} Hz ({os.path.getsize(out)} bytes compressed)")
        assert dec.frames == planar.shape[1]


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
