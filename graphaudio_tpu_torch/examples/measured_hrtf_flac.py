"""Measured-HRTF spatialization and lossless FLAC delivery.

The twin of examples/measured_hrtf_flac.py on the port:
  1. load a measured HRIR set (SOFA file, .npz, or in-memory arrays) into a
     SpatialPannerNode in place of the analytic spherical-head default,
  2. render a moving source binaurally,
  3. write the mix as 24-bit FLAC (native encoder, lossless) and read it
     back sample-exact with the decoder the streaming nodes use.

Run:

    python -m graphaudio_tpu_torch.examples.measured_hrtf_flac [out.flac]
"""

import sys

import numpy as np

import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.io import AudioDecoder, write_flac
from graphaudio_tpu_torch.nodes.spatial import SpatialPannerNode

SR = 48000


def synthetic_measured_set():
    """Stand-in for a SOFA file: per-direction HRIRs with direction-coded
    delay and shadow. Real use: SpatialPannerNode.load_hrir("subject.sofa")."""
    azs, els, irs = [], [], []
    for el in (-45, 0, 45):
        for az in range(0, 360, 15):
            ir = np.zeros((2, 96), np.float32)
            # crude measured-like cues: ITD by azimuth, a little spread
            d_l = 4 + int(10 * (1 + np.sin(np.deg2rad(az))) / 2)
            d_r = 4 + int(10 * (1 - np.sin(np.deg2rad(az))) / 2)
            ir[0, d_l] = 1.0
            ir[0, d_l + 3] = 0.25
            ir[1, d_r] = 1.0
            ir[1, d_r + 3] = 0.25
            azs.append(az)
            els.append(el)
            irs.append(ir)
    return {
        "hrir": np.stack(irs),
        "azimuth_deg": np.asarray(azs, np.float64),
        "elevation_deg": np.asarray(els, np.float64),
        "sample_rate": SR,
    }


def main(device="cuda"):
    out_path = sys.argv[1] if len(sys.argv) > 1 else "hrtf_scene.flac"

    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=16, device=device)
    ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])

    rng = np.random.default_rng(7)
    src = gat.AudioBufferSourceNode(ctx)
    src.buffer = gat.PlayableAudioBuffer.from_mono_array(
        (rng.standard_normal(SR) * 0.2).astype(np.float32), SR
    )
    src.loop = True

    pan = SpatialPannerNode(ctx)
    pan.load_hrir(synthetic_measured_set())  # or: pan.load_hrir("subject.sofa")
    src.connect(pan).connect(ctx.destination)
    src.start(0)

    # Sweep the source around the head, one render call a segment (k-rate
    # positions take effect at the next call).
    chunks = []
    seconds = 4.0
    segs = 32
    for i in range(segs):
        angle = 2 * np.pi * i / segs
        pan.position_x.value = 3.0 * np.sin(angle)
        pan.position_z.value = -3.0 * np.cos(angle)
        chunks.append(ctx.render(int(seconds * SR / segs)))
    mix = np.concatenate(chunks, axis=1)

    write_flac(out_path, mix, SR, bits=24)
    with AudioDecoder(out_path) as dec:
        back = dec.decode_planar(dec.frames)
    q = np.clip(np.rint(mix.astype(np.float64) * (1 << 23)),
                -(1 << 23), (1 << 23) - 1) / (1 << 23)
    exact = np.array_equal(back, q.astype(np.float32))
    print(f"wrote {out_path}: {mix.shape[1] / SR:.1f} s binaural, "
          f"24-bit FLAC round-trip lossless: {exact}")


if __name__ == "__main__":
    main()
