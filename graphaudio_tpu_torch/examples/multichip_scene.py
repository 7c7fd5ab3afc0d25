"""Multi-device rendering: shard a voice scene over a mesh of ranks.

The twin of examples/multichip_scene.py on the port. ``n_devices`` ranks
are spawned and joined in a gloo process group; each builds the same graph,
puts it on a ``voice`` mesh of all ranks (``parallel.make_mesh`` and
``context.set_mesh``), renders 2 s of ``n_devices * 8`` voices and gets the
whole mix (the fan-in's sum is an all_reduce). With ``device="cuda"`` every
rank renders on the one card (gloo with CUDA tensors: NCCL refuses two
ranks on one GPU); with ``device="cpu"`` on the CPU. Rank 0 prints the
sharded stages and writes multichip_scene.wav to the working directory.
Run:

    python -m graphaudio_tpu_torch.examples.multichip_scene [n_devices]
"""

import sys

import numpy as np

SR = 48000


def build_scene(ctx, n_devices):
    """The scene of ``n_devices * 8`` looped, decaying tones into one
    master gain, in ``ctx``."""
    import graphaudio_tpu_torch as gat

    master = gat.GainNode(ctx)
    master.gain.value = 0.5
    master.connect(ctx.destination)
    for v in range(n_devices * 8):
        hz = 110.0 * (1.5 ** (v % 8))
        tone = (
            np.sin(2 * np.pi * hz * np.arange(SR) / SR)
            * np.exp(-np.arange(SR) / (0.3 * SR))
        ).astype(np.float32) * 0.1
        src = gat.AudioBufferSourceNode(ctx)
        src.buffer = gat.PlayableAudioBuffer.from_mono_array(tone, SR)
        src.loop = True
        g = gat.GainNode(ctx)
        g.gain.value = 0.8 / (1 + v % 4)
        src.connect(g).connect(master)
        src.start(v * 0.05)
    return ctx


def render_rank(rank, world, device):
    """One rank's render (a ``testing.mesh.run_ranks`` job): the scene on a
    voice mesh of every rank, 2 s; rank 0 prints and writes the WAV. Returns
    (audio f32[2, frames], the sharded stages, graph builds, the kernels'
    launches in this rank by wrapper name)."""
    import torch

    import graphaudio_tpu_torch as gat
    from graphaudio_tpu_torch.io import write_wav
    from graphaudio_tpu_torch.parallel import make_mesh
    from graphaudio_tpu_torch.utils import cudabuild

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else device
    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=8, device=dev)
    ctx.set_mesh(make_mesh(voice_axis=world, device_type=torch.device(device).type))
    build_scene(ctx, world)
    out = ctx.render_seconds(2.0)
    sharded = sorted(ctx._compiled.sharded_stages)
    if rank == 0:
        print(f"rendered {out.shape[1]} frames of {world * 8} voices over "
              f"{world} ranks; sharded stages: {sharded}")
        print(f"peak {np.abs(out).max():.3f}, rms {np.sqrt((out**2).mean()):.4f}")
        write_wav("multichip_scene.wav", out, SR)
        print("wrote multichip_scene.wav", flush=True)
    return out, sharded, ctx.stats.graph_builds, dict(cudabuild.launches)


def main(n_devices: int = 4, device="cuda"):
    """Spawn ``n_devices`` ranks and render; returns each rank's
    ``render_rank`` result, in rank order."""
    from graphaudio_tpu_torch.core.context import resolve_device
    from graphaudio_tpu_torch.testing.mesh import run_ranks

    # The job by its package name, also when this file runs as __main__.
    from graphaudio_tpu_torch.examples.multichip_scene import render_rank as job

    cuda = resolve_device(device).type == "cuda"  # raises where CUDA is absent
    return run_ranks(job, n_devices, "gloo", args=("cuda" if cuda else "cpu",),
                     timeout=600, cuda=cuda)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
