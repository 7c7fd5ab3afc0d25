"""Unity-rate buffer playback: the block copy of a voice group (K5).

At the context's rate a buffer source plays its samples unchanged, so a
superblock of a voice group is a copy of 128-frame blocks out of the packed
sample arena. The JAX package (graphaudio_tpu/nodes/sources.py
process_unity_group :1104, _gather_blocks_group :1073) fetches them as
128-sample row gathers and shifts unaligned voices with one-hot lane-shift
matmuls, because element gathers are slow on a TPU. ``unity_gather`` reads
each sample straight from the arena instead: csrc/unity.cu on a CUDA
tensor, ``unity_gather_plain`` on a CPU tensor. The f64 bookkeeping that
feeds it lives in nodes/sources.unity_group_plan.
"""

from __future__ import annotations

import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.utils import cudabuild


def unity_gather_plain(arena, row0, delta, bidx, g0, end_bound, looping, blk_ok):
    """Plain torch K5. arena f32[C, W] (W a multiple of 128); per voice:
    row0 i64[V] (first arena row of the window), delta i32[V] (lane offset
    within the row), end_bound i32[V], looping bool[V]; per block: bidx
    i32[V, S] (row index after row0), g0 i32[V, S] (original-coordinate
    index of the block's first sample), blk_ok bool[V, S].

    Sample i of block s of voice v is arena[c, row*128 + delta + i] with
    row = clip(row0 + bidx), the row after it when delta + i >= 128 (also
    clipped), kept where blk_ok and (looping or g0 + i < end_bound).
    Returns f32[V, C, S*128]."""
    C, W = arena.shape
    V, S = bidx.shape
    nrows = W // FRAMES_PER_BLOCK
    i = torch.arange(FRAMES_PER_BLOCK, device=arena.device, dtype=torch.int64)
    lo = torch.clamp(row0[:, None] + bidx.to(torch.int64), 0, nrows - 1)  # [V, S]
    hi = torch.clamp(lo + 1, 0, nrows - 1)
    j = delta.to(torch.int64)[:, None, None] + i  # [V, 1, 128]
    col = torch.where(j < FRAMES_PER_BLOCK, lo[:, :, None] * FRAMES_PER_BLOCK + j,
                      hi[:, :, None] * FRAMES_PER_BLOCK + j - FRAMES_PER_BLOCK)
    samples = arena[:, col.reshape(-1)].reshape(C, V, S, FRAMES_PER_BLOCK)
    valid = looping[:, None, None] | (
        g0.to(torch.int64)[:, :, None] + i < end_bound.to(torch.int64)[:, None, None])
    keep = blk_ok[:, :, None] & valid  # [V, S, 128]
    out = torch.where(keep[None], samples, torch.zeros((), dtype=samples.dtype,
                                                       device=samples.device))
    return out.permute(1, 0, 2, 3).reshape(V, C, S * FRAMES_PER_BLOCK)


def unity_gather(arena, row0, delta, bidx, g0, end_bound, looping, blk_ok):
    """K5: the unity-rate samples of a voice group, f32[V, C, S*128] (see
    ``unity_gather_plain``). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if arena.device.type == "cpu":
        return unity_gather_plain(arena, row0, delta, bidx, g0, end_bound, looping,
                                  blk_ok)
    V, S = bidx.shape
    C, W = arena.shape
    if W % FRAMES_PER_BLOCK:
        raise ValueError(f"arena width {W} is not a multiple of {FRAMES_PER_BLOCK}")
    req = cudabuild.require
    req(arena, "arena", torch.float32, ndim=2)
    req(row0, "row0", torch.int64, shape=(V,))
    req(delta, "delta", torch.int32, shape=(V,))
    req(bidx, "bidx", torch.int32, shape=(V, S))
    req(g0, "g0", torch.int32, shape=(V, S))
    req(end_bound, "end_bound", torch.int32, shape=(V,))
    req(looping, "looping", torch.bool, shape=(V,))
    req(blk_ok, "blk_ok", torch.bool, shape=(V, S))
    out = torch.empty((V, C, S * FRAMES_PER_BLOCK), dtype=torch.float32,
                      device=arena.device)
    # bool tensors are one byte per element: passed as uint8 pointers.
    status = cudabuild.launcher("ga_unity_gather")(
        arena.data_ptr(), W, C, V, S, row0.data_ptr(), delta.data_ptr(),
        bidx.data_ptr(), g0.data_ptr(), end_bound.data_ptr(), looping.data_ptr(),
        blk_ok.data_ptr(), out.data_ptr(), cudabuild.stream_of(arena),
    )
    cudabuild.check(status, "ga_unity_gather")
    cudabuild.launches["unity_gather"] += 1
    return out
