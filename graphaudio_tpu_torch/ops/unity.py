"""Unity-rate buffer playback: the block copy of a voice group (K5).

At the context's rate a buffer source plays its samples unchanged, so a
superblock of a voice group is a copy of 128-frame blocks out of the packed
sample arena. The JAX package (graphaudio_tpu/nodes/sources.py
process_unity_group :1104, _gather_blocks_group :1073) fetches them as
128-sample row gathers and shifts unaligned voices with one-hot lane-shift
matmuls, because element gathers are slow on a TPU. The port reads each
sample straight from the arena instead (``unity_gather_plain``).

K5 is one whole step of a unity-rate voice group: the f64 per-voice
bookkeeping (nodes/sources.AudioBufferSourceNode.unity_group_plan) and the
masked copy. ``unity_group_step`` launches it as one kernel on the card
(csrc/unity.cu); on the CPU the plan and ``unity_gather_plain`` are the
path.
"""

from __future__ import annotations

import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.ops import voice_group
from graphaudio_tpu_torch.utils import cudabuild


def unity_gather_plain(arena, row0, delta, bidx, g0, end_bound, looping, blk_ok):
    """The gather of K5's plain version, in torch. arena f32[C, W] (W a
    multiple of 128); per voice: row0 i64[V] (first arena row of the
    window), delta i32[V] (lane offset within the row), end_bound i32[V],
    looping bool[V]; per block: bidx
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


# The group's stacked [V] states the fused step reads, in the kernel's
# argument order, with their dtypes.
UNITY_STATE_FIELDS = (("started", torch.int32), ("start_time", torch.float64),
                      ("stop_time", torch.float64), ("offset", torch.float64),
                      ("duration", torch.float64), ("pos", torch.float64))


def unity_group_step(states, arena, gtab, block_times, block_end_times):
    """K5: one step of a unity-rate voice group in one launch on the card
    (csrc/unity.cu). Returns (pos, stop_time, out f32[V, C, S*128]); the
    new states are fresh tensors, two rows of one f64[2, V]. CUDA tensors
    only: the plain composition (AudioBufferSourceNode
    .unity_group_step_plain) is the CPU path. gtab is the group's packed
    geometry table (ops/voice_group.pack_group_table); the arena's width
    is a multiple of 128."""
    V, S = voice_group.check_group_inputs(states, UNITY_STATE_FIELDS, arena, gtab,
                                          block_times, block_end_times)
    C, W = arena.shape
    if W % FRAMES_PER_BLOCK:
        raise ValueError(f"arena width {W} is not a multiple of {FRAMES_PER_BLOCK}")
    out = arena.new_empty((V, C, S * FRAMES_PER_BLOCK))
    st_out = gtab.new_empty((2, V))
    ptr = [states[name].data_ptr() for name, _ in UNITY_STATE_FIELDS]
    status = cudabuild.launcher("ga_unity_group_step")(
        arena.data_ptr(), W, C, V, S, gtab.data_ptr(), *ptr, block_times.data_ptr(),
        block_end_times.data_ptr(), out.data_ptr(), st_out.data_ptr(),
        cudabuild.stream_of(arena))
    if status:
        cudabuild.check(status, "ga_unity_group_step")
    cudabuild.launches["unity_group_step"] += 1
    return st_out[0], st_out[1], out
