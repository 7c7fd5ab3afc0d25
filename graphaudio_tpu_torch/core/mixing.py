"""Channel up/down-mixing rules and the lane fan-in kernel (K3).

Parity: GraphAudio.Core/AudioNodeInput.MixBuffer (AudioNodeInput.cs:182-244):
  * equal channel counts        -> per-channel add
  * mono -> N                   -> broadcast the mono channel into every one
  * N -> mono                   -> sum channels, scaled by 1/sqrt(N)
  * otherwise                   -> add the first min(src, dst) channels

``fan_in_lanes`` sums a group's stacked [V, C, T] output over its lanes and
re-channels the sum for the consumer: the ("ALL", ...) bus fan-in of
graphaudio_tpu/core/graph.py mixed_signal (:1119-1127) plus adapt_channels,
as one CUDA kernel (csrc/fan_in.cu) on a CUDA tensor and as plain torch on a
CPU tensor. Under a mesh whose ``voice`` dimension shards the group's lanes,
each rank sums its own lanes and one ``all_reduce`` over the dimension's
group completes the fan-in (``group``; graphaudio_tpu/core/graph.py:1124-1127,
the JAX package's psum).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from graphaudio_tpu_torch.utils import cudabuild


def _downmix_scale(src_channels: int) -> float:
    return float(np.float32(1.0 / math.sqrt(src_channels)))


def adapt_channels(src, dst_channels: int):
    """Return ``src`` re-channelled to ``dst_channels`` per the mixing rules.

    src: f32[src_channels, T]. Result: f32[dst_channels, T] such that adding
    it into an accumulator reproduces MixBuffer's contribution (the mono
    up-mix is a broadcast view).
    """
    src_channels = src.shape[0]
    if src_channels == dst_channels:
        return src
    if src_channels == 1 and dst_channels > 1:
        # mono -> N: broadcast add (AudioNodeInput.cs:201-213)
        return src.expand(dst_channels, *src.shape[1:])
    if src_channels > 1 and dst_channels == 1:
        # N -> mono: sum * 1/sqrt(N) (AudioNodeInput.cs:214-228)
        return src.sum(dim=0, keepdim=True) * _downmix_scale(src_channels)
    # discrete fallback: first min(src, dst) channels (AudioNodeInput.cs:229-243)
    n = min(src_channels, dst_channels)
    out = src[:n]
    if n < dst_channels:
        pad = src.new_zeros((dst_channels - n,) + tuple(src.shape[1:]))
        out = torch.cat([out, pad], dim=0)
    return out


def resolve_channel_count(mode: str, node_channel_count: int, source_channel_counts) -> int:
    """Static channel-count resolution for an input port.

    Parity: AudioNodeInput.ComputeOutputChannelCount (AudioNodeInput.cs:140-168)
    with the dynamic buffer inspection replaced by the compile-time channel
    counts of connected outputs.
    """
    counts = [c for c in source_channel_counts if c is not None]
    if mode == "explicit":
        return node_channel_count
    if mode == "clamped-max":
        m = max(counts) if counts else 0
        return min(m if m > 0 else node_channel_count, node_channel_count)
    # "max"
    m = node_channel_count
    for c in counts:
        m = max(m, c)
    return m


def fan_in_lanes_plain(x, dst_channels: int):
    """Plain torch K3: f32[V, C, T] -> f32[dst_channels, T]."""
    return adapt_channels(x.sum(dim=0), dst_channels)


@functools.cache
def _fan_in_mode(src_channels: int, dst_channels: int):
    """(mode, scale) of csrc/fan_in.cu for a channel pair."""
    if src_channels == dst_channels:
        return 0, 1.0
    if src_channels == 1:
        return 1, 1.0
    if dst_channels == 1:
        return 2, _downmix_scale(src_channels)
    return 3, 1.0


def all_reduce_sum(t, group):
    """Sum ``t`` over the ranks of ``group`` and return the sum: ``t`` itself,
    reduced in place, when it is contiguous, else a contiguous copy (a
    collective writes every element of a dense buffer: a broadcast view,
    such as the mono up-mix, has fewer); a complex tensor goes as its real
    view. None is no group (one rank: nothing to add). Every rank of the
    group receives the same bits."""
    if group is not None:
        import torch.distributed as dist

        t = t.contiguous()
        dist.all_reduce(torch.view_as_real(t) if t.is_complex() else t, group=group)
    return t


def fan_in_lanes(x, dst_channels: int, group=None):
    """Sum a group tensor f32[V, C, T] over lanes into f32[dst_channels, T];
    with ``group`` (the mesh's ``voice`` line of a sharded group) ``x`` holds
    this rank's lanes and the sum is completed over the group's ranks.

    CPU tensors take the plain version; CUDA tensors launch the K3 kernel,
    which needs T a multiple of 16 and a 16-byte-aligned tensor. The launch
    path is lean (one combined check, a cached mode and launcher): K3 runs
    several times a step.
    """
    if group is not None:
        return all_reduce_sum(fan_in_lanes(x, dst_channels), group)
    if x.is_cpu:
        return fan_in_lanes_plain(x, dst_channels)
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 3 and x.is_contiguous()):
        cudabuild.require(x, "x", torch.float32, ndim=3)  # raises, naming what is wrong
    V, C, T = x.shape
    ptr = x.data_ptr()
    if T % 16 or ptr % 16:
        raise ValueError(f"x needs T % 16 == 0 and 16-byte alignment, got T={T}, "
                         f"address {ptr:#x}")
    out = x.new_empty((dst_channels, T))
    mode, scale = _fan_in_mode(C, dst_channels)
    status = cudabuild.launcher("ga_fan_in")(ptr, out.data_ptr(), V, C, dst_channels, T,
                                             mode, scale, cudabuild.stream_of(x))
    if status:
        cudabuild.check(status, "ga_fan_in")
    cudabuild.launches["fan_in_lanes"] += 1
    return out
