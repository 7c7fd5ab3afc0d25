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
CPU tensor.
"""

from __future__ import annotations

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


def _fan_in_mode(src_channels: int, dst_channels: int) -> int:
    if src_channels == dst_channels:
        return 0
    if src_channels == 1:
        return 1
    if dst_channels == 1:
        return 2
    return 3


def fan_in_lanes(x, dst_channels: int):
    """Sum a group tensor f32[V, C, T] over lanes into f32[dst_channels, T].

    CPU tensors take the plain version; CUDA tensors launch the K3 kernel.
    """
    if x.device.type == "cpu":
        return fan_in_lanes_plain(x, dst_channels)
    cudabuild.require(x, "x", torch.float32, ndim=3)
    V, C, T = x.shape
    out = torch.empty((dst_channels, T), dtype=torch.float32, device=x.device)
    lib = cudabuild.load()
    mode = _fan_in_mode(C, dst_channels)
    scale = _downmix_scale(C) if mode == 2 else 1.0
    status = lib.ga_fan_in(x.data_ptr(), out.data_ptr(), V, C, dst_channels, T,
                           mode, scale, cudabuild.stream_of(x))
    cudabuild.check(status, "ga_fan_in")
    cudabuild.launches["fan_in_lanes"] += 1
    return out
