"""Delay node (parity: GraphAudio.Core/Nodes/DelayNode.cs:9).

The port of graphaudio_tpu/nodes/delay.py. The reference keeps a
per-channel circular buffer and, per sample, reads at an integer a-rate
delay then writes the input (:66-91); a delay of zero reads silence
(:143-144). There is no feedback path (graph cycles are rejected), so
sample i reads either this superblock's input at i - d_i (when d_i <= i) or
the carried ring.

State: ``ring`` f32[C, L] (L = the max delay in samples) and the write
cursor ``wpos``, an int32 tensor on the render device (never read back to
the host). ``delay_step`` is K12 (csrc/delay.cu): one launch reads the old
ring and the input and writes the output and a new ring, so the ring's
reads never race its writes; ``delay_step_plain`` is its plain version.
``delayTime`` evaluates exactly (K6's exact a-rate rows): the truncation to
whole samples turns an ulp of the value into a whole sample of offset.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.node import AudioNode
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.utils import cudabuild

MAX_DELAY_SECONDS = 10  # parity: DelayNode.cs:11


def _delay_samples(delay_time, sample_rate: int, L: int):
    """trunc(f32(delayTime) * f32(sr)) clipped to [0, L], int32 (the clip
    before the conversion is the same clip, and keeps it in range)."""
    sr = torch.tensor(np.float32(sample_rate), device=delay_time.device)
    return torch.clamp(delay_time * sr, 0.0, float(L)).to(torch.int32)


def delay_step_plain(x, delay_time, ring, wpos, sample_rate: int):
    """Plain torch K12 (graphaudio_tpu/nodes/delay.py:54-90). x f32[C, T];
    delay_time f32[T] (any strides); ring f32[C, L]; wpos int32 0-d.
    Returns (out f32[C, T], new ring f32[C, L], new wpos int32 0-d)."""
    C, T = x.shape
    L = ring.shape[1]
    dev = x.device
    d = _delay_samples(delay_time, sample_rate, L)
    i = torch.arange(T, dtype=torch.int32, device=dev)
    s = i - d  # the source index inside this superblock
    from_input = x[:, torch.clamp(s, 0, T - 1).long()]
    from_ring = ring[:, torch.remainder(wpos + s, L).long()]
    out = torch.where(s >= 0, from_input, from_ring)
    out = torch.where(d <= 0, torch.zeros((), dtype=x.dtype, device=dev), out)
    # slot k of the ring is written by this step's input at (k - w) mod L
    j = torch.remainder(torch.arange(L, dtype=torch.int32, device=dev) - wpos, L)
    if T < L:
        new_ring = torch.where(j < T, x[:, torch.clamp(j, max=T - 1).long()], ring)
    else:  # only the trailing L inputs survive
        new_ring = x[:, (T - L + torch.remainder(j - (T - L) % L, L)).long()]
    new_wpos = torch.remainder(wpos + T, L).to(torch.int32)
    return out, new_ring, new_wpos


def delay_step(x, delay_time, ring, wpos, sample_rate: int):
    """K12: one launch of csrc/delay.cu on CUDA tensors, the plain version
    on CPU tensors; arguments and result as ``delay_step_plain``. A
    ``delay_time`` broadcast from one value (stride 0) is read as that
    value, not copied."""
    if x.device.type == "cpu":
        return delay_step_plain(x, delay_time, ring, wpos, sample_rate)
    x = x.contiguous()
    C, T = x.shape
    L = ring.shape[1]
    req = cudabuild.require
    req(x, "x", torch.float32, ndim=2)
    req(ring, "ring", torch.float32, shape=(C, L))
    req(wpos, "wpos", torch.int32, shape=())
    if delay_time.shape != (T,):
        raise ValueError(f"delay_time must be [{T}], got {tuple(delay_time.shape)}")
    if delay_time.stride(0) == 0:
        src, rows = delay_time[0], 0
    else:
        src, rows = delay_time, 1
    req(src, "delay_time", torch.float32)
    out = torch.empty_like(x)
    new_ring = torch.empty_like(ring)
    new_wpos = torch.empty_like(wpos)
    status = cudabuild.launcher("ga_delay_step")(
        x.data_ptr(), src.data_ptr(), rows, ring.data_ptr(), wpos.data_ptr(), C, T, L,
        float(np.float32(sample_rate)), out.data_ptr(), new_ring.data_ptr(),
        new_wpos.data_ptr(), cudabuild.stream_of(x))
    cudabuild.check(status, "ga_delay_step")
    cudabuild.launches["delay_step"] += 1
    return out, new_ring, new_wpos


class DelayNode(AudioNode):
    def __init__(self, context, max_delay_time: float = 1.0):
        if not (0 < max_delay_time <= MAX_DELAY_SECONDS):
            raise ValueError(f"max_delay_time must be in (0, {MAX_DELAY_SECONDS}]")
        super().__init__(context, input_count=1, output_count=1, name="Delay")
        self._max_delay_samples = int(max_delay_time * context.sample_rate)
        self.delay_time = self.create_audio_param(
            "delayTime",
            0.0,
            min_value=0.0,
            max_value=float(max_delay_time),
            automation_rate=AutomationRate.A_RATE,
        )
        # The integer-sample truncation amplifies 1-ulp value noise into
        # full-sample read differences; linear curves evaluate in f64.
        self.delay_time.exact_eval = True
        self._channels = 2  # updated at compile via output_channel_counts

    def output_channel_counts(self, input_channels):
        c = input_channels[0] if input_channels else 2
        self._channels = c
        return [c]

    def init_state(self, info):
        return {
            "ring": np.zeros((self._channels, self._max_delay_samples), np.float32),
            "wpos": np.int32(0),
        }

    def process(self, state, inputs, params, rc):
        """One delay (no group key): x f32[C, T]; K12."""
        out, ring, wpos = delay_step(inputs[0], params["delayTime"].per_sample(),
                                     state["ring"], state["wpos"], rc.sample_rate)
        return {"ring": ring, "wpos": wpos}, [out]
