"""Delay node (parity: GraphAudio.Core/Nodes/DelayNode.cs:9).

The port of graphaudio_tpu/nodes/delay.py. The reference keeps a
per-channel circular buffer and, per sample, reads at an integer a-rate
delay then writes the input (:66-91); a delay of zero reads silence
(:143-144). There is no feedback path (graph cycles are rejected), so
sample i reads either this superblock's input at i - d_i (when d_i <= i) or
the carried ring.

State, updated in place: ``ring`` f32[C, R] with R = L + min(T, L) slots
(L = the max delay in samples, T the superblock's frames); ``slot``, the
port's slot cursor c, int32[B] with one equal copy for each of K12's B =
C ceil(T / 256) blocks, so that no block moves a cursor that another still
reads (``slot_copies``: the slot state's length sets K12's grid); and the
JAX package's write cursor ``wpos`` ((w + T) mod L a step, as there),
int32 0-d. Both live on the render device and are never read back to the
host. The L slots before c hold the last L samples, the sample k back in
slot (c - k) mod R; a step reads only those and writes the input's
trailing min(T, L) samples to the slots from c on, so its reads and writes
never meet (csrc/delay.cu). ``delay_jax_view`` gives the JAX package's f32[C, L] ring of the same
history and ``delay_state_from_jax`` takes one over.

``delay_step`` is K12: one launch a step on CUDA tensors, the plain
version ``delay_step_plain`` on CPU tensors. ``delayTime`` evaluates
exactly (K6's exact a-rate rows): the truncation to whole samples turns an
ulp of the value into a whole sample of offset.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.node import AudioNode
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.utils import cudabuild

MAX_DELAY_SECONDS = 10  # parity: DelayNode.cs:11

#: Frames a K12 block covers at most. The launcher sizes its grid from the
#: slot state's length, so the block size is set here alone (csrc/delay.cu
#: has a compiled fast path for this size and a generic one).
K12_FRAMES_A_BLOCK = 256


def slot_copies(channels: int, frames: int) -> int:
    """B, the copies of the slot cursor: one for each of K12's blocks."""
    return channels * -(-frames // K12_FRAMES_A_BLOCK)


def _ring_width(state, frames: int, L: int) -> int:
    """W = min(T, L), the slots a step writes, checked against the ring's
    R = L + W."""
    R = state["ring"].shape[1]
    if R != L + min(frames, L):
        raise ValueError(f"ring of {R} slots is not L + min(T, L) at L={L} T={frames}")
    return R - L


def _delay_samples(delay_time, sample_rate: int, L: int):
    """trunc(f32(delayTime) * f32(sr)) clipped to [0, L], int32 (the clip
    before the conversion is the same clip, and keeps it in range)."""
    sr = torch.tensor(np.float32(sample_rate), device=delay_time.device)
    return torch.clamp(delay_time * sr, 0.0, float(L)).to(torch.int32)


def _history_slots(cursor, L: int, modulus: int, device):
    """The slots (cursor + s) mod ``modulus`` of the samples s = -L .. -1
    (oldest first)."""
    s = torch.arange(-L, 0, dtype=torch.int64, device=device)
    return torch.remainder(cursor.to(torch.int64) + s, modulus)


def delay_step_plain(x, delay_time, state, sample_rate: int, L: int):
    """Plain torch K12 (graphaudio_tpu/nodes/delay.py:54-90) on the port's
    ring: x f32[C, T] (any strides); delay_time f32[T] (any strides);
    ``state`` as ``DelayNode.init_state`` at the max delay ``L`` samples,
    updated in place. Returns the output f32[C, T]."""
    ring, wpos = state["ring"], state["wpos"]
    slot = state["slot"][0]
    C, T = x.shape
    R = ring.shape[1]
    W = _ring_width(state, T, L)
    dev = x.device
    d = _delay_samples(delay_time, sample_rate, L)
    i = torch.arange(T, dtype=torch.int32, device=dev)
    s = i - d  # the source index inside this superblock
    from_input = x[:, torch.clamp(s, 0, T - 1).long()]
    from_ring = ring[:, torch.remainder(slot + s, R).long()]
    out = torch.where(s >= 0, from_input, from_ring)
    out = torch.where(d <= 0, torch.zeros((), dtype=x.dtype, device=dev), out)
    # the trailing W inputs fill the W slots from the slot cursor on
    k = torch.remainder(slot + torch.arange(W, device=dev), R)
    ring[:, k] = x[:, T - W:]
    state["slot"].copy_(torch.remainder(state["slot"] + W, R))
    wpos.copy_(torch.remainder(wpos + T, L))
    return out


def delay_step(x, delay_time, state, sample_rate: int, L: int):
    """K12: one launch of csrc/delay.cu on CUDA tensors, the plain version
    on CPU tensors; arguments and result as ``delay_step_plain``. ``x`` is
    read through its strides (a broadcast channel is not copied); a
    ``delay_time`` broadcast from one value (stride 0) is read as that
    value. Nothing is allocated but the output."""
    if x.device.type == "cpu":
        return delay_step_plain(x, delay_time, state, sample_rate, L)
    ring, slot, wpos = state["ring"], state["slot"], state["wpos"]
    C, T = x.shape
    R = L + _ring_width(state, T, L)
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    req = cudabuild.require
    req(ring, "ring", torch.float32, shape=(C, R))
    req(slot, "slot", torch.int32, shape=(slot_copies(C, T),))
    req(wpos, "wpos", torch.int32, shape=())
    if delay_time.shape != (T,):
        raise ValueError(f"delay_time must be [{T}], got {tuple(delay_time.shape)}")
    if delay_time.stride(0) == 0:
        src, rows = delay_time[0], 0
    else:
        src, rows = delay_time, 1
    req(src, "delay_time", torch.float32)
    out = torch.empty((C, T), dtype=torch.float32, device=x.device)
    status = cudabuild.launcher("ga_delay_step")(
        x.data_ptr(), x.stride(0), x.stride(1), src.data_ptr(), rows, ring.data_ptr(), R,
        slot.data_ptr(), slot.numel(), wpos.data_ptr(), C, T, L, float(np.float32(sample_rate)),
        out.data_ptr(), cudabuild.stream_of(x))
    cudabuild.check(status, "ga_delay_step")
    cudabuild.launches["delay_step"] += 1
    return out


def delay_jax_view(state, L: int) -> dict:
    """The JAX package's state of the same history at the max delay ``L``
    samples: ``ring`` f32[C, L], the sample s < 0 samples back in slot
    (wpos + s) mod L, and ``wpos`` (new tensors)."""
    ring, wpos = state["ring"], state["wpos"]
    view = torch.empty((ring.shape[0], L), dtype=ring.dtype, device=ring.device)
    view[:, _history_slots(wpos, L, L, ring.device)] = \
        ring[:, _history_slots(state["slot"][0], L, ring.shape[1], ring.device)]
    return {"ring": view, "wpos": wpos.clone()}


def delay_state_from_jax(st: dict, frames: int, device, slot: int = 0) -> dict:
    """The JAX package's delay state {ring f32[C, L], wpos} as the port's at
    T = ``frames``, its slot cursor at ``slot``; the ring's other W slots
    are zero (the step writes them before any reads them)."""
    ring_j = torch.from_numpy(np.asarray(st["ring"], np.float32).copy())
    w = torch.tensor(int(st["wpos"]), dtype=torch.int32)
    C, L = ring_j.shape
    R = L + min(frames, L)
    c = torch.full((slot_copies(C, frames),), slot % R, dtype=torch.int32)
    ring = torch.zeros((C, R), dtype=torch.float32)
    ring[:, _history_slots(c[0], L, R, "cpu")] = ring_j[:, _history_slots(w, L, L, "cpu")]
    return {k: v.to(device) for k, v in (("ring", ring), ("slot", c), ("wpos", w))}


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
        L = self._max_delay_samples
        return {
            "ring": np.zeros((self._channels, L + min(info.frames, L)), np.float32),
            "slot": np.zeros(slot_copies(self._channels, info.frames), np.int32),
            "wpos": np.int32(0),
        }

    def process(self, state, inputs, params, rc):
        """One delay (no group key): x f32[C, T]; K12, in place."""
        out = delay_step(inputs[0], params["delayTime"].per_sample(), state, rc.sample_rate,
                         self._max_delay_samples)
        return state, [out]
