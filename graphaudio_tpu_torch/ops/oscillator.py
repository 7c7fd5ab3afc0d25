"""K11: the oscillator's and the constant source's group steps.

``oscillator_group_step`` computes one superblock of every lane of an
``OscillatorNode`` stage, the JAX package's ``OscillatorNode.process``
(graphaudio_tpu/nodes/sources.py:300-333) over stacked lanes:

- the sample-accurate gate of ``ScheduledSourceNode._sample_gate``
  (sources.py:143-170, ``sample_gate`` here);
- the f32 increments ``gate * fl32(2 pi / sr) * f``;
- each quantum's f64 sum of the gated frequencies times 2 pi / sr (bsum),
  their exclusive running sum over the superblock plus the lane's f64
  ``phase`` (the anchors), ``mod`` 2 pi, rounded to f32;
- the in-quantum phase ``cumsum(inc) - inc`` in f32, in the order XLA's CPU
  backend sums a 128-long cumsum (sequential runs of 16, then a sequential
  exclusive sum of the 8 run totals added to each run), so the port's
  phase is the JAX package's on the CPU;
- ``mod(anchor32 + local, fl32(2 pi))`` in f32, then the waveform, gated;
  the sine correctly rounded (f64, rounded once to f32, as
  ``xla_rounding.sin``), so that the CPU and the card give the same bits
  (their f32 sines differ by an ulp or more, which a resampler that
  integrates a sine-modulated rate turns into drift) and XLA's f32 sine
  agrees with it on 99.9 % of inputs;
- the new phase ``mod(phase + sum(bsum), 2 pi)`` in f64.

``mod`` is ``jnp.mod``: an exact ``fmod`` moved into the divisor's sign.
The f64 sums run in a fixed order too (sequential runs of 16 samples, then
the 8 runs, then the quanta), in the plain version and the kernel alike.

``constant_group_step`` is the ``ConstantSourceNode``'s: the gated
``offset``.

On the card a lane's superblock is cut into tiles of quanta (``kTile`` in
csrc/oscillator.cu), one block each; each block sums the quanta before its
tile itself, ``kPass`` quanta a pass, so the anchors are the same ascending
sums as here and the kernel's bits are the plain version's.

Both take the frequency (offset) either as f32[L, T] rows or, where the
param has no events and no modulation, as its broadcast base-value view
(stride 0 along time): the kernels then read the base values and nothing
is copied. CPU tensors take the plain versions; CUDA tensors launch
csrc/oscillator.cu, one launch a step for the whole group.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.ops import xla_rounding
from graphaudio_tpu_torch.utils import cudabuild

TWO_PI = 2.0 * math.pi
_TWO_PI_F = np.float32(TWO_PI)
_PI_F = np.float32(math.pi)
#: waveform codes of csrc/oscillator.cu, by ``OscillatorType`` value
WAVE_CODES = {"sine": 0, "square": 1, "sawtooth": 2, "triangle": 3}
_RUN = 16  # XLA's CPU cumsum: sequential runs of 16 samples


def jmod(x, y):
    """``jnp.mod``: exact ``fmod``, moved into the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def sample_gate(started, start_time, stop_time, block_times, sample_rate: int):
    """bool[L, S, 128]: the sample-accurate gate of L lanes (parity:
    OscillatorNode.cs:104-118): a quantum plays when started and
    t1 > start and t0 < stop; startFrame = ceil((start-t0)*sr) when the
    start falls inside the quantum, endFrame = floor((stop-t0)*sr) when the
    stop does."""
    sr = float(sample_rate)
    t0 = block_times[None, :]
    t1 = t0 + float(FRAMES_PER_BLOCK) / sr
    start, stop = start_time[:, None], stop_time[:, None]
    active = (started > 0)[:, None] & (t1 > start) & (t0 < stop)
    start_f = torch.where((t0 < start) & (start < t1),
                          torch.clamp(torch.ceil((start - t0) * sr), 0, FRAMES_PER_BLOCK),
                          torch.zeros_like(t0))
    end_f = torch.where(torch.isfinite(stop) & (t0 < stop) & (stop < t1),
                        torch.clamp(torch.floor((stop - t0) * sr), 0, FRAMES_PER_BLOCK),
                        torch.full_like(t0, float(FRAMES_PER_BLOCK)))
    i = torch.arange(FRAMES_PER_BLOCK, dtype=torch.float32, device=block_times.device)
    return (active[..., None] & (i >= start_f.float()[..., None])
            & (i < end_f.float()[..., None]))


def _seq_sum(x, dim):
    """Sum along ``dim``, element by element from the first."""
    acc = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        acc = acc + x.select(dim, k)
    return acc


def oscillator_group_step_plain(f, started, start_time, stop_time, phase, block_times,
                                sample_rate: int, wave: str):
    """Plain torch K11 (oscillator): f f32[L, T]; states [L] (started i32,
    start/stop/phase f64); block_times f64[S]. Returns (out f32[L, T],
    new phase f64[L])."""
    L = phase.shape[0]
    S = block_times.shape[0]
    Q = FRAMES_PER_BLOCK
    gate = sample_gate(started, start_time, stop_time, block_times, sample_rate)  # [L, S, Q]
    f3 = f.reshape(L, S, Q)
    zero = torch.zeros((), dtype=torch.float32, device=f.device)
    inc = torch.where(gate, np.float32(TWO_PI / sample_rate) * f3, zero)
    # In-quantum inclusive sum: sequential runs of 16, then the runs'
    # exclusive sequential sum added to each run (XLA's CPU order).
    runs = inc.reshape(L, S, Q // _RUN, _RUN)
    acc = torch.zeros_like(runs[..., 0])
    parts = []
    for k in range(_RUN):
        acc = acc + runs[..., k]
        parts.append(acc)
    P = torch.stack(parts, dim=-1)
    ex, e = [], torch.zeros_like(P[..., 0, 0])
    for r in range(Q // _RUN):
        ex.append(e)
        e = e + P[..., r, _RUN - 1]
    local = (P + torch.stack(ex, dim=-1)[..., None]).reshape(L, S, Q) - inc
    # Block sums in f64: runs of 16, then the 8 runs, in order.
    fg = torch.where(gate, f3, zero).double().reshape(L, S, Q // _RUN, _RUN)
    bsum = _seq_sum(_seq_sum(fg, 3), 2) * (TWO_PI / sample_rate)  # [L, S]
    anchors, cs = [], torch.zeros_like(phase)
    for s in range(S):
        anchors.append(phase + cs)
        cs = cs + bsum[:, s]
    anch32 = jmod(torch.stack(anchors, dim=1), torch.tensor(TWO_PI, dtype=torch.float64)).float()
    two_pi_f = torch.tensor(_TWO_PI_F, device=f.device)
    ph = jmod(anch32[..., None] + local, two_pi_f)
    if wave == "sine":
        w = xla_rounding.sin(ph)
    elif wave == "square":
        w = torch.where(ph < _PI_F, 1.0, -1.0).to(torch.float32)
    elif wave == "sawtooth":
        w = 2.0 * (ph / _TWO_PI_F) - 1.0
    else:  # triangle
        u = ph / _TWO_PI_F
        w = 4.0 * torch.abs(u - torch.floor(u + 0.5)) - 1.0
    out = torch.where(gate, w, zero).reshape(L, S * Q)
    new_phase = jmod(phase + cs, torch.tensor(TWO_PI, dtype=torch.float64))
    return out, new_phase


def constant_group_step_plain(offset, started, start_time, stop_time, block_times,
                              sample_rate: int):
    """Plain torch K11 (constant source): ``gate ? offset : 0``, f32[L, T]."""
    L = started.shape[0]
    gate = sample_gate(started, start_time, stop_time, block_times, sample_rate).reshape(L, -1)
    return torch.where(gate, offset.reshape(L, -1),
                       torch.zeros((), dtype=torch.float32, device=offset.device))


def _values_arg(x, L: int, T: int):
    """(pointer, per-sample?) of a param's values f32[L, T]: the base
    values of a broadcast view (stride 0 along time), else the rows."""
    if x.stride(-1) == 0:
        base = x.select(-1, 0)
        if base.is_contiguous() and base.dtype == torch.float32 and base.is_cuda:
            return base, 0
    cudabuild.require(x, "values", torch.float32, shape=(L, T))
    return x, 1


def _states_args(started, start_time, stop_time, L):
    cudabuild.require(started, "started", torch.int32, shape=(L,))
    cudabuild.require(start_time, "start_time", torch.float64, shape=(L,))
    cudabuild.require(stop_time, "stop_time", torch.float64, shape=(L,))


def oscillator_group_step(f, started, start_time, stop_time, phase, block_times,
                          sample_rate: int, wave: str):
    """K11 (oscillator): one superblock of L lanes; the contract of
    ``oscillator_group_step_plain``. CPU tensors take the plain version;
    CUDA tensors launch csrc/oscillator.cu once."""
    if block_times.device.type == "cpu":
        return oscillator_group_step_plain(f, started, start_time, stop_time, phase,
                                           block_times, sample_rate, wave)
    L = phase.shape[0]
    S = block_times.shape[0]
    T = S * FRAMES_PER_BLOCK
    vals, per_sample = _values_arg(f, L, T)
    _states_args(started, start_time, stop_time, L)
    cudabuild.require(phase, "phase", torch.float64, shape=(L,))
    cudabuild.require(block_times, "block_times", torch.float64, ndim=1)
    out = torch.empty((L, T), dtype=torch.float32, device=block_times.device)
    new_phase = torch.empty_like(phase)
    status = cudabuild.launcher("ga_oscillator_step")(
        vals.data_ptr(), per_sample, started.data_ptr(), start_time.data_ptr(),
        stop_time.data_ptr(), phase.data_ptr(), block_times.data_ptr(), L, S,
        float(sample_rate), float(FRAMES_PER_BLOCK) / sample_rate,
        float(np.float32(TWO_PI / sample_rate)), TWO_PI / sample_rate, WAVE_CODES[wave],
        out.data_ptr(), new_phase.data_ptr(), cudabuild.stream_of(phase))
    cudabuild.check(status, "ga_oscillator_step")
    cudabuild.launches["oscillator_group_step"] += 1
    return out, new_phase


def constant_group_step(offset, started, start_time, stop_time, block_times,
                        sample_rate: int):
    """K11 (constant source): ``gate ? offset : 0`` for L lanes, f32[L, T].
    CPU tensors take the plain version; CUDA tensors launch
    csrc/oscillator.cu once."""
    if block_times.device.type == "cpu":
        return constant_group_step_plain(offset, started, start_time, stop_time, block_times,
                                         sample_rate)
    L = started.shape[0]
    S = block_times.shape[0]
    T = S * FRAMES_PER_BLOCK
    vals, per_sample = _values_arg(offset.reshape(L, T), L, T)
    _states_args(started, start_time, stop_time, L)
    cudabuild.require(block_times, "block_times", torch.float64, ndim=1)
    out = torch.empty((L, T), dtype=torch.float32, device=block_times.device)
    status = cudabuild.launcher("ga_constant_step")(
        vals.data_ptr(), per_sample, started.data_ptr(), start_time.data_ptr(),
        stop_time.data_ptr(), block_times.data_ptr(), L, S, float(sample_rate),
        out.data_ptr(), cudabuild.stream_of(started))
    cudabuild.check(status, "ga_constant_step")
    cudabuild.launches["constant_group_step"] += 1
    return out
