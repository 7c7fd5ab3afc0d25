"""Scheduled sources: ConstantSourceNode, OscillatorNode, AudioBufferSourceNode.

Scheduled sources (parity: IAudioScheduledSourceNode.cs:8-25):
``start(when, offset, duration)`` is once-only, ``stop(when)`` is
first-stop-wins (a finite-duration start counts as the first stop), and an
``ended`` event fires when playback finishes, after which the node disposes
itself (AudioBufferSourceNode.cs:378-389).

The schedule (start/stop times) lives in the node's state as float64
scalars; gating masks are computed on the device each step, so voice
start/stop is a state update, not a rebuild. Playback positions are
float64, matching the reference's double accumulators
(AudioBufferSourceNode.cs:23); f64 is native on the GPU.

The port renders the three kernel variants of AudioBufferSourceNode, each
over a whole voice group: the unity-rate copy (``kernel_variant() ==
("unity", aligned)``: an asset at the context rate, playbackRate untouched),
``process_unity_group``; the static polyphase resampler (``("poly", p,
q)``: a constant rational rate such as 44.1 kHz assets in a 48 kHz
context), ``process_poly_group``; and the time-varying resampler
(``("resample", bound)``: an automated, modulated or irrational
playbackRate), ``process_resample_group``, which takes the per-quantum
playbackRate values. On the card each group step is one kernel launch, K5
(ops/unity.py), K1 and K7 (ops/resample.py), bookkeeping and audio
together; on the CPU the plan functions below and the plain gathers
compute the same step. A voice whose playbackRate is modulated is not
grouped: its ``process`` runs the K7 step over one lane.

The constant source and the oscillator run as group stages too: each
step of a stage is one K11 launch on the card (ops/oscillator.py), the
sample gate, the f64 phase anchors and the waveform together. The
oscillator's phase is an f64 state, reset by ``start``.
"""

from __future__ import annotations

import enum
import math
from fractions import Fraction
from typing import Callable, List

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.node import AudioNode
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.ops.oscillator import (
    constant_group_step,
    oscillator_group_step,
    sample_gate,
)
from graphaudio_tpu_torch.ops.resample import (
    cr_weights_fma,
    poly_group_step,
    poly_resample_plain,
    resample_group_step,
    split_positions,
    xla_cumsum,
    xla_sum,
)
from graphaudio_tpu_torch.ops import voice_group, xla_rounding
from graphaudio_tpu_torch.ops.unity import unity_group_step, unity_gather_plain

_INF = float("inf")


class ScheduledSourceNode(AudioNode):
    """Shared scheduling machinery for one-shot sources."""

    wants_notify = True

    def __init__(self, context, output_count: int, name: str):
        super().__init__(context, input_count=0, output_count=output_count, name=name)
        self._has_started = False
        self._has_stopped = False
        self._ended_raised = False
        self._ended_callbacks: List[Callable] = []
        self._host_stop_time = _INF  # host mirror of the scheduled stop

    def on_ended(self, callback: Callable) -> None:
        """Subscribe to the ended event (parity: ``Ended`` event)."""
        self._ended_callbacks.append(callback)

    @property
    def is_playing(self) -> bool:
        return self._has_started and not self._ended_raised

    # -- scheduling (parity: OscillatorNode.Start/Stop :55-89) ------------------

    def _sched_state(self):
        return {
            "started": np.int32(0),
            "start_time": np.float64(_INF),
            "stop_time": np.float64(_INF),
        }

    def start(self, when: float = 0.0, offset: float = 0.0, duration: float = _INF):
        if self._has_started:
            raise RuntimeError(f"{self.name} can only be started once.")
        start_time = max(0.0, when)
        updates = {"started": 1, "start_time": start_time}
        # Subclass validation runs BEFORE any flag flips, so a recoverable
        # error leaves the node startable once fixed.
        self._on_start(updates, offset, duration)
        self._has_started = True
        if math.isfinite(duration) and duration >= 0:
            self._has_stopped = True
            self._host_stop_time = start_time + duration
            updates["stop_time"] = self._host_stop_time

        def do(ctx):
            ctx.update_node_state(self, **updates)

        self.context.execute_or_post(do)
        return self

    def _on_start(self, updates: dict, offset: float, duration: float) -> None:
        """Subclass hook to add state updates at start time."""

    def stop(self, when: float = 0.0):
        # FIRST stop wins (the reference's `if (_hasStopped) return` guard).
        if self._has_stopped:
            return self
        self._has_stopped = True
        self._host_stop_time = min(self._host_stop_time, max(0.0, when))
        stop_time = self._host_stop_time

        def do(ctx):
            ctx.update_node_state(self, stop_time=stop_time)

        self.context.execute_or_post(do)
        return self

    @staticmethod
    def _active_mask(states, rc):
        """bool[..., S]: block plays (t1 > start and t0 < stop), gated on
        started; broadcasts over leading state dims (a group's lanes)."""
        return (
            (states["started"] > 0)[..., None]
            & (rc.block_end_times > states["start_time"][..., None])
            & (rc.block_times < states["stop_time"][..., None])
        )

    @staticmethod
    def _sample_gate(states, rc):
        """bool[..., S, 128]: the sample-accurate sub-block gate (parity:
        OscillatorNode.cs:104-118), startFrame = ceil((start-t0)*sr) when
        the start falls inside a quantum, endFrame = floor((stop-t0)*sr)
        when the stop does; over any leading state dims."""
        lead = states["started"].shape
        flat = {k: states[k].reshape(-1) for k in ("started", "start_time", "stop_time")}
        gate = sample_gate(flat["started"], flat["start_time"], flat["stop_time"],
                           rc.block_times, rc.sample_rate)
        return gate.reshape(*lead, *gate.shape[1:])

    # -- host-side ended handling ------------------------------------------------

    def _device_may_end(self) -> bool:
        """True when the device kernel itself can shorten ``stop_time``."""
        return False

    def may_notify(self) -> bool:
        """False for sources that never started, already ended, or can
        neither reach a finite scheduled stop nor self-stop on the device —
        the context then skips the post-render stop-time readback."""
        if not self._has_started or self._ended_raised:
            return False
        return math.isfinite(self._host_stop_time) or self._device_may_end()

    def notify_rendered(self, state, end_time: float) -> None:
        if self._ended_raised or not self._has_started:
            return
        stop_time = float(state["stop_time"])
        if math.isfinite(stop_time) and end_time >= stop_time:
            self._ended_raised = True
            for cb in self._ended_callbacks:
                try:
                    cb(self)
                except Exception:
                    pass  # parity: ended-event handler errors never stop rendering
            self.dispose()  # self-dispose (parity: OscillatorNode.cs:163-172)


def _lanes_of(state):
    """A stage's lane count and its states as [L] tensors (a single node's
    0-d states become one lane)."""
    lead = state["started"].shape
    return lead, {k: v.reshape(-1) if isinstance(v, torch.Tensor) else v
                  for k, v in state.items()}


class ConstantSourceNode(ScheduledSourceNode):
    """Emits the a-rate ``offset`` param (parity: ConstantSourceNode.cs:14),
    typically as a modulation source connected to other nodes' params."""

    def __init__(self, context):
        super().__init__(context, output_count=1, name="ConstantSource")
        self.offset = self.create_audio_param(
            "offset", 1.0, automation_rate=AutomationRate.A_RATE
        )

    def output_channel_counts(self, input_channels):
        return [1]

    def group_key(self, input_channels):
        return ("const-source", self._mod_signature())

    def init_state(self, info):
        return self._sched_state()

    def process(self, state, inputs, params, rc):
        """``gate ? offset : 0``: K11's constant step over the stage's
        lanes (one launch on the card)."""
        lead, st = _lanes_of(state)
        L = st["started"].shape[0]
        out = constant_group_step(
            params["offset"].per_sample().reshape(L, -1), st["started"], st["start_time"],
            st["stop_time"], rc.block_times, rc.sample_rate)
        return state, [out.reshape(*lead, 1, rc.frames)]


class OscillatorType(enum.Enum):
    """Parity: OscillatorNode.cs:208-214."""

    SINE = "sine"
    SQUARE = "square"
    SAWTOOTH = "sawtooth"
    TRIANGLE = "triangle"


class OscillatorNode(ScheduledSourceNode):
    """Periodic waveform generator (parity: OscillatorNode.cs:12).

    The reference accumulates a double phase per sample with a 2*pi wrap
    (:139-148); here the f64 phase is anchored once per 128-frame quantum
    from f64 sums of the gated frequency, and runs in f32 inside the
    quantum (ops/oscillator.py), as in the JAX package.
    """

    def __init__(self, context, type: OscillatorType = OscillatorType.SINE):
        super().__init__(context, output_count=1, name="Oscillator")
        self._type = type
        self.frequency = self.create_audio_param(
            "frequency",
            440.0,
            min_value=0.0,
            max_value=context.sample_rate / 2.0,
            automation_rate=AutomationRate.A_RATE,
        )
        # The phase INTEGRATES frequency values: automated curves evaluate
        # in f64 (K6's exact rows).
        self.frequency.exact_eval = True

    @property
    def type(self) -> OscillatorType:
        return self._type

    @type.setter
    def type(self, value: OscillatorType) -> None:
        if value != self._type:
            self._type = value
            self._config_changed()  # the waveform is part of the stage

    def output_channel_counts(self, input_channels):
        return [1]

    def group_key(self, input_channels):
        return ("oscillator", self._type, self._mod_signature())

    def init_state(self, info):
        st = self._sched_state()
        st["phase"] = np.float64(0.0)
        return st

    def _on_start(self, updates, offset, duration):
        updates["phase"] = 0.0  # parity: OscillatorNode.cs:63

    def process(self, state, inputs, params, rc):
        """K11's oscillator step over the stage's lanes (one launch on the
        card): the gated waveform and the new f64 phase."""
        lead, st = _lanes_of(state)
        L = st["started"].shape[0]
        out, phase = oscillator_group_step(
            params["frequency"].per_sample().reshape(L, -1), st["started"], st["start_time"],
            st["stop_time"], st["phase"], rc.block_times, rc.sample_rate, self._type.value)
        new_state = dict(state)
        new_state["phase"] = phase.reshape(lead)
        return new_state, [out.reshape(*lead, 1, rc.frames)]


class AudioBufferSourceNode(ScheduledSourceNode):
    """Scheduled playback of a PlayableAudioBuffer (AudioBufferSourceNode.cs:13).

    Playback position and resample position are float64. See the module
    docstring for the ported kernel variant.
    """

    def __init__(self, context):
        super().__init__(context, output_count=1, name="AudioBufferSource")
        self._buffer = None
        self._loop = False
        self._loop_start = 0.0
        self._loop_end = 0.0
        self.playback_rate = self.create_audio_param(
            "playbackRate",
            1.0,
            min_value=0.001,
            max_value=1000.0,
            automation_rate=AutomationRate.K_RATE,
        )
        self.playback_rate.exact_eval = True
        # Pristine playbackRate selects the unity-rate kernel; first touch
        # rebuilds into a resampling kernel.
        self.playback_rate.notify_first_touch = True

    # -- buffer & loop configuration -------------------------------------------

    def _device_may_end(self) -> bool:
        return not self._loop

    @property
    def buffer(self):
        return self._buffer

    @buffer.setter
    def buffer(self, value) -> None:
        if self._has_started:
            raise RuntimeError("Cannot change buffer after playback started")
        self._buffer = value
        self._config_changed()

    @property
    def loop(self) -> bool:
        return self._loop

    @loop.setter
    def loop(self, value: bool) -> None:
        if bool(value) != self._loop:
            self._loop = bool(value)
            self._config_changed()

    @property
    def loop_start(self) -> float:
        return self._loop_start

    @loop_start.setter
    def loop_start(self, value: float) -> None:
        self._loop_start = max(0.0, value)
        self._config_changed()

    @property
    def loop_end(self) -> float:
        return self._loop_end

    @loop_end.setter
    def loop_end(self, value: float) -> None:
        self._loop_end = max(0.0, value)
        self._config_changed()

    def output_channel_counts(self, input_channels):
        c = self._buffer.number_of_channels if self._buffer is not None else 1
        return [c]

    def loop_frames(self):
        """Static loop bounds in buffer frames (parity trunc semantics,
        AudioBufferSourceNode.cs:171-177)."""
        br = self._buffer.sample_rate
        L = self._buffer.length
        lsf = int(self._loop_start * br)
        lef = int(self._loop_end * br) if self._loop_end > 0 else L
        lef = min(lef, L)
        lsf = min(lsf, lef)
        return lsf, lef, lef - lsf

    def rate_bound(self) -> int:
        """Static pow2 upper bound on the effective resampling rate."""
        if self._buffer is None or self._static_unity_rate_cfg():
            return 1
        mx = self.playback_rate.max_scheduled_value()
        if self.playback_rate._mod_outputs:
            mx = max(2.0 * mx, 2.0)
        eff = (self._buffer.sample_rate / self.context.sample_rate) * mx
        b = 1
        while b < eff:
            b *= 2
        return b

    def _static_unity_rate_cfg(self) -> bool:
        return (
            self._buffer is not None
            and self._buffer.sample_rate == self.context.sample_rate
            and not self.playback_rate.touched
            and not self.playback_rate._mod_outputs
        )

    def static_ratio(self):
        """(p, q) when the effective rate is a STATIC exact rational, else None
        (no automation events, no modulation, and bufferRate/contextRate times
        the value is exactly rational with a small denominator)."""
        pr = self.playback_rate
        if self._buffer is None or pr.has_events() or pr._mod_outputs:
            return None
        try:
            f = Fraction(self._buffer.sample_rate, self.context.sample_rate)
            f = f * Fraction(float(pr.value))
        except (ValueError, ZeroDivisionError, OverflowError):
            return None
        p, q = f.numerator, f.denominator
        if p <= 0 or p * q > (1 << 20):
            return None
        return (int(p), int(q))

    def kernel_variant(self):
        """Static kernel selection, the same rule as the JAX package:
        ("unity", aligned), ("poly", p, q) or ("resample", bound)."""
        if self._buffer is None:
            return ("none",)
        if self._static_unity_rate_cfg():
            pos0 = float(self._state_overrides.get("pos", 0.0)) \
                if hasattr(self, "_state_overrides") else 0.0
            aligned = pos0 % FRAMES_PER_BLOCK == 0.0
            if self._loop:
                _, _, llen = self.loop_frames()
                aligned = aligned and llen % FRAMES_PER_BLOCK == 0
            return ("unity", aligned)
        r = self.static_ratio()
        if r is not None:
            return ("poly",) + r
        return ("resample", self.rate_bound())

    @staticmethod
    def _poly_geometry(superblock: int, p: int, q: int):
        """Static shapes of the polyphase kernel: T outputs need ncan
        canonical chunks of p input samples (+ nb extra chunks), read from a
        window of w samples starting up to ``front`` before the voice
        position (the phase-alignment shift m0 < p)."""
        T = superblock * FRAMES_PER_BLOCK
        ncan = (T + q - 1) // q + 1
        M = p + 4
        nb = -(-M // p)
        w = (ncan + nb) * p + 8
        front = p + 8
        return T, ncan, M, nb, w, front

    @classmethod
    def poly_window(cls, superblock: int, p: int, q: int):
        _, _, _, _, w, front = cls._poly_geometry(superblock, p, q)
        return w, front

    @staticmethod
    def unity_window(superblock: int) -> int:
        """Window of the unity-rate copy: one superblock plus a margin
        (the JAX package's ``_window_w(S, 1, True)``)."""
        return superblock * FRAMES_PER_BLOCK + 16

    def build_region(self, w_max: int, front: int = 0):
        """Sample region for window-sliced playback: ``front`` zeros, then the
        buffer, followed by either a zero pad (non-loop) or the loop content
        tiled twice-plus-a-window so any superblock's reads are LINEAR.
        geom["region_len"] is the extension length EXCLUDING front.
        Returns (region f32[C, front+n], geom dict). Same layout as the JAX
        package, so arenas carry across unchanged (utils/from_jax)."""
        data = self._buffer.data
        C, L = data.shape
        lsf, lef, llen = self.loop_frames()
        looping = self._loop and llen > 0
        if looping:
            n_ext = 2 * llen + w_max + 8
            reps = -(-n_ext // llen)
            tiled = np.tile(data[:, lsf:lef], (1, reps))[:, :n_ext]
            region = np.concatenate([data[:, :lsf], tiled], axis=1)
        else:
            pad = np.zeros((C, w_max + 8), np.float32)
            region = np.concatenate([data, pad], axis=1)
        ext_len = region.shape[1]
        if front:
            region = np.concatenate(
                [np.zeros((C, front), np.float32), region], axis=1
            )
        geom = {
            "length": np.float64(L),
            "rate": np.float64(self._buffer.sample_rate),
            "lsf": np.float64(lsf),
            "lef": np.float64(lef),
            "llen": np.float64(llen),
            "looping": np.bool_(looping),
            "loop_flag": np.bool_(self._loop),
            "region_len": np.int32(ext_len),
            "front": np.int32(front),
        }
        return np.ascontiguousarray(region), geom

    def group_key(self, input_channels):
        if self._buffer is None or self._params_modulated():
            return None
        return ("buffer-source", self._buffer.number_of_channels,
                self.kernel_variant())

    # -- state --------------------------------------------------------------------

    def init_state(self, info):
        st = self._sched_state()
        st.update(
            offset=np.float64(0.0),
            duration=np.float64(_INF),
            pos=np.float64(0.0),
            x=np.float64(0.0),
            primed=np.int32(0),
        )
        return st

    def _on_start(self, updates, offset, duration):
        if self._buffer is None:
            raise RuntimeError("Cannot start without a buffer set")
        if not self._buffer.is_initialized:
            raise RuntimeError("Buffer is not initialized")
        off = max(0.0, offset)
        updates["offset"] = off
        updates["duration"] = duration if duration >= 0 else _INF
        # playbackPosition = offset * buffer rate (AudioBufferSourceNode.cs:96)
        updates["pos"] = float(int(off * self._buffer.sample_rate))
        updates["primed"] = 0

    # -- kernels ------------------------------------------------------------------

    def process(self, state, inputs, params, rc):
        """Ungrouped path: a buffer-less source (silence) or a voice whose
        playbackRate is modulated (``group_key`` None, so always the
        time-varying variant): the K7 step over one lane, its region and
        geometry built once per window (as the JAX package's ``process``
        caches them), its per-quantum rate the modulated k-rate values."""
        dev = rc.block_times.device
        if self._buffer is None:
            return state, [torch.zeros((1, rc.frames), dtype=torch.float32, device=dev)]
        variant = self.kernel_variant()
        w = self.resample_window(rc.superblock, variant[1])
        cache_key = (w, self._loop, self._loop_start, self._loop_end, self._buffer.uid,
                     str(dev))
        if getattr(self, "_region_key", None) != cache_key:
            region, geom = self.build_region(w, 0)
            geom = dict(geom, off=np.int32(0))
            stacked = {k: np.asarray(v)[None] for k, v in geom.items()}
            self._region_cache = (
                torch.from_numpy(region).to(dev),
                {k: torch.from_numpy(v).to(dev) for k, v in stacked.items()},
                torch.from_numpy(voice_group.pack_group_table(
                    stacked, w, variant, rc.superblock, rc.sample_rate)).to(dev),
            )
            self._region_key = cache_key
        arena, geom, gtab = self._region_cache
        lead, st = _lanes_of(state)
        sts, out = self.process_resample_group(
            st, arena, geom, gtab, params["playbackRate"].per_block().reshape(1, -1), rc, w)
        new_state = {k: v.reshape(lead) if isinstance(v, torch.Tensor) else v
                     for k, v in sts.items()}
        return new_state, [out[0]]

    @staticmethod
    def _duration_end(state, buffer_rate, length):
        """Duration end frame (f64), parity :179-182; elementwise over
        stacked [V] states."""
        de = torch.where(
            torch.isfinite(state["duration"]),
            torch.trunc(state["offset"] * buffer_rate)
            + torch.trunc(state["duration"] * buffer_rate),
            length,
        )
        return torch.minimum(de, length)

    @classmethod
    def process_unity_group(cls, states, arena, geom, gtab, rc, w: int, aligned: bool):
        """Unity-rate playback of a whole voice group (exact copy): K5.

        states: dict of stacked [V] tensors; arena f32[C, W] (W a multiple
        of 128, every voice region 128-aligned); geom: stacked [V] geometry
        incl. the arena offset ``off``; gtab: the same geometry packed by
        ops/voice_group.pack_group_table (the card reads it, the CPU path
        reads geom). Returns
        (new_states, out f32[V, C, T]). On the card one launch computes the
        whole step (ops.unity.unity_group_step); on the CPU the plain
        composition does (``unity_group_step_plain``).
        """
        if arena.is_cpu:
            return cls.unity_group_step_plain(states, arena, geom, rc, w, aligned)
        pos, stop_time, out = unity_group_step(states, arena, gtab, rc.block_times,
                                               rc.block_end_times)
        new_states = dict(states)
        new_states["pos"] = pos
        new_states["stop_time"] = stop_time
        return new_states, out

    @classmethod
    def unity_group_step_plain(cls, states, arena, geom, rc, w: int, aligned: bool):
        """K5's plain version: ``unity_group_plan`` then
        ops.unity.unity_gather_plain."""
        new_states, args = cls.unity_group_plan(states, geom, rc, w, aligned)
        return new_states, unity_gather_plain(arena, **args)

    @classmethod
    def unity_group_plan(cls, states, geom, rc, w: int, aligned: bool):
        """The f64 per-voice bookkeeping of one unity step (CPU path; K5
        recomputes it in its block prologue on the card): returns
        (new_states, K5's per-voice arguments row0, delta, bidx, g0,
        end_bound, looping, blk_ok).

        The sequence is the JAX package's process_unity_group
        (graphaudio_tpu/nodes/sources.py:1104-1209), op for op, so the new
        ``pos`` and ``stop_time`` match it exactly. Active blocks of a
        superblock form one contiguous run, so block s reads the voice's
        bidx[v, s]-th 128-frame chunk after its window start; ``aligned``
        voices (positions and loop lengths multiples of 128) start on a row.
        """
        S = rc.superblock
        i32 = torch.int32
        f64 = torch.float64
        active = cls._active_mask(states, rc)  # [V, S]
        de = cls._duration_end(states, geom["rate"], geom["length"])  # [V]
        lef, lsf, llen = geom["lef"], geom["lsf"], geom["llen"]
        looping = geom["looping"]
        region_len = geom["region_len"].to(i32)
        base = geom["off"].to(i32) + geom["front"].to(i32)

        adv = torch.where(active, torch.full((), float(FRAMES_PER_BLOCK), dtype=f64,
                                             device=active.device),
                          torch.zeros((), dtype=f64, device=active.device))
        p0 = states["pos"]
        pos_b = p0[:, None] + (torch.cumsum(adv, dim=1) - adv)  # [V, S] f64
        delta_b = (pos_b - p0[:, None]).to(i32)  # 128 * (active blocks before s)
        bidx = torch.clamp(torch.div(delta_b, FRAMES_PER_BLOCK, rounding_mode="floor"),
                           0, S - 1)

        qmod = torch.remainder(p0 - lsf, torch.clamp(llen, min=1.0))
        e0 = torch.where(looping & (p0 >= lsf), lsf + llen + qmod, p0).to(i32)
        if aligned:
            # Positions and arena offsets are multiples of 128; floor the
            # end-clip so the start stays aligned (only past-the-end voices
            # clip, and their samples are masked).
            hi = torch.div(region_len - w, FRAMES_PER_BLOCK, rounding_mode="floor") \
                * FRAMES_PER_BLOCK
            start = torch.minimum(torch.clamp(e0, min=0), hi)
            row0 = torch.div(base + start, FRAMES_PER_BLOCK, rounding_mode="floor")
            delta = torch.zeros_like(row0)
        else:
            abs_start = base + torch.minimum(torch.clamp(e0, min=0), region_len - w)
            row0 = torch.div(abs_start, FRAMES_PER_BLOCK, rounding_mode="floor")
            delta = abs_start - row0 * FRAMES_PER_BLOCK

        # Validity in ORIGINAL coordinates (duration / degenerate loops):
        # sample i of block s is g0[v, s] + i.
        g0 = p0.to(i32)[:, None] + delta_b
        de_i = de.to(i32)
        end_bound = torch.where(geom["loop_flag"], torch.minimum(lef.to(i32), de_i), de_i)
        # A block has a valid sample iff its first one is (g0 + i increases).
        any_valid = looping[:, None] | (g0 < end_bound[:, None])
        # Final-block clear + auto-stop (AudioBufferSourceNode.cs:360-368).
        pos_after = pos_b + FRAMES_PER_BLOCK
        cleared = active & torch.where(
            looping[:, None], ~any_valid, (pos_after >= de[:, None]) | ~any_valid
        )
        inf = torch.full_like(rc.block_end_times[None, :], _INF)
        first_stop = torch.amin(
            torch.where(cleared, rc.block_end_times[None, :], inf), dim=1)
        new_stop = torch.minimum(states["stop_time"], first_stop)

        new_pos = p0 + adv.sum(dim=1)
        new_pos = torch.where(
            looping & (new_pos >= lef),
            lsf + torch.remainder(new_pos - lef, torch.clamp(llen, min=1.0)),
            new_pos,
        )
        new_states = dict(states)
        new_states["pos"] = new_pos
        new_states["stop_time"] = new_stop
        args = {
            "row0": row0.to(torch.int64).contiguous(),
            "delta": delta.to(i32).contiguous(),
            "bidx": bidx.to(i32).contiguous(),
            "g0": g0.to(i32).contiguous(),
            "end_bound": end_bound.to(i32).contiguous(),
            "looping": looping.contiguous(),
            "blk_ok": (active & ~cleared).contiguous(),
        }
        return new_states, args

    @classmethod
    def process_poly_group(cls, states, arena, geom, gtab, rc, w: int, p: int, q: int,
                           taps):
        """Static polyphase resampling of a whole voice group: K1.

        states: dict of stacked [V] tensors; arena f32[C, W]; geom: dict of
        stacked [V] tensors incl. the per-voice arena offset ``off``;
        gtab: the same geometry packed by ops/voice_group.pack_group_table
        (the card reads it, the CPU path reads geom); taps: (wtab f32[q, 4],
        btab i32[q]) from ops.resample.poly_taps. Returns (new_states, out f32[V, C, T]). On the card
        one launch computes the whole step (ops.resample.poly_group_step);
        on the CPU the plain composition does (``poly_group_step_plain``).
        """
        if arena.is_cpu:
            return cls.poly_group_step_plain(states, arena, geom, rc, w, p, q, taps)
        x, primed, stop_time, out = poly_group_step(
            states, arena, gtab, rc.block_times, rc.block_end_times, taps[0], taps[1])
        new_states = dict(states)
        new_states["x"] = x
        new_states["primed"] = primed
        new_states["stop_time"] = stop_time
        return new_states, out

    @classmethod
    def poly_group_step_plain(cls, states, arena, geom, rc, w: int, p: int, q: int, taps):
        """K1's plain version: ``poly_group_plan`` then
        ops.resample.poly_resample_plain."""
        new_states, args = cls.poly_group_plan(states, geom, rc, w, p, q)
        out = poly_resample_plain(arena, wtab=taps[0], btab=taps[1], p=p, q=q, **args)
        return new_states, out

    @classmethod
    def poly_group_plan(cls, states, geom, rc, w: int, p: int, q: int):
        """The f64 per-voice bookkeeping of one polyphase step (CPU path;
        K1 recomputes it in its block prologue on the card): returns
        (new_states, K1's per-voice arguments win_start, j0, bidx, blk_ok,
        jlim, looping).

        The sequence is the JAX package's, op for op
        (graphaudio_tpu/nodes/sources.py:1238-1251, :1291-1339), so the new
        ``x`` and ``stop_time`` match it exactly.
        """
        S = rc.superblock
        _T, _ncan, _M, _nb, w_e, _front = cls._poly_geometry(S, p, q)
        if w != w_e:
            raise ValueError(f"window {w} does not match the poly geometry {w_e}")
        i64 = torch.int64
        f64 = torch.float64

        stop_time = states["stop_time"]
        active = cls._active_mask(states, rc)  # [V, S]
        de = cls._duration_end(states, geom["rate"], geom["length"])  # [V]
        lef, lsf, llen = geom["lef"], geom["lsf"], geom["llen"]
        looping = geom["looping"]
        llen1 = torch.clamp(llen, min=1.0)

        # The JAX reference runs jitted, and XLA rewrites each f64 division by
        # a constant as a multiply by its reciprocal; the port does the same
        # so that x and stop_time match it bit for bit.
        inv_q = 1.0 / q
        x0 = torch.where(states["primed"] > 0, states["x"], states["pos"] + 1.0)
        # Snap to the 1/q grid (f64 accumulation drifts ~1e-16/step).
        x0 = torch.round(x0 * q) * inv_q
        # map into the periodic extension (loop wraps become linear reads)
        qmod = torch.remainder(x0 - lsf, llen1)
        e0 = torch.where(looping & (x0 >= lsf), lsf + llen + qmod, x0)
        ef = torch.floor(e0)
        A0 = ef.to(i64)
        r0 = torch.round((e0 - ef) * q).to(i64)
        A0 = A0 + (r0 == q).to(i64)  # frac rounded up to 1
        r0 = torch.where(r0 == q, 0, r0)
        # Canonical phase: j0 solves j0*p = r0 (mod q) (p, q coprime).
        pinv = pow(p, -1, q) if q > 1 else 0
        j0 = (r0 * pinv) % q
        m0 = torch.div(j0 * p - r0, q, rounding_mode="floor")
        start = torch.minimum(
            torch.clamp(A0 - m0 - 1, min=-(p + 8)),
            geom["region_len"].to(i64) - w,
        )
        win_start = geom["off"].to(i64) + geom["front"].to(i64) + start

        # Block placement: active blocks form one contiguous run.
        act = active.to(i64)
        bidx = torch.clamp(torch.cumsum(act, dim=1) - act, 0, S - 1)  # [V, S]

        # Validity: floor(x_j) + 2 <= end - 1  <=>  j < jlim (exact f64 ints).
        lef_i = lef.to(i64)
        de_i = de.to(i64)
        end_bound = torch.where(geom["loop_flag"], torch.minimum(lef_i, de_i), de_i)
        x0q = torch.round(x0 * q)
        num = (end_bound.to(f64) - 2.0) * q - x0q
        jlim = torch.floor((num + (p - 1)) * (1.0 / p)).to(torch.float32)  # [V]
        # Consumed-position block gate (AudioBufferSourceNode.cs:270-272).
        p0 = states["pos"]
        x_b = x0[:, None] + bidx.to(f64) * (FRAMES_PER_BLOCK * p / q)
        consumed_b = p0[:, None] + 4.0 + torch.floor(x_b - p0[:, None] - 1.0)
        blk_valid = looping[:, None] | (consumed_b < de[:, None])  # [V, S]
        # Whole-block clear when consumption crosses durationEnd inside the
        # block (AudioBufferSourceNode.cs:360-368).
        consumed_after = p0[:, None] + 4.0 + torch.floor(
            x_b + 127.0 * p / q - p0[:, None] - 1.0
        )
        cleared = active & ~looping[:, None] & (consumed_after >= de[:, None])
        blk_ok = active & blk_valid & ~cleared
        # A block has a valid sample iff its first one is (jpos increases).
        first_ok = looping[:, None] | (
            (bidx * FRAMES_PER_BLOCK).to(torch.float32) < jlim[:, None]
        )
        starved = active & (~(blk_valid & first_ok) | cleared)  # [V, S]
        first_stop = torch.amin(
            torch.where(starved, rc.block_end_times[None, :],
                        torch.full_like(rc.block_end_times[None, :], _INF)),
            dim=1,
        )
        new_stop = torch.minimum(stop_time, first_stop)

        # Exact advance: n_active*128*p is an exact f64 integer; one rounding
        # at the /q, then the grid snap restores exactness.
        n_active = active.to(f64).sum(dim=1)
        new_x = x0 + (n_active * (FRAMES_PER_BLOCK * p)) * inv_q
        new_x = torch.where(
            looping & (new_x >= lef),
            lsf + torch.remainder(new_x - lef, llen1),
            new_x,
        )
        new_x = torch.round(new_x * q) * inv_q

        new_states = dict(states)
        new_states["x"] = new_x
        new_states["primed"] = torch.where(
            active.any(dim=1), torch.ones_like(states["primed"]), states["primed"]
        )
        new_states["stop_time"] = new_stop
        args = {
            "win_start": win_start.contiguous(),
            "j0": j0.to(torch.int32).contiguous(),
            "bidx": bidx.to(torch.int32).contiguous(),
            "blk_ok": blk_ok.contiguous(),
            "jlim": jlim.contiguous(),
            "looping": looping.contiguous(),
        }
        return new_states, args

    # -- the time-varying resampler (K7) ----------------------------------------
    #
    # The JAX package interpolates a window through overlapping 64-sample
    # tiles and a 4-banded matmul; the port reads the taps straight from the
    # arena. What the tiles decide is kept: the window's size and start,
    # and which taps of a quantum lie in its tile (those outside it get
    # weight 0 in the reference, as they do here).

    @staticmethod
    def resample_window(superblock: int, bound: int) -> int:
        """Window of the time-varying resampler for a pow2 rate bound (the
        JAX package's ``_window_w(S, bound, False)``)."""
        hop = voice_group.RESAMPLE_HOP
        n_tiles = (superblock * FRAMES_PER_BLOCK * bound) // hop + 3
        return (n_tiles - 1) * hop + voice_group.resample_tile_len(bound)

    @staticmethod
    def _map_ext(p, geom):
        """Map an original-coordinate position into the region's periodic
        extension once per superblock; reads proceed linearly from there."""
        lsf, llen = geom["lsf"], geom["llen"]
        q = torch.remainder(p - lsf, torch.clamp(llen, min=1.0))
        return torch.where(geom["looping"] & (p >= lsf), lsf + llen + q, p)

    @classmethod
    def resample_window_starts(cls, states, geom, w: int):
        """[V] absolute arena offsets of each voice's resample window (the
        JAX package's ``resample_window_starts``, nodes/sources.py:768)."""
        x0 = torch.where(states["primed"] > 0, states["x"], states["pos"] + 1.0)
        e0 = cls._map_ext(x0, geom)
        start = torch.minimum(torch.clamp(torch.floor(e0).to(torch.int64) - 1, min=0),
                              geom["region_len"].to(torch.int64) - w)
        return geom["off"].to(torch.int64) + geom["front"].to(torch.int64) + start

    @classmethod
    def process_resample_group(cls, states, arena, geom, gtab, rate_pb, rc, w: int):
        """Time-varying resampling of a whole voice group: K7.

        states: dict of stacked [V] tensors; arena f32[C, W]; geom: stacked
        [V] geometry incl. ``off``; gtab: the same packed
        (ops/voice_group.pack_group_table; the card reads it, the CPU path
        reads geom); rate_pb: the playbackRate f32[V, S] a quantum, rows
        or one base value a voice (stride 0 along S). Returns (new_states,
        out f32[V, C, T]). On the card one launch computes the whole step
        (ops.resample.resample_group_step); on the CPU
        ``resample_group_step_plain`` does.
        """
        if arena.is_cpu:
            return cls.resample_group_step_plain(states, arena, geom, rate_pb, rc, w)
        x, primed, stop_time, out = resample_group_step(
            states, arena, gtab, rate_pb, rc.block_times, rc.block_end_times)
        new_states = dict(states)
        new_states["x"] = x
        new_states["primed"] = primed
        new_states["stop_time"] = stop_time
        return new_states, out

    @classmethod
    def resample_group_step_plain(cls, states, arena, geom, rate_pb, rc, w: int):
        """K7's plain version: the JAX package's ``_process_resample``
        (graphaudio_tpu/nodes/sources.py:783-900) over the group's stacked
        [V] states, op for op in f64 with XLA's roundings (its cumsum and sum
        orders, the fmas it contracts), so the new ``x``, ``primed`` and
        ``stop_time`` match it exactly. The audio reads the four taps of
        each output straight from the arena, with the weight of a tap
        outside its quantum's tile 0 as in the reference's banded matrix;
        each output sums its taps as ((w0*a0 + w1*a1) + w2*a2) + w3*a3."""
        S = rc.superblock
        f64, i64 = torch.float64, torch.int64
        C = arena.shape[0]
        V = states["x"].shape[0]
        dev = arena.device
        active = cls._active_mask(states, rc)  # [V, S]
        de = cls._duration_end(states, geom["rate"], geom["length"])  # [V]
        lef, lsf, llen = geom["lef"], geom["lsf"], geom["llen"]
        looping = geom["looping"]
        cap, tile, n_tiles = voice_group.resample_geometry(S, w)

        ratio = geom["rate"] / float(rc.sample_rate)
        rate_b = torch.clamp(ratio[:, None] * rate_pb.to(f64), max=float(cap))  # [V, S]
        # The first output of a fresh voice lies at pos + 1 (the 4-sample
        # warmup of CubicResampler.cs:31-38, :52).
        x0 = torch.where(states["primed"] > 0, states["x"], states["pos"] + 1.0)
        e0 = cls._map_ext(x0, geom)
        win0 = cls.resample_window_starts(states, geom, w)  # [V]
        start = win0 - geom["off"].to(i64) - geom["front"].to(i64)
        zero = torch.zeros((), dtype=f64, device=dev)
        adv = torch.where(active, FRAMES_PER_BLOCK * rate_b, zero)
        du_b = xla_cumsum(adv) - adv  # [V, S] offsets from x0
        ub = (e0 - start.to(f64))[:, None] + du_b  # block anchors in the window
        base_l, frac = split_positions(ub, rate_b)  # [V, S, 128]

        # The taps, each in its quantum's tile or weight 0.
        hop = voice_group.RESAMPLE_HOP
        m_b = torch.clamp(torch.div(torch.floor(ub).to(i64) - 1, hop, rounding_mode="floor"),
                          0, n_tiles - 1)
        base_row = base_l.to(i64) - (m_b * hop)[..., None]
        at = win0[:, None, None] + base_l.to(i64)
        y = None
        for k, wk in zip((-1, 0, 1, 2), cr_weights_fma(frac)):
            inb = (base_row + k >= 0) & (base_row + k < tile)
            idx = torch.where(inb, at + k, torch.zeros((), dtype=i64, device=dev))
            a = arena[:, idx.reshape(-1)].reshape(C, V, S, FRAMES_PER_BLOCK)
            term = torch.where(inb, wk * a, torch.zeros((), dtype=torch.float32, device=dev))
            y = term if y is None else y + term  # [C, V, S, 128]

        # Validity in ORIGINAL coordinates.
        shift = torch.round(x0 - e0).to(i64) + start
        base_orig = base_l.to(i64) + shift[:, None, None]
        de_i = de.to(i64)
        end_bound = torch.where(geom["loop_flag"], torch.minimum(lef.to(i64), de_i), de_i)
        valid = looping[:, None, None] | (base_orig + 2 <= (end_bound - 1)[:, None, None])
        # Consumed-position block gate (AudioBufferSourceNode.cs:270-272).
        p0 = states["pos"][:, None]
        xd = x0[:, None] + du_b
        consumed_b = (p0 + 4.0) + torch.floor((xd - p0) - 1.0)
        valid = valid & (looping[:, None] | (consumed_b < de[:, None]))[..., None]
        # Whole-block clear when consumption crosses durationEnd in the
        # block (AudioBufferSourceNode.cs:360-368).
        c127 = torch.full_like(rate_b, 127.0)
        consumed_after = (p0 + 4.0) + torch.floor(
            (xla_rounding.fma64(c127, rate_b, xd) - p0) - 1.0)
        cleared = active & ~looping[:, None] & (consumed_after >= de[:, None])
        gate = (active & ~cleared)[..., None] & valid
        out = torch.where(gate[None], y, torch.zeros((), dtype=torch.float32, device=dev))

        # Auto-stop on starvation or duration-end clear.
        starved = active & (~valid.any(dim=2) | cleared)
        bet = rc.block_end_times[None, :]
        first_stop = torch.amin(torch.where(starved, bet, torch.full_like(bet, _INF)), dim=1)
        new_x = x0 + xla_sum(adv)
        new_x = torch.where(looping & (new_x >= lef),
                            lsf + torch.remainder(new_x - lef, torch.clamp(llen, min=1.0)),
                            new_x)
        new_states = dict(states)
        new_states["x"] = new_x
        new_states["primed"] = torch.where(active.any(dim=1),
                                           torch.ones_like(states["primed"]), states["primed"])
        new_states["stop_time"] = torch.minimum(states["stop_time"], first_stop)
        return new_states, out.permute(1, 0, 2, 3).reshape(V, C, S * FRAMES_PER_BLOCK)
