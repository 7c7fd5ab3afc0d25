"""Scheduled sources: ScheduledSourceNode and AudioBufferSourceNode.

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

The port renders two kernel variants of AudioBufferSourceNode, each over a
whole voice group: the unity-rate copy (``kernel_variant() ==
("unity", aligned)``: an asset at the context rate, playbackRate untouched)
with ``process_unity_group`` around K5 (ops/unity.py), and the static
polyphase resampler (``("poly", p, q)``: a constant rational rate such as
44.1 kHz assets in a 48 kHz context) with ``process_poly_group`` around K1.
The time-varying resampler raises NotImplementedError naming its ROADMAP
item.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Callable, List

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.node import AudioNode
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.ops.resample import poly_resample
from graphaudio_tpu_torch.ops.unity import unity_gather

_INF = float("inf")

_UNPORTED_VARIANTS = {
    "resample": "time-varying-rate resampling is not ported yet "
                "(ROADMAP.md module item 7, kernel K7)",
}


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
    def require_ported(variant) -> None:
        """Raise for the kernel variants this slice does not port."""
        msg = _UNPORTED_VARIANTS.get(variant[0])
        if msg is not None:
            raise NotImplementedError(msg)

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
        """Ungrouped path: only a buffer-less source is ungrouped in this
        slice (a modulated playbackRate selects the unported resampler)."""
        if self._buffer is None:
            return state, [torch.zeros((1, rc.frames), dtype=torch.float32,
                                       device=rc.block_times.device)]
        self.require_ported(("resample",))

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
    def process_unity_group(cls, states, arena, geom, rc, w: int, aligned: bool):
        """Unity-rate playback of a whole voice group (exact copy).

        states: dict of stacked [V] tensors; arena f32[C, W] (W a multiple
        of 128, every voice region 128-aligned); geom: stacked [V] geometry
        incl. the arena offset ``off``. Returns (new_states, out f32[V, C,
        T]); the audio comes from K5 (ops.unity.unity_gather).
        """
        new_states, args = cls.unity_group_plan(states, geom, rc, w, aligned)
        return new_states, unity_gather(arena, **args)

    @classmethod
    def unity_group_plan(cls, states, geom, rc, w: int, aligned: bool):
        """The f64 per-voice bookkeeping of one unity step: returns
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
    def process_poly_group(cls, states, arena, geom, rc, w: int, p: int, q: int,
                           taps):
        """Static polyphase resampling of a whole voice group.

        states: dict of stacked [V] tensors; arena f32[C, W]; geom: dict of
        stacked [V] tensors incl. the per-voice arena offset ``off``;
        taps: (wtab f32[q, 4], btab i32[q]) from ops.resample.poly_taps.
        Returns (new_states, out f32[V, C, T]); the audio comes from K1
        (ops.resample.poly_resample).
        """
        new_states, args = cls.poly_group_plan(states, geom, rc, w, p, q)
        out = poly_resample(arena, wtab=taps[0], btab=taps[1], p=p, q=q, **args)
        return new_states, out

    @classmethod
    def poly_group_plan(cls, states, geom, rc, w: int, p: int, q: int):
        """The f64 per-voice bookkeeping of one polyphase step: returns
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
