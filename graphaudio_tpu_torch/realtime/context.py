"""Realtime audio context: render thread -> native ring -> output device.

The port of graphaudio_tpu/realtime/context.py. Parity:
GraphAudio.Realtime/RealtimeAudioContext.cs — ring capacity = buffer_size * 5
(:38), a dedicated render thread that fills the ring whenever a step's
frames of space exist and otherwise waits on the space semaphore
(:143-165), an output device that drains the ring natively with underrun
zero-fill (:167-235), and device enumeration/selection (:55-141).

Two devices meet here, so they take two names: ``device`` is the torch
device the graph renders on (``"cuda"`` by default, raising where CUDA is
absent, as ``OfflineAudioContext`` does) and ``output_device`` the audio
output (``"null"``, ``"alsa"``, ``"alsa:<pcm>"`` or ``"auto"``), which the
JAX package calls ``device``.

On the card the render thread runs the offline context's step (a small
superblock for low latency) two deep: it launches step n+1, then finishes
step n, which waits on step n's own CUDA event and writes its interleaved
frames into the native ring; the C++ device thread (native/garing.cpp)
consumes the ring in real time without touching Python.

While a realtime context plays, the objects that existed when playback
began are frozen out of Python's cyclic collector (``gc.freeze``): a full
collection then walks only what was made since, instead of the whole
heap of a long-lived process (487 ms of one on an H100's host, inside a
launch, is an audible dropout); the last context to stop unfreezes them.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time
import warnings
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.context import AudioContextBase, resolve_device
from graphaudio_tpu_torch.core.stepgraph import StepGraph
from graphaudio_tpu_torch.realtime.ring import RingBuffer, load_native


#: The realtime contexts now playing (ids); the heap is frozen while one is.
_playing: set = set()
_playing_lock = threading.Lock()


def _hold_heap(ctx) -> None:
    """Freeze the heap out of the cyclic collector if ``ctx`` is the first
    context to play."""
    with _playing_lock:
        if not _playing:
            gc.freeze()
        _playing.add(id(ctx))


def _release_heap(ctx) -> None:
    """Give the frozen heap back to the collector once no context plays."""
    with _playing_lock:
        if id(ctx) in _playing:
            _playing.discard(id(ctx))
            if not _playing:
                gc.unfreeze()


@dataclass(frozen=True)
class AudioDeviceInfo:
    """Parity: AudioDeviceInfo (RealtimeAudioContext.cs:272-313)."""

    name: str
    is_default: bool
    backend: str = "null"


class RealtimeAudioContext(AudioContextBase):
    def __init__(
        self,
        sample_rate: int = 48000,
        channels: int = 2,
        buffer_size: int = 256,
        output_device: Optional[str] = None,
        superblock: int = 2,
        auto_tune: bool = False,
        auto_start_thread: bool = True,
        device="cuda",
    ):
        """``auto_tune=True`` measures the per-step round trip of the render
        device at startup and grows ``superblock`` (and the ring, via
        ``buffer_size``) until one step's audio duration clears it with
        margin; it warns if even the largest superblock cannot. On a card
        in the same host the measurement is far under a millisecond and the
        requested geometry is kept. The chosen values are inspectable as
        ``superblock`` / ``tuned_rtt_s``. Chain fusion is off: a realtime
        step delivers what it renders."""
        dev = resolve_device(device)
        self.tuned_rtt_s: Optional[float] = None
        if auto_tune:
            rtt = self._measure_step_rtt(dev)
            superblock, buffer_size = self._tune_geometry(
                rtt, sample_rate, superblock, buffer_size
            )
            self.tuned_rtt_s = rtt
        super().__init__(sample_rate=sample_rate, superblock=superblock, device=dev)
        # On the card a step with nothing edited replays as one CUDA graph.
        self._step_graph = StepGraph() if dev.type == "cuda" else None
        self.channels = channels
        self.buffer_size = buffer_size
        #: last exception survived by the render thread (None = healthy)
        self.last_render_error = None
        self.destination.set_channel_count(channels)
        # Ring capacity = bufferSize * 5 (parity :38).
        self.ring = RingBuffer(channels, buffer_size * 5)

        # "auto" = real hardware (ALSA via dlopen'd libasound) when present,
        # else the clock-paced null backend — the reference's miniaudio
        # default-device behavior (Miniaudio.cs:303-349). Explicit "alsa"
        # requests fail loudly instead of silently degrading.
        self._device_name = output_device or "auto"
        self._lib = load_native()
        self._dev = None
        if self._lib is not None and self.ring.native_handle is not None:
            self._dev = self._lib.gadev_open(
                self._device_name.encode(),
                self.ring.native_handle,
                sample_rate,
                channels,
                buffer_size,
            )
            if self._dev is None:
                raise RuntimeError(
                    f"could not open audio device {self._device_name!r}"
                )

        self._running = False
        self._thread_quit = False
        self._render_thread: Optional[threading.Thread] = None
        self._render_thread_id: Optional[int] = None
        if auto_start_thread:
            self._start_render_thread()

    # -- startup latency probe / geometry auto-tuning ------------------------------

    @staticmethod
    def _measure_step_rtt(device, samples: int = 5) -> float:
        """Per-step wall-time floor: the round trip of a minimal op on
        ``device``, launch through the copy of its result to the host (every
        render step pays at least this whatever the graph's size); the
        p80 of ``samples`` after one warm call."""
        x = torch.zeros(FRAMES_PER_BLOCK, dtype=torch.float32, device=device)
        (x + 1.0).cpu()  # warm
        walls = []
        for _ in range(max(samples, 2)):
            t0 = time.perf_counter()
            (x + 1.0).cpu()
            walls.append(time.perf_counter() - t0)
        walls.sort()
        return walls[int(0.8 * (len(walls) - 1))]

    @staticmethod
    def _tune_geometry(
        rtt_s: float,
        sample_rate: int,
        min_superblock: int,
        buffer_size: int,
        margin: float = 1.25,
        max_superblock: int = 64,
    ):
        """Smallest superblock whose per-step audio duration covers the
        measured round trip with ``margin`` (the 2-deep launch/finish
        pipeline hides ONE step's latency; throughput still needs
        audio-per-step >= step wall). The ring is grown to hold 2.5 steps
        (buffer_size = superblock*64 -> ring = superblock*320 frames): a
        ring that only fits one step must fully drain before each render —
        guaranteed periodic underruns on a high-latency link."""
        s = max(1, int(min_superblock))
        while (
            s < max_superblock
            and s * FRAMES_PER_BLOCK / sample_rate < margin * rtt_s
        ):
            s *= 2
        if s * FRAMES_PER_BLOCK / sample_rate < margin * rtt_s:
            warnings.warn(
                f"RealtimeAudioContext: measured per-step round trip "
                f"{rtt_s * 1e3:.1f} ms exceeds the largest superblock's "
                f"audio duration ({s * FRAMES_PER_BLOCK / sample_rate * 1e3:.1f} ms "
                f"at superblock {s}); realtime playback WILL underrun on "
                f"this link — use co-located hardware or offline rendering",
                RuntimeWarning,
                stacklevel=3,
            )
        return s, max(int(buffer_size), s * FRAMES_PER_BLOCK // 2)

    # -- output device enumeration (parity :55-141) --------------------------------

    @staticmethod
    def get_available_devices() -> List[AudioDeviceInfo]:
        lib = load_native()
        if lib is None:
            return [AudioDeviceInfo("null", True)]
        buf = ctypes.create_string_buffer(4096)
        n = lib.gadev_enumerate(buf, 4096, 32)
        names = []
        off = 0
        for _ in range(n):
            s = ctypes.string_at(ctypes.addressof(buf) + off).decode()
            names.append(s)
            off += len(s) + 1
        return [
            AudioDeviceInfo(
                nm, i == 0, "alsa" if nm.startswith("alsa") else "null"
            )
            for i, nm in enumerate(names)
        ]

    @staticmethod
    def get_default_device() -> AudioDeviceInfo:
        return RealtimeAudioContext.get_available_devices()[0]

    def switch_device(self, name: str) -> None:
        """Hot-switch the output device (parity: SwitchDevice, :86-141)."""
        if self._lib is None or self.ring.native_handle is None:
            self._device_name = name
            return
        was_running = self._running
        if self._dev is not None:
            self._lib.gadev_close(self._dev)
        self._device_name = name
        self._dev = self._lib.gadev_open(
            name.encode(), self.ring.native_handle,
            self.sample_rate, self.channels, self.buffer_size,
        )
        if self._dev is None:
            raise RuntimeError(f"could not open audio device {name!r}")
        if was_running:
            self._lib.gadev_start(self._dev)

    # -- transport ----------------------------------------------------------------

    def start(self) -> None:
        """Parity: Start -> ma_device_start (:76-84). The heap as it is now
        leaves the cyclic collector while the context plays."""
        _hold_heap(self)
        self._running = True
        if self._dev is not None:
            self._lib.gadev_start(self._dev)

    def stop(self) -> None:
        self._running = False
        if self._dev is not None:
            self._lib.gadev_stop(self._dev)
        _release_heap(self)

    @property
    def is_running(self) -> bool:
        return self._running

    @property
    def frames_played(self) -> int:
        return int(self._lib.gadev_frames_played(self._dev)) if self._dev else 0

    @property
    def underrun_frames(self) -> int:
        return int(self._lib.gadev_underruns(self._dev)) if self._dev else 0

    @property
    def device_backend(self) -> str:
        """Actual backend driving the output: "alsa" or "null" ("none"
        without the native library)."""
        if self._dev is None:
            return "none"
        return self._lib.gadev_backend(self._dev).decode()

    # -- command routing: mutations funnel to the render thread ---------------------

    def execute_or_post(self, command) -> None:
        """Graph mutations run on the render thread at step boundaries
        (parity: ExecuteOrPost, AudioContextBase.cs:291-305)."""
        if self._disposed:
            raise RuntimeError("context is disposed")
        if threading.get_ident() == self._render_thread_id:
            command(self)
        else:
            self._pending.append(command)

    # -- render thread (parity: RenderLoop, :143-165) -------------------------------

    def _start_render_thread(self) -> None:
        self._render_thread = threading.Thread(
            target=self._render_loop, name="ga-render", daemon=True
        )
        self._render_thread.start()

    def _render_loop(self) -> None:
        self._render_thread_id = threading.get_ident()
        # The thread's current stream is the one the kernels take
        # (cudabuild.stream_of) and the one each launch's event is recorded on.
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            self._pump()

    def _pump(self) -> None:
        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        # Two-deep pipeline: launch step n+1 BEFORE finishing step n, so the
        # host's work for n+1 overlaps the device's for n. Where step n's
        # device work is already done when there is room for it, its audio
        # goes into the ring first and the launch of n+1 follows, so the
        # ring holds one launch's time more; its ended-events still fire
        # after that launch, as they always do.
        pending = None
        written = False

        def write(p):
            out = self._render_steps_audio(p)  # [C, T]
            self.ring.write_interleaved(np.ascontiguousarray(out.T))

        def flush(p, written):
            try:
                out = self._render_steps_finish(p)  # [C, T]
            except Exception:
                if self._thread_quit or self._disposed:
                    return None
                raise
            if not written:
                self.ring.write_interleaved(np.ascontiguousarray(out.T))
            return None

        while not self._thread_quit:
            try:
                if not self._running:
                    if pending is not None:
                        pending = flush(pending, written)
                    threading.Event().wait(0.002)
                    continue
                if self.ring.available_write() >= frames_per_step:
                    if pending is not None and not written and pending.ready():
                        write(pending)
                        written = True
                    nxt = self._render_steps_launch(1)
                    if pending is not None:
                        flush(pending, written)
                    pending, written = nxt, False
                else:
                    self.ring.wait_for_space(frames_per_step, 5)
            except Exception as exc:  # noqa: BLE001
                if self._thread_quit or self._disposed:
                    return
                # A transient failure (e.g. a decoder error surfacing
                # through feed staging) must not silently kill the render
                # thread while is_running stays True — the device would
                # drain the ring to zeros forever with no signal. Record
                # it, drop the in-flight step, and keep rendering; the app
                # can poll last_render_error / stats.render_errors.
                self.last_render_error = exc
                self.stats.render_errors += 1
                pending = None
                threading.Event().wait(0.002)

    def render_step_blocking(self) -> np.ndarray:
        """Render one superblock on the calling thread (for tests/tools)."""
        return self._render_steps(1)

    # -- lifecycle -------------------------------------------------------------------

    def dispose(self) -> None:
        if self._disposed:
            return
        self._thread_quit = True
        self._running = False
        if self._render_thread is not None:
            self._render_thread.join(timeout=2.0)
        if self._dev is not None:
            self._lib.gadev_close(self._dev)
            self._dev = None
        _release_heap(self)
        self.ring.dispose()
        super().dispose()
