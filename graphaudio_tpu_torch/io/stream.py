"""Streaming source node: decoder thread + host-staged feeds.

The port of graphaudio_tpu/io/stream.py: the host side (decoder thread,
transport, feed staging) is copied. Every step's frames of a render call
are read at once when the call stages its feeds (``read_feed``: one K15
launch, ops/stream.py and csrc/stream.cu, on a CUDA feed; its plain version
on a CPU feed), and ``process`` hands the step its row of that read.

Parity: GraphAudio.IO/AudioStreamSourceNodeBase.cs (push-source with buffer
recycling, StreamState Playing/Paused/Stopped with flush-on-stop, per-channel
cubic resampling when the effective rate != 1) and AudioDecoderStreamNode.cs
(dedicated decoder thread refilling N x 4096-frame buffers, gapless looping
via rewind-and-continue, Seek = stop -> seek -> refill -> resume).

Design: the decoder thread fills a host-side chunk queue exactly like the
reference; at each render-call boundary the node *stages a feed* — a float32
[channels, N] array of upcoming source samples, which the context copies to
the render device once a call (core/context.py). The kernel is a stateless
gather over the whole call (unity-rate copy or Catmull-Rom resample at
x_j = x0 + j*rate); all stream bookkeeping (consumption, looping,
pause/stop, underruns) happens on the host, mirroring the reference's
host-thread discipline.

Documented deviations: ``playback_rate`` takes effect at render-call
boundaries (the reference applies it per 128-frame block), as in the JAX
package; a stopped or paused node's silent feed covers the whole call (the
JAX package's is 8192 frames long and its gather fills frames past it with
NaN).
"""

from __future__ import annotations

import enum
import math
import threading

import numpy as np

from graphaudio_tpu_torch.core.node import AudioNode
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.io.decode import AudioDecoder
from graphaudio_tpu_torch.ops.stream import stream_feed_call

# Feed arrays pad to multiples of this, as in the JAX package (stable jit
# shapes there); the padding is part of the result: the resampler's taps
# past the data clamp onto its zeros.
_FEED_BUCKET = 8192


class StreamState(enum.Enum):
    """Parity: AudioStreamSourceNodeBase.StreamState (:12-48)."""

    PLAYING = "playing"
    PAUSED = "paused"
    STOPPED = "stopped"


class AudioDecoderStreamNode(AudioNode):
    """Streams decoded audio through the graph.

    Create via :meth:`from_file` / :meth:`from_bytes` (parity:
    AudioDecoderStreamNode.FromFile/FromStream, :92-117).
    """

    def __init__(self, context, decoder: AudioDecoder,
                 buffer_frames: int = 4096, buffer_count: int = 3):
        super().__init__(context, input_count=0, output_count=1, name="AudioDecoderStream")
        self._decoder = decoder
        self._buffer_frames = buffer_frames
        self._buffer_count = buffer_count
        self._state = StreamState.STOPPED
        self._loop = False
        self._eof = False
        self._lock = threading.Lock()
        self._chunks: list = []  # decoded planar chunks [C, n]
        self._buffered = 0
        self._pending = np.zeros((decoder.channels, 0), np.float32)
        self._next_x0 = 1.0  # resampler warmup position (CubicResampler.cs:31-38)
        self._primed = False
        # The staged call's read: None for the unity copy, else the
        # resampler's (x0, rate); set by prepare_feed, read by read_feed.
        self._call_read = None
        self._wake = threading.Event()
        self._quit = False
        self._thread = threading.Thread(
            target=self._fill_loop, name="ga-decoder", daemon=True
        )
        self._thread.start()

        self.playback_rate = self.create_audio_param(
            "playbackRate", 1.0, min_value=0.001, max_value=1000.0,
            automation_rate=AutomationRate.K_RATE,
        )
        # The unity-vs-resample kernel is a STATIC variant selected on
        # `touched` — the first touch must invalidate the compiled program
        # (same as AudioBufferSourceNode) or the cached unity kernel keeps
        # playing at rate 1.0 while host staging advances at the new rate.
        self.playback_rate.notify_first_touch = True

    # -- factories -------------------------------------------------------------

    @staticmethod
    def from_file(context, path, buffer_frames: int = 4096, buffer_count: int = 3):
        return AudioDecoderStreamNode(
            context, AudioDecoder(path), buffer_frames, buffer_count
        )

    @staticmethod
    def from_bytes(context, data, buffer_frames: int = 4096, buffer_count: int = 3):
        return AudioDecoderStreamNode(
            context, AudioDecoder(data), buffer_frames, buffer_count
        )

    from_stream = from_bytes

    @staticmethod
    async def from_file_async(context, path, buffer_frames: int = 4096,
                              buffer_count: int = 3):
        """Awaitable factory: the decoder open runs off-thread (parity:
        AudioDecoderStreamNode.FromFileAsync, :92-117)."""
        import asyncio

        dec = await asyncio.to_thread(AudioDecoder, path)
        return AudioDecoderStreamNode(context, dec, buffer_frames, buffer_count)

    # -- info ---------------------------------------------------------------------

    @property
    def state(self) -> StreamState:
        return self._state

    @property
    def sample_rate(self) -> int:
        return self._decoder.sample_rate

    @property
    def channels(self) -> int:
        return self._decoder.channels

    @property
    def duration(self) -> float:
        return self._decoder.duration

    @property
    def loop(self) -> bool:
        return self._loop

    @loop.setter
    def loop(self, value: bool) -> None:
        self._loop = bool(value)
        self._wake.set()

    def output_channel_counts(self, input_channels):
        return [self._decoder.channels]

    # -- transport (parity: AudioStreamSourceNodeBase.cs:94-117) ----------------

    def play(self) -> None:
        self._state = StreamState.PLAYING
        self._wake.set()

    def pause(self) -> None:
        if self._state == StreamState.PLAYING:
            self._state = StreamState.PAUSED

    def stop(self) -> None:
        """Stop and flush (rewinds to the start, like the reference's
        flush-on-stop + refill from rewind)."""
        with self._lock:
            self._state = StreamState.STOPPED
            self._chunks.clear()
            self._buffered = 0
            self._pending = np.zeros((self._decoder.channels, 0), np.float32)
            self._next_x0 = 1.0
            self._primed = False
            self._eof = False
            self._decoder.try_rewind()
        self._wake.set()

    def seek(self, seconds: float) -> None:
        """Parity: Seek = stop -> seek -> refill -> resume (:122-141)."""
        was_playing = self._state == StreamState.PLAYING
        with self._lock:
            self._chunks.clear()
            self._buffered = 0
            self._pending = np.zeros((self._decoder.channels, 0), np.float32)
            self._next_x0 = 1.0
            self._primed = False
            self._eof = False
            if not self._decoder.try_seek(seconds):
                self._decoder.try_rewind()
        if was_playing:
            self._state = StreamState.PLAYING
        self._wake.set()

    # -- decoder thread (parity: AudioDecoderStreamNode.cs:157-223) ---------------

    def _fill_loop(self) -> None:
        while not self._quit:
            # Cleared before the check: a wake set after it ends the wait
            # below at once, so none is lost.
            self._wake.clear()
            filled = False
            with self._lock:
                want = self._buffer_count * self._buffer_frames
                if self._buffered < want and not self._eof:
                    chunk = self._decoder.decode_planar(self._buffer_frames)
                    if chunk.shape[1] > 0:
                        self._chunks.append(chunk)
                        self._buffered += chunk.shape[1]
                        filled = True
                    elif self._loop:
                        # Gapless loop: rewind and keep filling (:186-223).
                        self._decoder.try_rewind()
                        filled = True
                    else:
                        self._eof = True
            if not filled:
                # Nothing to do until a pull, play, stop, seek, a loop change
                # or dispose sets the event: an idle decoder thread takes no
                # CPU. (A 10 ms poll in every idle stream node of every live
                # context took the GIL from a realtime render thread often
                # enough to stall its launches by tens of ms.)
                self._wake.wait()

    def _pull(self, frames: int) -> np.ndarray:
        """Take up to ``frames`` decoded frames (synchronous decode fallback
        keeps faster-than-realtime offline renders fed)."""
        parts = []
        got = 0
        with self._lock:
            while got < frames:
                if not self._chunks:
                    if self._eof and not self._loop:
                        break
                    chunk = self._decoder.decode_planar(self._buffer_frames)
                    if chunk.shape[1] == 0:
                        if self._loop:
                            self._decoder.try_rewind()
                            continue
                        self._eof = True
                        break
                    parts.append(chunk)
                    got += chunk.shape[1]
                    continue
                chunk = self._chunks.pop(0)
                self._buffered -= chunk.shape[1]
                parts.append(chunk)
                got += chunk.shape[1]
        self._wake.set()
        if not parts:
            return np.zeros((self._decoder.channels, 0), np.float32)
        data = np.concatenate(parts, axis=1)
        if data.shape[1] > frames:
            # Put the overshoot back in front of the queue.
            with self._lock:
                self._chunks.insert(0, data[:, frames:])
                self._buffered += data.shape[1] - frames
            data = data[:, :frames]
        return data

    # -- feed staging (called by the context at render boundaries) -----------------

    def _unity(self) -> bool:
        return (
            self._decoder.sample_rate == self.context.sample_rate
            and not self.playback_rate.touched
        )

    def prepare_feed(self, total_out_frames: int) -> np.ndarray:
        C = self._decoder.channels
        if self._state != StreamState.PLAYING:
            n = _FEED_BUCKET * (-(-max(total_out_frames, 1) // _FEED_BUCKET))
            feed = np.zeros((C, n), np.float32)
            self.context.update_node_state(self, x0=1.0, rate=1.0)
            self._call_read = None if self._unity() else (1.0, 1.0)
            return feed

        if self._unity():
            need = total_out_frames
            fresh = self._pull(max(0, need - self._pending.shape[1]))
            data = np.concatenate([self._pending, fresh], axis=1)
            out, rest = data[:, :need], data[:, need:]
            self._pending = rest
            if out.shape[1] < need:
                out = np.pad(out, ((0, 0), (0, need - out.shape[1])))
                if self._eof and not self._loop and self._pending.shape[1] == 0:
                    self._state = StreamState.STOPPED
            n = _FEED_BUCKET * (-(-max(need, 1) // _FEED_BUCKET))
            feed = np.zeros((C, n), np.float32)
            feed[:, :need] = out
            self.context.update_node_state(self, x0=0.0, rate=1.0)
            self._call_read = None
            return feed

        # Automation evaluated at the call boundary (the reference reads the
        # k-rate curve per block, AudioStreamSourceNodeBase.cs:211; feeds
        # stage per render call, so the rate holds for the call — the
        # documented call-granularity deviation for stream nodes).
        rate = (
            self._decoder.sample_rate / self.context.sample_rate
        ) * float(self.playback_rate.value_at_time(self.context.current_time))
        x0 = self._next_x0
        x_end = x0 + total_out_frames * rate
        need = int(math.ceil(x_end)) + 2  # last tap = floor(x)+2
        fresh = self._pull(max(0, need - self._pending.shape[1]))
        data = np.concatenate([self._pending, fresh], axis=1)
        starved = data.shape[1] < need
        if starved:
            data = np.pad(data, ((0, 0), (0, need - data.shape[1])))
            if self._eof and not self._loop:
                self._state = StreamState.STOPPED
        n = _FEED_BUCKET * (-(-need // _FEED_BUCKET))
        feed = np.zeros((C, n), np.float32)
        feed[:, : data.shape[1]] = data[:, :n]

        consumed = max(0, int(math.floor(x_end)) - 3)  # keep 4-tap history
        self._pending = data[:, consumed:need] if not starved else np.zeros(
            (C, 0), np.float32
        )
        self._next_x0 = x_end - consumed if not starved else 1.0
        self.context.update_node_state(self, x0=x0, rate=rate)
        self._call_read = (x0, rate)
        return feed

    def read_feed(self, feed, n_steps: int, S: int):
        """Every step's frames of the call from its staged ``feed`` (f32[C,
        N] on the render device), f32[n_steps, C, S*128]: one K15 launch on
        the card, the plain read on the CPU. The mode and the resampler's
        x0 and rate are the ones ``prepare_feed`` staged the call with, so
        a playbackRate touched mid-call takes effect at the next call."""
        if self._call_read is None:
            return stream_feed_call(feed, n_steps, S)
        return stream_feed_call(feed, n_steps, S, *self._call_read)

    # -- kernel -----------------------------------------------------------------

    def init_state(self, info):
        return {"x0": np.float64(1.0), "rate": np.float64(1.0)}

    def process(self, state, inputs, params, rc):
        """The step's frames: its row of the call's read (``read_feed``), a
        contiguous [C, T] view. The state is the call's x0 and rate, which
        that read used."""
        read = rc.feeds[str(self.node_id)]  # [n_steps, C, T]
        row = (rc.frame0 - rc.feeds["__base__"]) // read.shape[2]
        return state, [read[row]]

    def dispose(self) -> None:
        self._quit = True
        self._wake.set()
        self._thread.join(timeout=2.0)
        # The decoder owns a native codec handle (gac_open_*): close it or
        # every disposed streaming sound leaks native memory and (for
        # file-backed decoders) a file descriptor. Only close once the
        # decoder thread is definitely out of its read loop.
        if not self._thread.is_alive():
            try:
                self._decoder.close()
            except Exception:
                pass
        super().dispose()
