"""SPSC frame ring buffer over the native garing library.

The port of graphaudio_tpu/realtime/ring.py, over graphaudio_tpu_torch/
native/garing.cpp (a byte-identical copy of the JAX package's), built with
g++ into graphaudio_tpu_torch/_build/ at first use. Host code: the ring
holds host frames that the render thread copies out of pinned memory.

Parity: GraphAudio.Realtime/RingBuffer.cs — native-memory interleaved float
storage, lock-free volatile positions, split wraparound copies (:56-86), and
semaphore-based ``wait_for_space`` backpressure (:51). A pure-Python fallback
(threading.Condition) covers environments without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time

import numpy as np

from graphaudio_tpu_torch.utils.nativebuild import load_or_build

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SRC = os.path.join(_NATIVE_DIR, "garing.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def load_native():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = load_or_build(_SRC, extra_flags=["-pthread"])
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        c = ctypes
        sigs = {
            "garing_create": (c.c_void_p, [c.c_uint32, c.c_uint32]),
            "garing_destroy": (None, [c.c_void_p]),
            "garing_available_write": (c.c_uint64, [c.c_void_p]),
            "garing_available_read": (c.c_uint64, [c.c_void_p]),
            "garing_write": (c.c_uint32, [c.c_void_p, c.POINTER(c.c_float), c.c_uint32]),
            "garing_read": (c.c_uint32, [c.c_void_p, c.POINTER(c.c_float), c.c_uint32]),
            "garing_wait_space": (c.c_int, [c.c_void_p, c.c_uint32, c.c_uint32]),
            "gadev_open": (
                c.c_void_p,
                [c.c_char_p, c.c_void_p, c.c_uint32, c.c_uint32, c.c_uint32],
            ),
            "gadev_start": (None, [c.c_void_p]),
            "gadev_stop": (None, [c.c_void_p]),
            "gadev_close": (None, [c.c_void_p]),
            "gadev_frames_played": (c.c_uint64, [c.c_void_p]),
            "gadev_underruns": (c.c_uint64, [c.c_void_p]),
            "gadev_tap": (None, [c.c_void_p, c.POINTER(c.c_float)]),
            "gadev_enumerate": (c.c_int, [c.c_char_p, c.c_int, c.c_int]),
            "gadev_backend": (c.c_char_p, [c.c_void_p]),
        }
        for name, (restype, argtypes) in sigs.items():
            f = getattr(lib, name)
            f.restype = restype
            f.argtypes = argtypes
        _lib = lib
        return _lib


class RingBuffer:
    """Interleaved float32 frame ring (native when available)."""

    def __init__(self, channels: int, capacity_frames: int):
        self.channels = channels
        self.capacity = capacity_frames
        self._lib = load_native()
        # Serializes native calls against dispose(): the render thread can
        # be mid-call (or about to call) when another thread disposes the
        # context — without the lock that's a use-after-free on the native
        # Ring (garing_* take the raw pointer unchecked).
        self._hlock = threading.Lock()
        if self._lib is not None:
            self._h = self._lib.garing_create(channels, capacity_frames)
            self._native = True
        else:
            self._native = False
            self._buf = np.zeros((capacity_frames, channels), np.float32)
            self._wpos = 0
            self._rpos = 0
            self._cv = threading.Condition()

    # -- native path -----------------------------------------------------------

    @property
    def native_handle(self):
        return self._h if self._native else None

    def available_write(self) -> int:
        if self._native:
            with self._hlock:
                if self._h is None:
                    return 0
                return int(self._lib.garing_available_write(self._h))
        with self._cv:
            return self.capacity - (self._wpos - self._rpos)

    def available_read(self) -> int:
        if self._native:
            with self._hlock:
                if self._h is None:
                    return 0
                return int(self._lib.garing_available_read(self._h))
        with self._cv:
            return self._wpos - self._rpos

    def write_interleaved(self, frames: np.ndarray) -> int:
        """frames: f32[n, channels]. Returns frames written."""
        frames = np.ascontiguousarray(frames, np.float32)
        n = frames.shape[0]
        if self._native:
            with self._hlock:
                if self._h is None:
                    return 0
                return int(
                    self._lib.garing_write(
                        self._h,
                        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        n,
                    )
                )
        with self._cv:
            put = min(n, self.capacity - (self._wpos - self._rpos))
            for i in range(put):
                self._buf[(self._wpos + i) % self.capacity] = frames[i]
            self._wpos += put
            return put

    def read_interleaved(self, n: int) -> np.ndarray:
        """Read n frames (zero-filled on underrun): f32[n, channels]."""
        out = np.zeros((n, self.channels), np.float32)
        if self._native:
            with self._hlock:
                if self._h is not None:
                    self._lib.garing_read(
                        self._h,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        n,
                    )
            return out
        with self._cv:
            take = min(n, self._wpos - self._rpos)
            for i in range(take):
                out[i] = self._buf[(self._rpos + i) % self.capacity]
            self._rpos += take
            self._cv.notify_all()
            return out

    def wait_for_space(self, frames: int, timeout_ms: int = 5) -> bool:
        """Parity: RingBuffer.WaitForSpace (:51)."""
        if self._native:
            with self._hlock:
                if self._h is not None:
                    return bool(
                        self._lib.garing_wait_space(self._h, frames, timeout_ms)
                    )
            time.sleep(timeout_ms / 1000.0)  # disposed: don't busy-spin
            return False
        with self._cv:
            return self._cv.wait_for(
                lambda: self.capacity - (self._wpos - self._rpos) >= frames,
                timeout=timeout_ms / 1000.0,
            )

    def dispose(self) -> None:
        if self._native:
            with self._hlock:
                if self._h is not None:
                    self._lib.garing_destroy(self._h)
                    self._h = None
