"""AudioDecoder: file/stream decoding to PlayableAudioBuffers.

The port of graphaudio_tpu/io/decode.py (host code, copied with its imports
swapped); the native codec is the port's own copy,
graphaudio_tpu_torch/native/gacodec.cpp.

Parity: GraphAudio.IO/LibsndfileDecoder.cs — properties Duration/SampleRate/
Channels (:63-68), interleaved ``decode`` (:73-83), planar ``decode_planar``
(:92-160), ``try_seek``/``try_rewind`` (:167-181), and the static loaders
``load_from_file``/``load_from_bytes`` -> PlayableAudioBuffer (:186-234).

Backend: the native C++ codec (io/native.py); pure-Python RIFF/WAVE fallback
(stdlib struct/numpy) when the native library is unavailable.
"""

from __future__ import annotations

import ctypes
import io as _io
import os
import struct
from typing import Optional

import numpy as np

from graphaudio_tpu_torch.core.buffer import PlayableAudioBuffer
from graphaudio_tpu_torch.io import native


class _PyWavReader:
    """Minimal pure-Python RIFF/WAVE reader (PCM u8/s16/s24/s32, f32/f64)."""

    def __init__(self, data: bytes):
        if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        pos = 12
        fmt = None
        self._data_off = None
        self._data_len = 0
        while pos + 8 <= len(data):
            cid = data[pos : pos + 4]
            size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
            body = pos + 8
            if cid == b"fmt ":
                fmt = data[body : body + size]
            elif cid == b"data":
                self._data_off = body
                self._data_len = min(size, len(data) - body)
            pos = body + size + (size & 1)
        if fmt is None or self._data_off is None:
            raise ValueError("malformed WAV")
        tag, self.channels, self.sample_rate = struct.unpack("<HHI", fmt[:8])
        self.bits = struct.unpack("<H", fmt[14:16])[0]
        if tag == 0xFFFE and len(fmt) >= 26:
            tag = struct.unpack("<H", fmt[24:26])[0]
        if tag not in (1, 3):
            raise ValueError(f"unsupported WAV format tag {tag}")
        self.is_float = tag == 3
        self._raw = data
        self._bpf = self.channels * (self.bits // 8)
        self.frames = self._data_len // self._bpf
        self.pos = 0

    def read(self, frames: int) -> np.ndarray:
        frames = min(frames, self.frames - self.pos)
        if frames <= 0:
            return np.zeros((0, self.channels), np.float32)
        start = self._data_off + self.pos * self._bpf
        raw = self._raw[start : start + frames * self._bpf]
        self.pos += frames
        if self.is_float:
            dt = np.float32 if self.bits == 32 else np.float64
            arr = np.frombuffer(raw, dt).astype(np.float32)
        elif self.bits == 8:
            arr = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif self.bits == 16:
            arr = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif self.bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            v = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            arr = v.astype(np.float32) / 8388608.0
        elif self.bits == 32:
            arr = (np.frombuffer(raw, np.int32).astype(np.float64) / 2147483648.0).astype(np.float32)
        else:
            raise ValueError(f"unsupported bit depth {self.bits}")
        return arr.reshape(-1, self.channels)

    def seek(self, frame: int) -> None:
        self.pos = int(np.clip(frame, 0, self.frames))


class AudioDecoder:
    """Decode an audio file/stream to float32 frames.

    Accepts a path, raw bytes, or a binary file-like object. The underlying
    decode runs in native code when available (gacodec), mirroring the
    reference's P/Invoke into libsndfile.
    """

    def __init__(self, source):
        self._handle = None
        self._py = None
        self._keepalive = None

        lib = native.load()
        if isinstance(source, (str, os.PathLike)):
            path = os.fspath(source)
            if lib is not None:
                self._lib = lib
                self._handle = lib.gac_open_file(path.encode())
            if self._handle is None:
                with open(path, "rb") as f:
                    self._py = _PyWavReader(f.read())
        else:
            data = source if isinstance(source, (bytes, bytearray)) else source.read()
            data = bytes(data)
            if lib is not None:
                self._lib = lib
                self._keepalive = data  # the native decoder reads from this
                buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
                self._keepalive = buf
                self._handle = lib.gac_open_memory(
                    ctypes.cast(buf, ctypes.c_char_p), len(data)
                )
            if self._handle is None:
                self._py = _PyWavReader(data)

        if self._handle is not None:
            self.channels = self._lib.gac_channels(self._handle)
            self.sample_rate = self._lib.gac_sample_rate(self._handle)
            self.frames = int(self._lib.gac_frames(self._handle))
        else:
            self.channels = self._py.channels
            self.sample_rate = self._py.sample_rate
            self.frames = self._py.frames

    @property
    def duration(self) -> float:
        """Total duration in seconds (parity: AudioDecoder.Duration)."""
        return self.frames / self.sample_rate

    def decode(self, frames: int) -> np.ndarray:
        """Read up to ``frames`` interleaved frames -> f32[n, channels]."""
        if self._handle is not None:
            out = np.zeros((frames, self.channels), np.float32)
            n = self._lib.gac_read_f32(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frames,
            )
            return out[: int(n)]
        return self._py.read(frames)

    def decode_planar(self, frames: int) -> np.ndarray:
        """Read up to ``frames`` frames -> planar f32[channels, n]
        (parity: DecodePlanar, LibsndfileDecoder.cs:92-160)."""
        return np.ascontiguousarray(self.decode(frames).T)

    def decode_short(self, frames: int) -> np.ndarray:
        """Read up to ``frames`` interleaved frames -> int16[n, channels]
        (parity: the reference's sf_readf_short binding,
        GraphAudio.IO/Libsndfile.cs:26-68).

        Conversion is the exact inverse of this decoder's f32
        normalization (round(x*32768), clipped at +32767): sources stored
        as <=16-bit integer PCM — including G.711 and ADPCM, which expand
        to int16 — round-trip BIT-EXACTLY to their stored samples. Float
        and >16-bit sources quantize at int16 precision."""
        x = self.decode(frames)
        return np.clip(
            np.round(x.astype(np.float64) * 32768.0), -32768, 32767
        ).astype(np.int16)

    def decode_planar_short(self, frames: int) -> np.ndarray:
        """int16 planar [channels, n] (see decode_short)."""
        return np.ascontiguousarray(self.decode_short(frames).T)

    def try_seek(self, seconds: float) -> bool:
        """Parity: TrySeek (:167-175)."""
        frame = int(seconds * self.sample_rate)
        if self._handle is not None:
            return self._lib.gac_seek(self._handle, frame) == 0
        self._py.seek(frame)
        return True

    def try_rewind(self) -> bool:
        """Parity: TryRewind (:177-181)."""
        return self.try_seek(0.0)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.gac_close(self._handle)
            self._handle = None
        self._py = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- static loaders (parity: LoadFromFile/LoadFromStream, :186-234) -------

    @staticmethod
    def load_from_file(path) -> PlayableAudioBuffer:
        with AudioDecoder(path) as dec:
            planar = dec.decode_planar(dec.frames)
            return PlayableAudioBuffer.from_channel_arrays(
                [planar[c] for c in range(dec.channels)], dec.sample_rate
            )

    @staticmethod
    def load_from_bytes(data) -> PlayableAudioBuffer:
        with AudioDecoder(data) as dec:
            planar = dec.decode_planar(dec.frames)
            return PlayableAudioBuffer.from_channel_arrays(
                [planar[c] for c in range(dec.channels)], dec.sample_rate
            )

    load_from_stream = load_from_bytes

    @staticmethod
    async def load_from_file_async(path) -> PlayableAudioBuffer:
        """Awaitable decode — runs off-thread (parity: LoadFromFileAsync,
        LibsndfileDecoder.cs:186-210)."""
        import asyncio

        return await asyncio.to_thread(AudioDecoder.load_from_file, path)

    @staticmethod
    async def load_from_bytes_async(data) -> PlayableAudioBuffer:
        """Awaitable decode (parity: LoadFromStreamAsync,
        LibsndfileDecoder.cs:212-234)."""
        import asyncio

        return await asyncio.to_thread(AudioDecoder.load_from_bytes, data)

    load_from_stream_async = load_from_bytes_async


def write_wav(path, data: np.ndarray, sample_rate: int, float32: bool = False) -> None:
    """Write planar f32[channels, n] audio as a WAV file (native encoder,
    Python fallback)."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None]
    inter = np.ascontiguousarray(data.T).reshape(-1)
    lib = native.load()
    if lib is not None:
        r = lib.gac_write_wav(
            os.fspath(path).encode(),
            inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            data.shape[1],
            data.shape[0],
            int(sample_rate),
            3 if float32 else 1,
        )
        if r == 0:
            return
        raise IOError(
            f"native WAV encoder failed (code {r}) writing {path!r}"
        )
    if float32:
        # Pure-Python WAVE_FORMAT_IEEE_FLOAT writer: the wave module only
        # does integer PCM, and silently quantizing a requested-lossless
        # f32 file would make output depend on whether g++ was available.
        import struct

        payload = inter.astype("<f4").tobytes()
        ch, sr = data.shape[0], int(sample_rate)
        hdr = b"".join([
            b"RIFF", struct.pack("<I", 4 + 28 + 12 + 8 + len(payload)),
            b"WAVE",
            # fmt size 18: WAVE_FORMAT_IEEE_FLOAT carries cbSize=0
            b"fmt ", struct.pack("<IHHIIHHH", 18, 3, ch, sr, sr * ch * 4,
                                 ch * 4, 32, 0),
            b"fact", struct.pack("<II", 4, data.shape[1]),
            b"data", struct.pack("<I", len(payload)),
        ])
        with open(os.fspath(path), "wb") as f:
            f.write(hdr + payload)
        return
    import wave

    with wave.open(os.fspath(path), "wb") as w:
        w.setnchannels(data.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        pcm = np.clip(
            np.round(inter * 32767.0), -32768, 32767
        ).astype(np.int16)
        w.writeframes(pcm.tobytes())


def _quantize_pcm16(data: np.ndarray) -> np.ndarray:
    return np.clip(
        np.round(np.asarray(data, np.float64) * 32767.0), -32768, 32767
    ).astype(np.int16)


def _planar(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, np.float32)
    return data[None] if data.ndim == 1 else data


def write_aiff(path, data: np.ndarray, sample_rate: int) -> None:
    """Write planar f32[channels, n] as AIFF (big-endian PCM16, COMM with
    the 80-bit extended sample rate + SSND — the layout gacodec's
    parse_aiff reads; parity: the reference's libsndfile SF_FORMAT_AIFF)."""
    import struct

    data = _planar(data)
    ch, n = data.shape
    pcm = _quantize_pcm16(np.ascontiguousarray(data.T).reshape(-1))
    payload = pcm.astype(">i2").tobytes()
    # 80-bit IEEE extended sample rate (AIFF COMM field).
    sr = float(sample_rate)
    import math

    m, e = math.frexp(sr)
    ext = struct.pack(">HQ", e + 16382, int(m * (1 << 64)))
    comm = struct.pack(">HIH", ch, n, 16) + ext
    ssnd = struct.pack(">II", 0, 0) + payload
    body = (
        b"COMM" + struct.pack(">I", len(comm)) + comm
        + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
        + (b"\x00" if len(ssnd) & 1 else b"")
    )
    with open(os.fspath(path), "wb") as f:
        f.write(b"FORM" + struct.pack(">I", 4 + len(body)) + b"AIFF" + body)


def write_au(path, data: np.ndarray, sample_rate: int,
             float32: bool = False) -> None:
    """Write planar f32[channels, n] as Sun/NeXT AU (.au/.snd): 24-byte
    big-endian header + BE PCM16 (or BE float32) payload (gacodec's
    parse_au encodings 3/6)."""
    import struct

    data = _planar(data)
    ch, n = data.shape
    inter = np.ascontiguousarray(data.T).reshape(-1)
    if float32:
        payload = inter.astype(">f4").tobytes()
        enc = 6
    else:
        payload = _quantize_pcm16(inter).astype(">i2").tobytes()
        enc = 3
    hdr = struct.pack(
        ">4sIIIII", b".snd", 24, len(payload), enc, int(sample_rate), ch
    )
    with open(os.fspath(path), "wb") as f:
        f.write(hdr + payload)


def write_caf(path, data: np.ndarray, sample_rate: int,
              float32: bool = True) -> None:
    """Write planar f32[channels, n] as Core Audio Format LPCM (caff v1 +
    desc + data with edit count — the layout gacodec's parse_caf reads).
    Default float32 keeps the write lossless; ``float32=False`` packs
    little-endian PCM16."""
    import struct

    data = _planar(data)
    ch, n = data.shape
    inter = np.ascontiguousarray(data.T).reshape(-1)
    if float32:
        payload = inter.astype("<f4").tobytes()
        flags, bits = 1 | 2, 32  # float + little-endian
    else:
        payload = _quantize_pcm16(inter).astype("<i2").tobytes()
        flags, bits = 2, 16
    bpf = ch * bits // 8
    desc = struct.pack(
        ">d4sIIIII", float(sample_rate), b"lpcm", flags, bpf, 1, ch, bits
    )
    body = (
        b"desc" + struct.pack(">q", len(desc)) + desc
        + b"data" + struct.pack(">q", 4 + len(payload))
        + struct.pack(">I", 0)  # edit count
        + payload
    )
    with open(os.fspath(path), "wb") as f:
        f.write(b"caff" + struct.pack(">HH", 1, 0) + body)


def codec_capabilities() -> dict:
    """Which compressed codecs resolved on this machine.

    WAV/AIFF always decode (native parser + pure-Python fallback); MP3 and
    Ogg/Vorbis ride the system's libmpg123/libvorbisfile via the native
    layer (parity: the reference fails open when its shipped libsndfile is
    missing a format)."""
    lib = native.load()
    # Container ENCODERS are self-contained (pure-Python headers + PCM
    # payloads) and never depend on the native layer or system codecs.
    always = {"wav_encode": True, "aiff_encode": True, "au_encode": True,
              "caf_encode": True}
    if lib is None:
        return {"wav": True, "aiff": False, "au": False, "caf": False,
                "mp3": False, "ogg": False,
                "flac": False, "adpcm": False, "opus": False,
                "alac": False,
                "mp3_encode": False, "ogg_encode": False,
                "flac_encode": False, "opus_encode": False,
                "alac_encode": False, **always}
    return {
        "wav": True,
        "aiff": True,
        "au": True,
        "caf": True,
        **always,
        "mp3": bool(lib.gac_has_mp3()),
        "ogg": bool(lib.gac_has_vorbis()),
        "flac": bool(lib.gac_has_flac()),
        "adpcm": bool(lib.gac_has_adpcm()),
        "opus": bool(lib.gac_has_opus()),
        "alac": bool(lib.gac_has_alac()),
        "mp3_encode": bool(lib.gac_has_mp3_encode()),
        "ogg_encode": bool(lib.gac_has_vorbis_encode()),
        "flac_encode": bool(lib.gac_has_flac_encode()),
        "opus_encode": bool(lib.gac_has_opus_encode()),
        "alac_encode": bool(lib.gac_has_alac_encode()),
    }


def _interleave(data: np.ndarray):
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None]
    return data, np.ascontiguousarray(data.T).reshape(-1)


def write_mp3(path, data: np.ndarray, sample_rate: int, bitrate_kbps: int = 192) -> None:
    """Encode planar f32[channels, n] audio as MP3 (system libmp3lame).

    Raises RuntimeError when the encoder is unavailable."""
    data, inter = _interleave(data)
    lib = native.load()
    if lib is None or not lib.gac_has_mp3_encode():
        raise RuntimeError("MP3 encoding unavailable (libmp3lame not found)")
    r = lib.gac_write_mp3(
        os.fspath(path).encode(),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[1], data.shape[0], int(sample_rate), int(bitrate_kbps),
    )
    if r != 0:
        raise RuntimeError("MP3 encoding failed")


def write_flac(path, data: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Encode planar f32[channels, n] audio as FLAC (native encoder: fixed
    predictors + Rice coding; 16- or 24-bit). Lossless at the chosen bit
    depth. Parity surface: libsndfile SF_FORMAT_FLAC
    (GraphAudio.IO/Libsndfile.cs format table)."""
    data, inter = _interleave(data)
    lib = native.load()
    if lib is None:
        raise RuntimeError("FLAC encoding unavailable (native codec not built)")
    r = lib.gac_write_flac(
        os.fspath(path).encode(),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[1], data.shape[0], int(sample_rate), int(bits),
    )
    if r != 0:
        raise RuntimeError("FLAC encoding failed")


def write_alac(path, data: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Encode planar f32[channels, n] audio as Apple Lossless inside a CAF
    container (native encoder; 16- or 24-bit; 1-8 channels). Lossless at the
    chosen bit depth. Parity surface: libsndfile's caf/alac path
    (GraphAudio.IO/Libsndfile.cs:26-68 format table)."""
    data, inter = _interleave(data)
    lib = native.load()
    if lib is None:
        raise RuntimeError("ALAC encoding unavailable (native codec not built)")
    r = lib.gac_write_alac(
        os.fspath(path).encode(),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[1], data.shape[0], int(sample_rate), int(bits),
    )
    if r != 0:
        raise RuntimeError("ALAC encoding failed")


def write_opus(path, data: np.ndarray, sample_rate: int,
               bitrate_bps: int = 96000) -> None:
    """Encode planar f32[channels, n] audio as Ogg Opus (RFC 7845; system
    libopus + libogg, both dlopen'd). ``sample_rate`` must be an Opus native
    rate (8/12/16/24/48 kHz); decoding always yields 48 kHz. Parity surface:
    libsndfile SF_FORMAT_OPUS (GraphAudio.IO/Libsndfile.cs format table)."""
    data, inter = _interleave(data)
    lib = native.load()
    if lib is None or not lib.gac_has_opus_encode():
        raise RuntimeError("Opus encoding unavailable (libopus/libogg not found)")
    r = lib.gac_write_opus(
        os.fspath(path).encode(),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[1], data.shape[0], int(sample_rate), int(bitrate_bps),
    )
    if r != 0:
        raise RuntimeError("Opus encoding failed")


def write_ogg(path, data: np.ndarray, sample_rate: int, quality: float = 0.5) -> None:
    """Encode planar f32[channels, n] audio as Ogg/Vorbis (system libvorbisenc).

    Raises RuntimeError when the encoder is unavailable."""
    data, inter = _interleave(data)
    lib = native.load()
    if lib is None or not lib.gac_has_vorbis_encode():
        raise RuntimeError("Ogg encoding unavailable (libvorbisenc not found)")
    r = lib.gac_write_ogg(
        os.fspath(path).encode(),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[1], data.shape[0], int(sample_rate), float(quality),
    )
    if r != 0:
        raise RuntimeError("Ogg encoding failed")
