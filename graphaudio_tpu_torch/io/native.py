"""ctypes binding to the port's native codec (graphaudio_tpu_torch/native/
gacodec.cpp, a byte-identical copy of the JAX package's).

The port of graphaudio_tpu/io/native.py. Builds the shared library on
demand (g++, into graphaudio_tpu_torch/_build/, see utils/nativebuild.py) —
the moral equivalent of the reference shipping per-RID libsndfile binaries
(GraphAudio.IO/runtimes/). Falls back to None when no compiler is available;
decode.py then uses the pure-Python WAV path.
"""

from __future__ import annotations

import ctypes
import os
import threading

from graphaudio_tpu_torch.utils.nativebuild import load_or_build

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SRC = os.path.join(_NATIVE_DIR, "gacodec.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def _configure(lib) -> None:
    c = ctypes
    sigs = {
        "gac_open_file": (c.c_void_p, [c.c_char_p]),
        "gac_open_memory": (c.c_void_p, [c.c_char_p, c.c_size_t]),
        "gac_channels": (c.c_int, [c.c_void_p]),
        "gac_sample_rate": (c.c_int, [c.c_void_p]),
        "gac_frames": (c.c_int64, [c.c_void_p]),
        "gac_read_f32": (c.c_int64, [c.c_void_p, c.POINTER(c.c_float), c.c_int64]),
        "gac_seek": (c.c_int, [c.c_void_p, c.c_int64]),
        "gac_tell": (c.c_int64, [c.c_void_p]),
        "gac_close": (None, [c.c_void_p]),
        "gac_write_wav": (
            c.c_int,
            [c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_int, c.c_int],
        ),
        # Compressed codecs ride the system's mpg123/vorbis/lame libraries
        # (dlopen'd by the native layer); the gac_has_* probes report which
        # resolved on this machine.
        "gac_has_mp3": (c.c_int, []),
        "gac_has_vorbis": (c.c_int, []),
        "gac_has_mp3_encode": (c.c_int, []),
        "gac_has_vorbis_encode": (c.c_int, []),
        "gac_write_mp3": (
            c.c_int,
            [c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_int, c.c_int],
        ),
        "gac_write_ogg": (
            c.c_int,
            [c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_int, c.c_float],
        ),
        # FLAC is implemented natively (no system library).
        "gac_has_flac": (c.c_int, []),
        "gac_has_flac_encode": (c.c_int, []),
        "gac_write_flac": (
            c.c_int,
            [c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_int, c.c_int],
        ),
        # IMA/MS ADPCM decode natively; Ogg Opus via dlopen'd libogg+libopus.
        "gac_has_adpcm": (c.c_int, []),
        "gac_has_opus": (c.c_int, []),
        "gac_has_opus_encode": (c.c_int, []),
        "gac_write_opus": (
            c.c_int,
            [c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_int, c.c_int],
        ),
        # Apple Lossless (ALAC) inside CAF: native decode + encode, from the
        # published bitstream format.
        "gac_has_alac": (c.c_int, []),
        "gac_has_alac_encode": (c.c_int, []),
        "gac_write_alac": (
            c.c_int,
            [c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_int, c.c_int],
        ),
    }
    for name, (restype, argtypes) in sigs.items():
        f = getattr(lib, name)
        f.restype = restype
        f.argtypes = argtypes


def load():
    """Load (building if needed) the native codec library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = load_or_build(_SRC)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            _configure(lib)
            _lib = lib
        except OSError:
            return None
        return _lib
