"""Build and load the port's hand-written CUDA kernels.

The sources are ``graphaudio_tpu_torch/csrc/*.cu``. Each is compiled with
``nvcc`` for Hopper (``sm_90a``) into an object file, all at once in
parallel, and the objects are linked into ONE shared library with a plain C
interface, loaded with ``ctypes``; the build needs no PyTorch headers, so
it takes seconds, not minutes. It runs at first use, into
``graphaudio_tpu_torch/_build/`` (git-ignored), and is keyed by a hash of
the sources and flags, so a fresh checkout builds everything on its first
CUDA render and later processes reuse the library.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# C signature of every exported launcher (all return the cudaError_t of the
# launch as an int).
_SIGNATURES = {
    # arena, W, C, V, S, gtab, 8 states, clocks, wtab, btab, outputs, stream
    "ga_poly_group_step": [_P, _I64, _I, _I, _I, _P, *[_P] * 8, _P, _P, _P, _P,
                           _P, _P, _P, _P],
    # arena, W, C, V, S, gtab, 8 states, rates, rates a row?, clocks,
    # outputs, stream
    "ga_resample_group_step": [_P, _I64, _I, _I, _I, _P, *[_P] * 8, _P, _I, _P, _P, _P, _P,
                               _P, _P],
    "ga_conv_mac": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                    _I, _I, _I, _I, _P],
    # X, hr, hi, ring_r, ring_i, acc, K, L, P_local, NB, R, head, rev, p0, stream
    "ga_conv_mac_slice": [*[_P] * 6, *[_I] * 8, _P],
    # yfull, overlap, y, K, C, L, B, host combine map, stream
    "ga_conv_ola": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "ga_fan_in": [_P, _P, _I, _I, _I, _I64, _I, ctypes.c_float, _P],
    "ga_pack_int16": [_P, _P, _I, _I64, _P],
    # x, out, C, T, then ops/wire.MulawPlan: variant, vec, V, tail, threads,
    # blocks, shared bytes; stream
    "ga_pack_mulaw": [_P, _P, _I, _I64, _I, _I, _I, _I64, _I, _I, _I, _P],
    # audio, carry, C, F, spb, carry_len, ncap, blocks a thread block, thread
    # blocks a channel, stage bytes, streamed?, blocks, new carry, stream
    "ga_ima_chunk_encode": [_P, _P, _I, _I64, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # arena, W, C, V, S, gtab, 6 states, clocks, outputs, stream
    "ga_unity_group_step": [_P, _I64, _I, _I, _I, _P, *[_P] * 6, _P, _P, _P, _P, _P],
    "ga_param_eval_batch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            ctypes.c_double, _P, _P],
    # intr, per-sample rows?, mod, V, Cm, T, L, npb, down-mix scale, lo, hi, out, stream
    "ga_apply_modulation": [_P, _I, _P, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float,
                            ctypes.c_float, _P, _P],
    # f, per-sample?, started, start, stop, phase, clocks, L, S, sr, 128/sr,
    # fl32(2pi/sr), 2pi/sr, wave, out, new phase, stream
    "ga_oscillator_step": [_P, _I, _P, _P, _P, _P, _P, _I, _I, ctypes.c_double,
                           ctypes.c_double, ctypes.c_float, ctypes.c_double, _I, _P, _P, _P],
    # offset, per-sample?, started, start, stop, clocks, L, S, sr, out, stream
    "ga_constant_step": [_P, _I, _P, _P, _P, _P, _I, _I, ctypes.c_double, _P, _P],
    "ga_biquad_coeffs_batch": [_P, _P, _P, _P, _P, _I, _I, ctypes.c_float, ctypes.c_float,
                               _P, _P, _P],
    "ga_biquad_cascade": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P, _P, _P, _P],
    "ga_first_order_tb": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
    "ga_hrtf_fir": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    ctypes.c_float, ctypes.c_float, _I, _P, _P, _P, _P],
    "ga_hrtf_fir_rows": [_P, _P, _I, _I, _I, _P, _P],
    # X, hx, haz, hel, az, el, spectra r/i, V, S, P, E, A, c_az, c_el, quanta
    # a block, acc, next hx, haz, hel, stream
    "ga_hrtf_part_mac": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         ctypes.c_float, ctypes.c_float, _I, _P, _P, _P, _P, _P],
    # X, hx, haz, hel, az, el, spectra r/i (the slice), V, S, P, P_local,
    # p_base, E, A, c_az, c_el, acc, next hx, haz, hel, stream
    "ga_hrtf_part_mac_slice": [*[_P] * 8, *[_I] * 7, ctypes.c_float, ctypes.c_float,
                               _P, _P, _P, _P, _P],
    # x, gain, V, C, S, out, stream
    "ga_hrtf_part_input": [_P, _P, _I, _I, _I, _P, _P],
    # y (unscaled), ola, x, gain, blend, V, C, S, out, next ola, stream
    "ga_hrtf_part_ola": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # src, consts, S, listener pos/right/up/ahead, out, host plan words, stream
    "ga_spatial_gains_batch": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    # x, its channel and frame strides, delay times, a row?, ring, R, slot
    # cursor copies and their count (one a block: the grid), write cursor,
    # C, T, L, sr, out, stream
    "ga_delay_step": [_P, _I64, _I64, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, ctypes.c_float,
                      _P, _P],
    # x, V, C, pan, a row a lane?, T, out, stream
    "ga_stereo_pan": [_P, _I, _I, _P, _I, _I, _P, _P],
    # feed, C, N, n_steps, S, x0, rate (the stage's f64 state; ignored for
    # unity), resample?, out, stream
    "ga_stream_feed_call": [_P, _I, _I, _I, _I, ctypes.c_double, ctypes.c_double, _I, _P, _P],
    # x, y0 low/high, a low, a^16 low, a high, a^16 high, gl, gm, gh, rows,
    # C, T, split, out, carry low/high, stream
    "ga_onepole_split": [_P, _P, _P, *[ctypes.c_double] * 4, _P, _P, _P, _I, _I, _I, _I,
                         _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None

#: Kernel launches by wrapper name. Each wrapper adds one where it launches
#: its kernel and nowhere else; ``launches.clear()`` sets every count to 0.
launches = collections.Counter()


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def nvcc_path() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(Path(os.environ[env]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda/bin and PATH): "
        "the port's CUDA kernels cannot be built"
    )


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libga_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source hash is built; returns the
    library path. One ``nvcc -c`` per source runs in parallel, then one
    link. The compilers' output (``-Xptxas=-v`` register and shared-memory
    report) is kept beside the library as ``.log``."""
    target = library_path()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{target.stem}.{os.getpid()}"
    cus = [s for s in sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(cu)] for cu, o in zip(cus, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
    failed = [c[-1] for c, p in zip(cmds, procs) if p.returncode != 0]
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = ["link"]
    for o in objs:
        o.unlink(missing_ok=True)
    target.with_suffix(".log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half a file
    return target


def load():
    """The loaded kernel library (built on first call). Once it is loaded,
    no lock is taken."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ga_error_string.argtypes = [ctypes.c_int]
            lib.ga_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


@functools.cache
def launcher(name: str):
    """The exported C launcher ``name`` of the loaded library, looked up
    once."""
    return getattr(load(), name)


def check(status: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if status != 0:
        msg = load().ga_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``t``'s device, as
    an int (ctypes passes it as a ``c_void_p``). Builds no stream object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require(t, name: str, dtype, ndim: int = None, shape=None) -> None:
    """Wrapper input checks: a contiguous CUDA tensor of the given dtype
    and rank/shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
