"""Build-on-demand loader for the port's native C++ helpers: the codec
(``native/gacodec.cpp``) and the realtime ring and output device
(``native/garing.cpp``).

The port of graphaudio_tpu/utils/nativebuild.py. The shared objects are not
committed: each library builds with g++ into ``graphaudio_tpu_torch/_build/``
(git-ignored, beside the CUDA kernels' library) under a name derived from a
hash of its source, so the binary on disk can never be stale with respect
to the source that should have produced it. A file lock around the build
lets concurrent processes (test workers) build a library once: the first
builds, the others wait and then find it.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def _loads(so_path: str) -> bool:
    """True when the shared object resolves against THIS machine's libraries
    (dlopen is refcounted, so the caller's own CDLL afterwards is free)."""
    import ctypes

    try:
        ctypes.CDLL(so_path)
        return True
    except OSError:
        return False


def load_or_build(src_path: str, extra_flags: Optional[List[str]] = None) -> Optional[str]:
    """Return the path of an up-to-date shared object for ``src_path``.

    Builds with g++ when the hash-named artifact is missing, with
    ``extra_flags`` after the source (``-pthread`` for the ring); returns
    None when the source is absent or the build fails (callers fall back
    to pure-Python implementations: the WAV-only decoder for the codec,
    the ``threading.Condition`` ring with no output device for the ring).
    """
    if not os.path.exists(src_path):
        return None
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(src_path))[0]
    so_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if so_path.exists() and _loads(str(so_path)):
        return str(so_path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{so_path.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so_path.exists():
            # Built while this process waited; or an artifact built on
            # another machine that may reference versioned symbols this
            # machine's system libraries lack: rebuild it in place then.
            if _loads(str(so_path)):
                return str(so_path)
            so_path.unlink(missing_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
        try:
            subprocess.run(
                # Link flags after the source: with ld's --as-needed
                # default, -lfoo before the object that needs it is dropped.
                ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), src_path,
                 *(extra_flags or [])],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, so_path)  # atomic: no reader sees half a file
        except Exception:
            tmp.unlink(missing_ok=True)
            return None
    return str(so_path)
