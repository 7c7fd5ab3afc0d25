"""setup_s: process start to the window's start (host clock): imports, the
CUDA context, the kernels' library (built by a checkout's first run), the
inputs, the scene's build and its warm-up calls."""


def read(rec):
    return rec.setup_s
