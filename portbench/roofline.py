"""The card's peaks and a kernel's share of its roofline.

A kernel's roofline time is the larger of the bytes it must move over the
HBM rate and its operations over the f32 rate (NVIDIA H100 SXM data
sheet, dense, at the 700 W limit; the card's name and power limit are
recorded beside every run in ``PERF.md``). The share is that time over the
kernel's mean device time a launch in the traced sub-window, in percent.
Each ``metrics/<kernel>_roofline.py`` counts its kernel's bytes (each
input byte read once, each output byte written once) and operations at the
cell's shapes.
"""

from __future__ import annotations

from portbench import devtrace

HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12


def bound_s(moved_bytes: float, ops: float) -> float:
    """The least time the card could take for the work."""
    return max(moved_bytes / HBM_BYTES_S, ops / F32_FLOPS)


def share(rec, kernel: str, work):
    """``kernel``'s share of its roofline, in percent, in the record's
    traced sub-window: ``work(cfg, superblock)`` gives (bytes, operations)
    a launch. None where the trace holds no launch of it."""
    if rec.trace is None:
        return None
    timed = devtrace.kernel_time(rec.trace, kernel)
    if timed is None:
        return None
    _, mean_s = timed
    moved, ops = work(rec.cfg, rec.superblock)
    return 100.0 * bound_s(moved, ops) / mean_s


def conv_geometry(superblock: int, ir_frames: int):
    """(L, P, NB): sub-blocks a step, IR partitions and spectrum bins of a
    ConvolverNode's partitioned convolution at a superblock: the 128-frame
    grain below 1024 frames a step, else the largest multiple of 128
    dividing the step up to 1024 (at least 512, or the whole step), as the
    node chooses it (graphaudio_tpu_torch/nodes/convolver.py
    ``_grain_for``)."""
    T = superblock * 128
    if T < 1024:
        grain = 128
    else:
        grain = T
        b = min(1024, T) - min(1024, T) % 128
        while b >= 512:
            if T % b == 0:
                grain = b
                break
            b -= 128
    return T // grain, -(-ir_frames // grain), grain + 1
