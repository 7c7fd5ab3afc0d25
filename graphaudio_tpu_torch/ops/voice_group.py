"""What the fused buffer-source group steps (K1, K5, K7) share: the packed
geometry table and the input checks of their launches.

A buffer-source group's geometry (each voice's buffer length, rate, loop
frames, region and arena offset) does not change between steps. The graph
stacks it once into a dict of [V] arrays (the plain path reads it) and
packs it once more here into one f64 table, so a step's launch passes one
pointer for it: row v holds voice v's fields in ``GEOM_FIELDS`` order (the
integers and flags exactly, as doubles), and one more row holds the group's
constants, computed in Python exactly as the plain plan computes them.
K7's table has one column more, its own: each voice's rate / sample_rate,
divided here once (numpy's f64 division is correctly rounded, as the plain
version's torch division and CUDA's ``__ddiv_rn`` are), so the kernel's
prologue does not divide.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.utils import cudabuild

#: Columns of the table, in the kernels' order (csrc/poly_resample.cu,
#: csrc/unity.cu, csrc/resample.cu).
GEOM_FIELDS = ("length", "rate", "lsf", "lef", "llen", "looping", "loop_flag",
               "region_len", "front", "off")
GEOM_COLS = len(GEOM_FIELDS)
#: Columns of K7's table: GEOM_FIELDS, then the voice's rate / sample_rate.
RESAMPLE_COLS = GEOM_COLS + 1
#: Hop of the time-varying resampler's interpolation tiles
#: (the JAX package's AudioBufferSourceNode._HOP).
RESAMPLE_HOP = 64


def resample_tile_len(bound: int) -> int:
    """Length of the time-varying resampler's tiles for a rate bound (the
    JAX package's ``AudioBufferSourceNode._tile_len``)."""
    need = FRAMES_PER_BLOCK * bound + RESAMPLE_HOP + 8
    return -(-need // RESAMPLE_HOP) * RESAMPLE_HOP


def resample_geometry(superblock: int, w: int):
    """(cap, tile, n_tiles) of the time-varying resampler's window ``w``:
    the rate clamp the window admits (audio-rate modulation has no static
    bound, so rates above it clamp to it, as in the JAX package's
    ``_process_resample``), and the tiles of the reference's banded
    interpolation, whose bands decide which taps count."""
    cap = max(1, (w - 16) // (superblock * FRAMES_PER_BLOCK))
    tile = resample_tile_len(cap)
    return cap, tile, (w - tile) // RESAMPLE_HOP + 1


def pack_group_table(geom, w: int, variant, superblock: int = 0,
                     sample_rate: float = 0.0) -> np.ndarray:
    """f64[V + 1, GEOM_COLS]: the stacked geometry ``geom`` (dict of [V]
    arrays, ``off`` included) and, in the last row, the constants of the
    kernel variant: for ("poly", p, q) p, q, p^-1 mod q, w, 1/q, 128p/q,
    127p/q and 1/p (the plan's own expressions); for ("unity", aligned) w
    and the aligned flag; for ("resample", bound) w, the rate clamp, the
    tile length, the tile count (``resample_geometry``) and the context's
    sample rate (``superblock`` and ``sample_rate`` required there), and
    one more column, f64[V + 1, RESAMPLE_COLS]: each voice's rate /
    sample_rate."""
    V = len(geom["off"])
    cols = RESAMPLE_COLS if variant[0] == "resample" else GEOM_COLS
    table = np.zeros((V + 1, cols), np.float64)
    for i, name in enumerate(GEOM_FIELDS):
        table[:V, i] = np.asarray(geom[name]).astype(np.float64)
    if variant[0] == "poly":
        p, q = variant[1:]
        pinv = pow(p, -1, q) if q > 1 else 0
        consts = [p, q, pinv, w, 1.0 / q, FRAMES_PER_BLOCK * p / q, 127.0 * p / q, 1.0 / p]
    elif variant[0] == "resample":
        consts = [w, *resample_geometry(superblock, w), float(sample_rate)]
        table[:V, GEOM_COLS] = table[:V, GEOM_FIELDS.index("rate")] / np.float64(sample_rate)
    else:
        consts = [w, 1.0 if variant[1] else 0.0]
    table[V, :len(consts)] = consts
    return table


def check_group_inputs(states, fields, arena, gtab, block_times, block_end_times,
                       cols=GEOM_COLS):
    """Raise unless a fused group step's inputs are contiguous CUDA tensors
    of the kernel's dtypes and shapes: the states named in ``fields``
    ((name, dtype) pairs) [V], gtab f64[V + 1, cols] (K7's RESAMPLE_COLS),
    the clocks f64[S], arena f32[C, W]. One combined test passes the common
    case; otherwise the failing input is named. Returns (V, S)."""
    V = gtab.shape[0] - 1
    S = block_times.shape[0]
    ok = (arena.is_cuda and arena.dtype == torch.float32 and arena.dim() == 2
          and arena.is_contiguous() and gtab.is_cuda and gtab.dtype == torch.float64
          and gtab.is_contiguous() and tuple(gtab.shape) == (V + 1, cols))
    for t in (block_times, block_end_times):
        ok = ok and t.is_cuda and t.dtype == torch.float64 and t.is_contiguous() \
            and tuple(t.shape) == (S,)
    for name, dtype in fields:
        t = states[name]
        ok = ok and t.is_cuda and t.dtype == dtype and t.is_contiguous() \
            and tuple(t.shape) == (V,)
    if ok:
        return V, S
    req = cudabuild.require
    req(arena, "arena", torch.float32, ndim=2)
    req(gtab, "gtab", torch.float64, shape=(V + 1, cols))
    req(block_times, "block_times", torch.float64, shape=(S,))
    req(block_end_times, "block_end_times", torch.float64, shape=(S,))
    for name, dtype in fields:
        req(states[name], name, dtype, shape=(V,))
    raise ValueError("the group step's inputs do not match")
