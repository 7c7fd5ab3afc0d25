"""K4mu's thread map and byte function (csrc/pack.cu), walked in numpy.

The kernel gives each thread V consecutive frames of every channel, one
thread a group of the T // V whole groups; the next thread writes the T
mod V tail frames.
``ops/wire.mulaw_pack_plan`` picks the instantiation (C = 1 or 2 in
registers, any other C through shared memory), vector or scalar loads (by
the base address mod 16 and T), the grid and the tail. The walk below
follows the plan thread by thread: every (frame, channel) byte must be
written exactly once, every vector load must be 16-byte aligned, and the
bytes must be ``mulaw_encode_np``'s. The kernel's exponent, 24 - clz of
the biased magnitude floored at 0, is held to the reference's count of
the 7 segment thresholds for every magnitude, and its byte function to
the JAX package's ``pack_mulaw`` over every int16 level.
"""

import numpy as np
import pytest
import torch

from graphaudio_tpu.ops import wire as jwire
from graphaudio_tpu_torch.ops import wire
from graphaudio_tpu_torch.utils import cudabuild

# the quantizer's edges: rounding ties, clipping, zero and infinities
EDGES = np.array([0.5 / 32767, -0.5 / 32767, 1.5 / 32767, -1.5 / 32767, 1.5, -7.0, 0.0,
                  np.inf, -np.inf], np.float32)


def _levels():
    """Every int16 quantization level q / 32767, q in [-32767, 32767]."""
    return np.arange(-32767, 32768, dtype=np.float32) / np.float32(32767)


def _clz32(m):
    """Leading zeros of positive int32 values (exact: frexp's exponent is
    the bit length)."""
    return 32 - np.frexp(m.astype(np.float64))[1]


def kernel_bytes(x):
    """``mulaw_byte`` of csrc/pack.cu on f32 samples, in numpy."""
    x = np.asarray(x, np.float32)
    v = np.minimum(np.maximum(x, np.float32(-1)), np.float32(1))
    q = np.rint(v * np.float32(32767)).astype(np.int32)
    sign = q.view(np.uint32) >> 31
    mag = np.minimum(np.abs(q), 32635) + 0x84
    e = np.maximum(0, 24 - _clz32(mag))
    mant = (mag >> (e + 3)) & 0xF
    return (((sign << 7) | (e << 4) | mant) ^ 0xFF).astype(np.uint8)


def test_exponent_is_24_minus_clz():
    mag = np.arange(0x84, 0x8000, dtype=np.int32)
    count = sum((mag >= (0x100 << k)).astype(np.int32) for k in range(7))
    np.testing.assert_array_equal(np.maximum(0, 24 - _clz32(mag)), count)


def test_byte_function_every_level_against_jax():
    x = np.concatenate([EDGES, _levels()])[None, :]
    want = np.asarray(jwire.pack_mulaw(x))
    np.testing.assert_array_equal(kernel_bytes(x[0]), want)
    np.testing.assert_array_equal(wire.pack_mulaw_plain(torch.from_numpy(x)).numpy(), want)


def _instantiated(plan):
    """The plan's V is csrc/pack.cu's kV, and its variant one the file
    launches."""
    src = (cudabuild.CSRC_DIR / "pack.cu").read_text()
    return (f"constexpr int kV = {plan.frames};" in src
            and f"launch_mulaw<{plan.variant}>" in src)


def walk(plan, x, offset):
    """The kernel's writes under ``plan`` for f32 [C, T] ``x`` whose base
    is ``offset`` bytes past a 16-byte boundary: (bytes, writes a byte)."""
    C, T = x.shape
    V = plan.frames
    flat = x.reshape(-1)
    out = np.zeros(C * T, np.uint8)
    writes = np.zeros(C * T, np.int64)
    groups = plan.tail // V
    g = np.arange(plan.blocks * plan.threads)  # one thread a group
    assert g.size >= -(-T // V)  # every group and the tail have a thread
    live = g[g < groups]
    j, c = np.arange(V), np.arange(C)
    t = live[:, None, None] * V + j[None, :, None]  # [groups, V, 1]
    if plan.vec:  # 16-byte loads of 4 frames a row: each one's first address aligned
        first = offset + 4 * (c[None, None, :] * T + t[:, ::4])
        assert np.all(first % 16 == 0)
    src = (c[None, None, :] * T + t).reshape(-1)  # x's flat index of (frame, channel)
    dst = (t * C + c[None, None, :]).reshape(-1)
    np.add.at(writes, dst, 1)
    out[dst] = kernel_bytes(flat[src])
    # thread ``groups``: the tail frames [tail, T), every channel
    t = np.arange(plan.tail, T)
    dst = (t[:, None] * C + c[None, :]).reshape(-1)
    np.add.at(writes, dst, 1)
    out[dst] = kernel_bytes(flat[(c[None, :] * T + t[:, None]).reshape(-1)])
    return out, writes


@pytest.mark.parametrize("residue", range(wire.MULAW_FRAMES))
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_plan_walk_writes_every_byte_once(C, offset, residue):
    rng = np.random.default_rng(100 * C + 10 * offset + residue)
    pool = np.concatenate([EDGES, rng.permutation(_levels())])
    V = wire.MULAW_FRAMES
    for k in (0, 1, 257, 600):  # 257 and 600 groups: a second and a third block
        T = k * V + residue
        if T == 0:
            continue
        x = np.resize(rng.permutation(pool), C * T).reshape(C, T)
        plan = wire.mulaw_pack_plan(C, T, offset)
        assert _instantiated(plan), plan
        assert plan.variant == (C if C <= 2 else 0)
        assert plan.vec == (offset == 0 and (C == 1 or T % 4 == 0))
        assert plan.tail == T - T % V and plan.threads % 32 == 0
        assert plan.smem == (0 if C <= 2 else plan.threads * V * C)
        out, writes = walk(plan, x, offset)
        np.testing.assert_array_equal(writes, 1)
        np.testing.assert_array_equal(out, wire.mulaw_encode_np(x))


def test_plan_many_channels():
    """Any C up to MULAW_MAX_CHANNELS goes through shared memory within 48
    KB, with fewer threads a block past 24 channels; more raise."""
    for C in (6, 24, 25, 100, wire.MULAW_MAX_CHANNELS):
        plan = wire.mulaw_pack_plan(C, 4099, 0)
        assert plan.variant == 0 and 32 <= plan.threads <= 256 and plan.smem <= 48 * 1024
        assert (plan.threads == 256) == (C <= 24) and plan.threads % 32 == 0
        if C in (6, 25):
            x = np.resize(_levels(), C * 4099).reshape(C, 4099)
            out, writes = walk(plan, x, 0)
            np.testing.assert_array_equal(writes, 1)
            np.testing.assert_array_equal(out, wire.mulaw_encode_np(x))
    with pytest.raises(ValueError, match="channels"):
        wire.mulaw_pack_plan(wire.MULAW_MAX_CHANNELS + 1, 8, 0)
