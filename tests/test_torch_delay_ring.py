"""K12's in-place ring (graphaudio_tpu_torch/csrc/delay.cu), on the CPU.

* A numpy walk of the kernel's slot plan, thread by thread in its index
  arithmetic: over a sweep of (C, T, L, slot cursor, delays) and chained
  steps, no slot that a step reads is one that it writes, the writes fill
  exactly the min(T, L) slots from the cursor, every surviving input lands
  where the plan says, and every output is the sample d back in a plain
  linear history.
* The plain K12 (``delay_step_plain``) against the JAX
  ``DelayNode.process`` over chained steps, through ``delay_jax_view``:
  output, ring and ``wpos`` bit for bit (tolerance 0), at d = L every
  step, T < L, T = L, T >= L, T >> L, a ramp through d = 0 to past T, d =
  0, random delays, a broadcast stereo input and a row-view input.
* ``delay_state_from_jax`` with the JAX cursor at 0, mid-ring and at L - 1,
  and the node's state layout (one copy of the slot cursor for each of
  K12's blocks).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.nodes.delay import DelayNode as JaxDelay
from graphaudio_tpu_torch.core.graph import StaticRenderInfo
from graphaudio_tpu_torch.nodes.delay import (
    delay_jax_view,
    delay_state_from_jax,
    delay_step_plain,
    slot_copies,
)

SR = 48000


# ---- the slot plan, as the kernel computes it ------------------------------------------


def _walk_step(ring, c0, x, d, L):
    """One launch of delay.cu in numpy, every thread (c, i) at once, in the
    kernel's int32 index arithmetic. Returns (out, new slot cursor, the
    slots read, the slots written)."""
    C, T = x.shape
    R = ring.shape[1]
    W = R - L
    i = np.arange(T)
    s = i - d
    k = c0 + s
    read_slot = np.where(k < 0, k + R, k)
    reads = (d > 0) & (s < 0)
    out = np.where(reads, ring[:, np.where(reads, read_slot, 0)], 0.0)
    out = np.where((d > 0) & (s >= 0), x[:, np.clip(s, 0, T - 1)], out).astype(np.float32)
    m = i - (T - W)
    kw = c0 + m
    write_slot = np.where(kw >= R, kw - R, kw)
    writes = m >= 0
    ring[:, write_slot[writes]] = x[:, writes]
    new_c = c0 + W - R if c0 + W >= R else c0 + W
    return out, new_c, read_slot[reads], write_slot[writes]


_PLAN_SHAPES = [(128, 5), (128, 127), (128, 128), (128, 129), (256, 96), (128, 1000),
                (384, 100), (256, 600)]


@pytest.mark.parametrize("T,L", _PLAN_SHAPES, ids=[f"T{t}-L{l}" for t, l in _PLAN_SHAPES])
def test_slot_plan_reads_never_meet_writes(T, L):
    rng = np.random.default_rng(T * 7919 + L)
    W = min(T, L)
    R = L + W
    delays = {"L": np.full(T, L), "zero": np.zeros(T, int), "one": np.ones(T, int),
              "T": np.full(T, min(T, L)), "T-1": np.full(T, min(T - 1, L)),
              "ramp": np.minimum(np.arange(T) * (L + T) // T, L),
              "random": rng.integers(0, L + 1, T)}
    for name, d in delays.items():
        for c0 in sorted({0, 1, W - 1, L - 1, R - 1, int(rng.integers(0, R))}):
            C = 1 + (c0 % 2)
            # a linear history: L samples before the first step, then each
            # step's input; the ring starts holding those L samples
            hist = rng.standard_normal((C, L)).astype(np.float32)
            ring = np.full((C, R), np.nan, np.float32)
            ring[:, (c0 - L + np.arange(L)) % R] = hist
            c = c0
            for step in range(3):
                x = rng.standard_normal((C, T)).astype(np.float32)
                out, c_new, read, written = _walk_step(ring, c, x, d, L)
                where = f"{name}, cursor {c0}, step {step}"
                assert not np.intersect1d(read, written).size, where
                assert read.size == 0 or (read.min() >= 0 and read.max() < R), where
                np.testing.assert_array_equal(np.sort(written), np.sort((c + np.arange(W)) % R),
                                              err_msg=where)
                assert c_new == (c + W) % R, where
                full = np.concatenate([hist, x], axis=1)
                want = np.where(d > 0, full[:, hist.shape[1] + np.arange(T) - d], 0.0)
                np.testing.assert_array_equal(out, want, err_msg=where)
                hist = full
                # each sample k back sits in slot (cursor - k) mod R
                back = np.arange(1, L + 1)
                np.testing.assert_array_equal(ring[:, (c_new - back) % R], hist[:, -back],
                                              err_msg=where)
                c = c_new


# ---- the plain K12 against the JAX node, chained -----------------------------------------


class _Signal:
    def __init__(self, values):
        self._values = values

    def per_sample(self):
        return self._values


def _delay_times(rng, kind, T, L, step):
    """f32[T] delay times in seconds whose samples trunc(dt * sr) are as
    ``kind`` says."""
    if kind == "L":
        v = np.float32(L / SR)
        while int(v * np.float32(SR)) < L:
            v = np.nextafter(v, np.float32(1.0))
        return np.full(T, v, np.float32)
    if kind == "zero":
        return np.zeros(T, np.float32)
    if kind == "random":
        return (rng.integers(0, L + 1, T) / SR).astype(np.float32)
    top = L / SR * 1.2 if kind == "ramp" else 2.5 * T / SR  # "ramp0": 0 to 2.5 T, past T
    lo = -0.1 * top if kind == "ramp0" else 0.0
    ramp = np.linspace(lo, top, T) + 0.07 * step * top
    return np.minimum(ramp, L / SR).astype(np.float32)


_CHAINS = [
    ("d=L T<L", 2, 128, 200, "L", "contiguous"),
    ("d=L T>L", 1, 256, 96, "L", "contiguous"),
    ("T<L ramp", 2, 128, 400, "ramp", "contiguous"),
    ("T=L", 1, 256, 256, "ramp", "contiguous"),
    ("T>L ramp", 2, 384, 100, "ramp", "contiguous"),
    ("T>>L", 1, 512, 5, "ramp", "contiguous"),
    ("ramp through 0 past T", 1, 128, 1000, "ramp0", "contiguous"),
    ("d=0", 2, 256, 160, "zero", "contiguous"),
    ("random d", 2, 256, 300, "random", "contiguous"),
    ("broadcast stereo", 2, 256, 600, "ramp", "broadcast"),
    ("row view", 2, 256, 600, "L", "row view"),
]


@pytest.mark.parametrize("C,T,L,kind,layout", [c[1:] for c in _CHAINS],
                         ids=[c[0] for c in _CHAINS])
def test_plain_k12_chained_against_jax(C, T, L, kind, layout):
    rng = np.random.default_rng(C * 1000 + T + L)
    jnode = JaxDelay(ga.OfflineAudioContext(sample_rate=SR, superblock=1), L / SR)
    L = jnode._max_delay_samples
    rc = types.SimpleNamespace(sample_rate=SR, frames=T)
    w = int(rng.integers(0, L))
    jst = {"ring": jnp.asarray(rng.standard_normal((C, L)).astype(np.float32)),
           "wpos": jnp.int32(w)}
    R, W = L + min(T, L), min(T, L)
    slot0 = int(rng.integers(0, R))
    st = delay_state_from_jax(jst, T, "cpu", slot=slot0)
    for step in range(5):
        if layout == "broadcast":  # a mono row up-mixed as a stride-0 view
            mono = torch.from_numpy(rng.standard_normal((1, T)).astype(np.float32))
            xt = mono.expand(C, T)
        elif layout == "row view":  # rows and a window of a wider tensor
            big = torch.from_numpy(rng.standard_normal((C + 2, T + 9)).astype(np.float32))
            xt = big[1:1 + C, 7:7 + T]
        else:
            xt = torch.from_numpy(rng.standard_normal((C, T)).astype(np.float32))
        assert (layout == "contiguous") == xt.is_contiguous()
        dt = _delay_times(rng, kind, T, L, step)
        jst, (jout,) = jnode.process(jst, [jnp.asarray(xt.numpy())],
                                     {"delayTime": _Signal(jnp.asarray(dt))}, rc)
        out = delay_step_plain(xt, torch.from_numpy(dt), st, SR, L)
        view = delay_jax_view(st, L)
        where = f"step {step}"
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout), err_msg=where)
        np.testing.assert_array_equal(view["ring"].numpy(), np.asarray(jst["ring"]),
                                      err_msg=where)
        assert int(view["wpos"]) == int(jst["wpos"]) == (w + (step + 1) * T) % L
        assert st["slot"].tolist() == [(slot0 + (step + 1) * W) % R] * st["slot"].numel()
    if kind == "L":  # d = L was exercised: every output read the ring or x at L back
        assert int(np.float32(dt[0]) * np.float32(SR)) == L


# ---- hand-off and layout ------------------------------------------------------------------


@pytest.mark.parametrize("where", ["0", "mid", "L-1"])
@pytest.mark.parametrize("T,L", [(128, 960), (256, 96)], ids=["T<L", "T>L"])
def test_state_from_jax_cursor(T, L, where):
    rng = np.random.default_rng(L + T)
    w = {"0": 0, "mid": L // 2 + 1, "L-1": L - 1}[where]
    ring = rng.standard_normal((2, L)).astype(np.float32)
    for slot in (0, 5, L + min(T, L) - 1):
        st = delay_state_from_jax({"ring": ring, "wpos": np.int32(w)}, T, "cpu", slot=slot)
        assert st["ring"].shape == (2, L + min(T, L)) and int(st["slot"][0]) == slot
        # one copy of the slot cursor for each of K12's blocks of 256 frames
        assert st["slot"].tolist() == [slot] * slot_copies(2, T) == [slot] * (2 * -(-T // 256))
        assert st["slot"].dtype == st["wpos"].dtype == torch.int32 and st["wpos"].dim() == 0
        view = delay_jax_view(st, L)
        np.testing.assert_array_equal(view["ring"].numpy(), ring)
        assert int(view["wpos"]) == w
    # then steps from the JAX cursor, against the JAX node
    jnode = JaxDelay(ga.OfflineAudioContext(sample_rate=SR, superblock=1), L / SR)
    assert jnode._max_delay_samples == L
    rc = types.SimpleNamespace(sample_rate=SR, frames=T)
    jst = {"ring": jnp.asarray(ring), "wpos": jnp.int32(w)}
    for step in range(3):
        x = rng.standard_normal((2, T)).astype(np.float32)
        dt = (rng.integers(0, L + 1, T) / SR).astype(np.float32)
        jst, (jout,) = jnode.process(jst, [jnp.asarray(x)], {"delayTime": _Signal(jnp.asarray(dt))},
                                     rc)
        out = delay_step_plain(torch.from_numpy(x), torch.from_numpy(dt), st, SR, L)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(delay_jax_view(st, L)["ring"].numpy(),
                                      np.asarray(jst["ring"]))


@pytest.mark.parametrize("superblock,max_s", [(1, 0.02), (6, 0.016), (16, 0.01)],
                         ids=["T<L", "T=L", "T>L"])
def test_node_state_layout(superblock, max_s):
    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=superblock, device="cpu")
    node = gat.DelayNode(ctx, max_delay_time=max_s)
    info = StaticRenderInfo(SR, superblock)
    st = node.init_state(info)
    L, T = node._max_delay_samples, info.frames
    assert st["ring"].shape == (2, L + min(T, L)) and st["ring"].dtype == np.float32
    assert st["slot"].dtype == st["wpos"].dtype == np.int32
    assert st["slot"].shape == (slot_copies(2, T),) == (2 * -(-T // 256),)
    assert not st["slot"].any() and int(st["wpos"]) == 0
