"""Port K6 (AudioParam curve evaluation) against the JAX package.

The same encoded automation (numpy, from a seed) goes through the JAX
``eval_intrinsic_blocked`` (jitted, non-exact branch) and the port's
``eval_intrinsic_blocked`` on CPU tensors (its plain version), batched over
the lanes of a group. Events sit on block starts, on sample instants and
between samples; every curve type occurs; the capacity is padded.

Tolerance: 2.5e-7 relative plus 2.5e-7 absolute, two ulp of the O(1)
values (a curve that crosses zero keeps the absolute error of its
operands). The event index, the f32 relative times and the linear ramps
round identically; XLA's own f32 ``pow``/``exp`` and the port's
f64-rounded ones differ by an ulp or two on about 0.2 % of samples.
"""

import jax
import numpy as np
import pytest
import torch

from graphaudio_tpu.ops import param_eval as jpe
from graphaudio_tpu_torch.ops import param_eval as tpe

SR = 48000
DT = 1.0 / SR
BLOCK = 128 / SR
REL = 2.5e-7


def _events(rng, n, t_end):
    """n sorted events of every type; a third on block starts, a third on
    sample instants, the rest anywhere."""
    out = []
    for k in range(n):
        where = k % 3
        if where == 0:
            t = float(rng.integers(0, int(t_end / BLOCK))) * BLOCK
        elif where == 1:
            t = float(rng.integers(0, int(t_end * SR))) * DT
        else:
            t = float(rng.uniform(0.0, t_end))
        kind = int(rng.integers(0, 4))
        value = float(rng.uniform(0.05, 2.0)) * (1 if rng.random() > 0.1 else -1)
        out.append((kind, t, value, float(rng.uniform(0.0005, 0.02))))
    out.sort(key=lambda e: e[1])
    return out


def _encodings(seed, lanes, cap, t_end):
    rng = np.random.default_rng(seed)
    encs = []
    for lane in range(lanes):
        n = [cap, cap - 3, 1, 0][lane % 4]  # full, padded, single, none
        base = float(rng.uniform(0.1, 1.0))
        evs = _events(rng, n, t_end)
        want = jpe.encode_events(base, evs, cap)
        got = tpe.encode_events(base, evs, cap)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
        encs.append(got)
    return encs


def _clock(n_blocks):
    """The reference's accumulated block clock (context.py)."""
    return np.add.accumulate(np.full(n_blocks, BLOCK) * (np.arange(n_blocks) > 0))


_jax_eval = jax.jit(jpe.eval_intrinsic_blocked, static_argnums=(2, 3))


@pytest.mark.parametrize("npb", [128, 1], ids=["a-rate", "k-rate"])
@pytest.mark.parametrize("cap", [8, 32])
def test_matches_jax(npb, cap):
    S = 8
    encs = _encodings(seed=cap + npb, lanes=4, cap=cap, t_end=40 * BLOCK)
    stacked = {k: torch.from_numpy(np.stack([np.asarray(e[k]) for e in encs])) for k in encs[0]}
    clock = _clock(6 * S)
    for step in range(6):
        bt = clock[step * S:(step + 1) * S]
        got = tpe.eval_intrinsic_blocked(stacked, torch.from_numpy(bt), npb, DT).numpy()
        assert got.shape == (4, S * npb) and got.dtype == np.float32
        for lane, e in enumerate(encs):
            want = np.asarray(_jax_eval(e, bt, npb, DT))
            np.testing.assert_allclose(got[lane], want, rtol=REL, atol=REL)


def test_group_lane_dims_carry_through():
    encs = _encodings(seed=3, lanes=4, cap=8, t_end=10 * BLOCK)
    flat = {k: torch.from_numpy(np.stack([np.asarray(e[k]) for e in encs])) for k in encs[0]}
    grid = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in flat.items()}
    bt = torch.from_numpy(_clock(4))
    a = tpe.eval_intrinsic_blocked(flat, bt, 128, DT)
    b = tpe.eval_intrinsic_blocked(grid, bt, 128, DT)
    assert b.shape == (2, 2, 512)
    assert torch.equal(a, b.reshape(4, 512))


def test_capacity_zero_is_the_base_value():
    enc = {k: torch.from_numpy(np.asarray(v))[None]
           for k, v in tpe.encode_events(0.25, [], 0).items()}
    out = tpe.eval_intrinsic_blocked(enc, torch.from_numpy(_clock(4)), 128, DT)
    assert out.shape == (1, 512) and bool((out == 0.25).all())


_jax_eval_exact = jax.jit(jpe.eval_intrinsic_blocked, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("npb", [128, 1], ids=["a-rate", "k-rate"])
def test_exact_branches_match_jax(npb):
    """The exact branches (k-rate: the f64 curve at the block times;
    a-rate: linear ramps in f64) on lanes of every curve type, within the
    tolerance above; a k-rate row, and an a-rate lane of set values and
    linear ramps alone, bit for bit."""
    S = 8
    encs = _encodings(seed=40 + npb, lanes=4, cap=16, t_end=40 * BLOCK)
    rng = np.random.default_rng(npb)
    lin = sorted(((int(rng.integers(0, 2)), float(rng.uniform(0, 40 * BLOCK)),
                   float(rng.uniform(0.05, 2.0)), 0.01) for _ in range(12)), key=lambda e: e[1])
    encs.append(tpe.encode_events(0.5, lin, 16))
    stacked = {k: torch.from_numpy(np.stack([np.asarray(e[k]) for e in encs])) for k in encs[0]}
    clock = _clock(6 * S)
    for step in range(6):
        bt = clock[step * S:(step + 1) * S]
        got = tpe.eval_intrinsic_blocked(stacked, torch.from_numpy(bt), npb, DT, exact=True)
        got = got.numpy()
        for lane, e in enumerate(encs):
            want = np.asarray(_jax_eval_exact(e, bt, npb, DT, True))
            if npb == 1 or lane == len(encs) - 1:
                np.testing.assert_array_equal(got[lane], want)
            else:
                np.testing.assert_allclose(got[lane], want, rtol=REL, atol=REL)
