"""The port's config-1/2/3 slice end to end, on the CPU (plain kernel versions).

* configs 1, 2 and 3 (superblock 4, 8192 frames) against their goldens,
  tests/goldens/config{1,2,3}_*.npz (JAX CPU renders), within 1e-5;
* config 3 side by side with a JAX render at superblock 32 over 2 steps,
  within 1e-5. The JAX OfflineAudioContext fuses the four biquads into
  one pipelined stage by default (``pipeline_chains=True``), which is how
  the golden was rendered; the port renders them unfused;
* a mid-render hand-off through utils.from_jax (unity source and biquad
  state): a JAX render of config 3's first section runs 2 steps, both
  packages continue 2 steps, within 1e-5;
* config 3 against a float64 numpy mirror of the algorithm (pole split,
  cascade, correction pass, per superblock) over 2048 frames: the port is
  no further from it than the golden itself is.

Config 3's output peaks at 0.015, so 1e-5 absolute is 7e-4 of its level:
the golden's own f32 rounding puts it 8.4e-6 from the f64 mirror at 8192
frames, and the port lands 6.8e-6 from the golden.
"""

import jax
import numpy as np
import pytest

import benchmarks.configs as bc
import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.testing import configs as tc
from graphaudio_tpu_torch.utils import from_jax

SR = 48000
TOL = 1e-5
GOLDENS = {
    1: ("config1_buffer_gain", tc.config1_buffer_gain),
    2: ("config2_mix_bus_ramps", tc.config2_mix_bus),
    3: ("config3_biquad_eq_chain", tc.config3_eq_chain),
}


@pytest.mark.parametrize("n", sorted(GOLDENS))
def test_config_golden(n):
    name, builder = GOLDENS[n]
    out = builder(superblock=4, device="cpu").render(8192)
    golden = np.load(f"tests/goldens/{name}.npz")["out"]
    assert out.shape == golden.shape and out.dtype == np.float32
    assert np.isfinite(out).all()
    assert np.abs(out.astype(np.float64) - golden).max() < TOL


def test_config3_side_by_side_with_jax():
    T = 32 * 128
    jctx = bc.config3_eq_chain(superblock=32)
    want = jctx.render(2 * T)
    tctx = tc.config3_eq_chain(superblock=32, device="cpu")
    got = np.concatenate([tctx.render(3000), tctx.render(2 * T - 3000)], axis=1)
    assert jctx.pipeline_chains  # the JAX default: the fused chain
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() < TOL


def _source_into_eq(mod, superblock, **ctx_kw):
    """Config 3's first section at a small size: a looped stereo 48 kHz
    buffer -> one peaking biquad whose frequency and Q ramp -> out (one
    biquad, so the JAX context has no chain to fuse and both packages
    share the stage keys)."""
    rng = np.random.default_rng(33)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **ctx_kw)
    sig = (rng.standard_normal(SR // 4) * 0.2).astype(np.float32)
    src = mod.AudioBufferSourceNode(ctx)
    src.buffer = mod.PlayableAudioBuffer.from_stereo_arrays(sig, sig[::-1].copy(), SR)
    src.loop = True
    flt = mod.BiQuadFilterNode(ctx, type=mod.FilterType.PEAKING)
    flt.gain.value = 3.0
    flt.frequency.set_value_at_time(200.0, 0.0)
    flt.frequency.linear_ramp_to_value_at_time(2000.0, 0.03)
    flt.q.set_value_at_time(0.5, 0.0)
    flt.q.linear_ramp_to_value_at_time(4.0, 0.03)
    src.connect(flt).connect(ctx.destination)
    src.start(0)
    return ctx


def test_mid_render_handoff_from_jax():
    superblock = 4
    T = superblock * 128
    jctx = _source_into_eq(ga, superblock)
    jctx.render(2 * T)
    tctx = _source_into_eq(gat, superblock, device="cpu")
    from_jax.load_render_state(
        tctx, jax.device_get(jctx._states), jax.device_get(jctx._consts),
        jctx._current_frame, jctx._current_time,
    )
    # The source position and the biquad's running state came across.
    assert tctx._states["st0"]["pos"].item() == 2 * T
    assert np.abs(tctx._states["st1"]["w1"].numpy()).max() > 0.0
    want = jctx.render(2 * T)  # the same program as the first call
    got = tctx.render(2 * T)
    assert tctx.current_time == jctx.current_time
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() < TOL


# ---- the float64 mirror ------------------------------------------------------

TYPES = ("lowpass", "peaking", "peaking", "highpass")


def _rbj64(kind, f, q, gain_db):
    w0 = 2.0 * np.pi * f / SR
    c, s = np.cos(w0), np.sin(w0)
    alpha = s / (2.0 * q)
    if kind == "lowpass":
        b = ((1 - c) / 2, 1 - c, (1 - c) / 2)
        a = (1 + alpha, -2 * c, 1 - alpha)
    elif kind == "highpass":
        b = ((1 + c) / 2, -(1 + c), (1 + c) / 2)
        a = (1 + alpha, -2 * c, 1 - alpha)
    else:  # peaking
        A = 10.0 ** (gain_db / 40.0)
        b = (1 + alpha * A, -2 * c, 1 - alpha * A)
        a = (1 + alpha / A, -2 * c, 1 - alpha / A)
    return [bk / a[0] for bk in b] + [a[1] / a[0], a[2] / a[0]]


def _biquad64(x, b0, b1, b2, a1, a2, w1, w2):
    """One superblock of the pole-split cascade with the correction pass,
    sequential, in f64 (graphaudio_tpu/ops/biquad.py biquad_apply)."""
    disc = np.sqrt((a1 * a1 - 4.0 * a2).astype(np.complex128))
    p1, p2 = 0.5 * (-a1 + disc), 0.5 * (-a1 - disc)

    def run(inp):
        v, w = w1 - p2[0] * w2, w1.astype(np.complex128)
        out = np.empty(x.shape)
        for t in range(x.shape[1]):
            v = p1[t] * v + inp[:, t]
            w = p2[t] * w + v
            out[:, t] = w.real
        tm1 = np.concatenate([w1[:, None], out[:, :-1]], axis=1)
        return out, tm1, np.concatenate([w2[:, None], tm1[:, :-1]], axis=1)

    wt, tm1, tm2 = run(x.astype(np.complex128))
    prev = np.concatenate([p2[:1], p2[:-1]])
    wt, tm1, tm2 = run(x - (p1 * (p2 - prev))[None] * tm2)
    return b0 * wt + b1 * tm1 + b2 * tm2, wt[:, -1], tm1[:, -1]


def _config3_mirror64(frames, superblock):
    """Config 3 (benchmarks/configs.py:57-85) in f64: the looped stereo
    buffer through four biquads whose frequency and Q ramp linearly from
    each whole 3 s to 2.5 s past it."""
    rng = np.random.default_rng(3)
    sig = (rng.standard_normal(2 * SR) * 0.2).astype(np.float32)
    buf = np.stack([sig, sig[::-1]]).astype(np.float64)
    x = buf[:, np.arange(frames) % buf.shape[1]]
    ph = np.mod(np.arange(frames) / SR, 3.0)
    ramp = np.minimum(ph / 2.5, 1.0)
    T = superblock * 128
    for i, kind in enumerate(TYPES):
        f = 200.0 * (i + 1) + 1800.0 * (i + 1) * ramp
        q = 0.5 + 3.5 * ramp
        coeffs = _rbj64(kind, f, q, 3.0 if kind == "peaking" else 0.0)
        w1, w2 = np.zeros(2), np.zeros(2)
        y = np.empty_like(x)
        for t0 in range(0, frames, T):
            sl = slice(t0, t0 + T)
            y[:, sl], w1, w2 = _biquad64(x[:, sl], *(c[sl] for c in coeffs), w1, w2)
        x = y
    return x


def test_config3_against_f64_mirror():
    frames = 2048
    mirror = _config3_mirror64(frames, 4)
    port = tc.config3_eq_chain(superblock=4, device="cpu").render(frames).astype(np.float64)
    golden = np.load("tests/goldens/config3_biquad_eq_chain.npz")["out"][:, :frames]
    port_err = np.abs(port - mirror).max()
    golden_err = np.abs(golden.astype(np.float64) - mirror).max()
    assert np.abs(mirror).max() > 1e-3
    assert port_err < TOL
    assert port_err <= golden_err
