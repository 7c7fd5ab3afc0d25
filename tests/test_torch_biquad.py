"""Port K8 (RBJ coefficients, pole split) and P2 (the pole-split cascade)
against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
port runs on CPU tensors, so its plain versions: the coefficients in f32
with XLA's rounding, the recurrences in the JAX association order with f64
state (ops/biquad.py says why). Tolerances, each with its reason:

* coefficients: 1e-6 relative, a few f32 ulp (XLA's own f32 sin/cos/pow
  are not always correctly rounded; the port's are);
* first-order solves in c64 against the JAX ones: 2e-6 of the largest
  state, f32 products in the same order with another rounding of the
  complex multiply;
* filtered audio against a sequential f64 mirror of the same pole-split
  algorithm: 1e-6 of the peak level (the port's error is the f32 rounding
  of its output);
* filtered audio against the JAX package: 1e-5 of the peak level for the
  sweep, the bar the goldens are held to; 5e-5 for the single resonant
  sections of ``test_biquad_apply_matches_jax``, whose f32 JAX recurrence
  is itself that far from the f64 mirror (asserted there), and for the
  +18 dB gain step, the bound the JAX package's own test of that step
  holds it to (tests/test_biquad.py, peaking gain automation);
* state carried across render calls in the port: bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.ops import biquad as jbq
from graphaudio_tpu_torch.ops import biquad as tbq

SR = 48000
TOL = 1e-5


def _params(rng, T):
    freq = rng.uniform(20.0, 20000.0, T).astype(np.float32)
    q = rng.uniform(0.1, 12.0, T).astype(np.float32)
    gain = rng.uniform(-24.0, 24.0, T).astype(np.float32)
    return freq, q, gain


@pytest.mark.parametrize("ftype", tbq.FILTER_TYPES)
def test_rbj_coefficients_match_jax(ftype):
    rng = np.random.default_rng(10)
    freq, q, gain = _params(rng, 4096)
    want = jax.jit(jbq.rbj_coefficients, static_argnums=(0, 4))(ftype, freq, q, gain, SR)
    got = tbq.rbj_coefficients(ftype, torch.from_numpy(freq), torch.from_numpy(q),
                               torch.from_numpy(gain), SR)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


def test_pole_order_matches_jax():
    """Im(p1) >= 0 for complex poles, as XLA's complex sqrt gives it; the
    correction pass is not symmetric in p1 and p2."""
    a1 = np.array([1.9, -1.9, 0.5, -2.5, 0.0], np.float32)
    a2 = np.array([0.95, 0.95, -0.3, 1.5, 0.81], np.float32)

    def jax_poles(a1, a2):
        a1c, a2c = a1.astype(jnp.complex64), a2.astype(jnp.complex64)
        disc = jnp.sqrt(a1c * a1c - 4.0 * a2c)
        return 0.5 * (-a1c + disc), 0.5 * (-a1c - disc)

    w1, w2 = (np.asarray(p) for p in jax.jit(jax_poles)(a1, a2))
    p1, p2 = tbq.split_poles(torch.from_numpy(a1), torch.from_numpy(a2))
    np.testing.assert_allclose(p1.numpy(), w1, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p2.numpy(), w2, rtol=1e-6, atol=1e-7)
    assert abs(complex(p1[0]) - complex(-0.95, 0.2179449)) < 1e-6
    assert abs(complex(p1[1]) - complex(0.95, 0.2179449)) < 1e-6
    # Coefficients from the RBJ formulas: the pole split agrees on all.
    rng = np.random.default_rng(11)
    freq, q, gain = _params(rng, 2048)
    _, _, _, ra1, ra2 = tbq.rbj_coefficients("peaking", torch.from_numpy(freq),
                                             torch.from_numpy(q), torch.from_numpy(gain), SR)
    w1, w2 = (np.asarray(p) for p in jax.jit(jax_poles)(ra1.numpy(), ra2.numpy()))
    p1, p2 = tbq.split_poles(ra1, ra2)
    assert np.abs(p1.numpy() - w1).max() < 1e-6 and np.abs(p2.numpy() - w2).max() < 1e-6


def _solve_inputs(rng, T, C=2):
    r = rng.uniform(0.2, 0.9995, T)
    th = rng.uniform(-np.pi, np.pi, T)
    p = (r * np.exp(1j * th)).astype(np.complex64)
    u = (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)
    s0 = (rng.standard_normal(C) + 1j * rng.standard_normal(C)).astype(np.complex64)
    return p, u, s0


@pytest.mark.parametrize("T", [128, 512, 4096], ids=["S==1", "two-level", "two-level-4096"])
def test_first_order_scan_matches_jax(T):
    p, u, s0 = _solve_inputs(np.random.default_rng(T), T)
    want = np.asarray(jax.jit(jbq._first_order_scan)(p, u, s0))
    got = tbq._first_order_scan(torch.from_numpy(p), torch.from_numpy(u),
                                torch.from_numpy(s0)).numpy()
    assert np.abs(got - want).max() < 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("T", [512, 4096])
def test_first_order_const_matches_jax(T):
    p, u, s0 = _solve_inputs(np.random.default_rng(T + 1), T)
    want = np.asarray(jax.jit(jbq._first_order_const)(p[3], u, s0))
    got = tbq._first_order_const(torch.from_numpy(p[3:4]), torch.from_numpy(u[None]),
                                 torch.from_numpy(s0[None]))[0].numpy()
    assert np.abs(got - want).max() < 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("time_varying", [False, True], ids=["constant", "time-varying"])
@pytest.mark.parametrize("T", [512, 4096])
def test_biquad_apply_matches_jax(T, time_varying):
    rng = np.random.default_rng(T + time_varying)
    V, C = 2, 2
    n = np.arange(T, dtype=np.float32)
    x = (rng.standard_normal((V, C, T)) * 0.3).astype(np.float32)
    w1 = (rng.standard_normal((V, C)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((V, C)) * 0.1).astype(np.float32)
    ys, w1s, w2s = [], [], []
    lane_coeffs = []
    for v in range(V):
        if time_varying:
            f = (300.0 + 900.0 * v) * (1.0 + 3.0 * n / T)
            q = 0.5 + 3.5 * n / T
        else:
            f = np.full(T, 700.0 + 900.0 * v, np.float32)
            q = np.full(T, 2.0, np.float32)
        coeffs = jbq.rbj_coefficients("peaking", f.astype(np.float32), q.astype(np.float32),
                                      np.float32(3.0), SR)
        lane_coeffs.append([np.asarray(c) for c in coeffs])
        y, a, b = jax.jit(jbq.biquad_apply, static_argnames=("time_varying", "constant"))(
            x[v], coeffs, w1[v], w2[v], time_varying=time_varying, constant=not time_varying)
        ys.append(np.asarray(y))
        w1s.append(np.asarray(a))
        w2s.append(np.asarray(b))
    b0, b1, b2, a1, a2 = (torch.from_numpy(np.stack([c[k] for c in lane_coeffs])) for k in range(5))
    p1, p2 = tbq.split_poles(a1, a2)
    got = tbq.biquad_apply(torch.from_numpy(x), b0, b1, b2, p1, p2, torch.from_numpy(w1),
                           torch.from_numpy(w2), time_varying=time_varying)
    mirror = _biquad_mirror64(x, b0.numpy(), b1.numpy(), b2.numpy(), p1.numpy(),
                              p2.numpy(), w1, w2, time_varying)
    want = (np.stack(ys), np.stack(w1s), np.stack(w2s))
    for g, w, m in zip(got, want, mirror):
        assert g.dtype == torch.float32 and g.shape == w.shape
        peak = max(1.0, np.abs(m).max())
        assert np.abs(g.numpy() - m).max() < 1e-6 * peak
        assert np.abs(w - m).max() < 5e-5 * peak  # the JAX package's own f32 error
        assert np.abs(g.numpy() - w).max() < 5e-5 * peak


def _biquad_mirror64(x, b0, b1, b2, p1, p2, w1, w2, time_varying):
    """Sequential f64 form of the pole-split cascade with the correction
    pass (ops/biquad.py), on the same c64 poles and f32 coefficients."""
    p1, p2 = p1.astype(np.complex128), p2.astype(np.complex128)
    b0, b1, b2 = (b.astype(np.float64) for b in (b0, b1, b2))
    V, C, T = x.shape
    w1, w2 = w1.astype(np.float64), w2.astype(np.float64)

    def run(inp):
        v = w1 - p2[:, :1] * w2
        w = w1.astype(np.complex128)
        out = np.empty((V, C, T))
        for t in range(T):
            v = p1[:, t, None] * v + inp[..., t]
            w = p2[:, t, None] * w + v
            out[..., t] = w.real
        return out

    wt = run(x.astype(np.complex128))
    tm1 = np.concatenate([w1[..., None], wt[..., :-1]], axis=-1)
    tm2 = np.concatenate([w2[..., None], tm1[..., :-1]], axis=-1)
    if time_varying:
        prev = np.concatenate([p2[:, :1], p2[:, :-1]], axis=-1)
        wt = run(x - (p1 * (p2 - prev))[:, None, :] * tm2)
        tm1 = np.concatenate([w1[..., None], wt[..., :-1]], axis=-1)
        tm2 = np.concatenate([w2[..., None], tm1[..., :-1]], axis=-1)
    y = b0[:, None] * wt + b1[:, None] * tm1 + b2[:, None] * tm2
    return y, wt[..., -1], tm1[..., -1]


def _source_into_filter(mod, ftype, superblock, seconds=0.2, **ctx_kw):
    """A looped stereo 48 kHz buffer (unity source) -> one biquad -> out."""
    rng = np.random.default_rng(12)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **ctx_kw)
    sig = (rng.standard_normal(int(seconds * SR)) * 0.3).astype(np.float32)
    src = mod.AudioBufferSourceNode(ctx)
    src.buffer = mod.PlayableAudioBuffer.from_stereo_arrays(sig, sig[::-1].copy(), SR)
    src.loop = True
    flt = mod.BiQuadFilterNode(ctx, type=ftype)
    src.connect(flt).connect(ctx.destination)
    src.start(0)
    return ctx, flt


def _mono_voices_into_filters(mod, voices, **ctx_kw):
    """``voices`` looped mono buffers, each into its own lowpass (one group
    stage) -> out. The filters' inputs resolve to stereo, so each mono
    voice is up-mixed."""
    rng = np.random.default_rng(13)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=4, **ctx_kw)
    for v in range(voices):
        src = mod.AudioBufferSourceNode(ctx)
        sig = (rng.standard_normal(SR // 10) * 0.3).astype(np.float32)
        src.buffer = mod.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        flt = mod.BiQuadFilterNode(ctx, type=mod.FilterType.LOWPASS)
        flt.frequency.value = 400.0 + 700.0 * v
        src.connect(flt).connect(ctx.destination)
        src.start(0)
    return ctx


@pytest.mark.parametrize("voices", [1, 4])
def test_mono_voices_into_filters_get_contiguous_input(monkeypatch, voices):
    """The biquad kernel takes no strides: the mono-to-stereo up-mix a
    filter stage receives is a contiguous [V, 2, T] tensor, and the render
    matches the JAX package."""
    seen = []
    process = gat.BiQuadFilterNode.process

    def spy(self, state, inputs, params, rc):
        seen.append((tuple(inputs[0].shape), inputs[0].is_contiguous()))
        return process(self, state, inputs, params, rc)

    monkeypatch.setattr(gat.BiQuadFilterNode, "process", spy)
    got = _mono_voices_into_filters(gat, voices, device="cpu").render(2048)
    want = _mono_voices_into_filters(ga, voices).render(2048)
    assert seen and all(s == ((voices, 2, 512), True) for s in seen)
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL * max(1.0, np.abs(want).max())


def test_lowpass_sweep_node_matches_jax():
    out = []
    for mod, kw in ((ga, {}), (gat, {"device": "cpu"})):
        ctx, flt = _source_into_filter(mod, mod.FilterType.LOWPASS, 4, **kw)
        flt.frequency.set_value_at_time(150.0, 0.0)
        flt.frequency.exponential_ramp_to_value_at_time(9000.0, 0.08)
        flt.q.set_value_at_time(0.7, 0.01)
        flt.q.linear_ramp_to_value_at_time(6.0, 0.07)
        out.append(ctx.render(4096 + 700) if mod is ga else
                   np.concatenate([ctx.render(1000), ctx.render(3796)], axis=1))
    want, got = out
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < TOL * max(1.0, np.abs(want).max())


def test_peaking_gain_event_switches_to_time_varying_poles():
    """The first gain event of a peaking filter leaves the constant-pole
    kernel (gain reaches a1/a2): the port rebuilds its graph, keeps the
    running state and matches the JAX package across the switch."""
    outs, keys = [], []
    for mod, kw in ((ga, {}), (gat, {"device": "cpu"})):
        ctx, flt = _source_into_filter(mod, mod.FilterType.PEAKING, 4, **kw)
        flt.frequency.value = 1200.0
        flt.q.value = 2.0
        first = ctx.render(1536)
        assert not flt._time_varying()
        flt.gain.set_value_at_time(18.0, 2048 / SR)
        assert flt._time_varying()
        outs.append(np.concatenate([first, ctx.render(2560)], axis=1))
        if mod is gat:
            keys.append(flt.group_key([2]))
    want, got = outs
    assert keys[0][3] is True  # the time-varying kernel
    assert np.abs(got - want).max() < 5e-5 * max(1.0, np.abs(want).max())
    # The event changed the output: the gain really reached the poles.
    still = _source_into_filter(gat, gat.FilterType.PEAKING, 4, device="cpu")[0]
    assert np.abs(still.render(4096)[:, 2560:] - got[:, 2560:]).max() > 1e-2


def test_state_carries_across_render_calls():
    def build():
        ctx, flt = _source_into_filter(gat, gat.FilterType.HIGHSHELF, 4, device="cpu")
        flt.frequency.set_value_at_time(500.0, 0.0)
        flt.frequency.linear_ramp_to_value_at_time(5000.0, 0.05)
        flt.gain.value = 6.0
        return ctx, flt

    whole_ctx, _ = build()
    whole = whole_ctx.render(3 * 512 * 4)
    ctx, flt = build()
    parts = np.concatenate([ctx.render(n) for n in (512, 1000, 4632)], axis=1)
    np.testing.assert_array_equal(parts, whole)
    st = ctx.peek_node_state(flt)
    assert st["w1"].shape == (2,) and st["w1"].dtype == np.float32
    np.testing.assert_array_equal(st["__type_sel__"], np.eye(8, dtype=np.float32)[7])
