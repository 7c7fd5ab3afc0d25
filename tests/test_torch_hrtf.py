"""The port's HRTF and one-pole ops against the JAX package, on the CPU.

* the analytic and measured HRIR grid builders (numpy copies): equal;
* ``interp_hrir`` on time-domain grids against the jitted JAX function (the
  package renders jitted; XLA folds the constant divisions, and the port
  mirrors that): within two f32 ulps of the largest tap, 2.4e-7 (the JAX
  package sums the four bilinear products in a one-hot matmul);
* P1's plain version (a time-domain direct-form FIR, INPUT-side: quantum s
  is filtered with the HRIR interpolated at s, its tail overlap-adds into
  s+1) against ``fir_freq_per_block`` on interpolated spectra, for a moving
  source with a non-zero carried tail, on the analytic 64-tap grid
  (192-point path) and a 128-tap measured grid (256-point path), at config
  5's voice level (std 0.03): within 1e-6 max abs, output and carried tail,
  and within 1e-7 of a float64 direct convolution;
* P1 in the Pallas probe's row form against the probe's f64 reference;
* a 320-tap grid: P1 refuses it, the partitioned filter (K10p's plain
  version) renders it as ``fir_freq_partitioned`` does, within 1e-5;
* K9's plain version against ``onepole_lowpass`` with a carry: within
  1e-6 x max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaudio_tpu.ops import hrtf as jh
from graphaudio_tpu.ops import onepole as jop
from graphaudio_tpu_torch.ops import hrtf as th
from graphaudio_tpu_torch.ops import onepole as top

SR = 48000


def _measured_set(n, seed=5):
    """Dense random measured-style HRIRs on a 3 x 12 direction lattice."""
    rng = np.random.default_rng(seed)
    azs, els, irs = [], [], []
    for el_deg in (-30, 0, 30):
        for az_deg in range(0, 360, 30):
            irs.append((rng.standard_normal((2, n)) * np.exp(-np.arange(n) / (n / 4.0))
                        ).astype(np.float32) * 0.2)
            azs.append(az_deg)
            els.append(el_deg)
    return {"hrir": np.stack(irs), "azimuth_deg": np.asarray(azs, np.float64),
            "elevation_deg": np.asarray(els, np.float64), "sample_rate": SR}


def test_grid_builders_match():
    np.testing.assert_array_equal(th.build_hrir_grid(SR), jh.build_hrir_grid(SR))
    data = _measured_set(100)
    kw = dict(n_azimuth=12, n_elevation=7)
    np.testing.assert_array_equal(th.load_hrir_grid(data, SR, **kw),
                                  jh.load_hrir_grid(data, SR, **kw))
    assert th.hrtf_fft_size(64) == jh.hrtf_fft_size(64) == 192
    assert th.hrtf_fft_size(100) == jh.hrtf_fft_size(100) == 256
    for n in (64, 128, 129, 320):
        assert th.hrir_partition_count(n) == jh.hrir_partition_count(n)


def test_interp_hrir_time_domain():
    rng = np.random.default_rng(0)
    grid = jh.build_hrir_grid(SR)
    az = rng.uniform(-20.0, 20.0, 512).astype(np.float32)
    el = rng.uniform(-np.pi / 2, np.pi / 2, 512).astype(np.float32)
    az[:4] = [0.0, -0.0, np.float32(2 * np.pi), -1e-8]
    el[:4] = [np.float32(np.pi / 2), np.float32(-np.pi / 2), 0.0, 1e-8]
    want = np.asarray(jax.jit(jh.interp_hrir)(jnp.asarray(grid), jnp.asarray(az), jnp.asarray(el)))
    got = th.interp_hrir(torch.from_numpy(grid), torch.from_numpy(az), torch.from_numpy(el))
    assert got.shape == want.shape == (512, 2, 64)
    assert np.abs(got.numpy() - want).max() <= 2.4e-7


def _moving_direction(V, S, rng):
    """Azimuths sweeping 0.3 -> 2.9 rad (and on through the wrap for odd
    voices), elevations sweeping over the grid rows."""
    t = np.linspace(0.0, 1.0, S)
    az = np.stack([0.3 + 2.6 * t + 4.0 * (v % 2) * t for v in range(V)])
    el = np.stack([-1.2 + 2.3 * t * (v + 1) / V for v in range(V)])
    return az.astype(np.float32), el.astype(np.float32)


@pytest.mark.parametrize("grid_kind, C", [("analytic", 1), ("analytic", 2), ("measured128", 1)])
def test_p1_plain_matches_fir_freq_per_block(grid_kind, C):
    rng = np.random.default_rng(11)
    if grid_kind == "analytic":
        grid = jh.build_hrir_grid(SR)  # 64 taps: 192-point path, tail 64
    else:
        grid = jh.load_hrir_grid(_measured_set(128), SR, n_azimuth=12, n_elevation=7)
    V, S, L = 2, 32, grid.shape[-1]
    W = jh.hrtf_fft_size(L) - 128
    az, el = _moving_direction(V, S, rng)
    x = (rng.standard_normal((V, C, S * 128)) * 0.03).astype(np.float32)
    ola = (rng.standard_normal((V, 2, W)) * 0.01).astype(np.float32)
    ola[..., L - 1:] = 0.0  # a real tail is zero past L-1 taps

    @jax.jit
    def jax_voice(x, az, el, ola):
        sr_g, si_g = (jnp.asarray(g) for g in jh.hrir_grid_spectra(grid))
        mono = jnp.mean(x, axis=0).reshape(S, 128)
        y, o = jh.fir_freq_per_block(mono, jh.interp_hrir(sr_g, az, el),
                                     jh.interp_hrir(si_g, az, el), ola)
        return y.reshape(2, S * 128), o

    want, want_ola = map(np.stack, zip(*(map(np.asarray, jax_voice(x[v], az[v], el[v], ola[v]))
                                          for v in range(V))))
    t = torch.from_numpy
    out, new_ola = th.hrtf_fir_plain(t(x), None, t(az), t(el), torch.ones(V, S), t(grid), t(ola))
    assert np.abs(want).max() > 1e-2
    assert np.abs(out.numpy() - want).max() < 1e-6
    assert np.abs(new_ola.numpy() - want_ola).max() < 1e-6

    # float64 direct convolution with the port's interpolated HRIRs
    h = th.interp_hrir(t(grid).double(), t(az), t(el)).numpy()
    ref = np.zeros((V, 2, S * 128 + 128))
    ref[..., :W] = ola
    for v in range(V):
        mono = x[v].astype(np.float64).mean(axis=0)
        for s in range(S):
            for e in range(2):
                ref[v, e, s * 128:s * 128 + 128 + L - 1] += np.convolve(
                    mono[s * 128:(s + 1) * 128], h[v, s, e])
    ref = ref[..., :S * 128]
    assert np.abs(out.numpy() - ref).max() < 1e-7


def test_p1_blend_and_gain():
    """The fused broadband gain and the SpatialBlend crossfade: blend 0 is
    the direct signal up-mixed to both ears; a gain scales the input."""
    rng = np.random.default_rng(12)
    grid = torch.from_numpy(jh.build_hrir_grid(SR))
    V, S = 2, 4
    x = torch.from_numpy((rng.standard_normal((V, 1, S * 128)) * 0.3).astype(np.float32))
    az, el = torch.full((V, S), 0.7), torch.zeros(V, S)
    ola = torch.zeros(V, 2, 64)
    gain = torch.full((V, S), 0.5)
    dry, _ = th.hrtf_fir_plain(x, gain, az, el, torch.zeros(V, S), grid, ola)
    torch.testing.assert_close(dry, (x * 0.5).expand(V, 2, S * 128), rtol=0, atol=0)
    wet_g, _ = th.hrtf_fir_plain(x, gain, az, el, torch.ones(V, S), grid, ola)
    wet, _ = th.hrtf_fir_plain(x * 0.5, None, az, el, torch.ones(V, S), grid, ola)
    torch.testing.assert_close(wet_g, wet, rtol=0, atol=0)


def test_p1_rows_plain_matches_probe():
    """The probe's function, out[r, c*F+t] = sum_k h[r, c*L+k] x[r, L-1-k+t],
    against its own f64 reference (benchmarks/probes/hrtf_fir_pallas.py:96-101)."""
    rng = np.random.default_rng(13)
    R, F, L = 64, 128, 64
    x = rng.standard_normal((R, F + L - 1)).astype(np.float32)
    h = (rng.standard_normal((R, 2 * L)) * 0.2).astype(np.float32)
    hb = h.reshape(R, 2, L).astype(np.float64)
    ref = np.zeros((R, 2, F))
    for k in range(L):
        ref += hb[:, :, k, None] * x.astype(np.float64)[:, None, L - 1 - k:L - 1 - k + F]
    got = th.hrtf_fir_rows_plain(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    assert np.abs(got - ref.reshape(R, 2 * F)).max() < 1e-5 * np.abs(ref).max()


def test_partitioned_kernels_raise():
    """A 320-tap grid on one quantum, once a raise of P1 (the partitioned
    filter was not ported): P1 still refuses it, and the partitioned filter
    renders it as the JAX package's fir_freq_partitioned does (jitted, with
    interp_hrir of the partition spectra), within 1e-5."""
    rng = np.random.default_rng(16)
    grid = (rng.standard_normal((7, 24, 2, 320)) * 0.1).astype(np.float32)
    x = (rng.standard_normal((1, 1, 128)) * 0.5).astype(np.float32)
    az, el = np.float32([[0.9]]), np.float32([[-0.3]])
    ola = np.zeros((1, 2, 128), np.float32)
    with pytest.raises(ValueError, match="hrtf_fir_partitioned"):
        th.hrtf_fir(torch.from_numpy(x), None, torch.from_numpy(az), torch.from_numpy(el),
                    torch.ones(1, 1), torch.from_numpy(grid), torch.from_numpy(ola))
    sr, si = th.hrir_grid_spectra(grid)
    assert sr.shape == (7, 24, 2, 3, 129)
    hx, hang = np.zeros((1, 2, 258), np.float32), np.zeros((1, 2), np.float32)
    t = torch.from_numpy
    out, *_ = th.hrtf_fir_partitioned(t(x), None, t(az), t(el), torch.ones(1, 1), t(sr), t(si),
                                      t(hx), t(hang), t(hang), t(ola))

    @jax.jit
    def jax_filter(x, az, el):
        azc, elc = jnp.concatenate([hang[0], az]), jnp.concatenate([hang[0], el])
        hr = jh.interp_hrir(jnp.asarray(sr), azc, elc)
        hi = jh.interp_hrir(jnp.asarray(si), azc, elc)
        return jh.fir_freq_partitioned(x.reshape(1, 128), hr, hi, hx[0], ola[0])[0]

    want = np.asarray(jax_filter(x[0, 0], az[0], el[0])).reshape(2, 128)
    assert np.abs(want).max() > 1e-2
    assert np.abs(out[0].numpy() - want).max() < 1e-5


@pytest.mark.parametrize("hz", [800.0, 8000.0])
def test_onepole_matches_jax(hz):
    rng = np.random.default_rng(14)
    a = float(np.exp(-2.0 * np.pi * hz / SR))
    x = (rng.standard_normal((3, 2, 16 * 128)) * 0.5).astype(np.float32)
    y0 = (rng.standard_normal((3, 2)) * 0.2).astype(np.float32)
    want, want_c = map(np.asarray, jop.onepole_lowpass(jnp.asarray(x), a, jnp.asarray(y0)))
    got, got_c = top.onepole_lowpass(torch.from_numpy(x), a, torch.from_numpy(y0))
    bound = 1e-6 * np.abs(want).max()
    assert np.abs(got.numpy() - want).max() < bound
    assert np.abs(got_c.numpy() - want_c).max() < bound
    # and the recurrence itself, in f64
    y = np.empty(x.shape)
    p = y0.astype(np.float64)
    for n in range(x.shape[-1]):
        p = a * p + (1 - a) * x[..., n]
        y[..., n] = p
    assert np.abs(got.numpy() - y).max() < bound
