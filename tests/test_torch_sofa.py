"""The port's measured-HRTF path through a synthetic SOFA file, on the CPU
(twins of tests/test_sofa.py on graphaudio_tpu_torch.testing.sofa and the
port's loader and renderer):

* the committed fixture tests/fixtures/synthetic_hrtf.sofa is the port's
  generator's output (and the JAX package's set, equal);
* the loader's HDF5 branch is exact at the grid nodes that coincide with
  measurement directions;
* ``set_default_hrir(SOFA)`` then a grouped render of three voices against
  the JAX package's numpy oracle fed the same regridded grid, within 1e-5,
  and the measured set differs from the analytic default.
"""

import os

import numpy as np
import pytest

import graphaudio_tpu_torch as gat
from graphaudio_tpu.testing.sofa_fixture import synthetic_hrir_set as jax_set
from graphaudio_tpu_torch.ops.hrtf import load_hrir_grid
from graphaudio_tpu_torch.testing.sofa import synthetic_hrir_set, write_synthetic_sofa

h5py = pytest.importorskip("h5py")

SR = 48000
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "synthetic_hrtf.sofa")


def test_committed_fixture_matches_generator(tmp_path):
    p = tmp_path / "regen.sofa"
    write_synthetic_sofa(p)
    with h5py.File(FIXTURE, "r") as a, h5py.File(p, "r") as b:
        for k in ("Data.IR", "SourcePosition", "Data.SamplingRate"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    for got, want in zip(synthetic_hrir_set(44100, 72, 512, 9), jax_set(44100, 72, 512, 9)):
        np.testing.assert_array_equal(got, want)


def test_sofa_load_exact_at_measurement_directions():
    hrirs, az_deg, el_deg = synthetic_hrir_set()
    n_az, n_el = 24, 13
    grid = load_hrir_grid(FIXTURE, SR, n_azimuth=n_az, n_elevation=n_el)
    assert grid.shape == (n_el, n_az, 2, 64)
    for m in range(len(az_deg)):
        # The grid's azimuth is CLOCKWISE, SOFA's counterclockwise.
        ai = (-az_deg[m]) % 360.0 / (360.0 / n_az)
        ei = (el_deg[m] + 90.0) / (180.0 / (n_el - 1))
        if abs(ai - round(ai)) < 1e-9 and abs(ei - round(ei)) < 1e-9:
            np.testing.assert_allclose(grid[int(round(ei)) % n_el, int(round(ai)) % n_az],
                                       hrirs[m], atol=1e-6)
    # Interpolation sanity: the grid's energies lie within the measured ones.
    e = np.sum(grid.astype(np.float64) ** 2, axis=(2, 3))
    me = np.sum(hrirs.astype(np.float64) ** 2, axis=(1, 2))
    assert e.max() <= me.max() * 1.001 and e.min() >= 0.0


def _voice(ctx, sig, ang, y=0.0):
    src = gat.AudioBufferSourceNode(ctx)
    src.buffer = gat.PlayableAudioBuffer.from_mono_array(sig, SR)
    src.loop = True
    pan = gat.SpatialPannerNode(ctx)
    pan.position_x.value = 2.0 * np.cos(ang)
    pan.position_y.value = y
    pan.position_z.value = 2.0 * np.sin(ang)
    src.connect(pan).connect(ctx.destination)
    src.start(0)


def _context(default_hrir=None):
    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=2, device="cpu")
    if default_hrir is not None:
        ctx.set_default_hrir(default_hrir, n_azimuth=12, n_elevation=7)
    ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    return ctx


def test_sofa_default_hrir_render_matches_oracle(rng):
    from graphaudio_tpu.testing.oracle import (
        OracleBufferSource, OracleContext, OracleSpatialPanner,
    )

    voices, frames = 3, 1024
    sigs = [(rng.standard_normal(2048) * 0.2).astype(np.float32) for _ in range(voices)]
    ctx = _context(FIXTURE)
    octx = OracleContext(sample_rate=SR)
    octx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    grid = load_hrir_grid(FIXTURE, SR, n_azimuth=12, n_elevation=7)
    for v in range(voices):
        ang = 2 * np.pi * v / voices + 0.3
        _voice(ctx, sigs[v], ang, 0.4 * (v - 1))
        src = OracleBufferSource(octx)
        src.set_buffer(sigs[v], SR)
        src.loop = True
        pan = OracleSpatialPanner(octx, grid)
        pan.position_x.value = 2.0 * np.cos(ang)
        pan.position_y.value = 0.4 * (v - 1)
        pan.position_z.value = 2.0 * np.sin(ang)
        src.connect(pan).connect(octx.destination)
        src.start(0)
    got = ctx.render(frames)
    groups = [sp for sp in ctx._compiled.plan if type(sp["rep"]).__name__ == "SpatialPannerNode"]
    assert [sp["n_lanes"] for sp in groups] == [4]  # three voices, one padded group
    want = octx.render(frames)
    # Skip the oracle's documented first-block channel-count transient.
    assert np.max(np.abs(got[:, 128:] - want[:, 128:])) < 1e-5
    # The measured set really differs from the analytic default.
    single, analytic = _context(FIXTURE), _context()
    for c in (single, analytic):
        _voice(c, sigs[0], 0.3)
    assert np.max(np.abs(single.render(frames) - analytic.render(frames))) > 1e-3
