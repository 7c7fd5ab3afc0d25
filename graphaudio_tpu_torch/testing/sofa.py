"""Synthetic measured-like HRTF set, written as a standard AES69 SOFA file.

The port's copy of graphaudio_tpu/testing/sofa_fixture.py (numpy; ``h5py``
is imported by the writer alone, so a machine without it can still make
the set and pass it on as a dict). The reference ships phonon's built-in
measured HRTF with every context (GraphAudio.SteamAudio/
SteamAudioContext.cs:82-106); no third-party measured set can be bundled
here, so this module GENERATES a measured-like set (quasi-uniform sphere
sampling, per-direction ITD/ILD, direction-coded pinna-style noise tails
that no analytic model reproduces) and writes it in the AES69 (SOFA) HDF5
layout that ``ops.hrtf.load_hrir_grid`` / ``context.set_default_hrir``
read. A committed copy of the default set lives at
tests/fixtures/synthetic_hrtf.sofa (regenerate with ``python -m
graphaudio_tpu_torch.testing.sofa <path>``).
"""

from __future__ import annotations

import numpy as np


def synthetic_hrir_set(sample_rate: int = 48000, n_directions: int = 72,
                       length: int = 64, seed: int = 9):
    """Generate (hrirs f32[M, 2, length], azimuth_deg[M], elevation_deg[M]).

    Azimuth follows the SOFA convention: degrees COUNTERCLOCKWISE from
    straight ahead (90 = left ear). Each direction gets a two-ear impulse
    pair with spherical-head-like ITD/ILD plus a deterministic noise tail
    keyed to the direction index — measured-like in the sense that the set
    is NOT derivable from the analytic model the context defaults to.
    """
    rng = np.random.default_rng(seed)
    # Fibonacci sphere: quasi-uniform directions, no pole clustering.
    i = np.arange(n_directions, dtype=np.float64)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - 2.0 * (i + 0.5) / n_directions  # [-1, 1] ~ sin(elevation)
    el = np.arcsin(np.clip(y, -1.0, 1.0))
    az_ccw = np.mod(golden * i, 2.0 * np.pi)

    hrirs = np.zeros((n_directions, 2, length), np.float64)
    head_radius_s = 0.0875 / 343.0  # Woodworth-ish scale, in seconds
    for m in range(n_directions):
        # Clockwise azimuth (toward the RIGHT ear) for the ear geometry.
        az_cw = -az_ccw[m]
        lateral = np.sin(az_cw) * np.cos(el[m])  # +1 = fully right
        for ear, sign in ((0, -1.0), (1, +1.0)):  # 0 = left, 1 = right
            itd_s = head_radius_s * (1.0 - sign * lateral)
            delay = itd_s * sample_rate
            d0 = int(np.floor(delay))
            frac = delay - d0
            gain = 0.35 + 0.65 * (0.5 * (1.0 + sign * lateral))
            if d0 + 1 < length:
                hrirs[m, ear, d0] += gain * (1.0 - frac)
                hrirs[m, ear, d0 + 1] += gain * frac
            # Direction-coded decaying noise tail ("pinna response"):
            # deterministic per (direction, ear) so regridding exactness
            # at measurement directions is testable.
            tail_rng = np.random.default_rng(seed * 100003 + m * 2 + ear)
            t = np.arange(length)
            tail = (
                tail_rng.standard_normal(length)
                * np.exp(-t / (0.12 * length))
                * 0.15
                * gain
            )
            tail[: d0 + 1] = 0.0
            hrirs[m, ear] += tail
    return (
        hrirs.astype(np.float32),
        np.rad2deg(az_ccw).astype(np.float64),
        np.rad2deg(el).astype(np.float64),
    )


def write_synthetic_sofa(path, sample_rate: int = 48000,
                         n_directions: int = 72, length: int = 64,
                         seed: int = 9) -> None:
    """Write the synthetic set as an AES69 SOFA (HDF5) file with the fields
    load_hrir_grid reads: Data.IR [M, 2, N], SourcePosition [M, 3]
    (azimuth deg CCW, elevation deg, radius), Data.SamplingRate."""
    import h5py

    hrirs, az_deg, el_deg = synthetic_hrir_set(
        sample_rate, n_directions, length, seed
    )
    pos = np.stack(
        [az_deg, el_deg, np.full_like(az_deg, 1.0)], axis=1
    )
    with h5py.File(path, "w") as f:
        f.attrs["Conventions"] = "SOFA"
        f.attrs["SOFAConventions"] = "SimpleFreeFieldHRIR"
        f.attrs["DataType"] = "FIR"
        f.create_dataset("Data.IR", data=hrirs.astype(np.float64))
        f.create_dataset("SourcePosition", data=pos)
        f.create_dataset(
            "Data.SamplingRate", data=np.asarray([float(sample_rate)])
        )


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "synthetic_hrtf.sofa"
    write_synthetic_sofa(out)
    print(f"wrote {out}")
