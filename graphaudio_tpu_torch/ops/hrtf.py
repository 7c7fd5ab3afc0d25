"""Binaural HRTF rendering: the HRIR grid and the per-quantum HRTF FIR (P1).

The port of graphaudio_tpu/ops/hrtf.py. The host-side grid builders are
numpy, copied: the analytic spherical-head model (``build_hrir_grid``,
Brown & Duda's head shadow, Woodworth's ITD, a pinna reflection) and the
measured-set regridding (``load_hrir_grid``). They produce an f32 grid
[E, A, 2, L] on a regular (elevation x azimuth) lattice.

At render time each 128-frame quantum of a voice is filtered with the
bilinear interpolation of the four grid HRIRs around its direction. The JAX
package interpolates precomputed grid SPECTRA and filters in the frequency
domain with matmul DFTs (``fir_freq_per_block`` :255, ``interp_hrir``
:135); the benchmark probe ``benchmarks/probes/hrtf_fir_pallas.py`` wrote
the same maths as a time-domain Pallas kernel (P1, ``fir_pallas_call``
:127 → ``fir_kernel`` :113). Here it is a direct-form FIR in the time
domain, which is exact by linearity (the interpolated spectrum is the
spectrum of the interpolated HRIR):

* ``hrtf_fir``: csrc/hrtf_fir.cu on a CUDA tensor (with the lane table
  of ``fir_tile_plan``), ``hrtf_fir_plain`` on a CPU tensor. INPUT-side
  semantics, as the package and its oracle: input quantum s is convolved
  with the kernel interpolated at s, and its tail overlap-adds into
  quantum s+1 (the carried ``ola`` tail crosses superblocks). The probe's
  kernel is OUTPUT-side (quantum s applies h[s] to the last 191 input
  samples), which differs for a moving source.
* ``hrtf_fir_rows``: the probe's own row form, for holding the kernel
  against the probe's function (``hrtf_fir_rows_plain``).

Kernels longer than 128 taps (up to MAX_HRIR_LENGTH) take the JAX
package's partitioned path (``fir_freq_partitioned`` :302, K10p): P
uniform 128-tap partitions on 256-point transforms, in the frequency
domain as there, with the same carried state (the packed input spectra of
the last P-1 quanta ``hx``, their directions ``haz`` / ``hel``, the tail
``ola``):

* ``hrtf_fir_partitioned``: on a CUDA tensor the input pass
  (csrc/hrtf_part.cu ``ga_hrtf_part_input``: the gain, the channel mean and
  the zero half of each quantum's 256-point transform input), torch.fft's
  rfft (cuFFT), K10p-a (``ga_hrtf_part_mac``: each partition's spectrum
  interpolated in the kernel from the four grid-spectra corners, once per
  direction run of a block's quanta, the spectral MAC and the next ring),
  torch.fft's irfft without its scale and K10p-b (``ga_hrtf_part_ola``:
  the 2^-8 scale, the overlap-add and the blend); on a CPU tensor
  ``hrtf_fir_partitioned_plain``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.mixing import all_reduce_sum
from graphaudio_tpu_torch.utils import cudabuild

SPEED_OF_SOUND = 343.0
HEAD_RADIUS = 0.0875

HRIR_LENGTH = 64
N_AZIMUTH = 24  # full circle, 15 degree steps
N_ELEVATION = 7  # -90..90, 30 degree steps

# Longest measured HRIR the renderer accepts: 8 uniform 128-tap partitions.
MAX_HRIR_LENGTH = 8 * FRAMES_PER_BLOCK
#: Bins of the partitioned path's 256-point transforms.
NUM_SPEC_BINS = FRAMES_PER_BLOCK + 1

# f32 constants as Python floats: a torch f32 op rounds a Python scalar to
# f32, so these are exactly the JAX package's weak-typed f32 constants.
_TWO_PI = float(np.float32(2 * math.pi))
_HALF_PI = float(np.float32(math.pi / 2))
_PI = float(np.float32(math.pi))


def _folded_scale(divisor: float, factor: int) -> float:
    """XLA compiles ``x / c * k`` (c, k constants) as ``x * fl(fl(1/c) * k)``:
    it inverts the divisor and folds the two constants, in f32."""
    return float(np.float32(np.float32(1.0) / np.float32(divisor)) * np.float32(factor))


# ---- host-side grids (numpy, copied) ----------------------------------------


def _sphere_shadow_ir(theta_inc: float, sample_rate: int, length: int) -> np.ndarray:
    """Impulse response of the Brown-Duda spherical head-shadow filter for a
    source at incidence angle ``theta_inc`` from the ear axis (radians)."""
    w0 = SPEED_OF_SOUND / HEAD_RADIUS  # rad/s
    alpha_min = 0.1
    theta_min = np.deg2rad(150.0)
    alpha = (1.0 + alpha_min / 2.0) + (1.0 - alpha_min / 2.0) * np.cos(
        theta_inc / theta_min * np.pi
    )
    # Bilinear transform of H(s) = (alpha s + w0) / (s + w0).
    fs = float(sample_rate)
    k = 2.0 * fs
    b0 = (alpha * k + w0) / (k + w0)
    b1 = (w0 - alpha * k) / (k + w0)
    a1 = (w0 - k) / (k + w0)
    ir = np.zeros(length)
    x = np.zeros(length)
    x[0] = 1.0
    y1 = 0.0
    x1 = 0.0
    for n in range(length):
        y = b0 * x[n] + b1 * x1 - a1 * y1
        ir[n] = y
        x1 = x[n]
        y1 = y
    return ir


def _fractional_delay(ir: np.ndarray, delay: float, length: int) -> np.ndarray:
    """Apply a (possibly fractional) delay with linear interpolation."""
    out = np.zeros(length)
    d_int = int(np.floor(delay))
    frac = delay - d_int
    for n in range(length):
        src = n - d_int
        if 0 <= src < length:
            out[n] += ir[src] * (1.0 - frac)
        if 0 <= src - 1 < length:
            out[n] += ir[src - 1] * frac
    return out


def build_hrir_grid(sample_rate: int,
                    n_azimuth: int = N_AZIMUTH,
                    n_elevation: int = N_ELEVATION,
                    length: int = HRIR_LENGTH) -> np.ndarray:
    """Precompute the analytic HRIR grid: f32[n_elevation, n_azimuth, 2, length].

    Grid coordinates: azimuth in [0, 2pi) measured clockwise from straight
    ahead toward the right ear; elevation in [-pi/2, pi/2].
    """
    grid = np.zeros((n_elevation, n_azimuth, 2, length), np.float32)
    a_c = HEAD_RADIUS / SPEED_OF_SOUND
    # Headroom for the near ear's negative ITD lead (up to a/c seconds).
    base_delay = float(np.ceil(a_c * sample_rate)) + 2.0
    for ei in range(n_elevation):
        el = -np.pi / 2 + np.pi * ei / (n_elevation - 1)
        for ai in range(n_azimuth):
            az = 2 * np.pi * ai / n_azimuth
            # Unit direction: x right, y up, z ahead.
            x = np.cos(el) * np.sin(az)
            for ear, ear_x in ((0, -1.0), (1, 1.0)):  # 0 = left, 1 = right
                cos_inc = np.clip(ear_x * x, -1.0, 1.0)
                theta_inc = np.arccos(cos_inc)
                # Woodworth ITD relative to head centre.
                if theta_inc <= np.pi / 2:
                    tau = -a_c * np.cos(theta_inc)
                else:
                    tau = a_c * (theta_inc - np.pi / 2)
                delay = base_delay + tau * sample_rate
                ir = _sphere_shadow_ir(theta_inc, sample_rate, length)
                # Pinna elevation cue: one concha reflection whose delay
                # shrinks as the source rises (first notch ~6 kHz below to
                # ~11 kHz above), normalized to unity DC gain.
                notch_hz = 6000.0 + 5000.0 * (el + np.pi / 2) / np.pi
                tau_pinna = sample_rate / (2.0 * notch_hz)  # samples
                rho = 0.4 * np.cos(el)
                ir = (ir + rho * _fractional_delay(ir, tau_pinna, length)) \
                    / (1.0 + rho)
                # Gentle elevation rolloff stands in for torso shadowing.
                elev_gain = 1.0 - 0.15 * (1.0 - np.cos(el))
                grid[ei, ai, ear] = (
                    _fractional_delay(ir, delay, length) * elev_gain
                ).astype(np.float32)
    return grid


def hrtf_fft_size(hrir_length: int) -> int:
    """The JAX package's transform size for an L-tap kernel: 192 points up
    to 64 taps, else 256. The port keeps it for the carried tail's width,
    ``fft - 128``, so states move between the packages unchanged."""
    return 192 if hrir_length <= 64 else 2 * FRAMES_PER_BLOCK


def hrir_partition_count(hrir_length: int) -> int:
    """1 while one overlap-add quantum holds the kernel (L <= fft - 127),
    else ceil(L / 128) uniform 128-tap partitions on the 256-point
    transform (``hrtf_fir_partitioned``)."""
    fft = hrtf_fft_size(hrir_length)
    if hrir_length <= fft - FRAMES_PER_BLOCK:
        return 1
    return -(-hrir_length // FRAMES_PER_BLOCK)


_spectra_cache = {}


def hrir_grid_spectra(grid):
    """Kernel spectra of an HRIR grid (graphaudio_tpu/ops/hrtf.py:214-252):
    (Sr, Si) f32[E, A, 2, B] (B = hrtf_fft_size(L) // 2 + 1) while L fits
    one exact overlap-add transform, or f32[E, A, 2, P, 129] for P uniform
    128-tap partitions, each zero-padded to 256 points; numpy's f64 rfft,
    rounded to f32 once. Interpolating these spectra is the spectrum of the
    interpolated HRIR (both are linear).

    Keyed on id(grid); the cache holds the grid, so an id cannot be reused
    while its entry lives, and keeps the last 8 grids."""
    key = id(grid)
    entry = _spectra_cache.get(key)
    if entry is None or entry[0] is not grid:
        g = np.asarray(grid, dtype=np.float64)  # [E, A, 2, L]
        L = g.shape[-1]
        fft = hrtf_fft_size(L)
        P = hrir_partition_count(L)
        if P > 1:
            # h = sum_p delay(h_p, 128 p), each h_p zero-padded to 128 taps.
            g = np.pad(g, [(0, 0)] * (g.ndim - 1) + [(0, P * FRAMES_PER_BLOCK - L)])
            g = g.reshape(g.shape[:-1] + (P, FRAMES_PER_BLOCK))
        padded = np.zeros(g.shape[:-1] + (fft,))
        padded[..., :g.shape[-1]] = g
        spec = np.fft.rfft(padded, axis=-1)  # [E, A, 2(, P), bins]
        entry = (grid, spec.real.astype(np.float32), spec.imag.astype(np.float32))
        while len(_spectra_cache) >= 8:
            _spectra_cache.pop(next(iter(_spectra_cache)))
        _spectra_cache[key] = entry
    return entry[1], entry[2]


def _regrid_hrirs(hrirs, az_rad, el_rad, sample_rate, source_rate,
                  n_azimuth, n_elevation, length):
    """Fit scattered measured HRIRs onto the regular grid.

    hrirs: f64[M, 2, N]; az_rad[M] (clockwise from straight ahead toward
    the RIGHT ear); el_rad[M] in [-pi/2, pi/2]. Each grid node takes the
    inverse-distance-weighted mean of the 3 nearest measurement directions
    (exact at measurement directions).
    """
    hrirs = np.asarray(hrirs, np.float64)
    if hrirs.ndim != 3 or hrirs.shape[1] != 2:
        raise ValueError(f"expected HRIRs [M, 2, N], got {hrirs.shape}")
    if length is not None and not (1 <= length <= MAX_HRIR_LENGTH):
        raise ValueError(
            f"HRIR length must be in [1, {MAX_HRIR_LENGTH}]; got {length}"
        )
    if int(source_rate) != int(sample_rate):
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(int(sample_rate), int(source_rate))
        hrirs = resample_poly(
            hrirs, int(sample_rate) // g, int(source_rate) // g, axis=-1
        )
    if length is None:
        length = min(hrirs.shape[-1], 2 * FRAMES_PER_BLOCK)
    if hrirs.shape[-1] >= length:
        hrirs = hrirs[..., :length]
    else:
        pad = length - hrirs.shape[-1]
        hrirs = np.pad(hrirs, ((0, 0), (0, 0), (0, pad)))

    # Unit direction per measurement (x right, y up, z ahead).
    mx = np.cos(el_rad) * np.sin(az_rad)
    my = np.sin(el_rad)
    mz = np.cos(el_rad) * np.cos(az_rad)
    mdir = np.stack([mx, my, mz], axis=1)  # [M, 3]

    grid = np.zeros((n_elevation, n_azimuth, 2, length), np.float32)
    for ei in range(n_elevation):
        el = -np.pi / 2 + np.pi * ei / (n_elevation - 1)
        for ai in range(n_azimuth):
            az = 2 * np.pi * ai / n_azimuth
            gdir = np.array([
                np.cos(el) * np.sin(az),
                np.sin(el),
                np.cos(el) * np.cos(az),
            ])
            ang = np.arccos(np.clip(mdir @ gdir, -1.0, 1.0))  # [M]
            k = min(3, len(ang))
            nearest = np.argpartition(ang, k - 1)[:k]
            d = ang[nearest]
            if d.min() < 1e-6:
                w = (d < 1e-6).astype(np.float64)
            else:
                w = 1.0 / d
            w /= w.sum()
            grid[ei, ai] = np.tensordot(w, hrirs[nearest], axes=1).astype(
                np.float32
            )
    return grid


def load_hrir_grid(source, sample_rate,
                   n_azimuth: int = N_AZIMUTH,
                   n_elevation: int = N_ELEVATION,
                   length: int | None = None) -> np.ndarray:
    """Load a MEASURED HRIR set onto the regular (elevation x azimuth) grid.

    ``source``: a SOFA file path (AES69: ``Data.IR`` [M, 2, N],
    ``SourcePosition`` [M, 3] in degrees, azimuth counterclockwise), or an
    ``.npz`` path or dict with ``hrir`` f32[M, 2, N], ``azimuth_deg`` [M]
    (counterclockwise), ``elevation_deg`` [M], ``sample_rate``. IRs are
    rate-converted to ``sample_rate``, cut or padded to ``length`` (default
    min(N, 256); at most MAX_HRIR_LENGTH = 1024, past 128 taps the
    renderer splits it into 128-tap partitions) and regridded by inverse-distance weighting of the 3
    nearest measurement directions. Returns f32[n_elevation, n_azimuth, 2,
    length].
    """
    if isinstance(source, dict) or hasattr(source, "files"):
        data = source
    else:
        path = str(source)
        if path.endswith(".npz"):
            data = np.load(path)
        else:
            import h5py

            with h5py.File(path, "r") as f:
                ir = np.asarray(f["Data.IR"])  # [M, R, N]
                pos = np.asarray(f["SourcePosition"])  # [M, 3]
                sr = float(np.asarray(f["Data.SamplingRate"]).reshape(-1)[0])
            if ir.ndim != 3 or ir.shape[1] != 2:
                raise ValueError(
                    f"SOFA Data.IR must be [M, 2, N]; got {ir.shape}"
                )
            # SOFA azimuth is counterclockwise (90 = left); the grid's is
            # clockwise (90 = right).
            return _regrid_hrirs(ir, -np.deg2rad(pos[:, 0]), np.deg2rad(pos[:, 1]),
                                 sample_rate, sr, n_azimuth, n_elevation, length)
    ir = np.asarray(data["hrir"])
    az_sofa = np.deg2rad(np.asarray(data["azimuth_deg"], np.float64))
    el = np.deg2rad(np.asarray(data["elevation_deg"], np.float64))
    sr = float(np.asarray(data["sample_rate"]).reshape(-1)[0])
    return _regrid_hrirs(ir, -az_sofa, el, sample_rate, sr,
                         n_azimuth, n_elevation, length)


# ---- bilinear interpolation -------------------------------------------------


def interp_corners(azimuth, elevation, n_elevation: int, n_azimuth: int):
    """The four grid rows and bilinear weights around each direction.

    azimuth, elevation f32[...] (radians; azimuth any range, elevation in
    [-pi/2, pi/2]). Returns (rows i64[4, ...], weights f32[4, ...]) in the
    order (e0, a0), (e0, a1), (e1, a0), (e1, a1), rows = e * A + a, with the
    op order of graphaudio_tpu/ops/hrtf.py interp_hrir (:145-153) as XLA
    compiles it (``_folded_scale``); csrc/hrtf_fir.cu repeats it.
    """
    E, A = n_elevation, n_azimuth
    az = torch.remainder(azimuth, _TWO_PI) * _folded_scale(_TWO_PI, A)  # [0, A]
    el = (elevation + _HALF_PI) * _folded_scale(_PI, E - 1)  # [0, E-1]
    az_fl, el_fl = torch.floor(az), torch.floor(el)
    a0 = az_fl.long() % A
    a1 = (a0 + 1) % A
    fa = az - az_fl
    e0 = torch.clamp(el_fl.long(), 0, E - 1)
    e1 = torch.clamp(e0 + 1, 0, E - 1)
    fe = el - el_fl
    rows = torch.stack([e0 * A + a0, e0 * A + a1, e1 * A + a0, e1 * A + a1])
    weights = torch.stack([(1 - fa) * (1 - fe), fa * (1 - fe), (1 - fa) * fe, fa * fe])
    return rows, weights


def interp_hrir(grid, azimuth, elevation):
    """Bilinear HRIR interpolation (parity: IPL.HrtfInterpolation.Bilinear,
    SpatialPannerNode.cs:255; graphaudio_tpu/ops/hrtf.py:135).

    grid f32[E, A, *rest]; azimuth, elevation f32[...]. Returns
    f32[..., *rest]: w00*g00 + w01*g01 + w10*g10 + w11*g11, summed left to
    right (the JAX package's one-hot matmul sums the same four products).
    """
    E, A = grid.shape[:2]
    rest = grid.shape[2:]
    flat = grid.reshape(E * A, -1)
    rows, w = interp_corners(azimuth, elevation, E, A)
    out = None
    for c in range(4):
        term = w[c].reshape(-1, 1) * flat[rows[c].reshape(-1)]
        out = term if out is None else out + term
    return out.reshape(tuple(azimuth.shape) + tuple(rest))


# ---- P1: the per-quantum HRTF FIR -------------------------------------------


def _check_fir_shapes(x, gain, az, el, blend, grid, ola):
    V, C, T = x.shape
    S = T // FRAMES_PER_BLOCK
    if T % FRAMES_PER_BLOCK or C not in (1, 2):
        raise ValueError(f"x must be [V, 1 or 2, S*128], got {tuple(x.shape)}")
    E, A, ears, L = grid.shape
    W = hrtf_fft_size(L) - FRAMES_PER_BLOCK
    if ears != 2:
        raise ValueError(f"grid must be [E, A, 2, L], got {tuple(grid.shape)}")
    if L > W:
        raise ValueError(f"P1 takes at most {W} taps; an HRIR of {L} taps renders in "
                         f"{hrir_partition_count(L)} partitions (hrtf_fir_partitioned)")
    if tuple(ola.shape) != (V, 2, W):
        raise ValueError(f"ola must be [{V}, 2, {W}], got {tuple(ola.shape)}")
    for name, t in (("az", az), ("el", el), ("blend", blend), ("gain", gain)):
        if t is not None and tuple(t.shape) != (V, S):
            raise ValueError(f"{name} must be [{V}, {S}], got {tuple(t.shape)}")
    return V, C, T, S, E, A, L, W


def hrtf_fir_plain(x, gain, az, el, blend, grid, ola):
    """Plain torch P1: the panner's direct gain, mono downmix, per-quantum
    interpolated HRIR filter and SpatialBlend crossfade for a group.

    x f32[V, C, T] (C = 1 or 2); gain f32[V, S] per-block broadband gain, or
    None when ``x`` is already the direct signal; az, el, blend f32[V, S];
    grid f32[E, A, 2, L] (time-domain HRIRs, L <= 128); ola f32[V, 2, W]
    (W = hrtf_fft_size(L) - 128), the tail carried from the last quantum.

    direct = x * gain; mono = mean over C; for quantum s, the full linear
    convolution of mono quantum s with h_s = interp(az_s, el_s), taps summed
    in ascending order (graphaudio_tpu/ops/hrtf.py fir_freq_per_block
    without the DFT); wet = its first 128 samples + the previous quantum's
    tail (``ola`` for s = 0); out = wet * blend + dry * (1 - blend), dry the
    direct signal up-mixed to stereo (nodes/spatial.py:439-441).
    Returns (out f32[V, 2, T], ola f32[V, 2, W]).
    """
    V, C, T, S, E, A, L, W = _check_fir_shapes(x, gain, az, el, blend, grid, ola)
    F = FRAMES_PER_BLOCK
    direct = x if gain is None else x * torch.repeat_interleave(gain, F, dim=-1)[:, None, :]
    mono = direct[:, 0] if C == 1 else direct.mean(dim=1)
    m = mono.reshape(V, S, 1, F)
    h = interp_hrir(grid, az, el)  # [V, S, 2, L]
    y_full = torch.zeros((V, S, 2, F + W), dtype=x.dtype, device=x.device)
    for k in range(L):
        y_full[..., k:k + F] += h[..., k:k + 1] * m
    first, second = y_full[..., :F], y_full[..., F:]
    prev = torch.cat([ola[:, None], second[:, :-1]], dim=1)  # [V, S, 2, W]
    wet = first.clone()
    wet[..., :W] = first[..., :W] + prev
    wet = wet.permute(0, 2, 1, 3).reshape(V, 2, T)
    b = torch.repeat_interleave(blend, F, dim=-1)[:, None, :]
    dry = direct.expand(V, 2, T) if C == 1 else direct
    out = wet * b + dry * (1.0 - b)
    return out, second[:, -1].contiguous()


#: Consecutive outputs of one ear that a lane of csrc/hrtf_fir.cu owns.
FIR_TILE_OUTPUTS = 8


class FirTilePlan(NamedTuple):
    """P1's tile plan (``fir_tile_plan``)."""
    outputs: int  # R
    taps: int  # L rounded up to a multiple of R: chunks cover [0, taps)
    # Lane i's word, 2 x 128 / R of them: ear in bit 0, first output t0 in
    # bits 1-8, chunks of the quantum's own chain in bits 9-16, chunks of
    # the previous quantum's tail in bits 17-24 (csrc/hrtf_fir.cu FirLanes).
    words: np.ndarray


@functools.cache
def fir_tile_plan(L: int, W: int, R: int = FIR_TILE_OUTPUTS) -> FirTilePlan:
    """The lane table csrc/hrtf_fir.cu runs for an L-tap HRIR and a W-sample
    carried tail; the kernel takes R = 8, the CPU tests walk R = 4 too. A
    block is one (quantum, voice); lane i owns ear i % 2 and the R outputs
    from t0 = (i // 2) * R, so tiles run in ascending t0 and the ramp tiles,
    whose outputs t < L - 1 need the previous quantum's tail, take the first
    lanes: at most one warp mixes the two kinds. Both ears of a tile sit in
    neighbouring lanes and read the same mono window.

    Each lane sums each of its outputs in its own accumulator, in ascending
    tap order, so the sums round as ``hrtf_fir_plain``'s. The chains run in
    chunks of R taps over zero-padded mono buffers, so no lane branches on
    a tap: the quantum's own chain takes the chunks k0 = 0, R, .. below
    min(taps, t0 + R) (the taps past t0 + R - 1 only meet the zeros before
    the quantum), the previous chain the chunks k0 = t0, t0 + R, .. below
    ``taps`` (the taps up to t0 meet the zeros after it). A product with a
    padded zero is +-0, which leaves the bits of a sum that started at +0
    unchanged. A ramp lane runs taps / R + 1 chunks, any other taps / R."""
    F = FRAMES_PER_BLOCK
    if R not in (4, 8):
        raise ValueError(f"P1 tiles take R = 4 or 8 outputs, got {R}")
    if not (1 <= L <= W <= F and W % R == 0):
        raise ValueError(f"P1 takes 1 <= L <= W <= {F} with R | W, got L={L} W={W} R={R}")
    taps = -(-L // R) * R
    words = []
    for i in range(2 * F // R):
        t0 = (i // 2) * R
        first = min(taps, t0 + R) // R
        prev = (taps - t0) // R if t0 < L - 1 else 0
        words.append(i % 2 | t0 << 1 | first << 9 | prev << 17)
    return FirTilePlan(R, taps, np.array(words, dtype=np.int32))


def hrtf_fir(x, gain, az, el, blend, grid, ola):
    """P1 for a group of spatial panners (see ``hrtf_fir_plain`` for the
    arguments). CPU tensors take the plain version; CUDA tensors launch
    csrc/hrtf_fir.cu with the lane table of ``fir_tile_plan``. Returns
    (out f32[V, 2, T], ola f32[V, 2, W])."""
    if x.device.type == "cpu":
        return hrtf_fir_plain(x, gain, az, el, blend, grid, ola)
    V, C, T, S, E, A, L, W = _check_fir_shapes(x, gain, az, el, blend, grid, ola)
    plan = fir_tile_plan(L, W)
    req = cudabuild.require
    for name, t in (("x", x), ("gain", gain), ("az", az), ("el", el), ("blend", blend),
                    ("grid", grid), ("ola", ola)):
        if t is not None:
            req(t, name, torch.float32)
    out = torch.empty((V, 2, T), dtype=torch.float32, device=x.device)
    ola_out = torch.empty((V, 2, W), dtype=torch.float32, device=x.device)
    status = cudabuild.launcher("ga_hrtf_fir")(
        x.data_ptr(), None if gain is None else gain.data_ptr(), az.data_ptr(),
        el.data_ptr(), blend.data_ptr(), grid.data_ptr(), ola.data_ptr(), V, C, S,
        E, A, L, W, _folded_scale(_TWO_PI, A), _folded_scale(_PI, E - 1), plan.taps,
        plan.words.ctypes.data, out.data_ptr(), ola_out.data_ptr(), cudabuild.stream_of(x),
    )
    cudabuild.check(status, "ga_hrtf_fir")
    cudabuild.launches["hrtf_fir"] += 1
    return out, ola_out


def hrtf_fir_rows_plain(x, h):
    """The probe's function (benchmarks/probes/hrtf_fir_pallas.py fir_kernel
    :113-123) in plain torch: x f32[R, F+L-1], h f32[R, 2L] ->
    f32[R, 2F], out[r, c*F + t] = sum_k h[r, c*L + k] * x[r, L-1-k+t], the
    taps summed in ascending k."""
    R, L2 = h.shape
    L = L2 // 2
    F = x.shape[1] - L + 1
    acc = torch.zeros((R, 2, F), dtype=x.dtype, device=x.device)
    hv = h.reshape(R, 2, L)
    for k in range(L):
        acc += hv[:, :, k:k + 1] * x[:, None, L - 1 - k:L - 1 - k + F]
    return acc.reshape(R, 2 * F)


def hrtf_fir_rows(x, h):
    """P1 in the probe's row form: csrc/hrtf_fir.cu on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return hrtf_fir_rows_plain(x, h)
    R, L2 = h.shape
    L = L2 // 2
    F = x.shape[1] - L + 1
    cudabuild.require(x, "x", torch.float32, shape=(R, F + L - 1))
    cudabuild.require(h, "h", torch.float32, shape=(R, 2 * L))
    if not (1 <= F <= 512 and 1 <= L <= 512):
        raise ValueError(f"the row form takes 1 <= F, L <= 512, got F={F} L={L}")
    out = torch.empty((R, 2 * F), dtype=torch.float32, device=x.device)
    status = cudabuild.launcher("ga_hrtf_fir_rows")(
        x.data_ptr(), h.data_ptr(), R, F, L, out.data_ptr(), cudabuild.stream_of(x))
    cudabuild.check(status, "ga_hrtf_fir_rows")
    cudabuild.launches["hrtf_fir_rows"] += 1
    return out


# ---- K10p: the partitioned filter of HRIRs past 128 taps ----------------------
#
# graphaudio_tpu/ops/hrtf.py fir_freq_partitioned (:302) with interp_hrir
# (:135) of the partition spectra (hrir_grid_spectra, :214), as the JAX
# panner calls them (graphaudio_tpu/nodes/spatial.py:410-430). Input
# quantum u is convolved with the HRIR interpolated at u's direction, whose
# partition p lands on output quantum u + p: the spectra of output quantum
# s are sum_p X[s-p] H_p(s-p), the partitions in ascending order, where
# X[u] for u < 0 comes from the ring of the last P-1 input spectra (``hx``,
# packed [R | I], oldest first) and H_p(u) from the four grid-spectra
# corners around u's direction (``haz``, ``hel`` for the ring's quanta).


def _check_part_shapes(x, gain, az, el, blend, spec_r, spec_i, hx, haz, hel, ola,
                       sliced=False):
    """The partitioned filter's shapes; ``sliced``: the spectra hold a slice
    of the partitions, whose global count P the ring gives (P-1 rows)."""
    V, C, T = x.shape
    F, B = FRAMES_PER_BLOCK, NUM_SPEC_BINS
    S = T // F
    if T % F or S < 1 or C not in (1, 2):
        raise ValueError(f"x must be [V, 1 or 2, S*128], got {tuple(x.shape)}")
    if spec_r.dim() != 5 or tuple(spec_i.shape) != tuple(spec_r.shape):
        raise ValueError(f"spectra must be two [E, A, 2, P, {B}], got {tuple(spec_r.shape)} "
                         f"and {tuple(spec_i.shape)}")
    E, A, ears, P, bins = spec_r.shape
    if sliced:
        P = hx.shape[-2] + 1
        if ears != 2 or bins != B or not 1 <= spec_r.shape[3] <= P or P < 2:
            raise ValueError(f"spectra must be a slice [E, A, 2, P_local, {B}] of the ring's "
                             f"P = {P} partitions, got {tuple(spec_r.shape)}")
    elif ears != 2 or bins != B or not 2 <= P <= MAX_HRIR_LENGTH // F:
        raise ValueError(f"spectra must be [E, A, 2, P, {B}] with 2 <= P <= "
                         f"{MAX_HRIR_LENGTH // F}, got {tuple(spec_r.shape)}")
    for name, t, want in (("hx", hx, (V, P - 1, 2 * B)), ("haz", haz, (V, P - 1)),
                          ("hel", hel, (V, P - 1)), ("ola", ola, (V, 2, F)),
                          ("az", az, (V, S)), ("el", el, (V, S)), ("blend", blend, (V, S)),
                          ("gain", gain, (V, S))):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got {tuple(t.shape)}")
    return V, C, S, E, A, P


def partitioned_input_plain(x, gain):
    """Plain input pass: the real input of the partitioned filter's forward
    transforms. direct = x * gain (gain f32[V, S] per quantum; x itself
    when gain is None), its mean over the channels, and each 128-sample
    quantum followed by 128 zeros, for a 256-point real DFT. x f32[V, C,
    S*128]; returns f32[V, S, 256]."""
    V, C, T = x.shape
    F = FRAMES_PER_BLOCK
    S = T // F
    q = x.reshape(V, C, S, F)
    direct = q if gain is None else q * gain.reshape(V, 1, S, 1)
    mono = direct[:, 0] if C == 1 else direct.mean(dim=1)
    return torch.nn.functional.pad(mono, (0, F))


def partitioned_input(x, gain):
    """The input pass: csrc/hrtf_part.cu ``ga_hrtf_part_input`` on CUDA
    tensors (one launch in place of the gain multiply, the mean and rfft's
    pad), ``partitioned_input_plain`` (arguments and result as there) on
    CPU tensors."""
    if x.device.type == "cpu":
        return partitioned_input_plain(x, gain)
    V, C, T = x.shape
    F = FRAMES_PER_BLOCK
    S = T // F
    cudabuild.require(x, "x", torch.float32, shape=(V, C, S * F))
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the input pass reads float4s)")
    if gain is not None:
        cudabuild.require(gain, "gain", torch.float32, shape=(V, S))
    out = torch.empty((V, S, 2 * F), dtype=torch.float32, device=x.device)
    status = cudabuild.launcher("ga_hrtf_part_input")(
        x.data_ptr(), None if gain is None else gain.data_ptr(), V, C, S, out.data_ptr(),
        cudabuild.stream_of(x))
    cudabuild.check(status, "ga_hrtf_part_input")
    cudabuild.launches["hrtf_part_input"] += 1
    return out


def partitioned_inverse(acc):
    """Each output quantum's filtered block f32[V, S, 2, 256] from K10p-a's
    sums, UNSCALED (torch.fft.irfft with norm="forward"): K10p-b applies
    the 1/256."""
    return torch.fft.irfft(acc, n=2 * FRAMES_PER_BLOCK, dim=-1, norm="forward")


def partitioned_mac_plain(X, hx, haz, hel, az, el, spec_r, spec_i):
    """Plain K10p-a: the spectral MAC of the partitioned filter.

    X complex64[V, S, 129] this superblock's input spectra; hx f32[V, P-1,
    258] the last P-1 quanta's, packed [R | I], oldest first, and haz, hel
    f32[V, P-1] their directions; az, el f32[V, S] this superblock's;
    spec_r, spec_i f32[E, A, 2, P, 129] the grid's partition spectra. Over
    the P-1+S quanta of concat(ring, X) each partition's spectrum is
    interpolated at its quantum's direction (``interp_hrir``), and output
    quantum s takes, for p = 0, 1, .., P-1 in turn, Y = Y + X[s-p] H_p(s-p)
    as yr + xr hr - xi hi and yi + xr hi + xi hr (the JAX package's
    expression). Returns (acc complex64[V, S, 2, 129], the next ring f32[V,
    P-1, 258], haz, hel f32[V, P-1]): the last P-1 rows of the
    concatenations."""
    V, S, B = X.shape
    P = spec_r.shape[3]
    xcat = torch.cat([hx, torch.cat([X.real, X.imag], dim=-1)], dim=1)  # [V, P-1+S, 2B]
    az_cat = torch.cat([haz, az], dim=1)
    el_cat = torch.cat([hel, el], dim=1)
    hr = interp_hrir(spec_r, az_cat, el_cat)  # [V, P-1+S, 2, P, B]
    hi = interp_hrir(spec_i, az_cat, el_cat)
    yr = torch.zeros((V, S, 2, B), dtype=hx.dtype, device=hx.device)
    yi = torch.zeros_like(yr)
    for p in range(P):
        start = P - 1 - p
        xs = xcat[:, start:start + S, None]  # [V, S, 1, 2B]
        xr, xi = xs[..., :B], xs[..., B:]
        hrp, hip = hr[:, start:start + S, :, p], hi[:, start:start + S, :, p]  # [V, S, 2, B]
        yr = yr + xr * hrp - xi * hip
        yi = yi + xr * hip + xi * hrp
    return (torch.complex(yr, yi), xcat[:, S:].contiguous(), az_cat[:, S:].contiguous(),
            el_cat[:, S:].contiguous())


def partitioned_ola_plain(y, ola, x, gain, blend):
    """Plain K10p-b: the overlap-add and the SpatialBlend crossfade.

    y f32[V, S, 2, 256]: each output quantum's filtered block, the inverse
    DFT of K10p-a's spectra UNSCALED (``partitioned_inverse``), here
    multiplied by 2^-8 as irfft's own scale would; ola f32[V, 2, 128] the
    previous quantum's second half; x, gain as ``partitioned_input_plain``;
    blend f32[V, S]. wet = the first 128 samples of quantum s + the last
    128 of s-1 (``ola`` for s = 0); out = wet * blend + dry * (1 - blend),
    dry the direct signal up-mixed to stereo. Returns (out f32[V, 2,
    S*128], ola f32[V, 2, 128]: the last quantum's second half)."""
    V, S = blend.shape
    F = FRAMES_PER_BLOCK
    C, T = x.shape[1], S * F
    y = y * (1.0 / (2 * F))
    first, second = y[..., :F], y[..., F:]
    prev = torch.cat([ola[:, None], second[:, :-1]], dim=1)  # [V, S, 2, F]
    wet = (first + prev).permute(0, 2, 1, 3).reshape(V, 2, T)
    direct = x if gain is None else x * torch.repeat_interleave(gain, F, dim=-1)[:, None, :]
    dry = direct.expand(V, 2, T) if C == 1 else direct
    b = torch.repeat_interleave(blend, F, dim=-1)[:, None, :]
    return wet * b + dry * (1.0 - b), second[:, -1].contiguous()


def hrtf_fir_partitioned_plain(x, gain, az, el, blend, spec_r, spec_i, hx, haz, hel, ola):
    """Plain torch K10p: the panner's partitioned HRTF filter for a group.

    x f32[V, C, T] (C = 1 or 2, T = S*128); gain f32[V, S] per-quantum
    broadband gain, or None when ``x`` is already the direct signal; az,
    el, blend f32[V, S]; spec_r, spec_i f32[E, A, 2, P, 129]
    (``hrir_grid_spectra`` of an HRIR of 129-1024 taps); the carried state
    hx f32[V, P-1, 258], haz, hel f32[V, P-1], ola f32[V, 2, 128], in the
    JAX package's layout. ``partitioned_input_plain``, the forward DFT
    (torch.fft.rfft), ``partitioned_mac_plain``, the unscaled inverse DFT
    (``partitioned_inverse``) and ``partitioned_ola_plain``. Returns (out
    f32[V, 2, T], hx, haz, hel, ola)."""
    _check_part_shapes(x, gain, az, el, blend, spec_r, spec_i, hx, haz, hel, ola)
    X = torch.fft.rfft(partitioned_input_plain(x, gain), dim=-1)
    acc, hx, haz, hel = partitioned_mac_plain(X, hx, haz, hel, az, el, spec_r, spec_i)
    out, ola = partitioned_ola_plain(partitioned_inverse(acc), ola, x, gain, blend)
    return out, hx, haz, hel, ola


#: The output quanta a K10p-a block may walk (csrc/hrtf_part.cu
#: instantiates these), most first.
MAC_BLOCK_QUANTA = (16, 8, 4)


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def mac_block_quanta(V, S, sms):
    """The quanta a K10p-a block walks: the most of ``MAC_BLOCK_QUANTA``
    whose grid, ceil(S / q) blocks a voice, still gives each of the card's
    ``sms`` SMs a block (else the fewest)."""
    for q in MAC_BLOCK_QUANTA:
        if -(-S // q) * V >= sms:
            return q
    return MAC_BLOCK_QUANTA[-1]


def partitioned_mac(X, hx, haz, hel, az, el, spec_r, spec_i):
    """K10p-a: csrc/hrtf_part.cu ``ga_hrtf_part_mac`` on CUDA tensors,
    ``partitioned_mac_plain`` (arguments and result as there) on CPU
    tensors. A block per (``mac_block_quanta`` output quanta, voice), a
    thread an (ear, bin): the block's window of the ring and X staged once;
    each partition walks the block's quanta in order, interpolating its
    spectrum only where the direction changes and fetching the four
    corners only where they change; the last block of a voice writes the
    next ring."""
    if X.device.type == "cpu":
        return partitioned_mac_plain(X, hx, haz, hel, az, el, spec_r, spec_i)
    V, S, B = X.shape
    E, A, _, P, _ = spec_r.shape
    req = cudabuild.require
    req(X, "X", torch.complex64, shape=(V, S, NUM_SPEC_BINS))
    for name, t, shape in (("hx", hx, (V, P - 1, 2 * B)), ("haz", haz, (V, P - 1)),
                           ("hel", hel, (V, P - 1)), ("az", az, (V, S)), ("el", el, (V, S)),
                           ("spec_r", spec_r, (E, A, 2, P, B)),
                           ("spec_i", spec_i, (E, A, 2, P, B))):
        req(t, name, torch.float32, shape=shape)
    dev = X.device
    acc = torch.empty((V, S, 2, B), dtype=torch.complex64, device=dev)
    hx_out = torch.empty((V, P - 1, 2 * B), dtype=torch.float32, device=dev)
    haz_out = torch.empty((V, P - 1), dtype=torch.float32, device=dev)
    hel_out = torch.empty((V, P - 1), dtype=torch.float32, device=dev)
    status = cudabuild.launcher("ga_hrtf_part_mac")(
        X.data_ptr(), hx.data_ptr(), haz.data_ptr(), hel.data_ptr(), az.data_ptr(),
        el.data_ptr(), spec_r.data_ptr(), spec_i.data_ptr(), V, S, P, E, A,
        _folded_scale(_TWO_PI, A), _folded_scale(_PI, E - 1),
        mac_block_quanta(V, S, _sm_count(dev.index)), acc.data_ptr(),
        hx_out.data_ptr(), haz_out.data_ptr(), hel_out.data_ptr(), cudabuild.stream_of(X))
    cudabuild.check(status, "ga_hrtf_part_mac")
    cudabuild.launches["hrtf_part_mac"] += 1
    return acc, hx_out, haz_out, hel_out


# ---- K14b: K10p-a over one rank's slice of the partitions ---------------------
#
# The ``part_axis`` branch of graphaudio_tpu/ops/hrtf.py fir_freq_partitioned
# (:345-379): under a mesh whose ``part`` dimension splits a per-node HRIR's
# (zero-padded) P partitions, each rank holds the grid spectra of its slice
# [p_base, p_base + P_local) and MACs it against the replicated timeline at
# the partitions' global offsets; one all_reduce over ``part`` completes
# the sums before the inverse transform and K10p-b, which every rank runs
# once on the whole sums (so the input pass's gain and downmix, and
# K10p-b's dry path and blend, count once).


#: The most partitions a K14b slice takes (csrc/hrtf_part.cu instantiates
#: 1 to 8): a slice of the longest HRIR's 8 partitions under any ``part``.
MAX_SLICE_PARTITIONS = MAX_HRIR_LENGTH // FRAMES_PER_BLOCK


def partitioned_mac_slice_plain(X, hx, haz, hel, az, el, spec_r, spec_i, p_base: int):
    """Plain K14b: ``partitioned_mac_plain`` over the partitions [p_base,
    p_base + P_local) of spec_r, spec_i f32[E, A, 2, P_local, 129] (the
    rank's slice), with the whole ring hx f32[V, P-1, 258], haz, hel f32[V,
    P-1] of a P-partition filter (P global). Output quantum s takes, for
    local partitions j = 0, 1, .. in turn (global p = p_base + j), Y = Y +
    X[s-p] H_p(s-p), the JAX package's expression. Returns (the partial
    acc complex64[V, S, 2, 129], the next ring, haz, hel: the whole of
    them, as ``partitioned_mac_plain``'s)."""
    V, S, B = X.shape
    Pl = spec_r.shape[3]
    P = hx.shape[1] + 1
    if not (0 <= p_base and p_base + Pl <= P):
        raise ValueError(f"partitions [{p_base}, {p_base + Pl}) are not of P = {P}")
    xcat = torch.cat([hx, torch.cat([X.real, X.imag], dim=-1)], dim=1)  # [V, P-1+S, 2B]
    az_cat = torch.cat([haz, az], dim=1)
    el_cat = torch.cat([hel, el], dim=1)
    hr = interp_hrir(spec_r, az_cat, el_cat)  # [V, P-1+S, 2, P_local, B]
    hi = interp_hrir(spec_i, az_cat, el_cat)
    yr = torch.zeros((V, S, 2, B), dtype=hx.dtype, device=hx.device)
    yi = torch.zeros_like(yr)
    for j in range(Pl):
        start = P - 1 - (p_base + j)
        xs = xcat[:, start:start + S, None]  # [V, S, 1, 2B]
        xr, xi = xs[..., :B], xs[..., B:]
        hrp, hip = hr[:, start:start + S, :, j], hi[:, start:start + S, :, j]
        yr = yr + xr * hrp - xi * hip
        yi = yi + xr * hip + xi * hrp
    return (torch.complex(yr, yi), xcat[:, S:].contiguous(), az_cat[:, S:].contiguous(),
            el_cat[:, S:].contiguous())


def partitioned_mac_slice(X, hx, haz, hel, az, el, spec_r, spec_i, p_base: int):
    """K14b: csrc/hrtf_part.cu ``ga_hrtf_part_mac_slice`` on CUDA tensors (a
    block one warp of 32 (ear, bin) columns of one (output quantum, voice);
    the slice's 1 to ``MAX_SLICE_PARTITIONS`` partitions a template
    argument, their corners computed by as many lanes and shuffled to the
    warp, every corner load issued before the multiply-adds; the next ring
    spread one value a thread over the blocks), ``partitioned_mac_slice_plain``
    (arguments and result as there) on CPU tensors."""
    if X.device.type == "cpu":
        return partitioned_mac_slice_plain(X, hx, haz, hel, az, el, spec_r, spec_i, p_base)
    V, S, B = X.shape
    E, A, _, Pl, _ = spec_r.shape
    P = hx.shape[1] + 1
    if not 1 <= Pl <= MAX_SLICE_PARTITIONS:
        raise ValueError(f"K14b takes 1 to {MAX_SLICE_PARTITIONS} partitions a slice, got {Pl}")
    req = cudabuild.require
    req(X, "X", torch.complex64, shape=(V, S, NUM_SPEC_BINS))
    for name, t, shape in (("hx", hx, (V, P - 1, 2 * B)), ("haz", haz, (V, P - 1)),
                           ("hel", hel, (V, P - 1)), ("az", az, (V, S)), ("el", el, (V, S)),
                           ("spec_r", spec_r, (E, A, 2, Pl, B)),
                           ("spec_i", spec_i, (E, A, 2, Pl, B))):
        req(t, name, torch.float32, shape=shape)
    dev = X.device
    acc = torch.empty((V, S, 2, B), dtype=torch.complex64, device=dev)
    hx_out = torch.empty((V, P - 1, 2 * B), dtype=torch.float32, device=dev)
    haz_out = torch.empty((V, P - 1), dtype=torch.float32, device=dev)
    hel_out = torch.empty((V, P - 1), dtype=torch.float32, device=dev)
    status = cudabuild.launcher("ga_hrtf_part_mac_slice")(
        X.data_ptr(), hx.data_ptr(), haz.data_ptr(), hel.data_ptr(), az.data_ptr(),
        el.data_ptr(), spec_r.data_ptr(), spec_i.data_ptr(), V, S, P, Pl, int(p_base), E, A,
        _folded_scale(_TWO_PI, A), _folded_scale(_PI, E - 1), acc.data_ptr(),
        hx_out.data_ptr(), haz_out.data_ptr(), hel_out.data_ptr(), cudabuild.stream_of(X))
    cudabuild.check(status, "ga_hrtf_part_mac_slice")
    cudabuild.launches["hrtf_part_mac_slice"] += 1
    return acc, hx_out, haz_out, hel_out


def partitioned_ola(y, ola, x, gain, blend):
    """K10p-b: csrc/hrtf_part.cu ``ga_hrtf_part_ola`` on CUDA tensors,
    ``partitioned_ola_plain`` (arguments and result as there: y unscaled)
    on CPU tensors. A thread an output sample."""
    if y.device.type == "cpu":
        return partitioned_ola_plain(y, ola, x, gain, blend)
    V, S = blend.shape
    F = FRAMES_PER_BLOCK
    C = x.shape[1]
    req = cudabuild.require
    req(y, "y", torch.float32, shape=(V, S, 2, 2 * F))
    req(ola, "ola", torch.float32, shape=(V, 2, F))
    req(x, "x", torch.float32, shape=(V, C, S * F))
    req(blend, "blend", torch.float32, shape=(V, S))
    if gain is not None:
        req(gain, "gain", torch.float32, shape=(V, S))
    out = torch.empty((V, 2, S * F), dtype=torch.float32, device=y.device)
    ola_out = torch.empty((V, 2, F), dtype=torch.float32, device=y.device)
    status = cudabuild.launcher("ga_hrtf_part_ola")(
        y.data_ptr(), ola.data_ptr(), x.data_ptr(), None if gain is None else gain.data_ptr(),
        blend.data_ptr(), V, C, S, out.data_ptr(), ola_out.data_ptr(), cudabuild.stream_of(y))
    cudabuild.check(status, "ga_hrtf_part_ola")
    cudabuild.launches["hrtf_part_ola"] += 1
    return out, ola_out


def hrtf_fir_partitioned(x, gain, az, el, blend, spec_r, spec_i, hx, haz, hel, ola,
                         part=None):
    """K10p for a group of spatial panners whose HRIR has 129-1024 taps
    (arguments and result as ``hrtf_fir_partitioned_plain``): the input
    pass, cuFFT's forward transform, K10p-a, cuFFT's unscaled inverse and
    K10p-b, each kernel's plain version on CPU tensors (which is then
    ``hrtf_fir_partitioned_plain``). With ``part`` = (p_base, group) the
    partitions are split over ranks: spec_r, spec_i hold this rank's slice
    [p_base, p_base + P_local) of the ring's P, K14b MACs it and one
    all_reduce over ``group`` (the mesh's ``part`` line) completes the
    sums; every rank runs the input pass and K10p-b once, on its whole
    input and the whole sums."""
    _check_part_shapes(x, gain, az, el, blend, spec_r, spec_i, hx, haz, hel, ola,
                       sliced=part is not None)
    X = torch.fft.rfft(partitioned_input(x, gain), dim=-1)
    if part is None:
        acc, hx, haz, hel = partitioned_mac(X, hx, haz, hel, az, el, spec_r, spec_i)
    else:
        p_base, group = part
        acc, hx, haz, hel = partitioned_mac_slice(X, hx, haz, hel, az, el, spec_r, spec_i, p_base)
        acc = all_reduce_sum(acc, group)
    out, ola = partitioned_ola(partitioned_inverse(acc), ola, x, gain, blend)
    return out, hx, haz, hel, ola
