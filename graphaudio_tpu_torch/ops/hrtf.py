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

* ``hrtf_fir``: csrc/hrtf_fir.cu on a CUDA tensor, ``hrtf_fir_plain`` on a
  CPU tensor. INPUT-side semantics, as the package and its oracle: input
  quantum s is convolved with the kernel interpolated at s, and its tail
  overlap-adds into quantum s+1 (the carried ``ola`` tail crosses
  superblocks). The probe's kernel is OUTPUT-side (quantum s applies h[s]
  to the last 191 input samples), which differs for a moving source.
* ``hrtf_fir_rows``: the probe's own row form, for holding the kernel
  against the probe's function (``hrtf_fir_rows_plain``).

Kernels longer than 128 taps take the JAX package's partitioned path
(``fir_freq_partitioned`` :302), which is not ported: they raise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.utils import cudabuild

SPEED_OF_SOUND = 343.0
HEAD_RADIUS = 0.0875

HRIR_LENGTH = 64
N_AZIMUTH = 24  # full circle, 15 degree steps
N_ELEVATION = 7  # -90..90, 30 degree steps

# Longest measured HRIR the JAX renderer accepts: 8 uniform 128-tap partitions.
MAX_HRIR_LENGTH = 8 * FRAMES_PER_BLOCK

PARTITIONED_TODO = (
    "HRIRs longer than 128 taps render through uniformly partitioned "
    "kernels (the JAX package's fir_freq_partitioned with its hx/haz/hel "
    "history), which are not ported yet (ROADMAP.md module item 11b); "
    "pass length<=128 to load_hrir/set_default_hrir"
)

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
    else ceil(L / 128) uniform 128-tap partitions (not ported)."""
    fft = hrtf_fft_size(hrir_length)
    if hrir_length <= fft - FRAMES_PER_BLOCK:
        return 1
    return -(-hrir_length // FRAMES_PER_BLOCK)


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
    min(N, 256)) and regridded by inverse-distance weighting of the 3
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
        raise NotImplementedError(PARTITIONED_TODO)
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


def hrtf_fir(x, gain, az, el, blend, grid, ola):
    """P1 for a group of spatial panners (see ``hrtf_fir_plain`` for the
    arguments). CPU tensors take the plain version; CUDA tensors launch
    csrc/hrtf_fir.cu. Returns (out f32[V, 2, T], ola f32[V, 2, W])."""
    if x.device.type == "cpu":
        return hrtf_fir_plain(x, gain, az, el, blend, grid, ola)
    V, C, T, S, E, A, L, W = _check_fir_shapes(x, gain, az, el, blend, grid, ola)
    req = cudabuild.require
    for name, t in (("x", x), ("gain", gain), ("az", az), ("el", el), ("blend", blend),
                    ("grid", grid), ("ola", ola)):
        if t is not None:
            req(t, name, torch.float32)
    out = torch.empty((V, 2, T), dtype=torch.float32, device=x.device)
    ola_out = torch.empty((V, 2, W), dtype=torch.float32, device=x.device)
    status = cudabuild.load().ga_hrtf_fir(
        x.data_ptr(), None if gain is None else gain.data_ptr(), az.data_ptr(),
        el.data_ptr(), blend.data_ptr(), grid.data_ptr(), ola.data_ptr(), V, C, S,
        E, A, L, W, _folded_scale(_TWO_PI, A), _folded_scale(_PI, E - 1),
        out.data_ptr(), ola_out.data_ptr(), cudabuild.stream_of(x),
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
    status = cudabuild.load().ga_hrtf_fir_rows(
        x.data_ptr(), h.data_ptr(), R, F, L, out.data_ptr(), cudabuild.stream_of(x))
    cudabuild.check(status, "ga_hrtf_fir_rows")
    cudabuild.launches["hrtf_fir_rows"] += 1
    return out
