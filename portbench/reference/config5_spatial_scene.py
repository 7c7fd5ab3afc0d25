"""Plain reference of config 5, the Kit's spatial scene, in float64.

The scene (``portbench/configs/config5_spatial_scene.py``): V looped mono
sounds, each through its gain (1) and an HRTF spatial panner into the
``sfx`` bus, whose reverb effect adds a convolution of the bus's mono
down-mix (wet 0.3) to the dry bus (1); the master bus passes it on.

Semantics, from the port's and the JAX package's sources read as a
specification (never imported):

* a sound started at frame 0 at its buffer's own rate plays sample
  ``t mod N`` at frame t;
* the panner works a 128-frame quantum at a time, from the k-rate
  position of the quantum: the listener-relative direction in the
  listener's basis (right = forward x up, up = right x forward, ahead =
  -forward), azimuth atan2(dx, -dz) and elevation asin(dy), the inverse
  distance gain min(1, ref / distance) (refDistance 1; no cone, no
  occlusion) and a spatial blend of 1 (SpatialPannerNode.cs:133-260);
* the quantum's HRIR is the bilinear interpolation of the grid's four
  HRIRs around that direction (IPL.HrtfInterpolation.Bilinear); the grid
  is the analytic spherical head, computed here again (``hrir_grid``);
* input-side filtering: quantum s of the gained mono input is convolved
  with its own HRIR and its tail overlap-adds into the quanta after it;
  the panner's output is that, times the blend, plus the direct signal
  up-mixed to stereo times (1 - blend);
* the reverb down-mixes the bus to mono by GraphAudio.Core's rule for N
  channels to one, (L + R) / sqrt(2) (AudioNodeInput.cs:214-228), convolves
  that with the normalized mono IR (``plain.normalization_scale``), no
  latency, and its wet gain's output, up-mixed, adds to both channels of
  the dry bus.

``render_blocks`` computes any blocks of that stream from scratch: a block
needs the IR's length of bus signal before it, which it recomputes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.plain import Precision, convolve_valid, normalization_scale

F = 128  # frames a quantum
#: Sounds filtered at once (bounds the transforms' memory).
VOICE_CHUNK = 16

# The analytic grid: 7 elevations x 24 azimuths x 64 taps, a head of
# 8.75 cm in air at 343 m/s (graphaudio_tpu/ops/hrtf.py build_hrir_grid).
SPEED_OF_SOUND = 343.0
HEAD_RADIUS = 0.0875
HRIR_LENGTH = 64
N_AZIMUTH = 24
N_ELEVATION = 7
REF_DISTANCE = 1.0
BLEND = 1.0


def _sphere_shadow_ir(theta_inc: float, sample_rate: int, length: int) -> np.ndarray:
    """Brown-Duda head shadow H(s) = (alpha s + w0) / (s + w0) by the
    bilinear transform, at incidence ``theta_inc`` from the ear axis."""
    w0 = SPEED_OF_SOUND / HEAD_RADIUS
    alpha = (1.0 + 0.1 / 2.0) + (1.0 - 0.1 / 2.0) * math.cos(theta_inc / math.radians(150.0)
                                                            * math.pi)
    k = 2.0 * sample_rate
    b0, b1, a1 = (alpha * k + w0) / (k + w0), (w0 - alpha * k) / (k + w0), (w0 - k) / (k + w0)
    ir = np.zeros(length)
    x1 = y1 = 0.0
    for n in range(length):
        x = 1.0 if n == 0 else 0.0
        y = b0 * x + b1 * x1 - a1 * y1
        ir[n], x1, y1 = y, x, y
    return ir


def _delay(ir: np.ndarray, delay: float) -> np.ndarray:
    """``ir`` delayed by ``delay`` samples, linearly interpolated, cut to
    its length."""
    n = len(ir)
    d = int(math.floor(delay))
    frac = delay - d
    out = np.zeros(n)
    for i in range(n):
        src = i - d
        if 0 <= src < n:
            out[i] += ir[src] * (1.0 - frac)
        if 0 <= src - 1 < n:
            out[i] += ir[src - 1] * frac
    return out


def hrir_grid(sample_rate: int) -> np.ndarray:
    """f64[E, A, 2, L]: the analytic HRIR at elevation -pi/2 + pi e / (E-1)
    and azimuth 2 pi a / A (clockwise from ahead towards the right ear),
    ear 0 left, 1 right: the head shadow, Woodworth's delay, a pinna
    reflection normalized to unity DC and an elevation roll-off."""
    grid = np.zeros((N_ELEVATION, N_AZIMUTH, 2, HRIR_LENGTH))
    a_c = HEAD_RADIUS / SPEED_OF_SOUND
    base_delay = math.ceil(a_c * sample_rate) + 2.0
    for ei in range(N_ELEVATION):
        el = -math.pi / 2 + math.pi * ei / (N_ELEVATION - 1)
        for ai in range(N_AZIMUTH):
            az = 2 * math.pi * ai / N_AZIMUTH
            x = math.cos(el) * math.sin(az)
            for ear, side in ((0, -1.0), (1, 1.0)):
                theta = math.acos(min(max(side * x, -1.0), 1.0))
                # Woodworth's delay relative to the head's centre
                if theta <= math.pi / 2:
                    tau = -a_c * math.cos(theta)
                else:
                    tau = a_c * (theta - math.pi / 2)
                ir = _sphere_shadow_ir(theta, sample_rate, HRIR_LENGTH)
                notch_hz = 6000.0 + 5000.0 * (el + math.pi / 2) / math.pi
                rho = 0.4 * math.cos(el)
                ir = (ir + rho * _delay(ir, sample_rate / (2.0 * notch_hz))) / (1.0 + rho)
                grid[ei, ai, ear] = _delay(ir, base_delay + tau * sample_rate) * (
                    1.0 - 0.15 * (1.0 - math.cos(el)))
    return grid


def listener_basis(listener: dict):
    """(position, right, up, ahead) f64[3] of the listener's transform."""
    f = np.asarray(listener["forward"], np.float64)
    u = np.asarray(listener["up"], np.float64)
    f = f / np.linalg.norm(f)
    u = u / np.linalg.norm(u)
    right = np.cross(f, u)
    right /= np.linalg.norm(right)
    return np.asarray(listener["position"], np.float64), right, np.cross(right, f), -f


def direction_and_gain(places, listener: dict):
    """Per (sound, quantum) position f32[..., 3]: (azimuth, elevation,
    gain) f64[...]: the direction in the listener's basis and the inverse
    distance gain."""
    pos, right, up, ahead = listener_basis(listener)
    w = np.asarray(places, np.float64) - pos
    dist = np.sqrt((w * w).sum(-1))
    near = dist <= 1e-4
    unit = w / np.where(near, 1.0, dist)[..., None]
    dx = np.where(near, 0.0, unit @ right)
    dy = np.where(near, 0.0, unit @ up)
    dz = np.where(near, -1.0, unit @ ahead)
    gain = np.where(dist <= REF_DISTANCE, 1.0, REF_DISTANCE / np.where(near, 1.0, dist))
    return np.arctan2(dx, -dz), np.arcsin(np.clip(dy, -1.0, 1.0)), np.clip(gain, 0.0, 1.0)


def interp_hrirs(grid, azimuth, elevation):
    """f64[..., 2, L]: the bilinear interpolation of the grid's four HRIRs
    around each direction."""
    E, A = grid.shape[:2]
    az = np.mod(azimuth, 2 * math.pi) * (A / (2 * math.pi))
    el = (elevation + math.pi / 2) * ((E - 1) / math.pi)
    az_fl, el_fl = np.floor(az), np.floor(el)
    a0 = az_fl.astype(np.int64) % A
    a1 = (a0 + 1) % A
    fa = (az - az_fl)[..., None, None]
    e0 = np.clip(el_fl.astype(np.int64), 0, E - 1)
    e1 = np.clip(e0 + 1, 0, E - 1)
    fe = (el - el_fl)[..., None, None]
    return ((1 - fa) * (1 - fe) * grid[e0, a0] + fa * (1 - fe) * grid[e0, a1]
            + (1 - fa) * fe * grid[e1, a0] + fa * fe * grid[e1, a1])


def panners_sum(cfg: dict, inputs: dict, grid, places_at, q0: int, nq: int, prec: Precision):
    """The sum of every panner's output, f[2, nq * 128], over quanta q0 ..
    q0 + nq - 1 (the quantum before q0 computed too, for its tail)."""
    dev = prec.device
    voices = inputs["voices"]
    V, N = voices.shape
    first = q0 - 1
    quanta = np.arange(first, q0 + nq)
    places = places_at(np.maximum(quanta, 0))  # f32[V, Q, 3]
    az, el, gain = direction_and_gain(places, cfg["listener"])
    frames = quanta[:, None] * F + np.arange(F)  # [Q, 128]
    live = torch.as_tensor(frames >= 0, device=dev)
    idx = torch.as_tensor(np.mod(frames, N), device=dev)
    total = torch.zeros((2, (nq + 1) * F), dtype=prec.dtype, device=dev)
    for v0 in range(0, V, VOICE_CHUNK):
        vs = slice(v0, v0 + VOICE_CHUNK)
        x = prec(voices[vs])[:, idx] * live  # [v, Q, 128]
        direct = prec(x * prec(gain[vs])[..., None])
        h = prec(interp_hrirs(grid, az[vs], el[vs]))  # [v, Q, 2, L]
        L = h.shape[-1]
        size = 2 * F
        y = torch.fft.irfft(torch.fft.rfft(direct[:, :, None, :], n=size)
                            * torch.fft.rfft(h, n=size), n=size)[..., :F + L - 1]
        wet = y[..., :F].clone()
        wet[:, 1:, :, :L - 1] += y[:, :-1, :, F:]  # the previous quantum's tail
        out = BLEND * wet + (1.0 - BLEND) * direct[:, :, None, :]
        total = total + prec(out).sum(0).permute(1, 0, 2).reshape(2, -1)
    return prec(total[:, F:])


def start_places(cfg: dict, angles) -> np.ndarray:
    """f32[V, 3]: each sound on the circle of ``radius`` in the horizontal
    plane at its angle, rounded to f32 as a Kit sound stores it."""
    a = np.asarray(angles, np.float64)
    r = cfg["radius"]
    return np.stack([r * np.cos(a), np.zeros_like(a), r * np.sin(a)], axis=-1).astype(np.float32)


def render_blocks(cfg: dict, inputs: dict, blocks, precision: str = "float64", device="cpu",
                  edits=None):
    """The destination's audio in each block (frame0, n) of the stream, both
    multiples of 128: a list of f64 numpy arrays [2, n]. ``edits`` maps
    quantum indices (int64[Q]) to the sounds' positions f32[V, Q, 3]; None
    keeps every sound at its start."""
    prec = Precision(precision, device)
    sr = cfg["sample_rate"]
    grid = hrir_grid(sr)
    if edits is None:
        start = start_places(cfg, inputs["angles"])
        edits = lambda quanta: np.repeat(start[:, None], len(quanta), axis=1)  # noqa: E731
    ir = np.asarray(inputs["ir"][0], np.float64)
    M = ir.shape[-1]
    h = prec(ir * normalization_scale(ir))
    out = []
    for frame0, n in blocks:
        if frame0 % F or n % F:
            raise ValueError("blocks must start and end on quanta")
        q_hist = -(-(M - 1) // F)  # quanta of bus signal the reverb reads back
        q0 = frame0 // F - q_hist
        bus = panners_sum(cfg, inputs, grid, edits, q0, q_hist + n // F, prec)
        mono = prec((bus[0] + bus[1]) / math.sqrt(2.0))
        rev = prec(convolve_valid(mono[None, -(n + M - 1):], h, n))
        wet = prec(cfg["reverb_wet"] * rev)
        out.append(prec(bus[:, -n:] + wet).double().cpu().numpy())
    return out
