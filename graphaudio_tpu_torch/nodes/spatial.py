"""3-D spatial panner: HRTF binaural rendering + closed-form direct path.

The port of graphaudio_tpu/nodes/spatial.py (parity target:
GraphAudio.SteamAudio/Nodes/SpatialPannerNode.cs): 17 k-rate params
(:94-110), the listener-relative direction in the listener basis
(:133-164), cone directivity (:166-204), distance attenuation with the
Linear / Inverse / Exponential model (:206-216, 263-284), occlusion with
3-band transmission (:218-248), and HRTF rendering with bilinear
interpolation and a SpatialBlend crossfade (:250-260).

Panners sharing a channel layout, distance model, HRIR grid and occlusion
state run as one group stage; ``process`` takes the stacked lanes:

* K10b ``spatial_gains`` (csrc/spatial_gains.cu): the direct path per
  (voice, quantum): direction, gains, blend;
* K9 ``onepole_lowpass`` twice (ops/onepole.py), only once occlusion or
  transmission was touched: the 3-band split;
* P1 ``hrtf_fir`` (ops/hrtf.py, csrc/hrtf_fir.cu): the direct gain, the
  mono downmix, the per-quantum interpolated HRIR filter and the blend.

The HRIR grid is the group's stage constant ``hrtf_grid`` f32[E, A, 2, L].
Left out (ROADMAP.md): HRIRs past 128 taps (the partitioned path, item
11b) and the ``part``-mesh single-stage members (item 15).
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.node import AudioNode, ChannelCountMode, ChannelInterpretation
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.ops.hrtf import (
    N_AZIMUTH,
    N_ELEVATION,
    PARTITIONED_TODO,
    build_hrir_grid,
    hrir_partition_count,
    hrtf_fft_size,
    hrtf_fir,
    load_hrir_grid,
)
from graphaudio_tpu_torch.ops.onepole import onepole_lowpass
from graphaudio_tpu_torch.utils import cudabuild

_F32MAX = 3.4028235e38
_RAD2DEG = float(np.float32(180.0 / math.pi))

# 3-band transmission crossover frequencies (phonon uses 800 Hz / 8 kHz).
XOVER_LOW_HZ = 800.0
XOVER_HIGH_HZ = 8000.0

# K10b's input rows, in order.
GAIN_PARAMS = (
    "positionX", "positionY", "positionZ",
    "orientationX", "orientationY", "orientationZ",
    "refDistance", "maxDistance", "rolloffFactor",
    "coneInnerAngle", "coneOuterAngle", "coneOuterGain",
    "spatialBlend", "occlusion",
    "transmissionLow", "transmissionMid", "transmissionHigh",
)


class DistanceModelType(enum.Enum):
    """Parity: SpatialPannerNode.DistanceModelType (:42-47)."""

    LINEAR = "linear"
    INVERSE = "inverse"
    EXPONENTIAL = "exponential"


_MODEL_CODE = {DistanceModelType.LINEAR: 0, DistanceModelType.INVERSE: 1,
               DistanceModelType.EXPONENTIAL: 2}
_LISTENER_KEYS = ("listener_pos", "listener_right", "listener_up", "listener_ahead")

_hrir_cache = {}


def _hrir_grid(sample_rate: int) -> np.ndarray:
    grid = _hrir_cache.get(sample_rate)
    if grid is None:
        grid = build_hrir_grid(sample_rate)
        _hrir_cache[sample_rate] = grid
    return grid


# ---- K10b: the direct path ---------------------------------------------------


def spatial_gains_plain(p, listener, model: DistanceModelType):
    """Plain torch K10b (graphaudio_tpu/nodes/spatial.py _direct_gains
    :270-348 and the direction of process :399-400).

    p f32[17, V, S]: the k-rate params per quantum, in GAIN_PARAMS order;
    listener: dict of f32[3] (``__globals__``). Returns f32[6, V, S]:
    azimuth, elevation, low / mid / high band gains, blend.
    """
    (px, py, pz, ox, oy, oz, ref, mx, rolloff, inner, outer, outer_gain,
     blend, occ, tl, tm, th) = p
    lp, right, up, ahead = (listener[k] for k in _LISTENER_KEYS)
    w0, w1, w2 = px - lp[0], py - lp[1], pz - lp[2]
    distance = torch.sqrt(w0 * w0 + w1 * w1 + w2 * w2)
    near = distance <= 1e-4
    inv = torch.where(near, 0.0, 1.0 / torch.clamp(distance, min=1e-9))
    n0, n1, n2 = w0 * inv, w1 * inv, w2 * inv
    dx = torch.where(near, 0.0, n0 * right[0] + n1 * right[1] + n2 * right[2])
    dy = torch.where(near, 0.0, n0 * up[0] + n1 * up[1] + n2 * up[2])
    dz = torch.where(near, -1.0, n0 * ahead[0] + n1 * ahead[1] + n2 * ahead[2])
    distance = torch.where(near, 0.0, distance)

    omag = torch.sqrt(ox * ox + oy * oy + oz * oz)
    o_ok = omag > 1e-4
    oinv = torch.where(o_ok, 1.0 / torch.clamp(omag, min=1e-9), 0.0)
    dot = torch.clamp(-(ox * n0 + oy * n1 + oz * n2) * oinv, -1.0, 1.0)
    angle = torch.abs(torch.acos(dot) * _RAD2DEG)
    half_inner, half_outer = inner * 0.5, outer * 0.5
    t = (angle - half_inner) / torch.clamp(half_outer - half_inner, min=1e-6)
    directivity = torch.where(
        angle <= half_inner, 1.0,
        torch.where(angle >= half_outer, outer_gain, 1.0 + t * (outer_gain - 1.0)))
    cone_active = ((inner < 360.0) | (outer < 360.0)) & o_ok
    directivity = torch.where(cone_active, directivity, 1.0)

    dc = torch.minimum(torch.maximum(distance, ref), mx)
    if model == DistanceModelType.LINEAR:
        atten = 1.0 - rolloff * (dc - ref) / torch.clamp(mx - ref, min=1e-9)
    elif model == DistanceModelType.EXPONENTIAL:
        atten = torch.pow(torch.clamp(dc / torch.clamp(ref, min=1e-9), min=1e-9), -rolloff)
    else:  # inverse: phonon's InverseDistance model, minDistance = ref
        atten = torch.where(distance <= ref, 1.0, ref / torch.clamp(distance, min=1e-9))
    atten = torch.clamp(atten, 0.0, 1.0)

    any_trans = (tl > 0.0) | (tm > 0.0) | (th > 0.0)

    def band(tr):
        return torch.where(occ > 0.0, torch.where(any_trans, (1.0 - occ) + occ * tr, 1.0 - occ), 1.0)

    base = atten * directivity
    azimuth = torch.atan2(dx, -dz)  # phonon convention: -z is ahead
    elevation = torch.asin(torch.clamp(dy, -1.0, 1.0))
    return torch.stack([azimuth, elevation, base * band(tl), base * band(tm),
                        base * band(th), blend])


def spatial_gains(p, listener, model: DistanceModelType):
    """K10b: csrc/spatial_gains.cu on a CUDA tensor, the plain version on a
    CPU tensor. Arguments and result as ``spatial_gains_plain``."""
    if p.device.type == "cpu":
        return spatial_gains_plain(p, listener, model)
    cudabuild.require(p, "p", torch.float32, ndim=3)
    if p.shape[0] != len(GAIN_PARAMS):
        raise ValueError(f"p must be [{len(GAIN_PARAMS)}, V, S], got {tuple(p.shape)}")
    ls = [listener[k] for k in _LISTENER_KEYS]
    for k, t in zip(_LISTENER_KEYS, ls):
        cudabuild.require(t, k, torch.float32, shape=(3,))
    _, V, S = p.shape
    out = torch.empty((6, V, S), dtype=torch.float32, device=p.device)
    status = cudabuild.load().ga_spatial_gains(
        p.data_ptr(), *(t.data_ptr() for t in ls), V * S, _MODEL_CODE[model],
        out.data_ptr(), cudabuild.stream_of(p))
    cudabuild.check(status, "ga_spatial_gains")
    cudabuild.launches["spatial_gains"] += 1
    return out


class SpatialPannerNode(AudioNode):
    def __init__(self, context):
        super().__init__(context, input_count=1, output_count=1, name="SpatialPanner")
        self.inputs[0].set_channel_count(2)
        self.inputs[0].set_channel_count_mode(ChannelCountMode.CLAMPED_MAX)
        self.inputs[0].set_channel_interpretation(ChannelInterpretation.SPEAKERS)
        self._distance_model = DistanceModelType.INVERSE
        self._channels = 2
        # Measured-HRIR override (None = the context default).
        self._custom_hrir = None
        self._custom_hrir_uid = 0

        k = AutomationRate.K_RATE
        p = self.create_audio_param
        self.position_x = p("positionX", 0.0, -_F32MAX, _F32MAX, k)
        self.position_y = p("positionY", 0.0, -_F32MAX, _F32MAX, k)
        self.position_z = p("positionZ", 0.0, -_F32MAX, _F32MAX, k)
        self.orientation_x = p("orientationX", 1.0, -1.0, 1.0, k)
        self.orientation_y = p("orientationY", 0.0, -1.0, 1.0, k)
        self.orientation_z = p("orientationZ", 0.0, -1.0, 1.0, k)
        self.ref_distance = p("refDistance", 1.0, 0.0, _F32MAX, k)
        self.max_distance = p("maxDistance", 10000.0, 0.0, _F32MAX, k)
        self.rolloff_factor = p("rolloffFactor", 1.0, 0.0, _F32MAX, k)
        self.cone_inner_angle = p("coneInnerAngle", 360.0, 0.0, 360.0, k)
        self.cone_outer_angle = p("coneOuterAngle", 360.0, 0.0, 360.0, k)
        self.cone_outer_gain = p("coneOuterGain", 0.0, 0.0, 1.0, k)
        self.spatial_blend = p("spatialBlend", 1.0, 0.0, 1.0, k)
        self.occlusion = p("occlusion", 0.0, 0.0, 1.0, k)
        self.transmission_low = p("transmissionLow", 0.0, 0.0, 1.0, k)
        self.transmission_mid = p("transmissionMid", 0.0, 0.0, 1.0, k)
        self.transmission_high = p("transmissionHigh", 0.0, 0.0, 1.0, k)
        # Pristine occlusion leaves the band split out of the stage (all
        # three band gains are equal then); the first touch rebuilds the
        # stage with the 3-band crossover.
        for prm in (self.occlusion, self.transmission_low,
                    self.transmission_mid, self.transmission_high):
            prm.notify_first_touch = True

    def _occlusion_active(self) -> bool:
        return any(
            prm.touched or prm.has_events() or prm._mod_outputs
            for prm in (self.occlusion, self.transmission_low,
                        self.transmission_mid, self.transmission_high)
        )

    @property
    def distance_model(self) -> DistanceModelType:
        return self._distance_model

    @distance_model.setter
    def distance_model(self, value: DistanceModelType) -> None:
        if value != self._distance_model:
            self._distance_model = value
            self._config_changed()  # part of the group key

    def output_channel_counts(self, input_channels):
        self._channels = input_channels[0] if input_channels else 2
        return [2]

    def load_hrir(self, source, n_azimuth=None, n_elevation=None, length=None) -> None:
        """Use a MEASURED HRIR set (SOFA path, .npz path, or dict with
        ``hrir``/``azimuth_deg``/``elevation_deg``/``sample_rate``) instead
        of the context default, regridded onto the regular (elevation x
        azimuth) grid (parity: phonon's measured HRTF with bilinear
        interpolation, SpatialPannerNode.cs:250-260)."""
        grid = load_hrir_grid(
            source, self.context.sample_rate,
            n_azimuth=n_azimuth or N_AZIMUTH,
            n_elevation=n_elevation or N_ELEVATION,
            length=length,
        )

        def do(ctx):
            self._custom_hrir = grid
            self._custom_hrir_uid += 1
            self._config_changed()

        self.context.execute_or_post(do)

    def clear_hrir(self) -> None:
        """Revert to the context default HRTF."""
        def do(ctx):
            self._custom_hrir = None
            self._custom_hrir_uid += 1
            self._config_changed()

        self.context.execute_or_post(do)

    def group_key(self, input_channels):
        # A per-node HRIR is a stage constant of its own, so such panners
        # only group with themselves; panners on the CONTEXT default batch.
        if self._custom_hrir is not None:
            hrir_key = (self.node_id, self._custom_hrir_uid)
        elif self.context._default_hrir is not None:
            hrir_key = ("ctx-default", self.context._default_hrir_uid)
        else:
            hrir_key = None
        return ("spatial-panner", input_channels[0], self._distance_model,
                hrir_key, self._occlusion_active(), self._mod_signature())

    def _active_grid(self, sample_rate):
        """The HRIR grid this panner renders with (per-node custom >
        context default > analytic spherical head)."""
        if self._custom_hrir is not None:
            return self._custom_hrir
        if self.context._default_hrir is not None:
            return self.context._default_hrir
        return _hrir_grid(sample_rate)

    def stage_consts(self) -> dict:
        """The group's HRIR grid f32[E, A, 2, L], uploaded once per build."""
        return {"hrtf_grid": self._active_grid(self.context.sample_rate)}

    def init_state(self, info):
        grid = self._active_grid(self.context.sample_rate)
        if hrir_partition_count(grid.shape[-1]) > 1:
            raise NotImplementedError(PARTITIONED_TODO)
        fft = hrtf_fft_size(grid.shape[-1])
        return {
            # Overlap-add tail of the binaural render (ops/hrtf.hrtf_fir).
            "ola": np.zeros((2, fft - FRAMES_PER_BLOCK), np.float32),
            # One-pole crossover states for 3-band transmission, per channel.
            "xlow": np.zeros((self._channels,), np.float32),
            "xhigh": np.zeros((self._channels,), np.float32),
        }

    def process(self, state, inputs, params, rc):
        """A group of V lanes: x f32[V, C, T]; state ola f32[V, 2, W],
        xlow / xhigh f32[V, C]. Returns [f32[V, 2, T]]."""
        x = inputs[0]
        p = torch.stack([params[name].per_block() for name in GAIN_PARAMS])
        az, el, gl, gm, gh, blend = spatial_gains(p, rc.globals, self._distance_model)
        grid = rc.stage_consts["hrtf_grid"]
        if self._occlusion_active():
            # Direct effect: per-band per-quantum gains (the reference
            # applies the DirectEffect in place on the input, :247-248).
            sr = rc.sample_rate
            low, xlow = onepole_lowpass(x, math.exp(-2.0 * math.pi * XOVER_LOW_HZ / sr),
                                        state["xlow"])
            lowmid, xhigh = onepole_lowpass(x, math.exp(-2.0 * math.pi * XOVER_HIGH_HZ / sr),
                                            state["xhigh"])

            def expand(g):  # [V, S] -> [V, 1, T]
                return torch.repeat_interleave(g, FRAMES_PER_BLOCK, dim=-1)[:, None, :]

            direct = low * expand(gl) + (lowmid - low) * expand(gm) + (x - lowmid) * expand(gh)
            out, ola = hrtf_fir(direct, None, az, el, blend, grid, state["ola"])
        else:
            # All band gains equal attenuation x directivity: one broadband
            # gain, applied inside P1.
            out, ola = hrtf_fir(x, gl, az, el, blend, grid, state["ola"])
            xlow, xhigh = state["xlow"], state["xhigh"]
        return {"ola": ola, "xlow": xlow, "xhigh": xhigh}, [out]
