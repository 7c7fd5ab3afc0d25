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

* K10b ``spatial_gains_batch`` (csrc/spatial_gains.cu): the direct path
  per (voice, quantum): direction, gains, blend; one launch in the step's
  prologue for every panner stage, its params read where they lie
  (``prologue_request``); a stage with a modulated param launches its own
  at its turn, reading that param's reserved K6 arena rows;
* K9 ``band_split`` (ops/onepole.py, csrc/onepole.cu), only once occlusion
  or transmission was touched: both crossovers and the 3-band combine in
  one launch;
* P1 ``hrtf_fir`` (ops/hrtf.py, csrc/hrtf_fir.cu): the direct gain, the
  mono downmix, the per-quantum interpolated HRIR filter and the blend,
  for HRIRs of up to 128 taps;
* K10p ``hrtf_fir_partitioned`` (ops/hrtf.py, csrc/hrtf_part.cu) in its
  place for HRIRs of 129-1024 taps (measured sets): the mono spectra,
  K10p-a's spectral MAC over P 128-tap partitions, the inverse transform,
  K10p-b's overlap-add and blend.

The HRIR is the group's stage constant: ``hrtf_grid`` f32[E, A, 2, L] for
P1, or its partition spectra ``hrtf_sr`` / ``hrtf_si`` f32[E, A, 2, P, 129]
for K10p, whose lanes also carry the JAX package's ring ``hx`` f32[P-1,
258] and its directions ``haz`` / ``hel`` f32[P-1].

Under a mesh whose ``part`` dimension has more than one rank, a panner with
its own HRIR past 128 taps (``load_hrir``) runs as a single stage (the JAX
package's part members, graphaudio_tpu/nodes/spatial.py:162-172,
:182-260): its partition spectra, padded with zero partitions to a multiple
of ``part``, are cut to this rank's slice, and ``hrtf_fir_partitioned``
runs K14b over it, completed by an all_reduce. Panners on the
context default keep voice batching and shard over ``voice``.
"""

from __future__ import annotations

import enum
import functools
import math

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.mesh import PartShardable, axis_size
from graphaudio_tpu_torch.core.node import (
    AudioNode,
    ChannelCountMode,
    ChannelInterpretation,
    PrologueRequest,
)
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.ops.hrtf import (
    N_AZIMUTH,
    N_ELEVATION,
    build_hrir_grid,
    hrir_grid_spectra,
    hrir_partition_count,
    hrtf_fft_size,
    hrtf_fir,
    hrtf_fir_partitioned,
    load_hrir_grid,
)
from graphaudio_tpu_torch.ops.onepole import band_split
from graphaudio_tpu_torch.ops.param_eval import SRC_ARATE, SRC_CONST, SRC_KRATE, source_words
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


# ---- K10b batched: every panner stage of a step in one launch ------------------
#
# The step's panner stages share one table, packed once per encoding by
# ``pack_gains_table``: per stage its first lane, distance model code,
# output offset and one source word a param (ops/param_eval.py
# ``source_words``: lane 0's K6 arena row or base value, the other lanes
# following at a fixed stride), as int32 words in csrc/spatial_gains.cu's
# ``GainsPlan`` layout; the base values of params without events, per lane,
# in ``consts``. The output is one arena of each stage's f32[6, V, S] in
# step order.

GAINS_MAX_STAGES = 32  # stages a launch takes (kMaxStages)


def _plan_words(stages, first_lane: int):
    """The int32 words of one ``GainsPlan`` (csrc/spatial_gains.cu) for up
    to GAINS_MAX_STAGES (lane0, V, model code, output offset, 17 source
    words) entries, lanes counted from ``first_lane``."""
    P, M = len(GAIN_PARAMS), GAINS_MAX_STAGES
    n = len(stages)
    lane0 = np.zeros(M + 1, np.int32)
    lane0[:n + 1] = [lane - first_lane for lane, *_ in stages] + [
        stages[-1][0] + stages[-1][1] - first_lane]
    lane0[n + 1:] = lane0[n]
    model, out, src = np.zeros(M, np.int32), np.zeros(M, np.int32), np.zeros((M, P), np.int32)
    for k, (_, _, code, off, words) in enumerate(stages):
        model[k], out[k], src[k] = code, off, words
    return np.concatenate([[n], lane0, model, out, src.reshape(-1)]).astype(np.int32)


def pack_gains_table(stages, superblock: int):
    """The K10b table of one encoding. ``stages``: (distance model code,
    {GAIN_PARAMS name: ParamSlot}) per panner stage, in step order. Returns
    numpy ``consts`` f32 and the host fields ``plans`` (the GainsPlan
    words of each launch as bytes, GAINS_MAX_STAGES stages a launch),
    ``stages`` ((output offset, V, model code, 17 source words)
    each), ``size`` (the output arena's floats) and ``superblock`` (S)."""
    S = superblock
    consts, entries = [], []
    lane = size = 0
    for code, slots in stages:
        V = slots[GAIN_PARAMS[0]].lanes
        # lane 0's word; lane v's follows it by v rows (or v constants)
        words = tuple(source_words(slots[name], consts)[0] for name in GAIN_PARAMS)
        entries.append((lane, V, code, size, words))
        lane += V
        size += 6 * V * S
    if entries and max(max(e[4]) for e in entries) >= 2 ** 31:
        raise ValueError("the K10b table's source offsets need more than 29 bits")
    if size >= 2 ** 31:
        raise ValueError(f"the K10b output arena of {size} floats needs 64-bit offsets")
    plans = tuple(_plan_words(entries[c:c + GAINS_MAX_STAGES], entries[c][0]).tobytes()
                  for c in range(0, len(entries), GAINS_MAX_STAGES))
    return {"consts": np.asarray(consts or [0.0], np.float32), "plans": plans,
            "stages": tuple((off, V, code, words) for _, V, code, off, words in entries),
            "size": size, "superblock": S}


def _split_gains(table, out):
    S = table["superblock"]
    return [out.narrow(0, off, 6 * V * S).view(6, V, S) for off, V, _, _ in table["stages"]]


def _stage_sources(words, V: int, S: int, arena, consts):
    """The [17, V, S] params of one stage as the kernel reads them."""
    rows = []
    v = torch.arange(V, device=consts.device)[:, None]
    s = torch.arange(S, device=consts.device)[None, :]
    for word in words:
        mode, off = word & 3, word >> 2
        if mode == SRC_CONST:
            rows.append(consts[off + v].expand(V, S))
        else:
            rows.append(arena[off + (v * S + s) * (FRAMES_PER_BLOCK if mode == SRC_ARATE else 1)])
    return torch.stack(rows)


def spatial_gains_batch_plain(table, arena, listener):
    """Plain torch K10b over a ``pack_gains_table`` table (its ``consts`` a
    tensor), the params read from ``arena`` (the step's K6 arena, None when
    no param has events) or the table's constants: each stage's p f32[17,
    V, S] as the kernel reads it, then ``spatial_gains_plain`` under the
    stage's model. Returns one f32[6, V, S] per stage."""
    S = table["superblock"]
    models = {c: m for m, c in _MODEL_CODE.items()}
    return [spatial_gains_plain(_stage_sources(words, V, S, arena, table["consts"]), listener,
                                models[code])
            for _, V, code, words in table["stages"]]


def _launch_k10b(src, consts, plans, S, listener, out):
    """csrc/spatial_gains.cu, one launch a plan (no checks but the
    listener's); the plans' output offsets are into ``out``."""
    ls = [listener[k] for k in _LISTENER_KEYS]
    for k, t in zip(_LISTENER_KEYS, ls):
        cudabuild.require(t, k, torch.float32, shape=(3,))
    launch = cudabuild.launcher("ga_spatial_gains_batch")
    stream = cudabuild.stream_of(out)
    for words in plans:
        status = launch(src.data_ptr(), consts.data_ptr(), S, *(t.data_ptr() for t in ls),
                        out.data_ptr(), words, stream)
        cudabuild.check(status, "ga_spatial_gains_batch")
        cudabuild.launches["spatial_gains_batch"] += 1


def spatial_gains_batch(table, arena, listener):
    """K10b: every panner stage of a step in one launch of
    csrc/spatial_gains.cu (one for each GAINS_MAX_STAGES stages; CUDA
    tensors) or
    ``spatial_gains_batch_plain`` (CPU tensors). Returns one f32[6, V, S]
    per stage, each a contiguous view of one output arena."""
    consts = table["consts"]
    if consts.device.type == "cpu":
        return spatial_gains_batch_plain(table, arena, listener)
    req = cudabuild.require
    req(consts, "consts", torch.float32, ndim=1)
    src = consts if arena is None else arena
    req(src, "arena", torch.float32, ndim=1)
    out = torch.empty(table["size"], dtype=torch.float32, device=consts.device)
    _launch_k10b(src, consts, table["plans"], table["superblock"], listener, out)
    return _split_gains(table, out)


def _step_gains(table, arena, rc):
    """The prologue's K10b call: every panner stage of the step at once."""
    return spatial_gains_batch(table, arena, rc.globals)


@functools.lru_cache(maxsize=64)
def _one_stage_plan(V: int, S: int, code: int) -> bytes:
    """The plan of one stage whose params are the k-rate rows of one
    f32[17, V, S] tensor."""
    words = tuple(((j * V * S) << 2) | SRC_KRATE for j in range(len(GAIN_PARAMS)))
    return _plan_words([(0, V, code, 0, words)], 0).tobytes()


def spatial_gains(p, listener, model: DistanceModelType):
    """K10b for one stage: a one-stage batch of csrc/spatial_gains.cu whose
    arena is ``p`` on a CUDA tensor, the plain version on a CPU tensor.
    Arguments and result as ``spatial_gains_plain``."""
    if p.device.type == "cpu":
        return spatial_gains_plain(p, listener, model)
    cudabuild.require(p, "p", torch.float32, ndim=3)
    if p.shape[0] != len(GAIN_PARAMS):
        raise ValueError(f"p must be [{len(GAIN_PARAMS)}, V, S], got {tuple(p.shape)}")
    _, V, S = p.shape
    out = torch.empty((6, V, S), dtype=torch.float32, device=p.device)
    plan = _one_stage_plan(V, S, _MODEL_CODE[model])
    _launch_k10b(p.view(-1), p, (plan,), S, listener, out)
    return out


class SpatialPannerNode(PartShardable, AudioNode):
    # K10b in the step's prologue reads these params; the stage's process
    # gets none of them.
    prologue_params = GAIN_PARAMS

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
        if self.supports_part_sharding(self.context.mesh):
            # A long per-node HRIR under a ``part`` mesh is a single stage,
            # so its partition axis can shard (nothing batches away: such a
            # panner only grouped with itself).
            return None
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

    # -- partition sharding over a mesh's ``part`` ------------------------------

    # Partition axis of each stage const, which the graph cuts to a rank's
    # slice: spectra are [E, A, 2, P, 129].
    const_part_axes = {"hrtf_sr": 3, "hrtf_si": 3}

    def supports_part_sharding(self, mesh) -> bool:
        return (self._custom_hrir is not None
                and hrir_partition_count(self._custom_hrir.shape[-1]) > 1
                and mesh is not None and axis_size(mesh, "part") > 1)

    def stage_consts(self, mesh=None) -> dict:
        """The group's HRIR, uploaded once per build: the grid f32[E, A, 2,
        L] for P1, or past 128 taps its partition spectra (Sr, Si) f32[E,
        A, 2, P, 129] for K10p (``hrtf_sr``, ``hrtf_si``, the JAX package's
        names). Under a ``part`` mesh zero partitions pad P to a multiple
        of its size (a zero partition of an older quantum adds exactly
        zero)."""
        grid = self._active_grid(self.context.sample_rate)
        if hrir_partition_count(grid.shape[-1]) == 1:
            return {"hrtf_grid": grid}
        sr, si = hrir_grid_spectra(grid)
        pad = self._padded_parts(sr.shape[3], mesh) - sr.shape[3]
        if pad:
            widths = [(0, 0)] * 3 + [(0, pad), (0, 0)]
            sr, si = np.pad(sr, widths), np.pad(si, widths)
        return {"hrtf_sr": sr, "hrtf_si": si}

    def init_state(self, info):
        grid = self._active_grid(self.context.sample_rate)
        fft = hrtf_fft_size(grid.shape[-1])
        state = {
            # Overlap-add tail of the binaural render (ops/hrtf.hrtf_fir).
            "ola": np.zeros((2, fft - FRAMES_PER_BLOCK), np.float32),
            # One-pole crossover states for 3-band transmission, per channel.
            "xlow": np.zeros((self._channels,), np.float32),
            "xhigh": np.zeros((self._channels,), np.float32),
        }
        P = self._padded_parts(hrir_partition_count(grid.shape[-1]), self.context.mesh)
        if P > 1:
            # The partitioned filter's history (graphaudio_tpu/nodes/
            # spatial.py:254-267): the packed input spectra of the P-1
            # quanta before the superblock, oldest first, and their source
            # directions, from which their kernels are interpolated again.
            state["hx"] = np.zeros((P - 1, fft + 2), np.float32)
            state["haz"] = np.zeros((P - 1,), np.float32)
            state["hel"] = np.zeros((P - 1,), np.float32)
        return state

    def prologue_request(self, slots, lanes=None):
        """K10b's item: the distance model (in the group key, so one for
        all ``lanes``) and where the 17 params lie."""
        return PrologueRequest(_step_gains, pack_gains_table,
                               (_MODEL_CODE[self._distance_model],
                                {n: slots[n] for n in GAIN_PARAMS}))

    def process(self, state, inputs, params, rc):
        """A group of V lanes: x f32[V, C, T]; state ola f32[V, 2, W],
        xlow / xhigh f32[V, C] (and past 128 taps hx f32[V, P-1, 258], haz
        / hel f32[V, P-1]); the direct path f32[6, V, S] from the step's
        K10b (the prologue's batch, or the stage's own launch when a param
        is modulated). Returns [f32[V, 2, T]]. An ungrouped stage has no
        lane dim in x, its state or its output."""
        if inputs[0].dim() == 2:
            st, (out,) = self.process({k: v[None] for k, v in state.items()},
                                      [inputs[0][None]], params, rc)
            return {k: v[0] for k, v in st.items()}, [out[0]]
        x = inputs[0]
        az, el, gl, gm, gh, blend = rc.prologue_result
        if self._occlusion_active():
            # Direct effect: per-band per-quantum gains (the reference
            # applies the DirectEffect in place on the input, :247-248).
            sr = rc.sample_rate
            x, xlow, xhigh = band_split(
                x, math.exp(-2.0 * math.pi * XOVER_LOW_HZ / sr),
                math.exp(-2.0 * math.pi * XOVER_HIGH_HZ / sr), state["xlow"], state["xhigh"],
                gl, gm, gh)
            gain = None
        else:
            # All band gains equal attenuation x directivity: one broadband
            # gain, applied inside the filter.
            gain = gl
            xlow, xhigh = state["xlow"], state["xhigh"]
        sc = rc.stage_consts
        if "hrtf_sr" in sc:
            # Past 128 taps: the partitioned filter, its ring carried; under a
            # ``part`` mesh this rank's slice of the partitions (K14b).
            part = getattr(rc, "part", None)
            out, hx, haz, hel, ola = hrtf_fir_partitioned(
                x, gain, az, el, blend, sc["hrtf_sr"], sc["hrtf_si"], state["hx"],
                state["haz"], state["hel"], state["ola"],
                part=None if part is None else (part[0] * sc["hrtf_sr"].shape[3], part[1]))
            return {"ola": ola, "xlow": xlow, "xhigh": xhigh, "hx": hx, "haz": haz,
                    "hel": hel}, [out]
        out, ola = hrtf_fir(x, gain, az, el, blend, sc["hrtf_grid"], state["ola"])
        return {"ola": ola, "xlow": xlow, "xhigh": xhigh}, [out]
