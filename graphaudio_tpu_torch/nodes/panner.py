"""Equal-power stereo panner (parity: GraphAudio.Core/Nodes/StereoPannerNode.cs:9).

The port of graphaudio_tpu/nodes/panner.py. Panners sharing a channel
count and mod signature run as one group stage; ``stereo_pan`` is K13
(csrc/stereo_pan.cu), one launch over the stage's lanes, and
``stereo_pan_plain`` its plain version:

    Mono law (StereoPannerNode.cs:76-108):   x = (pan+1)/2,
        gL = cos(x*pi/2), gR = sin(x*pi/2);  L = in*gL, R = in*gR.
    Stereo law (:110-153): x = pan+1 for pan<=0 else pan;
        pan<=0: L = inL + inR*gL, R = inR*gR
        pan> 0: L = inL*gL,       R = inR + inL*gR.

Rounding: the gains are the correctly rounded f32 cos and sin (f64, rounded
once; XLA's own f32 trig is an ulp off now and then), and the stereo law's
two multiply-adds are single fmas, as XLA contracts them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from graphaudio_tpu_torch.core.node import AudioNode, ChannelCountMode, ChannelInterpretation
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.ops import xla_rounding
from graphaudio_tpu_torch.utils import cudabuild

_HALF_PI = np.float32(math.pi / 2.0)


def stereo_pan_plain(x, pan):
    """Plain torch K13. x f32[V, C, T] (C = 1 or 2); pan f32[V, T] (any
    strides). Returns f32[V, 2, T]."""
    pan = torch.clamp(pan, -1.0, 1.0)
    hp = torch.tensor(_HALF_PI, device=x.device)
    if x.shape[1] == 1:
        a = (pan + 1.0) * 0.5 * hp
        gl, gr = xla_rounding.cos(a), xla_rounding.sin(a)
        return torch.stack([x[:, 0] * gl, x[:, 0] * gr], dim=1)
    in_l, in_r = x[:, 0], x[:, 1]
    left = pan <= 0.0
    a = torch.where(left, pan + 1.0, pan) * hp
    gl, gr = xla_rounding.cos(a), xla_rounding.sin(a)
    out_l = torch.where(left, xla_rounding.fma(in_r, gl, in_l), in_l * gl)
    out_r = torch.where(left, in_r * gr, xla_rounding.fma(in_l, gr, in_r))
    return torch.stack([out_l, out_r], dim=1)


def stereo_pan(x, pan):
    """K13: one launch of csrc/stereo_pan.cu over the lanes on CUDA tensors,
    the plain version on CPU tensors; arguments and result as
    ``stereo_pan_plain``. ``pan`` may be the broadcast view of one base
    value per lane (stride 0 along time): the kernel reads the base values,
    nothing is copied."""
    if x.device.type == "cpu":
        return stereo_pan_plain(x, pan)
    cudabuild.require(x, "x", torch.float32, ndim=3)
    V, C, T = x.shape
    if C not in (1, 2):
        raise ValueError(f"x must have 1 or 2 channels, got {C}")
    if pan.shape != (V, T):
        raise ValueError(f"pan must be [{V}, {T}], got {tuple(pan.shape)}")
    if pan.stride(-1) == 0 and pan.select(-1, 0).is_contiguous():
        src, rows = pan.select(-1, 0), 0
    else:
        src, rows = pan, 1
    cudabuild.require(src, "pan", torch.float32)
    out = torch.empty((V, 2, T), dtype=torch.float32, device=x.device)
    status = cudabuild.launcher("ga_stereo_pan")(
        x.data_ptr(), V, C, src.data_ptr(), rows, T, out.data_ptr(), cudabuild.stream_of(x))
    cudabuild.check(status, "ga_stereo_pan")
    cudabuild.launches["stereo_pan"] += 1
    return out


class StereoPannerNode(AudioNode):
    """Positions the input in the stereo image with an equal-power law."""

    def __init__(self, context):
        super().__init__(context, input_count=1, output_count=1, name="StereoPanner")
        self.inputs[0].set_channel_count(2)
        self.inputs[0].set_channel_count_mode(ChannelCountMode.CLAMPED_MAX)
        self.inputs[0].set_channel_interpretation(ChannelInterpretation.SPEAKERS)
        self.pan = self.create_audio_param(
            "pan", 0.0, min_value=-1.0, max_value=1.0,
            automation_rate=AutomationRate.A_RATE,
        )

    def output_channel_counts(self, input_channels):
        return [2]

    def group_key(self, input_channels):
        return ("stereo-pan", input_channels[0], self._mod_signature())

    def process(self, state, inputs, params, rc):
        """A group of V lanes: x f32[V, C, T], pan [V, T]; an ungrouped
        stage (a subclass without a group key): x f32[C, T], pan [T]."""
        x, pan = inputs[0], params["pan"].per_sample()
        if x.dim() == 2:
            return state, [stereo_pan(x[None].contiguous(), pan.reshape(1, -1))[0]]
        return state, [stereo_pan(x, pan)]
