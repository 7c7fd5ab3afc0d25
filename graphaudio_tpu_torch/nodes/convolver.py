"""Convolution reverb node (parity: GraphAudio.Core/Nodes/ConvolverNode.cs:10).

Setting ``buffer`` builds one partitioned-FFT convolver per IR channel
(ConvolverNode.cs:51-77). A 4-channel IR with ``enable_true_stereo`` becomes a
2-in/2-out True-Stereo matrix: outL = L*ir0 + R*ir2, outR = L*ir1 + R*ir3
(:127-144); otherwise N discrete channels with the input forced to the IR
channel count via Explicit mode (:73-76). The IR's sample rate must match the
context's (:48-49).

The partition grain is chosen exactly as in the JAX package (``_grain_for``),
so both packages partition the IR the same way: 128 frames for superblocks
below 1024 frames, else the largest multiple-of-128 divisor of the
superblock up to 1024. All grains run through ops.convolve.conv_step (K2),
whose overlap-add (K2b) also writes the true-stereo matrix's sums.

Under a mesh whose ``part`` dimension has more than one rank (the JAX
package's part members, graphaudio_tpu/nodes/convolver.py:186-270), a big
grain is the whole superblock (B == T, one spectrum a step, so the
replicated delay line grows by one row a step), the partitions are padded
with zero partitions to a multiple of ``part`` and ``conv_step`` runs K14a
over this rank's slice, an all_reduce, then the inverse and K2b.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.mesh import PartShardable, axis_size
from graphaudio_tpu_torch.core.node import AudioNode, ChannelCountMode
from graphaudio_tpu_torch.ops.convolve import (
    NUM_BINS,
    conv_step,
    prepare_ir,
    prepare_ir_big,
)

# Superblocks of >= this many frames partition the IR at big grain.
_BIG_BLOCK_MIN = 1024
_SUB_GRAIN_TARGET = 1024
_SUB_GRAIN_MIN = 512
# process() tells the 128 grain from a big grain by spectra width, which
# holds only while no big grain can equal FRAMES_PER_BLOCK.
assert _SUB_GRAIN_MIN > FRAMES_PER_BLOCK
# The true-stereo matrix as K2b's combine: outL = y0 + y2, outR = y1 + y3.
_TRUE_STEREO = ((0, 2), (1, 3))


def _pick_big_grain(T: int) -> int:
    """Largest multiple-of-128 divisor of T that is <= _SUB_GRAIN_TARGET;
    falls back to T (unsplit) if none >= _SUB_GRAIN_MIN exists."""
    b = min(_SUB_GRAIN_TARGET, T)
    b -= b % FRAMES_PER_BLOCK
    while b >= _SUB_GRAIN_MIN:
        if T % b == 0:
            return b
        b -= FRAMES_PER_BLOCK
    return T


class ConvolverNode(PartShardable, AudioNode):
    #: Host ints of the state that a realtime context's captured step holds
    #: on the card as int64 scalars (core/stepgraph.py): K2a reads the ring's
    #: head there, and conv_step advances it with torch ops.
    device_state_scalars = ("head",)

    def __init__(self, context):
        super().__init__(context, input_count=1, output_count=1, name="Convolver")
        self._buffer = None
        self._ir_channels: Optional[List[np.ndarray]] = None
        self._prep_cache: dict = {}  # grain -> (H [K,P,bins], Hi)
        self._conv_inputs: List[int] = []  # input channel feeding convolver k
        self._is_true_stereo = False
        self._effective_output_channels = 0
        self.normalize = True  # parity: ConvolverNode.Normalize (:87)
        self.enable_true_stereo = True  # parity: EnableTrueStereo (:95)

    @property
    def buffer(self):
        return self._buffer

    @buffer.setter
    def buffer(self, value) -> None:
        if value is None:
            self._buffer = None
            self._ir_channels = None
            self._prep_cache = {}
            self._conv_inputs = []
            self._is_true_stereo = False
            self._effective_output_channels = 0
            self.inputs[0].set_channel_count_mode(ChannelCountMode.MAX)
            self._config_changed()
            return
        if not value.is_initialized:
            raise RuntimeError(
                "Impulse response buffer must be initialized before being "
                "assigned to the ConvolverNode."
            )
        if value.sample_rate != self.context.sample_rate:
            raise RuntimeError(
                "Impulse response buffer sample rate must match the audio "
                f"context sample rate. IR rate: {value.sample_rate}, context "
                f"rate: {self.context.sample_rate}."
            )
        channels = value.number_of_channels
        # Snapshot the IR channels and the normalize flag at set time, like
        # the reference (ConvolverNode.cs:51-77); spectra prep is lazy.
        self._ir_channels = [
            np.asarray(value.get_channel_data(i), np.float32)
            for i in range(channels)
        ]
        self._normalize_at_set = self.normalize
        self._prep_cache = {}
        self._buffer = value
        self._is_true_stereo = channels == 4 and self.enable_true_stereo
        if self._is_true_stereo:
            # Convolvers 0,1 read L; 2,3 read R (ConvolverNode.cs:137-143).
            self._conv_inputs = [0, 0, 1, 1]
            self._effective_output_channels = 2
            self.inputs[0].set_channel_count(2)
        else:
            self._conv_inputs = list(range(channels))
            self._effective_output_channels = channels
            self.inputs[0].set_channel_count(channels)
        self.inputs[0].set_channel_count_mode(ChannelCountMode.EXPLICIT)
        self._config_changed()

    # -- grain selection & lazy spectra prep ------------------------------------

    def _grain_for(self, mesh) -> int:
        """0 = 128-sample quantum grain (short superblocks); otherwise the
        sub-block grain B <= T of the big path: T itself when the
        partitions shard over the mesh's ``part``."""
        T = self.context.superblock * FRAMES_PER_BLOCK
        if T < _BIG_BLOCK_MIN:
            return 0
        if self.supports_part_sharding(mesh):
            return T
        return _pick_big_grain(T)

    def _prepped(self, grain: int):
        """(H, Hi) f32[K, P, bins] partition spectra at ``grain`` (cached)."""
        cached = self._prep_cache.get(grain)
        if cached is not None:
            return cached
        norm = getattr(self, "_normalize_at_set", self.normalize)
        if grain:
            prepared = [prepare_ir_big(ch, grain, norm) for ch in self._ir_channels]
        else:
            prepared = [prepare_ir(ch, norm) for ch in self._ir_channels]
        H = np.stack([p[0] for p in prepared])
        Hi = np.stack([p[1] for p in prepared])
        self._prep_cache = {grain: (H, Hi)}  # only the live grain is kept
        return H, Hi

    def output_channel_counts(self, input_channels):
        if self._ir_channels is None:
            return [input_channels[0] if input_channels else 2]
        return [self._effective_output_channels]

    # -- partition sharding over a mesh's ``part`` ------------------------------

    # Partition axis of each stage const, which the graph cuts to a rank's
    # slice: spectra are [K, P, bins].
    const_part_axes = {"conv_hr": 1, "conv_hi": 1}

    def supports_part_sharding(self, mesh) -> bool:
        return (self._ir_channels is not None
                and self.context.superblock * FRAMES_PER_BLOCK >= _BIG_BLOCK_MIN
                and mesh is not None and axis_size(mesh, "part") > 1)

    def stage_consts(self, mesh=None) -> dict:
        """IR spectra as stage constants, uploaded once per graph build. Under
        a ``part`` mesh, zero partitions pad them to a multiple of its size:
        the rows are reversed (newest-input row last), so the padding goes
        before row 0; a zero partition adds exactly zero."""
        if self._ir_channels is None:
            return {}
        H, Hi = self._prepped(self._grain_for(mesh))
        pad = self._padded_parts(H.shape[1], mesh) - H.shape[1]
        if pad:
            widths = ((0, 0), (pad, 0), (0, 0))
            H, Hi = np.pad(H, widths), np.pad(Hi, widths)
        return {"conv_hr": H, "conv_hi": Hi}

    def sub_blocks(self) -> int:
        """L: sub-blocks per step at the current grain."""
        grain = self._grain_for(self.context.mesh)
        return self.context.superblock if grain == 0 else (
            self.context.superblock * FRAMES_PER_BLOCK // grain
        )

    def init_state(self, info):
        """Delay-line ring f32[K, P-1+L, bins] (split re/im) with its head,
        and the carried overlap f32[K, B]; P counts the padding of a
        ``part`` mesh."""
        if self._ir_channels is None:
            return {}
        mesh = self.context.mesh
        grain = self._grain_for(mesh)
        H, _ = self._prepped(grain)
        K, P, bins = H.shape
        R = self._padded_parts(P, mesh) - 1 + self.sub_blocks()
        return {
            "ring_r": np.zeros((K, R, bins), np.float32),
            "ring_i": np.zeros((K, R, bins), np.float32),
            "overlap": np.zeros((K, grain or FRAMES_PER_BLOCK), np.float32),
            "head": 0,  # host int: slot of this step's first sub-block
        }

    def process(self, state, inputs, params, rc):
        x = inputs[0]  # [C, T]
        if self._ir_channels is None:
            # No IR: cleared output at the input channel count (:107-118).
            return state, [torch.zeros_like(x)]
        hr = rc.stage_consts["conv_hr"]
        hi = rc.stage_consts["conv_hi"]
        bins = hr.shape[-1]
        grain = 0 if bins == NUM_BINS else bins - 1
        B = grain or FRAMES_PER_BLOCK
        T = x.shape[-1]
        K = len(self._conv_inputs)
        if self._is_true_stereo:
            # Convolvers 0, 1 read L and 2, 3 read R: the one routing copy;
            # K2b writes outL = y0 + y2, outR = y1 + y3.
            xs = torch.stack([x[src] for src in self._conv_inputs]).reshape(K, T // B, B)
            combine = _TRUE_STEREO
        else:
            xs = x.reshape(K, T // B, B)  # instance k reads channel k: a view
            combine = None
        part = getattr(rc, "part", None)  # this rank's slice of the partitions (K14a)
        out, head = conv_step(
            xs, hr, hi, state["ring_r"], state["ring_i"], state["head"],
            state["overlap"], rev=bool(grain), combine=combine,
            part=None if part is None else (part[0] * hr.shape[1], part[1]),
        )
        new_state = dict(state, head=head)
        return new_state, [out]
