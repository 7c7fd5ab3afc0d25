"""Channel routing nodes.

The port of graphaudio_tpu/nodes/channel.py. Parity:
GraphAudio.Core/Nodes/ChannelSplitterNode.cs:9 and ChannelMergerNode.cs:9.
Plain torch: row views and a stack (no reference kernel).
"""

from __future__ import annotations

import torch

from graphaudio_tpu_torch.core.constants import MAX_CHANNELS
from graphaudio_tpu_torch.core.node import AudioNode


class ChannelSplitterNode(AudioNode):
    """1 input -> N mono outputs; output i carries channel i or silence
    (ChannelSplitterNode.cs:24-59)."""

    def __init__(self, context, number_of_outputs: int = 2):
        if not (1 <= number_of_outputs <= MAX_CHANNELS):
            raise ValueError(
                f"number_of_outputs must be in [1, {MAX_CHANNELS}]"
            )
        super().__init__(
            context, input_count=1, output_count=number_of_outputs, name="ChannelSplitter"
        )
        self.number_of_outputs = number_of_outputs

    def output_channel_counts(self, input_channels):
        return [1] * self.number_of_outputs

    def process(self, state, inputs, params, rc):
        x = inputs[0]  # [C, T]
        c = x.shape[0]
        outs = []
        for i in range(self.number_of_outputs):
            if i < c:
                outs.append(x[i : i + 1])
            else:
                outs.append(torch.zeros((1, rc.frames), dtype=torch.float32, device=x.device))
        return state, outs


class ChannelMergerNode(AudioNode):
    """N mono inputs -> one N-channel output; channel i = channel 0 of input i
    (ChannelMergerNode.cs:23-55)."""

    def __init__(self, context, number_of_inputs: int = 2):
        if not (1 <= number_of_inputs <= MAX_CHANNELS):
            raise ValueError(
                f"number_of_inputs must be in [1, {MAX_CHANNELS}]"
            )
        super().__init__(
            context, input_count=number_of_inputs, output_count=1, name="ChannelMerger"
        )
        self.number_of_inputs = number_of_inputs

    def output_channel_counts(self, input_channels):
        return [self.number_of_inputs]

    def process(self, state, inputs, params, rc):
        rows = [inp[0] for inp in inputs]  # channel 0 of each mixed input
        return state, [torch.stack(rows, dim=0)]
