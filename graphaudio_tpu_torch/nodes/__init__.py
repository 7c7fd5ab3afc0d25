"""Node library of the port: every node of graphaudio_tpu.nodes.

AudioDestinationNode, GainNode, AudioBufferSourceNode (unity-rate, static
polyphase and time-varying variants), ConstantSourceNode, OscillatorNode,
ConvolverNode, BiQuadFilterNode, SpatialPannerNode, DelayNode,
StereoPannerNode, ChannelSplitterNode and ChannelMergerNode.
"""

from graphaudio_tpu_torch.nodes.destination import AudioDestinationNode
from graphaudio_tpu_torch.nodes.gain import GainNode
from graphaudio_tpu_torch.nodes.sources import (
    AudioBufferSourceNode,
    ConstantSourceNode,
    OscillatorNode,
    OscillatorType,
    ScheduledSourceNode,
)
from graphaudio_tpu_torch.nodes.convolver import ConvolverNode
from graphaudio_tpu_torch.nodes.biquad import BiQuadFilterNode, FilterType
from graphaudio_tpu_torch.nodes.spatial import DistanceModelType, SpatialPannerNode
from graphaudio_tpu_torch.nodes.delay import DelayNode
from graphaudio_tpu_torch.nodes.panner import StereoPannerNode
from graphaudio_tpu_torch.nodes.channel import ChannelMergerNode, ChannelSplitterNode

__all__ = [
    "AudioDestinationNode",
    "GainNode",
    "ScheduledSourceNode",
    "AudioBufferSourceNode",
    "ConstantSourceNode",
    "OscillatorNode",
    "OscillatorType",
    "ConvolverNode",
    "BiQuadFilterNode",
    "FilterType",
    "SpatialPannerNode",
    "DistanceModelType",
    "DelayNode",
    "StereoPannerNode",
    "ChannelSplitterNode",
    "ChannelMergerNode",
]
