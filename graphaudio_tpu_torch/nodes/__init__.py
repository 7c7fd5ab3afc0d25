"""Node library of the port (so far: the paths of configs 1-6).

AudioDestinationNode, GainNode, AudioBufferSourceNode (unity-rate and static
polyphase variants), ConstantSourceNode, OscillatorNode, ConvolverNode,
BiQuadFilterNode and SpatialPannerNode.
The other nodes of graphaudio_tpu.nodes are listed in ROADMAP.md.
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
]
