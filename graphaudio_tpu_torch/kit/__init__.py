"""Game-facing toolkit of the port (parity: GraphAudio.Kit, SURVEY.md §2.6).

The port of graphaudio_tpu/kit: AudioEngine / Sound hierarchy (buffered
and streaming) / hierarchical AudioBus / EffectChain / ReverbEffect / LRU
buffer cache / data providers / spatial anchors / step-linear 2-D
calculator / distance-blend controllers. Host code, copied with its
imports swapped.
"""

from graphaudio_tpu_torch.kit.engine import AudioEngine
from graphaudio_tpu_torch.kit.sound import Sound, BufferedSound, StreamingSound, SoundMixState
from graphaudio_tpu_torch.kit.bus import AudioBus
from graphaudio_tpu_torch.kit.effects import Effect, NodeEffect, EffectChain, ReverbEffect
from graphaudio_tpu_torch.kit.cache import AudioBufferCache, AudioBufferCacheOptions
from graphaudio_tpu_torch.kit.anchors import (
    SpatialAnchor,
    StepLinearConfig,
    step_linear_calculate,
    SpatialBlendController,
    DefaultSpatialBlendController,
    LinearSpatialBlendController,
)
from graphaudio_tpu_torch.kit.providers import DataProvider, FileSystemDataProvider

__all__ = [
    "AudioEngine",
    "Sound",
    "BufferedSound",
    "StreamingSound",
    "SoundMixState",
    "AudioBus",
    "Effect",
    "NodeEffect",
    "EffectChain",
    "ReverbEffect",
    "AudioBufferCache",
    "AudioBufferCacheOptions",
    "SpatialAnchor",
    "StepLinearConfig",
    "step_linear_calculate",
    "SpatialBlendController",
    "DefaultSpatialBlendController",
    "LinearSpatialBlendController",
    "DataProvider",
    "FileSystemDataProvider",
]
