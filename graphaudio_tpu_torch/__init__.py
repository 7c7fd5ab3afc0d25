"""graphaudio_tpu_torch — the PyTorch/CUDA port of graphaudio_tpu.

The same Web-Audio-style node graph (128-frame quanta, f64 block clock,
f32 audio) rendered with PyTorch on an NVIDIA GPU, with the hot ops of the
render path as hand-written CUDA kernels (``csrc/``, built with nvcc on
first use; see utils/cudabuild.py). The JAX package ``graphaudio_tpu`` is
the reference this package is held against; this package imports neither
``jax`` nor ``graphaudio_tpu``.

The device is explicit: ``OfflineAudioContext(device="cuda")`` is the
default and raises where CUDA is absent; ``device="cpu"`` renders with the
kernels' plain PyTorch versions.
"""

import torch as _torch

# Full-f32 matmuls and convolutions everywhere: the port is held to the JAX
# reference within 1e-5 max abs, and TF32 keeps about three decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from graphaudio_tpu_torch.core.constants import (  # noqa: E402
    DEFAULT_SAMPLE_RATE,
    FRAMES_PER_BLOCK,
    MAX_CHANNELS,
)
from graphaudio_tpu_torch.core.buffer import PlayableAudioBuffer  # noqa: E402
from graphaudio_tpu_torch.core.params import AudioParam, AutomationRate  # noqa: E402
from graphaudio_tpu_torch.core.node import (  # noqa: E402
    AudioNode,
    AudioNodeInput,
    AudioNodeOutput,
    ChannelCountMode,
    ChannelInterpretation,
)
from graphaudio_tpu_torch.core.context import (  # noqa: E402
    AudioContextBase,
    OfflineAudioContext,
)
from graphaudio_tpu_torch.nodes import (  # noqa: E402
    AudioBufferSourceNode,
    AudioDestinationNode,
    BiQuadFilterNode,
    ChannelMergerNode,
    ChannelSplitterNode,
    ConstantSourceNode,
    ConvolverNode,
    DelayNode,
    DistanceModelType,
    FilterType,
    GainNode,
    OscillatorNode,
    OscillatorType,
    SpatialPannerNode,
    StereoPannerNode,
)
from graphaudio_tpu_torch import io, kit, parallel, realtime, utils  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "FRAMES_PER_BLOCK",
    "DEFAULT_SAMPLE_RATE",
    "MAX_CHANNELS",
    "PlayableAudioBuffer",
    "AudioParam",
    "AutomationRate",
    "AudioNode",
    "AudioNodeInput",
    "AudioNodeOutput",
    "ChannelCountMode",
    "ChannelInterpretation",
    "AudioContextBase",
    "OfflineAudioContext",
    "AudioDestinationNode",
    "GainNode",
    "AudioBufferSourceNode",
    "ConstantSourceNode",
    "OscillatorNode",
    "OscillatorType",
    "ConvolverNode",
    "BiQuadFilterNode",
    "FilterType",
    "DelayNode",
    "StereoPannerNode",
    "ChannelSplitterNode",
    "ChannelMergerNode",
    "SpatialPannerNode",
    "DistanceModelType",
    "io",
    "kit",
    "parallel",
    "realtime",
    "utils",
]
