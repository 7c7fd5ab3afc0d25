"""Effect framework: Effect / NodeEffect / EffectChain / ReverbEffect.

Parity: GraphAudio.Kit/Effects/Effect.cs, NodeEffect.cs, EffectChain.cs,
Effects/ReverbEffect.cs.

The port of graphaudio_tpu/kit/effects.py.
"""

from __future__ import annotations

from typing import List

from graphaudio_tpu_torch.core.node import ChannelCountMode
from graphaudio_tpu_torch.nodes.convolver import ConvolverNode
from graphaudio_tpu_torch.nodes.gain import GainNode


class Effect:
    """Abstract input/output node pair (parity: Effect.cs:27-33)."""

    def __init__(self, engine):
        self.engine = engine

    @property
    def context(self):
        return self.engine.context

    @property
    def input(self):
        raise NotImplementedError

    @property
    def output(self):
        raise NotImplementedError

    def dispose(self) -> None:
        self.on_dispose()

    def on_dispose(self) -> None:
        raise NotImplementedError


class NodeEffect(Effect):
    """Wraps any single node as an Effect (parity: NodeEffect.cs:11-35)."""

    def __init__(self, engine, node):
        super().__init__(engine)
        if node.context is not engine.context:
            raise ValueError("Node must belong to the engine's context")
        self.node = node

    @property
    def input(self):
        return self.node

    @property
    def output(self):
        return self.node

    def on_dispose(self) -> None:
        self.node.dispose()


class EffectChain:
    """Ordered effects between fixed endpoints; every edit rebuilds the
    connections (parity: EffectChain.cs:127-150). Owns its effects."""

    def __init__(self, engine, source, destination):
        self._engine = engine
        self._effects: List[Effect] = []
        self._source = source
        self._destination = destination
        self._source.connect(self._destination)

    @property
    def effects(self) -> List[Effect]:
        return list(self._effects)

    @property
    def count(self) -> int:
        return len(self._effects)

    def __len__(self) -> int:
        return len(self._effects)

    def __getitem__(self, index: int) -> Effect:
        return self._effects[index]

    def add(self, effect: Effect) -> None:
        self.insert(len(self._effects), effect)

    def insert(self, index: int, effect: Effect) -> None:
        if not (0 <= index <= len(self._effects)):
            raise IndexError(index)
        self._effects.insert(index, effect)
        self._rebuild()

    def remove(self, effect: Effect) -> bool:
        try:
            index = self._effects.index(effect)
        except ValueError:
            return False
        self.remove_at(index)
        return True

    def remove_at(self, index: int) -> None:
        effect = self._effects.pop(index)
        effect.output.disconnect()
        effect.dispose()
        self._rebuild()

    def clear(self) -> None:
        if not self._effects:
            return
        for effect in self._effects:
            effect.output.disconnect()
            effect.dispose()
        self._effects.clear()
        self._rebuild()

    def update_endpoints(self, source, destination) -> None:
        """Parity: EffectChain.UpdateEndpoints (:120-125)."""
        self._source = source
        self._destination = destination
        self._rebuild()

    def _rebuild(self) -> None:
        """Full reconnection of source -> effects... -> destination
        (parity: Rebuild, :127-150)."""
        self._source.disconnect()
        for effect in self._effects:
            effect.output.disconnect()
        if not self._effects:
            self._source.connect(self._destination)
            return
        self._source.connect(self._effects[0].input)
        for i in range(len(self._effects) - 1):
            self._effects[i].output.connect(self._effects[i + 1].input)
        self._effects[-1].output.connect(self._destination)

    def dispose(self) -> None:
        self.clear()


class ReverbEffect(Effect):
    """Dry/wet convolution reverb mini-graph (parity: ReverbEffect.cs:13):

        inputSplit -> dry -> outputMerge
        inputSplit -> downmixer(mono Explicit) -> convolver -> wet -> outputMerge
    """

    def __init__(self, engine):
        super().__init__(engine)
        ctx = engine.context
        self._input_split = GainNode(ctx)
        self._output_merge = GainNode(ctx)
        self._dry_gain = GainNode(ctx)
        self._wet_gain = GainNode(ctx)
        self._downmixer = GainNode(ctx)
        self._downmix_enabled = True
        self._downmixer.inputs[0].set_channel_count(1)
        self._downmixer.inputs[0].set_channel_count_mode(ChannelCountMode.EXPLICIT)
        self._convolver = ConvolverNode(ctx)

        self._input_split.connect(self._dry_gain).connect(self._output_merge)
        self._input_split.connect(self._downmixer).connect(self._convolver)
        self._convolver.connect(self._wet_gain).connect(self._output_merge)

    @property
    def input(self):
        return self._input_split

    @property
    def output(self):
        return self._output_merge

    @property
    def dry(self):
        """Dry mix gain param (parity: :32-33)."""
        return self._dry_gain.gain

    @property
    def wet(self):
        """Wet mix gain param (parity: :35-37)."""
        return self._wet_gain.gain

    @property
    def normalize(self) -> bool:
        return self._convolver.normalize

    @property
    def enable_true_stereo(self) -> bool:
        return self._convolver.enable_true_stereo

    @property
    def downmix_enabled(self) -> bool:
        return self._downmix_enabled

    @downmix_enabled.setter
    def downmix_enabled(self, value: bool) -> None:
        """Toggle mono downmix before convolution (parity: :52-61)."""
        self._downmix_enabled = bool(value)
        self._downmixer.inputs[0].set_channel_count(1 if value else 2)
        self._downmixer.inputs[0].set_channel_count_mode(
            ChannelCountMode.EXPLICIT if value else ChannelCountMode.MAX
        )

    def set_impulse_response(self, buffer, normalize: bool = True,
                             enable_true_stereo: bool = True) -> None:
        self._convolver.normalize = normalize
        self._convolver.enable_true_stereo = enable_true_stereo
        self._convolver.buffer = buffer

    def load_impulse_response(self, path: str, normalize: bool = True,
                              enable_true_stereo: bool = True) -> None:
        """Load an IR via the engine's data provider
        (parity: SetImpulseResponseAsync, :96-103)."""
        if self.engine.data_provider is None:
            raise RuntimeError("No data provider is configured on the AudioEngine.")
        buffer = self.engine.data_provider.get_playable_buffer(path)
        self.set_impulse_response(buffer, normalize, enable_true_stereo)

    def on_dispose(self) -> None:
        self._input_split.dispose()
        self._output_merge.dispose()
        self._dry_gain.dispose()
        self._wet_gain.dispose()
        self._downmixer.dispose()
        self._convolver.dispose()
