"""Hierarchical mix bus (parity: GraphAudio.Kit/AudioBus.cs:11).

The port of graphaudio_tpu/kit/bus.py.
"""

from __future__ import annotations

from typing import List, Optional

from graphaudio_tpu_torch.nodes.gain import GainNode


class AudioBus:
    """One GainNode + EffectChain routed to the parent bus (AudioBus.cs:76-91).

    Gain clamps to [0,1] with mute (:41-62); ``fade`` runs an exponential ramp
    (:96-114).
    """

    def __init__(self, engine, path: str, parent: Optional["AudioBus"]):
        from graphaudio_tpu_torch.kit.effects import EffectChain

        self.engine = engine
        self.path = path
        self.parent = parent
        self._gain = 1.0
        self._muted = False
        self._children: List[AudioBus] = []
        self._gain_node = GainNode(engine.context)

        destination = parent.input if parent else engine.context.destination
        self.effects = EffectChain(engine, self._gain_node, destination)

        if parent is not None:
            parent._children.append(self)

    @property
    def is_master(self) -> bool:
        return self.parent is None

    @property
    def input(self):
        return self._gain_node

    @property
    def children(self) -> List["AudioBus"]:
        return list(self._children)

    @property
    def gain(self) -> float:
        return self._gain

    @gain.setter
    def gain(self, value: float) -> None:
        self._gain = min(max(float(value), 0.0), 1.0)
        self._update_gain()

    @property
    def muted(self) -> bool:
        return self._muted

    @muted.setter
    def muted(self, value: bool) -> None:
        self._muted = bool(value)
        self._update_gain()

    def fade(self, target: float, duration: float) -> None:
        """Exponential gain fade (parity: AudioBus.Fade, :96-114)."""
        target = min(max(float(target), 0.0), 1.0)
        if duration <= 0:
            self.gain = target
            return
        now = self.engine.context.current_time
        current = max(self._gain, 0.0001)
        tgt = max(target, 0.0001)
        self._gain_node.gain.set_value_at_time(current, now)
        self._gain_node.gain.exponential_ramp_to_value_at_time(tgt, now + duration)
        self._gain = target

    def _update_gain(self) -> None:
        self._gain_node.gain.value = 0.0 if self._muted else self._gain

    def _disconnect(self) -> None:
        self._gain_node.disconnect()
        self._gain_node.dispose()
