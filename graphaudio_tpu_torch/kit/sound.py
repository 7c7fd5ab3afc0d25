"""Playable sound instances.

The port of graphaudio_tpu/kit/sound.py. Parity: GraphAudio.Kit/Sound.cs
(abstract playable with mix modes, per-sound subgraph source -> gain ->
[panner] -> bus, ~20 spatial property proxies, anchor following,
distance-driven spatial blend, step-linear updates, fades) and
BufferedSound.cs (recreates the one-shot source node on Play/Seek).

Not ported yet (ROADMAP.md): ``StreamingSound`` (needs ``io``, module item
12) and ``SoundMixState.STEP_LINEAR_SPATIALIZED`` (needs StereoPannerNode,
K13, module item 10), which raises NotImplementedError.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from graphaudio_tpu_torch.kit.anchors import (
    DEFAULT_STEP_LINEAR,
    DefaultSpatialBlendController,
    StepLinearConfig,
)
from graphaudio_tpu_torch.nodes.gain import GainNode
from graphaudio_tpu_torch.nodes.sources import AudioBufferSourceNode
from graphaudio_tpu_torch.nodes.spatial import DistanceModelType, SpatialPannerNode


class SoundMixState(enum.Enum):
    """Parity: SoundMixState (Sound.cs:12-33)."""

    DIRECT = "direct"
    BINAURAL_SPATIALIZED = "binaural"
    STEP_LINEAR_SPATIALIZED = "step-linear"


class Sound:
    """An individual playable sound instance (parity: Sound.cs:38)."""

    default_spatial_blend_controller = DefaultSpatialBlendController.instance()
    default_step_linear_config = DEFAULT_STEP_LINEAR

    def __init__(self, engine, mix_state: SoundMixState, bus=None):
        from graphaudio_tpu_torch.kit.effects import EffectChain

        if mix_state == SoundMixState.STEP_LINEAR_SPATIALIZED:
            raise NotImplementedError(
                "SoundMixState.STEP_LINEAR_SPATIALIZED needs StereoPannerNode, "
                "which is not ported yet (ROADMAP.md module item 10, kernel K13)"
            )
        self.engine = engine
        self.mix_state = mix_state
        self.bus = bus or engine.master_bus
        self.is_one_shot = False
        self._disposed = False
        self._gain = 1.0
        self._position = np.zeros(3, np.float32)
        self._orientation = np.array([0, 0, 1], np.float32)
        self._anchor = None
        self._last_anchor_version = 0
        self.spatial_blend_controller = Sound.default_spatial_blend_controller
        self.step_linear_config: StepLinearConfig = Sound.default_step_linear_config

        ctx = engine.context
        self._gain_node = GainNode(ctx)
        self._spatial_panner: Optional[SpatialPannerNode] = None

        # Per-sound subgraph (parity: Sound.cs:375-421).
        if mix_state == SoundMixState.DIRECT:
            self._output = self._gain_node
        elif mix_state == SoundMixState.BINAURAL_SPATIALIZED:
            self._spatial_panner = SpatialPannerNode(ctx)
            self._output = self._spatial_panner
        else:
            raise ValueError(f"Unsupported mix state: {mix_state}")

        if self._output is not self._gain_node:
            self.effects = EffectChain(engine, self._gain_node, self._output)
            self._output.connect(self.bus.input)
            self._update_spatial_position()
            self._update_spatial_blend()
        else:
            # Direct mode: effects sit between gain and bus.
            self.effects = EffectChain(engine, self._gain_node, self.bus.input)

    # -- abstract transport ------------------------------------------------------

    @property
    def is_playing(self) -> bool:
        raise NotImplementedError

    @property
    def is_looping(self) -> bool:
        raise NotImplementedError

    @is_looping.setter
    def is_looping(self, value: bool) -> None:
        raise NotImplementedError

    @property
    def playback_rate(self) -> float:
        raise NotImplementedError

    @playback_rate.setter
    def playback_rate(self, value: float) -> None:
        raise NotImplementedError

    @property
    def duration(self) -> float:
        raise NotImplementedError

    def seek(self, seconds: float) -> None:
        raise NotImplementedError

    def _do_play(self) -> None:
        raise NotImplementedError

    def _do_pause(self) -> None:
        raise NotImplementedError

    def _do_stop(self) -> None:
        raise NotImplementedError

    def _apply_effective_playback_rate(self, rate: float) -> None:
        """Step-linear pitch hook (parity: Sound.cs:674-675)."""

    # -- mix properties ------------------------------------------------------------

    @property
    def is_disposed(self) -> bool:
        return self._disposed

    @property
    def gain(self) -> float:
        return self._gain

    @gain.setter
    def gain(self, value: float) -> None:
        self._gain = float(value)
        self._gain_node.gain.value = self._gain

    @property
    def input(self):
        """The input gain node (parity: Sound.Input)."""
        return self._gain_node

    @property
    def position(self) -> np.ndarray:
        return self._position

    @position.setter
    def position(self, value) -> None:
        self._position = np.asarray(value, np.float32)
        self._update_spatial_position()

    @property
    def anchor(self):
        return self._anchor

    @anchor.setter
    def anchor(self, value) -> None:
        self._anchor = value
        if value is not None:
            self._last_anchor_version = 0

    @property
    def orientation(self) -> np.ndarray:
        return self._orientation

    @orientation.setter
    def orientation(self, value) -> None:
        self._orientation = np.asarray(value, np.float32)
        sp = self._spatial_panner
        if sp is not None:
            sp.orientation_x.value = float(self._orientation[0])
            sp.orientation_y.value = float(self._orientation[1])
            sp.orientation_z.value = float(self._orientation[2])

    # Spatial property proxies (parity: Sound.cs:156-336).

    def _sp_get(self, name: str, default: float) -> float:
        sp = self._spatial_panner
        return getattr(sp, name).value if sp is not None else default

    def _sp_set(self, name: str, value: float) -> None:
        sp = self._spatial_panner
        if sp is not None:
            getattr(sp, name).value = value

    ref_distance = property(
        lambda s: s._sp_get("ref_distance", 1.0),
        lambda s, v: s._sp_set("ref_distance", v),
    )
    rolloff_factor = property(
        lambda s: s._sp_get("rolloff_factor", 1.0),
        lambda s, v: s._sp_set("rolloff_factor", v),
    )
    max_distance = property(
        lambda s: s._sp_get("max_distance", 10000.0),
        lambda s, v: s._sp_set("max_distance", v),
    )
    cone_inner_angle = property(
        lambda s: s._sp_get("cone_inner_angle", 360.0),
        lambda s, v: s._sp_set("cone_inner_angle", v),
    )
    cone_outer_angle = property(
        lambda s: s._sp_get("cone_outer_angle", 360.0),
        lambda s, v: s._sp_set("cone_outer_angle", v),
    )
    cone_outer_gain = property(
        lambda s: s._sp_get("cone_outer_gain", 0.0),
        lambda s, v: s._sp_set("cone_outer_gain", v),
    )
    occlusion = property(
        lambda s: s._sp_get("occlusion", 0.0),
        lambda s, v: s._sp_set("occlusion", v),
    )
    transmission_low = property(
        lambda s: s._sp_get("transmission_low", 0.0),
        lambda s, v: s._sp_set("transmission_low", v),
    )
    transmission_mid = property(
        lambda s: s._sp_get("transmission_mid", 0.0),
        lambda s, v: s._sp_set("transmission_mid", v),
    )
    transmission_high = property(
        lambda s: s._sp_get("transmission_high", 0.0),
        lambda s, v: s._sp_set("transmission_high", v),
    )

    @property
    def distance_model(self) -> DistanceModelType:
        sp = self._spatial_panner
        return sp.distance_model if sp is not None else DistanceModelType.INVERSE

    @distance_model.setter
    def distance_model(self, value: DistanceModelType) -> None:
        if self._spatial_panner is not None:
            self._spatial_panner.distance_model = value

    def set_transmission(self, low: float, mid: float, high: float) -> None:
        self.transmission_low = low
        self.transmission_mid = mid
        self.transmission_high = high

    def set_cone(self, inner_angle: float, outer_angle: float, outer_gain: float) -> None:
        if self._spatial_panner is None:
            return
        self.cone_inner_angle = inner_angle
        self.cone_outer_angle = outer_angle
        self.cone_outer_gain = min(max(outer_gain, 0.0), 1.0)

    def set_distance_model(self, model: DistanceModelType, ref_distance: float,
                           max_distance: float, rolloff_factor: float) -> None:
        if self._spatial_panner is None:
            return
        self.distance_model = model
        self.ref_distance = ref_distance
        self.max_distance = max_distance
        self.rolloff_factor = rolloff_factor

    # -- bus routing (parity: Sound.cs:426-450) ------------------------------------

    def set_bus(self, bus) -> None:
        if isinstance(bus, str):
            bus = self.engine.get_bus(bus)
        if bus.engine is not self.engine:
            raise ValueError("Bus must belong to the same engine.")
        self.bus = bus
        if self._output is self._gain_node:
            self.effects.update_endpoints(self._gain_node, bus.input)
        else:
            self._output.disconnect()
            self._output.connect(bus.input)

    # -- per-frame update (parity: Sound.cs:452-527) ----------------------------------

    def update(self) -> None:
        if self._anchor is not None:
            v = self._anchor.version
            if v != self._last_anchor_version:
                self._last_anchor_version = v
                self._update_spatial_position()
        self._update_spatial_blend()
        self._do_update()

    def _do_update(self) -> None:
        pass

    def _final_position(self) -> np.ndarray:
        if self._anchor is not None:
            return self._anchor.position + self._position
        return self._position

    def _update_spatial_position(self) -> None:
        sp = self._spatial_panner
        if sp is None:
            return
        pos = self._final_position()
        sp.position_x.value = float(pos[0])
        sp.position_y.value = float(pos[1])
        sp.position_z.value = float(pos[2])
        self._update_spatial_blend()

    def _update_spatial_blend(self) -> None:
        sp = self._spatial_panner
        if sp is None:
            return
        delta = self._final_position() - self.engine.listener_position
        distance = float(np.linalg.norm(delta))
        blend = min(max(self.spatial_blend_controller.get_blend(distance), 0.0), 1.0)
        sp.spatial_blend.value = blend

    # -- transport with fades (parity: Sound.cs:532-589) -------------------------------

    def play(self, fade_in_duration: float = 0.0) -> None:
        if fade_in_duration > 0:
            now = self.engine.context.current_time
            self._gain_node.gain.set_value_at_time(0.0001, now)
            self._do_play()
            self._gain_node.gain.exponential_ramp_to_value_at_time(
                self._gain, now + fade_in_duration
            )
            return
        self._do_play()

    def pause(self, fade_out_duration: float = 0.0) -> None:
        if fade_out_duration > 0:
            self._fade_out_then(fade_out_duration, self._do_pause)
            return
        self._do_pause()

    def stop(self, fade_out_duration: float = 0.0) -> None:
        if fade_out_duration > 0:
            self._fade_out_then(fade_out_duration, self._do_stop)
            return
        self._do_stop()

    def _fade_out_then(self, duration: float, action) -> None:
        """Fade then act; the action runs via engine.update() once the fade
        deadline passes (the reference awaits Task.Delay, Sound.cs:556-566)."""
        now = self.engine.context.current_time
        self._gain_node.gain.set_value_at_time(self._gain_node.gain.value, now)
        self._gain_node.gain.exponential_ramp_to_value_at_time(0.0001, now + duration)
        self.engine._defer(now + duration, action)

    # -- lifecycle ----------------------------------------------------------------------

    def dispose(self) -> None:
        if self._disposed:
            return
        self._disposed = True
        if self.is_playing:
            self._do_stop()
        self._gain_node.disconnect()
        self._output.disconnect()
        if self._spatial_panner is not None:
            self._spatial_panner.dispose()
        self._gain_node.dispose()
        self._on_dispose()

    def _on_dispose(self) -> None:
        pass


class BufferedSound(Sound):
    """Sound over AudioBufferSourceNode; recreates the one-shot source node on
    every Play/Seek (parity: BufferedSound.cs:86-139)."""

    def __init__(self, engine, buffer, mix_state: SoundMixState = SoundMixState.DIRECT,
                 bus=None):
        super().__init__(engine, mix_state, bus)
        self._buffer = buffer
        self._source: Optional[AudioBufferSourceNode] = None
        self._current_offset = 0.0
        self._loop = False
        self._loop_start = 0.0
        self._loop_end = 0.0
        self._playback_rate = 1.0

    @property
    def is_playing(self) -> bool:
        return self._source is not None and not self._source.disposed and not self._disposed

    @property
    def is_looping(self) -> bool:
        return self._loop

    @is_looping.setter
    def is_looping(self, value: bool) -> None:
        self._loop = bool(value)
        if self._source is not None:
            self._source.loop = value

    @property
    def playback_rate(self) -> float:
        return self._playback_rate

    @playback_rate.setter
    def playback_rate(self, value: float) -> None:
        self._playback_rate = float(value)
        if self._source is not None:
            self._source.playback_rate.value = value

    @property
    def loop_start(self) -> float:
        return self._loop_start

    @loop_start.setter
    def loop_start(self, value: float) -> None:
        self._loop_start = value
        if self._source is not None:
            self._source.loop_start = value

    @property
    def loop_end(self) -> float:
        return self._loop_end

    @loop_end.setter
    def loop_end(self, value: float) -> None:
        self._loop_end = value
        if self._source is not None:
            self._source.loop_end = value

    @property
    def duration(self) -> float:
        return self._buffer.duration

    def _create_source(self) -> None:
        src = AudioBufferSourceNode(self.engine.context)
        src.buffer = self._buffer
        src.loop = self._loop
        src.loop_start = self._loop_start
        src.loop_end = self._loop_end
        if self._playback_rate != 1.0:
            src.playback_rate.value = self._playback_rate
        src.connect(self.input)
        src.on_ended(lambda n: self._dispose_source())
        self._source = src

    def _dispose_source(self) -> None:
        if self._source is not None:
            src, self._source = self._source, None
            if not src.disposed:
                src.dispose()

    def seek(self, seconds: float) -> None:
        """Parity: BufferedSound.Seek (:116-139)."""
        self._current_offset = min(max(seconds, 0.0), self.duration)
        if self._source is not None:
            self._dispose_source()
            self._create_source()
            self._source.start(0, self._current_offset)

    def _do_play(self) -> None:
        if self._source is not None:
            self._dispose_source()
            self._current_offset = 0.0
        self._create_source()
        self._source.start(0, self._current_offset)

    def _do_pause(self) -> None:
        self._do_stop()  # parity: pause == stop for buffered (:141-144)

    def _do_stop(self) -> None:
        if self._source is not None:
            self._source.stop(0)
            self._dispose_source()

    def _apply_effective_playback_rate(self, rate: float) -> None:
        if self._source is not None:
            self._source.playback_rate.value = rate

    def _on_dispose(self) -> None:
        self._dispose_source()
