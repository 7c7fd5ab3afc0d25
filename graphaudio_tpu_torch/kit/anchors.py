"""Spatial anchors, step-linear spatialization, distance-blend controllers.

Parity: GraphAudio.Kit/SpatialAnchor.cs, StepLinearCalculator.cs,
SpatialBlendControllers/*.

The port of graphaudio_tpu/kit/anchors.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np


class SpatialAnchor:
    """Shared position with a version counter for O(1) dirty checks
    (parity: SpatialAnchor.cs:9-31)."""

    def __init__(self, position=(0.0, 0.0, 0.0)):
        self._position = np.asarray(position, np.float32)
        self._version = 1

    @property
    def position(self) -> np.ndarray:
        return self._position

    @position.setter
    def position(self, value) -> None:
        value = np.asarray(value, np.float32)
        if not np.array_equal(value, self._position):
            self._position = value
            self._version += 1

    @property
    def version(self) -> int:
        return self._version


@dataclass(frozen=True)
class StepLinearConfig:
    """Parity: StepLinearConfig record (StepLinearCalculator.cs:11-26)."""

    pan_step: float = 0.1
    gain_step: float = 0.05
    behind_pitch_decrease: float = 0.015
    pitch_lower_limit: float = 0.1


DEFAULT_STEP_LINEAR = StepLinearConfig()


class StepLinearResult(NamedTuple):
    pan: float
    gain: float
    pitch: float


def step_linear_calculate(
    listener_position,
    source_position,
    config: StepLinearConfig = DEFAULT_STEP_LINEAR,
    initial_pan: float = 0.0,
    initial_gain: float = 0.0,
    initial_pitch: float = 1.0,
) -> StepLinearResult:
    """Screen-reader-style stepwise pan/gain/pitch from listener-relative axis
    deltas (parity: StepLinearCalculator.Calculate, :35-89)."""
    lx, ly, lz = (float(v) for v in listener_position)
    sx, sy, sz = (float(v) for v in source_position)
    pan, gain, pitch = initial_pan, initial_gain, initial_pitch

    if sx < lx:
        dx = lx - sx
        pan -= dx * config.pan_step
        gain -= dx * config.gain_step
    elif sx > lx:
        dx = sx - lx
        pan += dx * config.pan_step
        gain -= dx * config.gain_step

    if sy < ly:
        pitch -= abs(config.behind_pitch_decrease)
        gain -= (ly - sy) * config.gain_step
    elif sy > ly:
        gain -= (sy - ly) * config.gain_step

    if sz < lz:
        pitch -= abs(config.behind_pitch_decrease)
        gain -= (lz - sz) * config.gain_step
    elif sz > lz:
        gain -= (sz - lz) * config.gain_step

    return StepLinearResult(
        min(max(pan, -1.0), 1.0),
        max(gain, -1.0),
        max(pitch, config.pitch_lower_limit),
    )


class SpatialBlendController:
    """Distance -> [0,1] 2D/3D blend strategy (parity: ISpatialBlendController)."""

    def get_blend(self, distance: float) -> float:
        raise NotImplementedError


class DefaultSpatialBlendController(SpatialBlendController):
    """Always fully spatialized (parity: DefaultSpatialBlendController.cs:12-15)."""

    _instance = None

    @classmethod
    def instance(cls) -> "DefaultSpatialBlendController":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def get_blend(self, distance: float) -> float:
        return 1.0


class LinearSpatialBlendController(SpatialBlendController):
    """Linear ramp between min/max distance (parity:
    LinearSpatialBlendController.cs:43-58)."""

    def __init__(self, min_distance: float, max_distance: float,
                 min_blend: float = 0.0, max_blend: float = 1.0):
        if min_distance < 0:
            raise ValueError("Distance cannot be negative.")
        if max_distance <= min_distance:
            raise ValueError("max_distance must be greater than min_distance.")
        if not (0.0 <= min_blend <= 1.0) or not (0.0 <= max_blend <= 1.0):
            raise ValueError("blend values must be in [0, 1].")
        if max_blend < min_blend:
            raise ValueError("max_blend cannot be less than min_blend.")
        self._min_d = min_distance
        self._max_d = max_distance
        self._min_b = min_blend
        self._max_b = max_blend

    def get_blend(self, distance: float) -> float:
        if distance <= self._min_d:
            return self._min_b
        if distance >= self._max_d:
            return self._max_b
        t = (distance - self._min_d) / (self._max_d - self._min_d)
        return self._min_b + t * (self._max_b - self._min_b)
