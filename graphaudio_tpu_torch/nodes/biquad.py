"""Biquad filter node (parity: GraphAudio.Core/Nodes/BiQuadFilterNode.cs:10).

The port of graphaudio_tpu/nodes/biquad.py. Eight RBJ-cookbook filter
types; a-rate ``frequency``/``Q`` params, k-rate ``gain`` (dB,
shelving/peaking). A stage's coefficients and poles come from the step's
prologue, one K8 launch over every biquad stage of the step
(``prologue_request``), or, when one of the three params is modulated,
from a one-stage K8 launch at the stage's turn; ``process`` runs the
stage's lanes through P2 (the pole-split cascade), see ops/biquad.py.

Documented deviation (as in the JAX package): the reference recomputes
coefficients lazily when the frequency moved by >0.001 Hz / Q by >0.0001
(:126-134); this implementation computes coefficients every sample
(identical for constant params, strictly more accurate for automated ones).
"""

from __future__ import annotations

import enum

import numpy as np

from graphaudio_tpu_torch.core.node import AudioNode, PrologueRequest
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.ops.biquad import (
    FILTER_TYPES,
    biquad_apply,
    biquad_coefficients_batch,
    pack_coefficient_table,
)


def _step_coefficients(table, arena, rc):
    """The prologue's K8 call: every biquad stage of the step at once."""
    return biquad_coefficients_batch(table, arena, rc.sample_rate)


class FilterType(enum.Enum):
    """Parity: BiQuadFilterNode.cs:288-298."""

    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    NOTCH = "notch"
    ALLPASS = "allpass"
    PEAKING = "peaking"
    LOWSHELF = "lowshelf"
    HIGHSHELF = "highshelf"


class BiQuadFilterNode(AudioNode):
    def __init__(self, context, type: FilterType = FilterType.LOWPASS):
        super().__init__(context, input_count=1, output_count=1, name="BiQuadFilter")
        self._type = type
        self.frequency = self.create_audio_param(
            "frequency",
            1000.0,
            min_value=1.0,
            max_value=context.sample_rate / 2.0,
            automation_rate=AutomationRate.A_RATE,
        )
        self.q = self.create_audio_param(
            "Q", 1.0, min_value=0.001, max_value=1000.0,
            automation_rate=AutomationRate.A_RATE,
        )
        # Constant frequency/Q take the constant-pole path; the first
        # scheduled event rebuilds the graph with the correction pass.
        self.frequency.notify_first_event = True
        self.q.notify_first_event = True
        self.gain = self.create_audio_param(
            "gain", 0.0, min_value=-60.0, max_value=60.0,
            automation_rate=AutomationRate.K_RATE,
        )
        # Gain enters the a1/a2 DENOMINATOR for peaking/shelving types, so
        # its first event must also leave the constant-pole path (other
        # types ignore gain entirely — no rebuild for them).
        self.gain.notify_first_event = type in self._GAIN_IN_POLES
        self._channels = 2

    _GAIN_IN_POLES = (FilterType.PEAKING, FilterType.LOWSHELF,
                      FilterType.HIGHSHELF)

    def _time_varying(self) -> bool:
        """True when the recurrence's POLE coefficients (a1/a2) can change
        over time: frequency/Q always enter them; gain only for the
        peaking/shelving types (RBJ: A reaches the denominator there)."""
        tv = bool(
            self.frequency._had_events
            or self.q._had_events
            or self.frequency._mod_outputs
            or self.q._mod_outputs
        )
        if self._type in self._GAIN_IN_POLES:
            tv = tv or bool(self.gain._had_events or self.gain._mod_outputs)
        return tv

    @property
    def type(self) -> FilterType:
        return self._type

    @type.setter
    def type(self, value: FilterType) -> None:
        if value != self._type:
            self._type = value
            self.gain.notify_first_event = value in self._GAIN_IN_POLES
            self._config_changed()  # the type's formulas are static per stage

    def output_channel_counts(self, input_channels):
        c = input_channels[0] if input_channels else 2
        self._channels = c
        return [c]

    def group_key(self, input_channels):
        return ("biquad", self._type, input_channels[0],
                self._time_varying(), self._mod_signature())

    def chain_key(self, input_channels):
        """Chain-fusion compatibility key (the type excluded), as in the JAX
        package: biquads of any types chain into one pipelined stage
        (core/graph.py ``_fuse_chains``), whose K8 rows carry each lane's
        type. ``_time_varying()`` is in it, so one flag serves every lane of
        the stage's P2 launch."""
        return ("biquad", input_channels[0], self._time_varying())

    def _type_onehot(self) -> np.ndarray:
        v = np.zeros(len(FILTER_TYPES), np.float32)
        v[FILTER_TYPES.index(self._type.value)] = 1.0
        return v

    def init_state(self, info):
        return {
            "w1": np.zeros((self._channels,), np.float32),
            "w2": np.zeros((self._channels,), np.float32),
            # The type selector of the JAX package's fused mixed-type chains;
            # carried so states move between the packages unchanged.
            "__type_sel__": self._type_onehot(),
        }

    def config_state(self):
        """Leaves that must always reflect the CURRENT config: a rebuild
        keeps running filter state, but never a stale type selector."""
        return {"__type_sel__": self._type_onehot()}

    #: K8 in the step's prologue reads all three params; ``process`` none.
    prologue_params = ("frequency", "Q", "gain")

    def prologue_request(self, slots, lanes=None):
        """K8's item: the type (each lane's, for a fused chain's ``lanes``)
        and where frequency, Q and gain lie."""
        ftype = (self._type.value if lanes is None
                 else tuple(n._type.value for n in lanes))
        return PrologueRequest(_step_coefficients, pack_coefficient_table,
                               (ftype, {n: slots[n] for n in ("frequency", "Q", "gain")}))

    def process(self, state, inputs, params, rc):
        """A group of V lanes: x f32[V, C, T], state w1/w2 f32[V, C]; an
        ungrouped stage: x f32[C, T], w1/w2 f32[C]. The coefficients (b0,
        b1, b2, p1, p2 [V or 1, T]) come from the step's K8 (the prologue's
        batch, or the stage's own launch when a param is modulated)."""
        if inputs[0].dim() == 2:
            st, (y,) = self.process({k: v[None] for k, v in state.items()},
                                    [inputs[0][None]], params, rc)
            return {k: v[0] for k, v in st.items()}, [y[0]]
        # The correction pass only runs when the poles can actually vary
        # (first event/modulation on frequency/Q — or on gain for
        # peaking/shelving types — rebuilds the graph).
        y, w1, w2 = biquad_apply(inputs[0], *rc.prologue_result, state["w1"], state["w2"],
                                 time_varying=self._time_varying())
        return {"w1": w1, "w2": w2, "__type_sel__": state["__type_sel__"]}, [y]
