"""Faults planted under the timed path, for the checks that the comparison
deciding ``correct`` fails them (``tests/test_portbench_control.py``) and
for their readings at a cell's own size (``calibrate.py --faults``):

* ``state_unchanged``: every step returns the state it was given;
* ``half_the_voices``: the fan-in sums only the first half of its voices
  and scales the sum up by the share left out (a mean over the rest);
* ``answer_altered``: one sample of every superblock (of 2 quanta or more)
  altered by 0.01 where the step produces it.

The exchange between chips has no fault here: every cell runs on one card.
"""

from __future__ import annotations

from contextlib import contextmanager

FAULTS = ("state_unchanged", "half_the_voices", "answer_altered")


def _state_unchanged(fn):
    def step(states, *args):
        _, out = fn(states, *args)
        return states, out
    return step


def _answer_altered(fn):
    def step(*args):
        states, out = fn(*args)
        out = out.clone()
        out[:, 37::128 * 2] += 0.01
        return states, out
    return step


@contextmanager
def planted(fault: str):
    """The port's graph with ``fault`` in it while the block runs (a scene
    must be compiled inside it)."""
    from graphaudio_tpu_torch.core import graph

    if fault == "half_the_voices":
        name, fan_in = "fan_in_lanes", graph.fan_in_lanes

        def half(x, dst, group=None):
            V = x.shape[0]
            if V < 2:
                return fan_in(x, dst, group)
            return fan_in(x[:V // 2].contiguous(), dst, group) * (V / (V // 2))

        owner, new = graph, half
    elif fault in ("state_unchanged", "answer_altered"):
        wrap = _state_unchanged if fault == "state_unchanged" else _answer_altered
        name, make = "make_render_fn", graph.CompiledGraph.make_render_fn

        def broken(self):
            fn, channels = make(self)
            return wrap(fn), channels

        owner, new = graph.CompiledGraph, broken
    else:
        raise ValueError(f"unknown fault {fault!r}")
    old = getattr(owner, name)
    setattr(owner, name, new)
    try:
        yield
    finally:
        setattr(owner, name, old)
