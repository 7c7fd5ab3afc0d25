"""The one traffic generator: drives a scene as a traffic mix's parameters
say (``traffic/<mix>.json``).

Every mix is closed loop, one client, one scene built at set-up. Its keys:

* ``call``: the call kind, a module ``calls/<call>.py`` found by name. It
  gives ``CONTEXT`` (``"offline"`` or ``"realtime"``: which of the
  configuration's superblocks, ``cfg["superblock"][CONTEXT]``, the context
  runs at), ``EDITS`` (whether it makes the mix's edits),
  ``open_context(drv)``, ``call_frames(drv)`` (frames a call delivers) and
  ``call(drv)`` (one call: its audio as f32[C, n], as the reference
  compares it); the rest of the mix's keys are the kind's parameters; a
  kind may put readings in ``drv.extra``, which readers see as
  ``Record.extra``;
* ``warmup_calls``: calls of the window's own shape made in set-up;
* ``edits``: null, or ``{"kind": k, ...}``: a module ``edits/<k>.py``
  whose ``Edits(drv, params, seed)`` gives ``before_step(step)`` and
  ``reference()`` (what the reference reads as ``edits``);
* ``compare_blocks``: superblocks of the window's audio, drawn from the
  seed, that the reference computes again;
* ``profile_steps``: steps the traced run profiles after its window.

A new call or edit kind is a new module; a new mix of existing kinds is a
new data file alone.
"""

from __future__ import annotations

import importlib

import numpy as np

FRAMES_PER_QUANTUM = 128


def kind_module(package: str, name: str):
    """``portbench.<package>.<name>`` (``calls`` or ``edits``)."""
    if not name.isidentifier():
        raise ValueError(f"{package} kind {name!r} is not a module name")
    return importlib.import_module(f"portbench.{package}.{name}")


class Driver:
    """A scene of one cell, built from ``seed``, and its calls."""

    def __init__(self, cell, seed: int, device: str):
        self.cell = cell
        cfg, mix = cell.cfg, cell.traffic
        self.cfg, self.mix = cfg, mix
        self.sr = cfg["sample_rate"]
        self.kind = kind_module("calls", mix["call"])
        self.superblock = cfg["superblock"][self.kind.CONTEXT]
        self.step_frames = self.superblock * FRAMES_PER_QUANTUM
        self.call_frames = self.kind.call_frames(self)
        self.inputs = cell.builder.make_inputs(cfg, seed)
        self.device = device
        self.ctx = None
        self.scene = None
        self.frame = 0  # stream frames delivered
        self.steps = 0  # steps launched
        self.extra = {}  # what a call kind records for the metric readers
        self.edits = None
        if mix.get("edits") is not None:
            if not self.kind.EDITS:
                raise ValueError(f"call kind {mix['call']!r} makes no edits")
            self.edits = kind_module("edits", mix["edits"]["kind"]).Edits(self, mix["edits"],
                                                                         seed)

    def build(self):
        """Make the context and wire the scene into it."""
        self.ctx = self.kind.open_context(self)
        self.scene = self.cell.builder.build(self.cfg, self.inputs, self.ctx)

    def edit_before(self, step: int) -> None:
        """The mix's edits due before ``step`` (a call kind calls this)."""
        if self.edits is not None:
            self.edits.before_step(step)

    def reference_edits(self):
        """What the reference reads as ``edits`` (None without edits)."""
        return None if self.edits is None else self.edits.reference()

    def call(self):
        """One call of the mix: (stream frame of its first sample, f32[C, n])."""
        frame0 = self.frame
        out = self.kind.call(self)
        self.frame += out.shape[1]
        return frame0, out

    def call_steps(self) -> float:
        """Superblocks a call delivers."""
        return self.call_frames / self.step_frames

    def dispose(self):
        if self.ctx is not None:
            self.ctx.dispose()
        self.ctx = self.scene = None


class BlockSampler:
    """Keeps ``k`` superblocks of the window's audio: a uniform sample of
    its calls drawn from the seed (reservoir sampling with geometric skips,
    Li's algorithm L, so a call not drawn costs one comparison), of each
    drawn call one superblock-aligned block inside it, also drawn."""

    def __init__(self, k: int, step_frames: int, seed: int):
        self.k = k
        self.T = step_frames
        self.rng = np.random.default_rng([seed % 2**63, 11])
        self.seen = 0
        self.blocks = []  # (stream frame0, f32[C, T])
        self._w = 1.0
        self._next = 0  # the 0-based index of the call drawn last, once full

    def offer(self, frame0: int, audio) -> None:
        self.seen += 1
        if len(self.blocks) < self.k:
            block = self._block(frame0, audio)
            if block is not None:
                self.blocks.append(block)
                if len(self.blocks) == self.k:
                    self._next = self.seen - 1
                    self._skip()
        elif self.seen - 1 == self._next:
            block = self._block(frame0, audio)
            if block is None:  # a call too short to hold one: draw the next
                self._next += 1
                return
            self.blocks[int(self.rng.integers(self.k))] = block
            self._skip()

    def _skip(self) -> None:
        self._w *= np.exp(np.log(self.rng.random()) / self.k)
        self._next += int(np.floor(np.log(self.rng.random()) / np.log1p(-self._w))) + 1

    def _block(self, frame0: int, audio):
        """A superblock-aligned block inside the call, drawn; None where the
        call holds none."""
        first = -(-frame0 // self.T) * self.T
        count = (frame0 + audio.shape[1] - first) // self.T
        if count <= 0:
            return None
        b0 = first + self.T * int(self.rng.integers(count))
        return b0, np.array(audio[:, b0 - frame0:b0 - frame0 + self.T])
