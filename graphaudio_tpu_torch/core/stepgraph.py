"""A realtime context's step replayed as one CUDA graph.

A realtime step at superblock 2 is 5.33 ms of audio; enqueuing it kernel by
kernel from Python costs 1-3.5 ms of an H100 host's time (config 5: about
34 kernel launches), which leaves a slow stretch of the host little room
before the ring runs dry. Once a context has rendered a few
launches with nothing edited, ``StepGraph`` captures the step (the same
kernels, in the same order, on the same buffers) and replays it: the host
then copies the block clock in and launches one graph.

The graph's inputs are the context's state tensors, its param encodings
and stage consts, and a device copy of the block clock, the only input
that changes from step to step. Each replay writes the step's new states
back into the state tensors it read (the copies are part of the graph), so
``ctx._states`` keeps the same tensors from launch to launch. A host int
that a step advances (the convolver's ring head) cannot live in a graph:
before the capture, each stage's ``device_state_scalars`` move to the card
as int64 scalars (a checkpoint saves them as it saves the host ints), which
its kernels read there, and they stay there.

Anything that could change what the step computes drops the graph, and the
launches run one kernel at a time again until the fingerprint has held for
``QUIET_LAUNCHES``: a param edit or a node-state edit (the context's edit
counts), a rebuild or re-encoding (the compiled graph, encodings and consts
by identity), a state replaced from outside (the listener,
``update_node_state``, a checkpoint load: the state dicts by identity), or
another number of rows. A step the graph cannot hold (a host value in its
state that changes, a capture CUDA refuses) runs one kernel at a time for
as long as its fingerprint lasts (``refused`` says why).

The wrappers count what they launch (``cudabuild.launches``): a capture
counts the kernels of the launch it replays at once, and a later replay
adds nothing there. ``replays`` counts the launches that ran through a
graph (the capture's own among them) and ``kernels`` what one replay
launches.
"""

from __future__ import annotations

from collections import Counter

import torch

from graphaudio_tpu_torch.utils import cudabuild

#: Launches with an unchanged fingerprint before the step is captured.
QUIET_LAUNCHES = 3


class NotStatic(Exception):
    """The step's new state does not map onto the state it read."""


def copy_back_pairs(old, new):
    """(destination, source) tensor pairs that write ``new``'s state back
    into ``old``'s tensors: one pair per leaf the step replaced, none for a
    leaf it kept (the same tensor, written in place or not at all). Raises
    ``NotStatic`` where the two differ in keys, shapes or dtypes, or in a
    host value."""
    if new is old:
        return []
    if isinstance(old, dict):
        if not isinstance(new, dict) or new.keys() != old.keys():
            raise NotStatic("the state's keys changed")
        return [p for k in old for p in copy_back_pairs(old[k], new[k])]
    if isinstance(old, torch.Tensor):
        if (not isinstance(new, torch.Tensor) or new.shape != old.shape
                or new.dtype != old.dtype or new.device != old.device):
            raise NotStatic("a state tensor changed its shape or type")
        return [(old, new)]
    if new != old:
        raise NotStatic("a host value in the state changed")
    return []


def hold_scalars_on_card(ctx) -> None:
    """Each stage's declared host-int state leaves (its node's
    ``device_state_scalars``) as int64 scalars on the context's device, in
    new stage dicts of ``ctx._states``; values unchanged."""
    for sp in ctx._compiled.plan:
        names = getattr(sp["rep"], "device_state_scalars", ())
        st = ctx._states.get(sp["key"])
        if not names or not isinstance(st, dict):
            continue
        held = {n: torch.full((), int(st[n]), dtype=torch.int64, device=ctx.device)
                for n in names if n in st and not isinstance(st[n], torch.Tensor)}
        if held:
            ctx._states[sp["key"]] = {**st, **held}


class StepGraph:
    """The captured step of one realtime context (see the module)."""

    def __init__(self):
        self._fp = None  # the fingerprint the launches ran under
        self._quiet = 0  # launches under it
        self._failed = False  # the capture under this fingerprint was refused
        self._graph = None
        self._bt = None  # the graph's block clock
        self._out = None  # the graph's audio
        self._states = None  # ctx._states as captured, and its stage dicts
        self._stages = ()
        #: launches that ran through a graph, captures made, and the kernels
        #: a replay of the last capture launches (by wrapper count name)
        self.replays = 0
        self.captures = 0
        self.kernels = Counter()
        #: why the last refused capture was refused (None: none was)
        self.refused = None

    @staticmethod
    def _fingerprint(ctx, n_rows):
        """What the step reads besides its state and clock: the compiled
        graph, encodings and consts (held, compared by identity), the edit
        counts and the rows a launch runs."""
        return (ctx._compiled, ctx._encs, ctx._consts, ctx._param_edits, ctx._state_edits,
                n_rows)

    def _same_fingerprint(self, fp) -> bool:
        old = self._fp
        return (old is not None and all(a is b for a, b in zip(fp[:3], old[:3]))
                and fp[3:] == old[3:])

    def drop(self) -> None:
        """Forget the graph (its memory goes with it)."""
        self._graph = self._bt = self._out = self._states = None
        self._stages = ()

    def render(self, ctx, block_times, frame0s, first_row, n_main, feeds):
        """``ctx._render_fn(ctx._states, ctx._encs, ctx._consts,
        block_times, frame0s, first_row, n_main, feeds)``: (states, audio),
        by the graph where there is one for this fingerprint, else kernel by
        kernel (capturing the graph once the fingerprint has held long
        enough). The caller sends no feeds, pipes or mesh this way."""
        args = (frame0s, first_row, n_main, feeds)
        fp = self._fingerprint(ctx, len(frame0s))
        if not self._same_fingerprint(fp) or (self._graph is not None
                                              and not self._same_states(ctx)):
            self.drop()
            self._fp, self._quiet, self._failed = fp, 0, False
        if self._graph is not None:
            self._bt.copy_(block_times)
            self._graph.replay()
            self.replays += 1
            return ctx._states, self._out
        self._quiet += 1
        if self._quiet > QUIET_LAUNCHES and not self._failed:
            captured = self._capture(ctx, block_times, args)
            if captured is not None:
                return captured
            self._failed = True
        return ctx._render_fn(ctx._states, ctx._encs, ctx._consts, block_times, *args)

    def _same_states(self, ctx) -> bool:
        states = ctx._states
        return states is self._states and all(states.get(k) is v for k, v in self._stages)

    def _capture(self, ctx, block_times, args):
        """Capture the step on a side stream, then replay it once for this
        launch; None (nothing run, the counts as they were) where the state
        or CUDA refuses."""
        hold_scalars_on_card(ctx)
        states = ctx._states
        before = Counter(cudabuild.launches)
        bt = block_times.clone()
        cur = torch.cuda.current_stream(bt.device)
        side = torch.cuda.Stream(bt.device)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    new, out = ctx._render_fn(states, ctx._encs, ctx._consts, bt, *args)
                    pairs = copy_back_pairs(states, new)
                    # a new leaf sharing memory with a leaf being written is
                    # read before any write
                    written = {d.untyped_storage().data_ptr() for d, _ in pairs}
                    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in written else s)
                             for d, s in pairs]
                    for d, s in pairs:
                        d.copy_(s)
                finally:
                    graph.capture_end()
        except Exception as exc:  # noqa: BLE001  (NotStatic, or CUDA refusing the capture)
            cudabuild.launches.clear()
            cudabuild.launches.update(before)
            cur.wait_stream(side)
            self.refused = repr(exc)
            return None
        cur.wait_stream(side)
        counts = Counter(cudabuild.launches)
        counts.subtract(before)
        self.kernels = +counts
        self._graph, self._bt, self._out = graph, bt, out
        self._states, self._stages = states, tuple(states.items())
        self.captures += 1
        graph.replay()  # this launch's rows (the capture ran nothing)
        self.replays += 1
        return states, out
