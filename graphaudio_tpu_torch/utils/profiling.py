"""Render performance statistics of the port.

The context records one entry per render call (a launch and its finish,
``core/context.py``). Breakdown fields
(``last_breakdown``, seconds on the host clock):

* ``prep_s``    drain commands, (re)build the graph, encode params, upload
                the call's block clock.
* ``enqueue_s`` host time spent issuing the step loop's device work
                (kernel launches, cuFFT calls, async device-to-host copies);
                nothing in it waits for the device.
* ``sync_s``    waiting for the device to finish the call's work and its
                device-to-host copies: at the finish, on the launch's own
                CUDA event.
* ``notify_s``  source ended-events after the call.

``wall = prep_s + enqueue_s + sync_s + notify_s``. On a CUDA device the
render is launch-bound when ``enqueue_s`` dominates and ``sync_s`` is small
(the device waits on the host); device-bound in the opposite case.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class RenderStats:
    """Aggregated statistics over a context's render calls."""

    render_calls: int = 0
    steps_rendered: int = 0
    quanta_rendered: int = 0
    frames_rendered: int = 0
    wall_seconds: float = 0.0
    enqueue_seconds: float = 0.0
    sync_seconds: float = 0.0
    graph_builds: int = 0
    #: render-thread exceptions survived (a realtime context records each in
    #: ``last_render_error`` and keeps rendering)
    render_errors: int = 0
    last_breakdown: dict = field(default_factory=dict)
    _call_quantum_us: List[float] = field(default_factory=list)

    def record(self, frames: int, quanta: int, steps: int, breakdown: dict) -> None:
        wall = sum(breakdown[k] for k in ("prep_s", "enqueue_s", "sync_s", "notify_s"))
        self.render_calls += 1
        self.steps_rendered += steps
        self.frames_rendered += frames
        self.quanta_rendered += quanta
        self.wall_seconds += wall
        self.enqueue_seconds += breakdown["enqueue_s"]
        self.sync_seconds += breakdown["sync_s"]
        self.last_breakdown = dict(breakdown, wall_s=wall)
        if quanta > 0:
            self._call_quantum_us.append(wall / quanta * 1e6)
            if len(self._call_quantum_us) > 4096:
                del self._call_quantum_us[:2048]

    def record_graph_build(self) -> None:
        self.graph_builds += 1

    def xrt(self, sample_rate: int) -> float:
        """Rendered-audio seconds per wall second."""
        if self.wall_seconds <= 0:
            return 0.0
        return (self.frames_rendered / sample_rate) / self.wall_seconds

    def _percentile(self, q: float) -> float:
        """Percentile (linear interpolation) over per-call quantum times."""
        if not self._call_quantum_us:
            return 0.0
        data = sorted(self._call_quantum_us)
        pos = q * (len(data) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(data) - 1)
        return float(data[lo] + (data[hi] - data[lo]) * (pos - lo))

    def p50_quantum_us(self) -> float:
        return self._percentile(0.5)

    def p99_quantum_us(self) -> float:
        return self._percentile(0.99)

    def summary(self, sample_rate: int) -> dict:
        return {
            "render_calls": self.render_calls,
            "steps_rendered": self.steps_rendered,
            "frames_rendered": self.frames_rendered,
            "wall_seconds": self.wall_seconds,
            "enqueue_seconds": self.enqueue_seconds,
            "sync_seconds": self.sync_seconds,
            "xrt": self.xrt(sample_rate),
            "p50_quantum_us": self.p50_quantum_us(),
            "p99_quantum_us": self.p99_quantum_us(),
            "graph_builds": self.graph_builds,
        }
