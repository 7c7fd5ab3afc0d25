"""One run of one cell: set-up, the measured window, the traced sub-window,
the check of the window's audio against the plain reference, the result.

``run`` is the whole of it; ``portbench/run.py`` is its command line. A run:

1. makes every input from the seed and builds the cell's scene with the
   port's public API (``build_ms``);
2. warms up with the mix's own calls (set-up ends there: ``setup_s``);
3. calls back to back for ``seconds`` (whole calls; the end-to-end rates
   are all the audio of the window's calls over their wall time);
4. with ``trace``, records the program's spans and counters over the
   window (``Record``) and then profiles ``profile_steps`` more steps
   (``devtrace``), and checks that the trace holds every launch of the
   port's kernels the wrappers counted there, shortening the sub-window
   where it did not;
5. checks that the process has not loaded JAX or the JAX package;
6. reads the device's memory peak, frees the scene, and has the plain
   reference compute the superblocks ``BlockSampler`` kept from the
   window; ``rel_err``, the largest gap over the largest magnitude, is
   held to the cell's limit (``cells/<workload>.json``).

The process runs as a user's would: the collector and the CPU pools as
the interpreter and PyTorch set them.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from portbench import devtrace
from portbench.cell import ROOT
from portbench.drive import BlockSampler, Driver

#: Top-level module names a run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "graphaudio_tpu")
#: Traced sub-windows tried, each half the one before, before a run gives
#: up its device readings.
PROFILE_TRIES = 3


@dataclass
class Record:
    """What a run read, for the metric readers (``metrics/<name>.py``).

    ``spans`` sums every numeric field of the program's per-launch
    breakdown (``RenderStats.last_breakdown``; nested keys joined by dots,
    such as ``parts.param_encode``) over the window's launches, in traced
    runs; ``setup_spans`` the same over set-up's. ``counters`` is each
    counter's change over the window: ``launches.<name>`` (the kernel
    wrappers' ``cudabuild.launches``), ``stats.<field>`` (the context's
    ``RenderStats``) and ``step_graph.<field>`` (its ``StepGraph``).
    ``extra`` is what the call kind put in ``Driver.extra``."""

    cell: object
    cfg: dict
    superblock: int
    setup_s: float = 0.0
    build_s: float = 0.0
    calls: int = 0
    audio_s: float = 0.0  # of the window's whole calls
    wall_s: float = 0.0  # of the same calls
    call_walls: list = field(default_factory=list)  # host seconds a call (traced)
    spans: dict = field(default_factory=dict)
    setup_spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    extra: dict = field(default_factory=dict)
    trace: dict = None  # devtrace.summarize of the sub-window


def forbidden_modules():
    """Modules loaded whose whole top-level name is forbidden."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _add_numbers(into: dict, tree: dict, prefix: str = "") -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _add_numbers(into, v, f"{prefix}{k}.")
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            into[prefix + k] = into.get(prefix + k, 0) + v


class SpanRecorder:
    """Sums each launch's breakdown into ``sums`` as the context records it
    (``RenderStats.record``), until ``close``."""

    def __init__(self, stats, sums: dict):
        self.stats, self.sums = stats, sums
        self._record = stats.record
        stats.record = self._on_record

    def _on_record(self, *args, **kwargs):
        self._record(*args, **kwargs)
        _add_numbers(self.sums, self.stats.last_breakdown)

    def close(self) -> None:
        if self.stats.__dict__.get("record") == self._on_record:
            del self.stats.record


def counters(ctx) -> dict:
    """The program's counters now: the wrappers' launches, the context's
    stats and its step graph's."""
    from graphaudio_tpu_torch.utils import cudabuild

    out = {f"launches.{k}": v for k, v in cudabuild.launches.items()}
    for prefix, obj in (("stats", ctx.stats), ("step_graph", getattr(ctx, "_step_graph", None))):
        for k, v in (vars(obj) if obj is not None else {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"{prefix}.{k}"] = v
    return out


def _change(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in after.keys() | before.keys()}


def _launch_total():
    from graphaudio_tpu_torch.utils import cudabuild

    # sub-counts ("name/mode") repeat a launch already counted
    return sum(v for k, v in cudabuild.launches.items() if "/" not in k)


def _replays(ctx):
    graph = getattr(ctx, "_step_graph", None)
    return 0 if graph is None else graph.replays


def _graph_kernels(ctx):
    graph = getattr(ctx, "_step_graph", None)
    return 0 if graph is None else sum(graph.kernels.values())


def _window(drv, rec, sampler, seconds, traced):
    """Calls back to back until ``seconds`` have passed; the rates count the
    calls begun inside the window, each whole."""
    ctx = drv.ctx
    recorder = SpanRecorder(ctx.stats, rec.spans) if traced else None
    before = counters(ctx)
    clock = time.perf_counter
    t0 = clock()
    end = t0 + seconds
    t = t0
    try:
        while t < end:
            frame0, out = drv.call()
            t1 = clock()
            sampler.offer(frame0, out)
            rec.calls += 1
            rec.audio_s += out.shape[1] / drv.sr
            if traced:
                rec.call_walls.append(t1 - t)
            t = t1
    finally:
        if recorder is not None:
            recorder.close()
    rec.wall_s = t - t0
    rec.counters = _change(before, counters(ctx))


def _profile(drv, sampler, steps, kernel_names):
    """Profile ``steps`` more steps (whole calls); halve them while the trace
    lost a launch of the port's kernels. Returns a devtrace summary or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = drv.ctx.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(PROFILE_TRIES):
        calls = max(1, int(round(steps / drv.call_steps())))
        launches0 = _launch_total()
        replays0 = _replays(drv.ctx)
        with profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW):
                for _ in range(calls):
                    sampler.offer(*drv.call())
            if cuda:
                torch.cuda.synchronize()
        try:
            summary = devtrace.summarize(devtrace.events(prof), kernel_names)
        except (OSError, ValueError, KeyError) as exc:  # an unreadable trace: no device readings
            print(f"portbench: the trace could not be read: {exc!r}", file=sys.stderr)
            summary = None
        want = (_launch_total() - launches0
                + (_replays(drv.ctx) - replays0) * _graph_kernels(drv.ctx))
        if summary is not None and (not cuda or summary["port_launches"] >= want):
            summary["expected_launches"] = want
            return summary
        print(f"portbench: the trace of {calls} calls holds "
              f"{summary and summary['port_launches']} of {want} launches; shortening it",
              file=sys.stderr)
        steps = max(1, steps // 2)
    return None


def rel_err(cell, drv, blocks, device, precision="float64"):
    """The largest gap between ``blocks`` ((stream frame0, f32[C, n]) each)
    and the reference's float64 audio there, over the reference's largest
    magnitude; None without blocks. With ``precision`` other than float64
    the blocks are ignored and the reference in that precision takes the
    program's place: the control."""
    if not blocks:
        return None
    spans = [(f0, a.shape[1]) for f0, a in blocks]
    edits = drv.reference_edits()
    refs = cell.reference.render_blocks(cell.cfg, drv.inputs, spans, "float64", device,
                                        edits=edits)
    if precision != "float64":
        got = cell.reference.render_blocks(cell.cfg, drv.inputs, spans, precision, device,
                                           edits=edits)
    else:
        got = [a.astype(np.float64) for _, a in blocks]
    gap = max(float(np.abs(g - r).max()) for g, r in zip(got, refs))
    peak = max(float(np.abs(r).max()) for r in refs)
    return gap / peak if peak > 0 else None


def measure(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            t_start=None):
    """Set-up, the window and, with ``trace``, the profiled sub-window of one
    run. Returns (record, driver, sampled blocks, failed calls, device
    memory peak, device name), the scene freed; raises ``RuntimeError``
    where the process loaded JAX or the JAX package."""
    import torch

    clock = time.perf_counter
    t_start = clock() if t_start is None else t_start
    cuda = device == "cuda"
    drv = Driver(cell, seed, device)
    rec = Record(cell=cell, cfg=cell.cfg, superblock=drv.superblock)
    if cuda:
        from graphaudio_tpu_torch.utils import cudabuild

        cudabuild.load()  # the kernels' library: built by a checkout's first run
    t_build = clock()
    drv.build()
    rec.build_s = clock() - t_build
    mix = cell.traffic
    recorder = SpanRecorder(drv.ctx.stats, rec.setup_spans)
    for _ in range(mix["warmup_calls"]):
        drv.call()
    recorder.close()
    rec.build_s += rec.setup_spans.get("parts.compile", 0.0)
    if cuda:
        torch.cuda.synchronize()
    sampler = BlockSampler(mix["compare_blocks"], drv.step_frames, seed)
    rec.setup_s = clock() - t_start
    failed = 0
    try:
        _window(drv, rec, sampler, seconds, trace)
        if trace:
            rec.trace = _profile(drv, sampler, mix["profile_steps"],
                                 devtrace.port_kernel_names(ROOT))
    except Exception as exc:  # noqa: BLE001  (a failed call fails the run's check)
        failed = 1
        print(f"portbench: a call failed: {exc!r}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {', '.join(found)}")
    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    rec.extra = drv.extra
    drv.dispose()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec, drv, sorted(sampler.blocks), failed, peak, kind


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", t_start=None):
    """One run of ``cell`` (``measure``, then the check). Returns (result
    dict, check lines); raises ``RuntimeError`` where the run may print no
    result."""
    rec, drv, blocks, failed, peak, kind = measure(cell, seed, seconds, trace, device, t_start)
    cuda = device == "cuda"
    t_ref = time.perf_counter()
    err = None if failed else rel_err(cell, drv, blocks, device)
    print(f"portbench: window {rec.wall_s:.3f} s, {rec.calls} calls; reference "
          f"{time.perf_counter() - t_ref:.3f} s for {len(blocks)} blocks", file=sys.stderr)
    limit = cell.limits["rel_err"]
    correct = failed == 0 and err is not None and err <= limit

    entries = cell.layer_metrics if trace else cell.metrics
    metrics = {}
    for entry, reader in entries:
        value = reader.read(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": rec.calls + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {"device_ops": devtrace.top(rec.trace["device_ops"]),
                               "idle_gaps": devtrace.top(rec.trace["idle_gaps"])}
    result["checks"] = {"rel_err": {"value": err, "limit": limit},
                        "blocks": {"value": len(blocks), "limit": 1}}
    lines = [f"check rel_err {err!r} limit {limit!r}",
             f"check blocks {len(blocks)} limit >= 1"]
    return result, lines
