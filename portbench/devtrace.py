"""The device trace of a traced run's profiled sub-window, reduced.

``torch.profiler`` records the sub-window (CPU and CUDA activities) inside
one annotation, ``portbench.window``; ``events`` reads its Chrome trace
(exported to a temporary file, read and deleted: the format's categories
are the same across PyTorch versions). From its events this module takes
the device intervals (kernels, copies, fills) inside that annotation,
their union (``busy_s``), the idle gaps between them, each labelled with
the host operation that was running at its middle, the device time by
kernel name, and the count of the port's own kernels, found by the names
their sources under ``graphaudio_tpu_torch/csrc`` give.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import tempfile
from collections import Counter, defaultdict
from pathlib import Path

WINDOW = "portbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")


def port_kernel_names(root: Path) -> tuple:
    """The names of the port's CUDA kernels (``__global__`` functions of
    ``graphaudio_tpu_torch/csrc/*.cu``)."""
    names = set()
    for src in sorted((root / "graphaudio_tpu_torch" / "csrc").glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return tuple(sorted(names))


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void ns::k<2>(float*)`` -> ``ns::k``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            if ch == "(" and depth == 0:
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def events(prof):
    """(category, name, start ns, end ns) of every complete event of a
    finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    out = []
    for e in trace.get("traceEvents", trace) if isinstance(trace, dict) else trace:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = round(float(e["ts"]) * 1e3)
        out.append((e.get("cat", ""), e.get("name", ""), start,
                    start + round(float(e["dur"]) * 1e3)))
    return out


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(evs, kernel_names) -> dict:
    """Reduce a profile's ``events``. Returns window_s, busy_s, device_ops (name -> seconds),
    kernels (name -> [count, seconds]), port_launches (count of events of
    the port's kernels), idle_gaps (host label -> seconds, the gaps'
    total), or None when the window annotation is missing."""
    win = [e for e in evs if e[1] == WINDOW and e[0] == "user_annotation"]
    if not win:
        return None
    _, _, w0, w1 = win[0]
    dev, host = [], []
    for kind, name, s, t in evs:
        if t <= w0 or s >= w1:
            continue
        if kind in DEVICE_KINDS:
            dev.append((max(s, w0), min(t, w1), name, kind))
        elif kind in HOST_KINDS and not name.startswith("portbench."):
            host.append((s, t, name))
    merged = _union((s, t) for s, t, _, _ in dev)
    busy = sum(t - s for s, t in merged)
    ops = defaultdict(float)
    kernels = defaultdict(lambda: [0, 0.0])
    port = 0
    ours = re.compile(r"\b(?:%s)\b" % "|".join(map(re.escape, kernel_names))) if kernel_names \
        else None
    for s, t, name, kind in dev:
        label = short_name(name) if kind == "kernel" else kind
        ops[label] += (t - s) * 1e-9
        if kind == "kernel":
            kernels[name][0] += 1
            kernels[name][1] += (t - s) * 1e-9
            if ours is not None and ours.search(name):
                port += 1
    gaps = []
    prev = w0
    for s, t in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    host.sort()
    idle = Counter()
    active, i = [], 0  # heap of (end, start, name) of the host ops begun so far
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (host[i][1], host[i][0], host[i][2]))
            i += 1
        while active and active[0][0] <= mid:
            heapq.heappop(active)
        # the innermost op running at the gap's middle
        live = [a for a in active if a[0] > mid]
        label = min(live, key=lambda a: a[0] - a[1])[2] if live else "no recorded host op"
        idle[label] += (g1 - g0) * 1e-9
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "device_ops": dict(ops),
        "kernels": {k: tuple(v) for k, v in kernels.items()},
        "port_launches": port,
        "idle_gaps": dict(idle),
    }


def idle_percent(summary):
    """The share of the sub-window in which the card ran nothing, in
    percent; None without a trace or where no device work was recorded."""
    if summary is None or summary["window_s"] <= 0 or summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def top(d: dict, n: int = 10):
    """The ``n`` largest entries of a name -> seconds map, as [name, s]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def kernel_time(summary: dict, substring: str):
    """(launches, mean device seconds a launch) of the kernels whose name
    holds ``substring``, or None where the trace has none."""
    count, total = 0, 0.0
    for name, (c, s) in summary["kernels"].items():
        if substring in name:
            count += c
            total += s
    return None if count == 0 else (count, total / count)
