"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix. Each piece lives in
files of its own under ``portbench/``, which this module finds by name, so
a later change adds a configuration, a mix, a cell or a metric by adding
files and entries and edits none:

* ``configs/<config>.json``: the sizes, as run (``BENCHMARK.json``'s
  ``file``), and ``configs/<config>.py`` beside it: ``make_inputs(cfg,
  seed)`` and ``build(cfg, inputs, ctx)``;
* ``reference/<config>.py``: the plain reference, ``render_blocks``;
* ``traffic/<mix>.json``: the mix's parameters, read by ``drive.py``,
  which finds the kind of call it names in ``calls/<kind>.py`` and the
  kind of edit in ``edits/<kind>.py``;
* ``cells/<workload>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from;
* ``metrics/<metric>.py``: one reader a metric, ``read(record)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    cfg: dict  # the configuration's sizes
    traffic: dict  # the mix's parameters
    limits: dict  # compared number -> limit
    builder: object  # portbench.configs.<config>
    reference: object  # portbench.reference.<config>
    metrics: list  # (BENCHMARK.json metric entry, reader module), end_to_end
    layer_metrics: list  # the same, per_layer


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str):
    """The reader module of metric ``name`` (``metrics/<name>.py``; a name
    may hold dots, so it is loaded by its path)."""
    path = PKG / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '__')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(entries, workload: str):
    """The metric entries that ``workload`` reports, with their readers."""
    return [(m, load_reader(m["name"])) for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def load_cell(workload: str, bench: dict = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (or of ``bench``)."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cfg = load_json(ROOT / conf["file"])
    stem = Path(conf["file"]).stem
    return Cell(
        name=workload,
        chips=int(wl["chips"]),
        cfg=cfg,
        traffic=load_json(PKG / "traffic" / f"{wl['traffic']}.json"),
        limits=load_json(PKG / "cells" / f"{workload}.json")["limits"],
        builder=importlib.import_module(f"portbench.configs.{stem}"),
        reference=importlib.import_module(f"portbench.reference.{stem}"),
        metrics=metrics_of(bench["end_to_end"], workload),
        layer_metrics=metrics_of(bench["per_layer"], workload),
    )
