"""The harness on the CPU: cells found by name, the result line, the inputs
both sides get, the import guard, and the reference's imports."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.cell import ROOT, load_cell
from portbench.drive import Driver
from portbench.tests.conftest import WORKLOADS



def _env(*paths):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([*map(str, paths), env.get("PYTHONPATH", "")])
    return env


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_added_config_mix_cell_and_metric_are_found_without_editing_a_file(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added to
    a copy as new files and BENCHMARK.json entries run with no existing
    file of the benchmark edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "config4_conv_reverb.json").read_text())
    cfg.update(name="config4_mono", ir_channels=1, voices=4, ir_seconds=0.25)
    (pb / "configs" / "config4_mono.json").write_text(json.dumps(cfg))
    (pb / "configs" / "config4_mono.py").write_text(
        "from portbench.configs.config4_conv_reverb import build, make_inputs  # noqa: F401\n")
    (pb / "reference" / "config4_mono.py").write_text(
        "from portbench.reference.config4_conv_reverb import render_blocks  # noqa: F401\n")
    (pb / "traffic" / "offline_short.json").write_text(json.dumps(
        {"call": "offline_render", "call_seconds": 0.4, "warmup_calls": 1, "edits": None,
         "compare_blocks": 3, "profile_steps": 8}))
    (pb / "cells" / "c4mono-short.json").write_text(json.dumps({"limits": {"rel_err": 1e-4}}))
    (pb / "metrics" / "calls_made.py").write_text("def read(rec):\n    return rec.calls\n")
    bench["configs"].append({"name": "config4_mono", "source": "a test", "reduced": [],
                             "file": "portbench/configs/config4_mono.json", "why": "a test"})
    bench["workloads"].append({"name": "c4mono-short", "config": "config4_mono",
                               "traffic": "offline_short", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "xrt":
            m["workloads"].append("c4mono-short")
    bench["per_layer"].append({"name": "calls_made", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "context", "moves": "xrt",
                               "workloads": ["c4mono-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json\n"
        "from portbench import harness\n"
        "from portbench.cell import load_cell\n"
        "cell = load_cell('c4mono-short')\n"
        "for trace in (False, True):\n"
        "    print(json.dumps(harness.run(cell, 2**31 + 9, 0.3, trace, 'cpu')[0]))\n")
    done = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, env=_env(tmp_path, ROOT), timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    untraced, traced = (json.loads(line) for line in done.stdout.strip().splitlines()[-2:])
    assert untraced["correct"] and traced["correct"]
    assert set(untraced["metrics"]) == {"xrt", "setup_s"}
    assert traced["metrics"]["calls_made"]["value"] >= 1
    assert _digests(tmp_path / "portbench").items() >= before.items()


PCM16_CALL = """
import numpy as np

from portbench.calls.offline_render import CONTEXT, EDITS, call_frames, open_context  # noqa: F401


def call(drv):
    pcm = drv.ctx.render_pcm16(drv.call_frames)
    drv.extra["pcm_bytes"] = drv.extra.get("pcm_bytes", 0) + pcm.nbytes
    out = pcm.reshape(drv.call_frames, -1).T.astype(np.float32) / np.float32(32767.0)
    drv.steps = -(-(drv.frame + out.shape[1]) // drv.step_frames)
    return out
"""


def test_a_mix_with_a_new_call_kind_and_new_readings_is_added_by_files_alone(tmp_path):
    """A mix whose calls are a new kind (pcm16 delivery), its cell, and
    readers of a span and of a reading that no reader read before are
    added to a copy as new files and BENCHMARK.json entries, and run with
    no existing file of the benchmark edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    (pb / "calls" / "offline_pcm16.py").write_text(PCM16_CALL)
    (pb / "traffic" / "pcm16_short.json").write_text(json.dumps(
        {"call": "offline_pcm16", "call_seconds": 0.4, "warmup_calls": 1, "edits": None,
         "compare_blocks": 3, "profile_steps": 8}))
    (pb / "cells" / "c4-pcm16.json").write_text(json.dumps({"limits": {"rel_err": 1e-3}}))
    (pb / "metrics" / "feed_us_step.py").write_text(
        "def read(rec):\n"
        "    return 1e6 * rec.spans['feed_s'] / rec.spans['rows']\n")
    (pb / "metrics" / "pcm_bytes.py").write_text(
        "def read(rec):\n    return rec.extra.get('pcm_bytes')\n")
    bench["workloads"].append({"name": "c4-pcm16", "config": "config4_conv_reverb",
                               "traffic": "pcm16_short", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "xrt":
            m["workloads"].append("c4-pcm16")
    for name in ("feed_us_step", "pcm_bytes"):
        bench["per_layer"].append({"name": name, "unit": "us", "better": "lower",
                                   "source": "program_span", "layer": "context",
                                   "moves": "xrt", "workloads": ["c4-pcm16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json\n"
        "from portbench import harness\n"
        "from portbench.cell import load_cell\n"
        "from portbench.tests.conftest import SMALL_CONFIG\n"
        "cell = load_cell('c4-pcm16')\n"
        "cell.cfg = dict(cell.cfg, **SMALL_CONFIG)\n"
        "for trace in (False, True):\n"
        "    print(json.dumps(harness.run(cell, 2**31 + 19, 0.3, trace, 'cpu')[0]))\n")
    done = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, env=_env(tmp_path, ROOT), timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    untraced, traced = (json.loads(line) for line in done.stdout.strip().splitlines()[-2:])
    assert untraced["correct"] and traced["correct"], (untraced["checks"], traced["checks"])
    assert set(untraced["metrics"]) == {"xrt", "setup_s"}
    assert traced["metrics"]["feed_us_step"]["value"] > 0
    assert traced["metrics"]["pcm_bytes"]["value"] >= 2 * 2 * 0.4 * 48000
    assert _digests(tmp_path / "portbench").items() >= before.items()


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_holds_exactly_the_contract_keys(small_cell, trace):
    result, lines = harness.run(small_cell("c4-offline"), 2**31 + 3, 0.3, trace, "cpu")
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if trace else ["checks"]
    assert list(result) == want
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = {"host_us_step", "launches_step", "build_ms"} if trace else {"xrt", "setup_s"}
    assert names <= set(result["metrics"])
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert list(result["checks"]) == ["rel_err", "blocks"]
    assert lines[0].startswith("check rel_err ")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_untraced_run_reports_exactly_its_cells_end_to_end_metrics(small_cell, workload):
    """Each cell reports the end-to-end metrics that BENCHMARK.json gives it,
    set-up among them, and every one above 0."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    result, _ = harness.run(small_cell(workload), 2**31 + 23, 0.3, False, "cpu")
    assert result["correct"], result["checks"]
    assert "setup_s" in want and len(want) >= 2
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_one_seed_gives_both_sides_the_same_inputs(small_cell, workload, monkeypatch):
    cell = small_cell(workload)
    seed = 2**31 + 17
    a, b = cell.builder.make_inputs(cell.cfg, seed), cell.builder.make_inputs(cell.cfg, seed)
    other = cell.builder.make_inputs(cell.cfg, seed + 1)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["voices"], other["voices"])
    drv = Driver(cell, seed, "cpu")
    seen = {}
    build = cell.builder.build

    def spy(cfg, inputs, ctx):
        seen["inputs"] = inputs
        seen["scene"] = build(cfg, inputs, ctx)
        return seen["scene"]

    monkeypatch.setattr(cell.builder, "build", spy)
    drv.build()
    assert seen["inputs"] is drv.inputs  # the reference reads drv.inputs too
    for k in a:
        assert np.array_equal(drv.inputs[k], a[k])
    scene = seen["scene"]
    if "sources" in scene:
        got = np.stack([s.buffer.get_channel_data(0) for s in scene["sources"]])
    else:
        got = np.stack([s._buffer.get_channel_data(0) for s in scene["sounds"]])
    assert np.array_equal(got, a["voices"])
    drv.dispose()


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "graphaudio_tpu",
                 "graphaudio_tpu.core"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    found = harness.forbidden_modules()
    assert {"jax", "jax.numpy", "jaxlib", "flax.linen", "graphaudio_tpu",
            "graphaudio_tpu.core"} <= set(found)
    assert not any(m.split(".")[0] in ("jaxtyping", "graphaudio_tpu_torch") for m in found)


def test_a_run_loads_no_jax_and_no_jax_package():
    script = (
        "import sys\n"
        "from portbench import harness\n"
        "from portbench.tests.conftest import shrink\n"
        "from portbench.cell import load_cell\n"
        "for w in ('c4-offline', 'c5-rt-moving'):\n"
        "    harness.run(shrink(load_cell(w)), 5, 0.2, False, 'cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, env=_env(ROOT), timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    top = set(json.loads(done.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "graphaudio_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    script = (
        "import sys\n"
        "import numpy as np\n"
        "from portbench.cell import load_json, ROOT\n"
        "from portbench.configs import config4_conv_reverb as c4, config5_spatial_scene as c5\n"
        "from portbench.reference import config4_conv_reverb as r4, config5_spatial_scene as r5\n"
        "for c, r, name in ((c4, r4, 'config4_conv_reverb'), (c5, r5, 'config5_spatial_scene')):\n"
        "    cfg = dict(load_json(ROOT / 'portbench' / 'configs' / (name + '.json')),\n"
        "               voices=2, ir_seconds=0.05)\n"
        "    r.render_blocks(cfg, c.make_inputs(cfg, 1), [(0, 256)])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, env=_env(ROOT), timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    top = set(json.loads(done.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not top & {"graphaudio_tpu_torch", *harness.FORBIDDEN}


def test_without_a_card_or_the_program_the_command_prints_no_result(tmp_path):
    """Without CUDA (this sandbox) the command fails before a result; and in
    a directory that holds only BENCHMARK.json and the benchmark it fails
    too."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    cmd = [sys.executable, "portbench/run.py", "--workload", "c4-offline", "--seed",
           str(2**31 + 1), "--seconds", "1", "--trace", "0"]
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (ROOT, tmp_path):
        done = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300,
                              env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert done.returncode != 0
        assert done.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    cell = load_cell("c4-offline")
    result, _ = harness.run(cell, 2**31 + 21, 2.0, False, "cuda")
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
