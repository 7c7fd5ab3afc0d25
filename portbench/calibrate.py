"""Readings a cell's limits are set from: the program's ``rel_err`` over
many seeds and the control's on the same blocks, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 --seconds <s> [--control]
        [--faults state_unchanged,half_the_voices,answer_altered --fault-seeds 3]

For each seed it makes a run's set-up and window (``harness.measure``,
``--seconds`` long, at the cell's own sizes and load), then prints one
JSON line: the seed, the program's ``rel_err`` against the float64
reference on the window's sampled blocks and, with ``--control``, the
control's on the same blocks: the reference itself in bfloat16 in the
program's place; with ``--faults``, on the first ``--fault-seeds``
seeds, the program's ``rel_err`` with each fault planted
(``portbench/faults.py``), each a set-up and window of its own. The lower
reading of a limit is the largest program reading, the upper the
smallest control reading. Runs on the card (as ``run.py`` does) unless
``--device cpu``. The benchmark's own runs never run the control or a
fault.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="", help="comma-separated faults to plant")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    sys.path.insert(0, str(ROOT))
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    from portbench import faults, harness
    from portbench.cell import load_cell

    cell = load_cell(args.workload)
    planted = [f for f in args.faults.split(",") if f]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rec, drv, blocks, failed, _, kind = harness.measure(cell, seed, args.seconds, False,
                                                             args.device)
        line = {"workload": cell.name, "seed": seed, "device": kind, "calls": rec.calls,
                "blocks": len(blocks), "failed": failed,
                "rel_err": None if failed else harness.rel_err(cell, drv, blocks, args.device)}
        if args.control:
            line["control_rel_err"] = harness.rel_err(cell, drv, blocks, args.device,
                                                      "bfloat16")
        if i < args.fault_seeds and planted:
            line["faults"] = {}
            for fault in planted:
                with faults.planted(fault):
                    rec, drv, blocks, failed, _, _ = harness.measure(cell, seed, args.seconds,
                                                                     False, args.device)
                line["faults"][fault] = (None if failed else
                                         harness.rel_err(cell, drv, blocks, args.device))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
