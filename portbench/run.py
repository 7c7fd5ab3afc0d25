"""Command line of the port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is a workload of ``BENCHMARK.json``
(``portbench/cell.py`` finds what it names); ``portbench/harness.py`` runs
it. The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error. Without CUDA, with fewer cards than the
cell asks for, or where the process loaded JAX or the JAX package, the run
prints no result and exits with another code than 0.

The process keeps PyTorch's and the collector's defaults, as a user's
render would have them. The kernels' library is built by a checkout's first run into
``graphaudio_tpu_torch/_build/`` (the port's own fixed place); PyTorch's
and Triton's caches, should anything use them, go under
``.portbench_cache/`` in the checkout.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _finite(obj):
    """``obj`` with every float that is not finite as None (JSON has no
    infinity)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    sys.path.insert(0, str(ROOT))
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from portbench.cell import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from portbench import harness

    try:
        result, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    except RuntimeError as exc:
        print(f"portbench: no result: {exc}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(_finite(result)) + "\n")
    sys.stdout.flush()
    sys.stderr.write("".join(line + "\n" for line in lines))
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
