"""The comparison that decides ``correct`` fails what it must, on the CPU at
a size a test run holds, each through a whole run (``harness.run``, the
chip check skipped):

* the control: the reference in bfloat16, its blocks standing in for the
  program's;
* the faults a cell can have, planted in the program (``portbench/faults.py``):
  a step that returns its state unchanged, half of the voices left out of
  the fan-in, one sample of every superblock altered where it is produced.
"""

from __future__ import annotations

import numpy as np
import pytest

from portbench import faults, harness
from portbench.drive import BlockSampler, Driver
from portbench.tests.conftest import WORKLOADS

SEED = 2**31 + 303


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_correct(small_cell, workload, monkeypatch):
    drivers = []

    class Seen(Driver):
        def __init__(self, *args):
            super().__init__(*args)
            drivers.append(self)

    block = BlockSampler._block

    def control_block(self, frame0, audio):
        got = block(self, frame0, audio)
        if got is None:
            return None
        drv = drivers[-1]
        ref = drv.cell.reference.render_blocks(drv.cfg, drv.inputs, [(got[0], self.T)],
                                               "bfloat16", "cpu", edits=drv.reference_edits())
        return got[0], ref[0].astype(np.float32)

    monkeypatch.setattr(harness, "Driver", Seen)
    monkeypatch.setattr(BlockSampler, "_block", control_block)
    result, _ = harness.run(small_cell(workload), SEED, 0.3, False, "cpu")
    assert result["checks"]["blocks"]["value"] >= 1
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["rel_err"]["value"] > 3 * result["checks"]["rel_err"]["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", ("none",) + faults.FAULTS)
def test_a_fault_under_the_timed_path_fails_correct(small_cell, workload, fault):
    if fault == "none":
        result, _ = harness.run(small_cell(workload), SEED, 0.3, False, "cpu")
    else:
        with faults.planted(fault):
            result, _ = harness.run(small_cell(workload), SEED, 0.3, False, "cpu")
    assert result["correct"] is (fault == "none"), result["checks"]
