"""The plain references against the port's CPU render at a tiny size: a few
superblocks of a few voices, every path the cells time (config 4 at the
big and the 128-frame convolver grain; config 5 offline, realtime, and
moving its sounds a game frame at a time)."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.drive import Driver

#: The port renders in f32 against the references' f64: a few ulps of the
#: peak after the convolutions' sums (the CPU renders read 1e-7 to 3e-6).
TOLERANCE = 1e-5


def _rel_err(audio, frame0, refs, blocks):
    gap = max(np.abs(audio[:, f0 - frame0:f0 - frame0 + n] - r).max()
              for (f0, n), r in zip(blocks, refs))
    return gap / max(np.abs(r).max() for r in refs)


@pytest.mark.parametrize("workload, superblock", [
    ("c4-offline", 64), ("c4-offline", 4), ("c5-offline", 32), ("c5-offline", 4)])
def test_offline_reference_matches_the_port(small_cell, workload, superblock):
    cell = small_cell(workload)
    cell.cfg = dict(cell.cfg, superblock={"offline": superblock})
    drv = Driver(cell, 2**31 + 101, "cpu")
    drv.build()
    T = drv.step_frames
    audio = drv.ctx.render(6 * T)
    blocks = [(0, T), (3 * T, 2 * T), (5 * T, T)]
    refs = cell.reference.render_blocks(cell.cfg, drv.inputs, blocks)
    drv.dispose()
    assert _rel_err(audio, 0, refs, blocks) < TOLERANCE


@pytest.mark.parametrize("workload", ["c5-rt-moving"])
def test_realtime_reference_matches_the_port(small_cell, workload):
    """Realtime steps through the harness's own driver, the moving mix's
    game frames included."""
    cell = small_cell(workload)
    drv = Driver(cell, 2**31 + 202, "cpu")
    drv.build()
    outs = [drv.call() for _ in range(40)]
    audio = np.concatenate([a for _, a in outs], axis=1)
    T = drv.step_frames
    blocks = [(0, 2 * T), (17 * T, 5 * T), (37 * T, 3 * T)]
    refs = cell.reference.render_blocks(cell.cfg, drv.inputs, blocks,
                                        edits=drv.reference_edits())
    drv.dispose()
    assert _rel_err(audio, 0, refs, blocks) < TOLERANCE
    if workload == "c5-rt-moving":
        # the sounds did move: the static scene's reference misses by far
        still = cell.reference.render_blocks(cell.cfg, drv.inputs, blocks)
        assert _rel_err(audio, 0, still, blocks) > 100 * TOLERANCE
