"""Config 5's Kit scene with every voice occluded, the port against the JAX
package, on the CPU (plain kernel versions).

Every panner runs the 3-band split (occlusion 0.5, transmission 0.8 / 0.4
/ 0.1), so all voices form one occluded panner group and the step's band
split covers the whole group. A few voices at superblock 8: two steps,
the listener turned in both renderers, two more steps; within 1e-5 (the
port's one-pole crossovers are f32 matmuls like the package's, in another
summation order).
"""

import numpy as np
import pytest

import benchmarks.configs as bc
from graphaudio_tpu_torch.testing.configs import config5_spatial_scene

TOL = 1e-5


def _occlude_all(ctx):
    for snd in ctx._sounds:
        snd.occlusion = 0.5
        snd.set_transmission(0.8, 0.4, 0.1)
    return ctx


@pytest.mark.parametrize("voices", [3, 6])
def test_every_voice_occluded_side_by_side_with_jax(voices):
    T = 8 * 128
    jctx = _occlude_all(bc.config5_spatial_scene(superblock=8, voices=voices))
    tctx = _occlude_all(config5_spatial_scene(superblock=8, voices=voices, device="cpu"))
    want, got = [jctx.render(2 * T)], [tctx.render(2 * T)]
    for ctx in (jctx, tctx):
        ctx._engine.set_listener([0.5, 0.0, 0.5], [0.3, 0.0, -1.0], [0, 1, 0])
    want.append(jctx.render(2 * T))
    got.append(tctx.render(2 * T))
    want, got = np.concatenate(want, axis=1), np.concatenate(got, axis=1)
    panner_groups = [sp for sp in tctx._compiled.plan
                     if type(sp["rep"]).__name__ == "SpatialPannerNode"]
    assert len(panner_groups) == 1  # one occluded group (lanes padded to a capacity)
    assert panner_groups[0]["rep"]._occlusion_active()
    assert np.abs(want).max() > 1e-3
    assert np.abs(got.astype(np.float64) - want).max() < TOL
