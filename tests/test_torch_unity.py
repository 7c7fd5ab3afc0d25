"""Port K5 (unity-rate buffer playback of a voice group) against the JAX
package.

The same voice group (48 kHz buffers in a 48 kHz context, playbackRate
untouched, so the ("unity", aligned) variant) is built in both packages
and stepped with ``AudioBufferSourceNode.process_unity_group``: looping
and non-looping voices, late starts, start offsets, a scheduled stop, a
finite duration and buffers that run out mid-block (the end-of-buffer
clear and auto-stop), once with every voice 128-aligned and once without.
The f64 bookkeeping is the same sequence of operations and the audio a
copy, so every state leaf, ``pos`` and ``stop_time`` included, and every
output sample must be EXACTLY equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.core import graph as jgraph
from graphaudio_tpu_torch.core import graph as tgraph

SR = 48000
B = 128 / SR

# (length, loop, loop_start, loop_end, when, offset, duration, stop)
ALIGNED = [
    (3000, False, 0.0, 0.0, 0.0, 0.0, float("inf"), None),
    (5000, True, 128 / SR, 1152 / SR, 0.003, 256 / SR, float("inf"), None),
    (4096, True, 0.0, 0.0, 0.0, 0.0, float("inf"), 0.021),
    (20000, False, 0.0, 0.0, 0.002, 512 / SR, 0.04, None),
    (6000, False, 0.0, 0.0, 0.011, 0.0, float("inf"), None),
]
UNALIGNED = [
    (3000, False, 0.0, 0.0, 0.0, 0.0013, float("inf"), None),
    (4100, True, 0.01, 0.03, 0.003, 0.005, float("inf"), None),
    (2000, True, 0.0, 0.0, 0.0, 0.0, float("inf"), 0.033),
    (20000, False, 0.0, 0.0, 0.002, 0.02, 0.04, None),
]


def _build(mod, specs, superblock, **ctx_kw):
    rng = np.random.default_rng(31)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **ctx_kw)
    for n, loop, ls, le, when, off, dur, stop in specs:
        src = mod.AudioBufferSourceNode(ctx)
        src.buffer = mod.PlayableAudioBuffer.from_stereo_arrays(
            (rng.standard_normal(n) * 0.3).astype(np.float32),
            (rng.standard_normal(n) * 0.3).astype(np.float32), SR)
        src.loop = loop
        src.loop_start, src.loop_end = ls, le
        src.connect(ctx.destination)
        src.start(when, off, dur)
        if stop is not None:
            src.stop(stop)
    ctx._ensure_compiled()
    return ctx


@pytest.mark.parametrize("specs, aligned", [(ALIGNED, True), (UNALIGNED, False)],
                         ids=["aligned", "unaligned"])
@pytest.mark.parametrize("superblock", [4, 8])
def test_unity_group_matches_jax(specs, aligned, superblock):
    steps = 96 // superblock  # 0.256 s: every non-looping voice ends
    jctx = _build(ga, specs, superblock)
    tctx = _build(gat, specs, superblock, device="cpu")
    w, variant, _ = tctx._compiled._bufsrc_cfg[0]
    assert variant == ("unity", aligned)
    assert jctx._compiled._bufsrc_cfg[0][:2] == (w, variant)
    arena, geom = jctx._consts["st0/arena"], jctx._consts["st0/geom"]
    np.testing.assert_array_equal(tctx._consts["st0/arena"].numpy(), np.asarray(arena))
    for k, v in geom.items():
        np.testing.assert_array_equal(tctx._consts["st0/geom"][k].numpy(), np.asarray(v),
                                      err_msg=k)
    jinfo = jgraph.StaticRenderInfo(SR, superblock)
    tinfo = tgraph.StaticRenderInfo(SR, superblock)

    @jax.jit
    def jstep(states, bt, frame0):
        rc = jgraph.RenderContext(jinfo, frame0, bt)
        return ga.AudioBufferSourceNode.process_unity_group(states, arena, geom, rc, w,
                                                            aligned=aligned)

    jst = jax.device_get(jctx._states["st0"])
    tst = tctx._states["st0"]
    clock = np.add.accumulate(np.full(steps * superblock, B) * (np.arange(steps * superblock) > 0))
    heard = 0.0
    for k in range(steps):
        bt = clock[k * superblock:(k + 1) * superblock]
        frame0 = k * superblock * 128
        jst, jout = jstep(jst, jnp.asarray(bt), jnp.int64(frame0))
        rc = tgraph.RenderContext(tinfo, frame0, torch.from_numpy(bt))
        tst, tout = gat.AudioBufferSourceNode.process_unity_group(
            tst, tctx._consts["st0/arena"], tctx._consts["st0/geom"], tctx._consts["st0/gtab"],
            rc, w, aligned=aligned)
        for key in jst:
            np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]), err_msg=key)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        heard += float(np.abs(np.asarray(jout)).sum())
    assert heard > 0.0
    # The non-looping voices and the stopped one ended inside the render
    # (duration, buffer end, stop()), so the clear and auto-stop gates ran.
    stops = tst["stop_time"].numpy()[:len(specs)]
    assert np.isfinite(stops).sum() == sum(1 for s in specs if not s[1] or s[7] is not None)


def test_window_and_variant_follow_the_jax_package():
    for sb in (1, 4, 32):
        assert gat.AudioBufferSourceNode.unity_window(sb) == \
            ga.AudioBufferSourceNode._window_w(sb, 1, True)
    for specs, aligned in ((ALIGNED, True), (UNALIGNED, False)):
        ctx = _build(gat, specs, 4, device="cpu")
        variants = {n.kernel_variant() for n in ctx._nodes.values()
                    if isinstance(n, gat.AudioBufferSourceNode)}
        assert variants == {("unity", aligned)}
