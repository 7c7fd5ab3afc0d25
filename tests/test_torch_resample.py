"""Port K1 (polyphase resample group) against the JAX package.

The same four-voice source group (looping and non-looping, start offsets, a
late start, a finite duration; 44.1 kHz buffers in a 48 kHz context, so the
147/160 polyphase variant) is built in both packages and stepped with
``AudioBufferSourceNode.process_poly_group``. The f64 bookkeeping is the
same sequence of operations, so the new ``x``, ``primed`` and ``stop_time``
must be EXACTLY equal; audio within 1e-6 (f32 summation order of the four
taps).
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
from graphaudio_tpu_torch.ops import resample as tres
from graphaudio_tpu.ops import resample as jres

SR = 48000


def _build(mod, superblock, **ctx_kw):
    rng = np.random.default_rng(21)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **ctx_kw)
    specs = [
        # (length, loop, loop_start, loop_end, when, offset, duration)
        (2000, True, 0.0, 0.0, 0.0, 0.0, float("inf")),
        (4000, True, 0.01, 0.03, 0.003, 0.005, float("inf")),
        (3000, False, 0.0, 0.0, 0.0, 0.01, float("inf")),
        (20000, False, 0.0, 0.0, 0.002, 0.02, 0.04),
    ]
    for n, loop, ls, le, when, off, dur in specs:
        src = mod.AudioBufferSourceNode(ctx)
        src.buffer = mod.PlayableAudioBuffer.from_mono_array(
            (rng.standard_normal(n) * 0.3).astype(np.float32), 44100
        )
        src.loop = loop
        src.loop_start, src.loop_end = ls, le
        src.playback_rate.value = 1.0
        src.connect(ctx.destination)
        src.start(when, off, dur)
    ctx._ensure_compiled()
    return ctx


@pytest.mark.parametrize("superblock, steps", [(4, 8), (8, 4)])
def test_poly_group_matches_jax(superblock, steps):
    jctx = _build(ga, superblock)
    tctx = _build(gat, superblock, device="cpu")
    w, variant, _ = tctx._compiled._bufsrc_cfg[0]
    assert variant == ("poly", 147, 160)
    assert jctx._compiled._bufsrc_cfg[0][:2] == (w, variant)
    p, q = variant[1:]

    jinfo = jgraph.StaticRenderInfo(SR, superblock)
    tinfo = tgraph.StaticRenderInfo(SR, superblock)
    jst = jax.device_get(jctx._states["st0"])
    arena = jctx._consts["st0/arena"]
    geom = jctx._consts["st0/geom"]
    np.testing.assert_array_equal(tctx._consts["st0/arena"].numpy(), np.asarray(arena))

    @jax.jit
    def jstep(states, bt, frame0):
        rc = jgraph.RenderContext(jinfo, frame0, bt)
        return ga.AudioBufferSourceNode.process_poly_group(states, arena, geom, rc, w, p, q)

    tst = tctx._states["st0"]
    taps = (tctx._consts["st0/poly_w"], tctx._consts["st0/poly_b"])
    inc = np.float64(128) / SR
    clock = np.add.accumulate(np.full(steps * superblock, inc) * (np.arange(steps * superblock) > 0))
    for k in range(steps):
        bt = clock[k * superblock:(k + 1) * superblock]
        frame0 = k * superblock * 128
        jst, jout = jstep(jst, jnp.asarray(bt), jnp.int64(frame0))
        rc = tgraph.RenderContext(tinfo, frame0, torch.from_numpy(bt))
        tst, tout = gat.AudioBufferSourceNode.process_poly_group(
            tst, tctx._consts["st0/arena"], tctx._consts["st0/geom"], tctx._consts["st0/gtab"],
            rc, w, p, q, taps
        )
        for key in ("x", "primed", "stop_time"):
            np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]), err_msg=key)
        assert np.abs(tout.numpy() - np.asarray(jout)).max() < 1e-6
    # Both non-looping voices stopped inside the render (one by a scheduled
    # duration, one by starving at its buffer end), so the starvation and
    # clear gates were exercised; the looping voices play on.
    assert np.isfinite(tst["stop_time"].numpy()).sum() == 2


def test_poly_taps_are_poly_matrix_entries():
    wtab, btab = tres.poly_taps(147, 160)
    H = jres.poly_matrix(147, 160)
    np.testing.assert_array_equal(tres.poly_matrix(147, 160), H)
    dense = np.zeros_like(H)
    for r in range(160):
        dense[btab[r] + np.arange(4), r] = wtab[r]
    np.testing.assert_array_equal(dense, H)


def test_cr_weights_match_jax():
    t = np.linspace(0.0, 1.0, 1001, dtype=np.float32)
    for got, want in zip(tres.cr_weights(torch.from_numpy(t)), jres.cr_weights(jnp.asarray(t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
