"""The port's time-varying resampler (K7's plain version) against the JAX package.

Each graph is built the same way in both packages (the port with
``device="cpu"``, so ``resample_group_step_plain`` and the plain K6/K6m
run) and rendered side by side. The outputs agree within 1e-5 (the
renders' tolerance: the reference sums each output's four taps as a
banded matmul, the port in tap order); each voice's new ``x``,
``primed`` and ``stop_time`` bit for bit, since the port follows the
reference's f64 arithmetic op for op (XLA's cumsum and sum orders and the
fmas it contracts). ``resample_group_step_plain`` itself is held to the
JAX function ``_process_resample`` per voice within 1e-6 and bit for bit
in its states. The twins of tests/test_resample.py keep that file's
goldens and tolerances.
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
RENDER_TOL = 1e-5
MODULE_TOL = 1e-6
STATE_KEYS = ("x", "primed", "stop_time", "pos")


def _mono(mod, superblock, **kw):
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **kw)
    ctx.destination.set_channel_count(1)
    ctx.destination.inputs[0].set_channel_count_mode(mod.ChannelCountMode.EXPLICIT)
    return ctx


def _pair(build, superblock=2):
    """(JAX context, port context, JAX nodes, port nodes) of ``build``."""
    jctx = _mono(ga, superblock)
    tctx = _mono(gat, superblock, device="cpu")
    return jctx, tctx, build(ga, jctx), build(gat, tctx)


def _check_states(jctx, tctx, jnodes, tnodes):
    for jn, tn in zip(jnodes, tnodes):
        js, ts = jctx.peek_node_state(jn), tctx.peek_node_state(tn)
        if js is None or "x" not in js:
            continue
        for k in STATE_KEYS:
            np.testing.assert_array_equal(np.asarray(ts[k]), np.asarray(js[k]), err_msg=k)


def _render_both(jctx, tctx, jnodes, tnodes, chunks):
    outs = []
    for n in chunks:
        a = jctx.render(n)
        b = tctx.render(n)
        np.testing.assert_allclose(b, a, rtol=0, atol=RENDER_TOL)
        _check_states(jctx, tctx, jnodes, tnodes)
        outs.append(b[0])
    return np.concatenate(outs)


def _catmull_rom(s0, s1, s2, s3, t):
    return s1 + t * (
        0.5 * (s2 - s0)
        + t * ((s0 - 2.5 * s1 + 2.0 * s2 - 0.5 * s3) + t * (0.5 * (s3 - s0) + 1.5 * (s1 - s2)))
    )


def _golden_resample(data, rate, n_out, start_pos=0.0):
    """tests/test_resample.py's mirror of CubicResampler: x_j = start+1+j*rate."""
    out = np.zeros(n_out, np.float32)
    for j in range(n_out):
        x = start_pos + 1.0 + j * rate
        base = int(np.floor(x))
        t = np.float32(x - base)
        idx = np.clip([base - 1, base, base + 1, base + 2], 0, len(data) - 1)
        out[j] = _catmull_rom(*[data[i] for i in idx], t)
    return out


def _source(mod, ctx, data, rate_hz=SR, loop=False):
    src = mod.AudioBufferSourceNode(ctx)
    src.buffer = mod.PlayableAudioBuffer.from_mono_array(data, rate_hz)
    src.loop = loop
    src.connect(ctx.destination)
    return src


DATA = np.random.default_rng(7).standard_normal(1 << 14).astype(np.float32)


# ---- twins of tests/test_resample.py, the "resample" variant -----------------


def test_rate_1_1_state_across_renders():
    def build(mod, ctx):
        src = _source(mod, ctx, DATA[:8192])
        src.playback_rate.value = 1.1
        src.start(0)
        return [src]

    jctx, tctx, jn, tn = _pair(build, superblock=1)
    assert tn[0].kernel_variant()[0] == "resample"
    out = _render_both(jctx, tctx, jn, tn, [512, 512, 512])
    assert np.max(np.abs(out - _golden_resample(DATA[:8192], float(np.float32(1.1)), 1536))) < 1e-5


def test_offset_and_irrational_rate():
    def build(mod, ctx):
        src = _source(mod, ctx, DATA[:8192])
        src.playback_rate.value = 1.7
        src.start(0, offset=1000.0 / SR)
        return [src]

    jctx, tctx, jn, tn = _pair(build)
    out = _render_both(jctx, tctx, jn, tn, [1024])
    assert np.max(np.abs(out - _golden_resample(DATA[:8192], float(np.float32(1.7)), 1024, 1000.0))) < 1e-5


def test_loop_seam():
    def build(mod, ctx):
        src = _source(mod, ctx, DATA[:1000], loop=True)
        src.playback_rate.value = 0.7
        src.start(0)
        return [src]

    jctx, tctx, jn, tn = _pair(build)
    _render_both(jctx, tctx, jn, tn, [2048, 2048])


def test_exhaustion_stops_and_one_shot_ends_mid_superblock():
    """A one-shot whose window start hits region_len - w (taps outside the
    band get weight 0), ending inside a superblock: the ended callback and
    the stop time as in the reference."""
    fired = {"jax": [], "port": []}

    def build(mod, ctx):
        src = _source(mod, ctx, DATA[:600])
        src.playback_rate.value = 2.1
        src.on_ended(lambda n: fired["jax" if mod is ga else "port"].append(1))
        src.start(0.001)
        return [src]

    jctx, tctx, jn, tn = _pair(build, superblock=4)
    out = _render_both(jctx, tctx, jn, tn, [512, 512, 1024])
    assert np.allclose(out[400:], 0.0) and np.any(out[:250] != 0.0)
    assert fired["jax"] == fired["port"] == [1]


def test_linear_ramped_rate_group():
    """Three voices in one resample group: a linear ramp, a ramp with an
    exponential leg and a setTarget (all k-rate, exact f64 curves), one
    looped, one with a finite duration."""
    def build(mod, ctx):
        nodes = []
        for v in range(3):
            src = _source(mod, ctx, DATA[1000 * v:1000 * v + 6000], rate_hz=44100,
                          loop=(v == 1))
            pr = src.playback_rate
            pr.set_value_at_time(0.8, 0.0)
            pr.linear_ramp_to_value_at_time(1.3 + 0.1 * v, 0.05 + 0.01 * v)
            if v == 1:
                pr.exponential_ramp_to_value_at_time(0.6, 0.09)
            if v == 2:
                pr.set_target_at_time(1.9, 0.07, 0.01)
            src.start(0.0005 * v, 0.0, 0.1 if v == 2 else float("inf"))
            nodes.append(src)
        return nodes

    jctx, tctx, jn, tn = _pair(build, superblock=4)
    assert {n.kernel_variant() for n in tn} == {("resample", 2)}
    tctx._ensure_compiled()
    groups = [sp for sp in tctx._compiled.plan if sp["bufsrc"] is not None]
    assert len(groups) == 1 and groups[0]["bufsrc"][1] == ("resample", 2)
    _render_both(jctx, tctx, jn, tn, [2048, 2048, 1024])


def test_modulated_rate_on_same_rate_source():
    """An audio-rate modulation of playbackRate (ungrouped voice: the K7
    step over one lane, its rate through K6m)."""
    def build(mod, ctx):
        src = _source(mod, ctx, DATA[:8192])
        lfo = mod.ConstantSourceNode(ctx)
        lfo.offset.value = -0.5  # rate 1.0 + (-0.5) = 0.5
        lfo.connect(src.playback_rate)
        src.start(0)
        lfo.start(0)
        return [src]

    jctx, tctx, jn, tn = _pair(build)
    assert tn[0].kernel_variant()[0] == "resample" and tn[0].group_key([]) is None
    out = _render_both(jctx, tctx, jn, tn, [1024])
    np.testing.assert_allclose(out, _golden_resample(DATA[:8192], 0.5, 1024), atol=2e-6)


def test_modulated_rate_past_the_window_clamps():
    def build(mod, ctx):
        src = _source(mod, ctx, DATA)
        src.playback_rate.value = 1.0
        lfo = mod.ConstantSourceNode(ctx)
        lfo.offset.value = 7.0  # rate 8.0, past the window's bound
        lfo.connect(src.playback_rate)
        src.start(0)
        lfo.start(0)
        return [src]

    jctx, tctx, jn, tn = _pair(build)
    src = tn[0]
    w = type(src).resample_window(tctx.superblock, src.rate_bound())
    cap = max(1, (w - 16) // (tctx.superblock * 128))
    out = _render_both(jctx, tctx, jn, tn, [1024])
    np.testing.assert_allclose(out, _golden_resample(DATA, float(cap), 1024), atol=2e-6)


def test_oscillator_vibrato_into_playback_rate():
    """An LFO through a depth gain into playbackRate (the vibrato case)."""
    def build(mod, ctx):
        src = _source(mod, ctx, DATA[:4000], loop=True)
        lfo = mod.OscillatorNode(ctx)
        lfo.frequency.value = 7.0
        depth = mod.GainNode(ctx)
        depth.gain.value = 0.02
        lfo.connect(depth)
        depth.connect(src.playback_rate)
        src.start(0)
        lfo.start(0)
        return [src]

    jctx, tctx, jn, tn = _pair(build, superblock=4)
    _render_both(jctx, tctx, jn, tn, [2048, 2048])


def test_touch_and_poly_to_resample_keep_playhead():
    """Unity -> resample (playbackRate set to 1.1) and poly -> resample (an
    event scheduled) mid-render: the lanes' positions migrate, and the
    polyphase voice plays on as its golden."""
    def build(mod, ctx):
        a = _source(mod, ctx, np.arange(4096, dtype=np.float32) / 4096)
        b = _source(mod, ctx, DATA[:8192], rate_hz=44100)
        a.start(0)
        b.start(0)
        return [a, b]

    jctx, tctx, jn, tn = _pair(build)
    assert [n.kernel_variant()[0] for n in tn] == ["unity", "poly"]
    _render_both(jctx, tctx, jn, tn, [1024])
    for nodes in (jn, tn):
        nodes[0].playback_rate.value = 1.1
        nodes[1].playback_rate.set_value_at_time(1.0, 0.0)
    assert [n.kernel_variant()[0] for n in tn] == ["resample", "resample"]
    _render_both(jctx, tctx, jn, tn, [1024])
    x_b = tctx.peek_node_state(tn[1])["x"]
    assert abs(x_b - (1.0 + 2048 * 44100.0 / 48000.0)) < 1e-9


# ---- resample_group_step_plain against _process_resample, per voice -----------


def _group(mod, superblock, **kw):
    rng = np.random.default_rng(3)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **kw)
    specs = [(3000, True, 0.01, 0.04, 0.0, 0.0, float("inf")),
             (5000, False, 0.0, 0.0, 0.001, 0.02, float("inf")),
             (700, False, 0.0, 0.0, 0.0, 0.0, float("inf")),
             (9000, False, 0.0, 0.0, 0.002, 0.0, 0.03)]
    for n, loop, ls, le, when, off, dur in specs:
        src = mod.AudioBufferSourceNode(ctx)
        src.buffer = mod.PlayableAudioBuffer.from_mono_array(
            (rng.standard_normal(n) * 0.3).astype(np.float32), 44100)
        src.loop = loop
        src.loop_start, src.loop_end = ls, le
        src.playback_rate.value = 1.2
        src.connect(ctx.destination)
        src.start(when, off, dur)
    ctx._ensure_compiled()
    return ctx


@pytest.mark.parametrize("superblock", [2, 4])
def test_group_step_plain_matches_process_resample(superblock):
    jctx = _group(ga, superblock)
    tctx = _group(gat, superblock, device="cpu")
    key = "st0"
    w, variant, _ = tctx._compiled._bufsrc_cfg[0]
    assert variant[0] == "resample" and jctx._compiled._bufsrc_cfg[0][:2] == (w, variant)
    rep_j = jctx._compiled.plan[0]["rep"]
    arena = jnp.asarray(jctx._compiled.consts[f"{key}/arena"])
    geoms = jctx._compiled.consts[f"{key}/geom"]
    info = jgraph.StaticRenderInfo(SR, superblock)
    rng = np.random.default_rng(superblock)
    states = {k: np.asarray(v) for k, v in jctx._states[key].items()}
    V = states["x"].shape[0]
    lane = jax.jit(jax.vmap(
        lambda st, g, pr, bt: rep_j._process_resample(
            st, arena, g, pr, jgraph.RenderContext(info, 0, bt), w)))
    tstates = tgraph.to_device(states, "cpu")
    tgeom = tgraph.to_device(tctx._compiled.consts[f"{key}/geom"], "cpu")
    tarena = torch.from_numpy(tctx._compiled.consts[f"{key}/arena"])
    for step in range(8):
        bt = np.add.accumulate(np.full(superblock, 128 / SR) * (np.arange(superblock) > 0))
        bt = bt + step * superblock * 128 / SR
        rates = rng.uniform(0.5, 1.9, (V, superblock)).astype(np.float32)
        jst, jout = lane(states, geoms, rates, np.broadcast_to(bt, (V, superblock)))
        rc = tgraph.RenderContext(tgraph.StaticRenderInfo(SR, superblock), 0,
                                  torch.from_numpy(bt))
        tst, tout = type(tnode := tctx._compiled.plan[0]["rep"]).resample_group_step_plain(
            tstates, tarena, tgeom, torch.from_numpy(rates), rc, w)
        assert tnode is not None
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout[0]), rtol=0, atol=MODULE_TOL)
        for k in ("x", "primed", "stop_time"):
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
        states = {k: np.asarray(v) for k, v in jst.items()}
        tstates = tst


# ---- the module pieces: split_positions, gather_resample ----------------------


def test_split_positions_and_gather_match_jax():
    """``split_positions`` against the JAX function compiled alone (bases
    bit for bit; fractions within one f32 ulp of the in-chunk offset, the
    one rounding the port's fma skips, as XLA does when it compiles
    ``_process_resample`` whole) and ``gather_resample`` (looped and not,
    against the JAX function run eagerly on the same positions, within
    1e-6)."""
    from graphaudio_tpu.ops import resample as jres
    from graphaudio_tpu_torch.ops import resample as tres

    rng = np.random.default_rng(17)
    xb = rng.uniform(0, 3000, (6, 4))
    rb = rng.uniform(0.3, 2.0, (6, 4))
    jb, jf = jax.jit(jax.vmap(lambda a, b: jres.split_positions(a, b, 128)))(xb, rb)
    tb, tf = tres.split_positions(torch.from_numpy(xb), torch.from_numpy(rb))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # the offset a_frac + j*rate is below 1 + 15*2, whose f32 ulp is 2^-19
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=2.0 ** -19)
    # the fma form itself: each offset rounded once from its exact value
    n_sub = 128 // tres.SUB_CHUNK
    anchors = xb[..., None] + np.arange(n_sub) * (tres.SUB_CHUNK * rb)[..., None]
    a_frac = (anchors - np.floor(anchors)).astype(np.float32).astype(np.float64)
    j = np.arange(tres.SUB_CHUNK, dtype=np.float64)
    local = (a_frac[..., None] + j * rb.astype(np.float32)[..., None, None]).astype(np.float32)
    want_f = (local - np.floor(local)).reshape(tf.shape)
    np.testing.assert_array_equal(tf.numpy(), want_f)
    data = rng.standard_normal((2, 5000)).astype(np.float32)
    for loop in (False, True):
        args = (loop, 1000, 4000, 3000, 7, 4990)
        # eager: jitted, XLA contracts the polynomial's multiply-adds its own
        # way (an ulp or ten apart), which the reference's stream resampler
        # does not fix; both take the JAX positions
        want = jres.gather_resample(jnp.asarray(data), jb, jf, *args)
        got = tres.gather_resample(torch.from_numpy(data), torch.from_numpy(np.array(jb)),
                                   torch.from_numpy(np.array(jf)), *args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODULE_TOL)
