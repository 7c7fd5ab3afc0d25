"""The port's DelayNode, StereoPannerNode, ChannelSplitterNode and
ChannelMergerNode, on the CPU.

* twins of the nine node tests of tests/test_nodes.py (:36-165: the
  panner's mono and stereo laws and centre, the splitter/merger round trip
  and silent extra outputs, the delay's constant, zero, tail and automated
  time) and of the delay/splitter/merger scene against the numpy oracle
  (tests/test_oracle.py:332-352);
* the plain K12 (``delay_step_plain``) against the JAX ``DelayNode.process``
  bit for bit (tolerance 0: the output, and the new ring and cursor through
  ``delay_jax_view``) at d = L, d = 0, d > T, T >= L, mono and stereo;
* the plain K13 (``stereo_pan_plain``) against the jitted JAX node, both
  laws, within 3e-7: its gains are the correctly rounded f32 cos and sin,
  XLA's f32 trig is an ulp off now and then, and an ulp of a gain below 1
  times |x| < 2.5 stays under 1.5e-7; the stereo law's two multiply-adds
  are fmas, as XLA contracts them (the separately rounded form agrees
  with the JAX node bit for bit on fewer samples);
* ``config4_pingpong`` and ``config5_steplinear`` (4 and 8 voices, 8
  superblocks) against their JAX renders within 1e-5, and the Kit's
  step-linear mode and a ``from_jax`` hand-off of the delay's ring and
  cursor mid-render.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu import kit as jkit
from graphaudio_tpu.nodes.delay import DelayNode as JaxDelay
from graphaudio_tpu.nodes.panner import StereoPannerNode as JaxPanner
from graphaudio_tpu_torch import kit as tkit
from graphaudio_tpu_torch.nodes.delay import (
    delay_jax_view,
    delay_state_from_jax,
    delay_step_plain,
)
from graphaudio_tpu_torch.nodes.panner import stereo_pan_plain
from graphaudio_tpu_torch.testing import configs as tconfigs
from graphaudio_tpu_torch.testing import groups
from graphaudio_tpu_torch.utils import from_jax

SR = 48000


def _ctx(superblock):
    return gat.OfflineAudioContext(sample_rate=SR, superblock=superblock, device="cpu")


def _noise_buffer(rng, n=2048, channels=1, scale=0.5):
    data = [rng.standard_normal(n).astype(np.float32) * scale for _ in range(channels)]
    return gat.PlayableAudioBuffer.from_channel_arrays(data, SR), np.stack(data)


def _play(ctx, buf):
    src = gat.AudioBufferSourceNode(ctx)
    src.buffer = buf
    src.start(0)
    return src


# ---- twins of tests/test_nodes.py ---------------------------------------------------


def test_stereo_panner_mono_law(rng):
    ctx = _ctx(1)
    buf, data = _noise_buffer(rng, 512)
    src = _play(ctx, buf)
    pan = gat.StereoPannerNode(ctx)
    pan.pan.value = -0.5
    src.connect(pan).connect(ctx.destination)
    out = ctx.render(256)
    x = (-0.5 + 1.0) * 0.5
    gl, gr = np.cos(x * np.pi / 2), np.sin(x * np.pi / 2)
    assert np.max(np.abs(out[0] - data[0][:256] * np.float32(gl))) < 1e-6
    assert np.max(np.abs(out[1] - data[0][:256] * np.float32(gr))) < 1e-6


def test_stereo_panner_stereo_law(rng):
    ctx = _ctx(1)
    buf, data = _noise_buffer(rng, 512, channels=2)
    src = _play(ctx, buf)
    pan = gat.StereoPannerNode(ctx)
    src.connect(pan).connect(ctx.destination)
    pan.pan.value = -1.0  # pan < 0 mixes R into L (StereoPannerNode.cs:138-142)
    out = ctx.render(256)
    gl, gr = np.cos(0.0), np.sin(0.0)  # 1, 0
    assert np.max(np.abs(out[0] - (data[0][:256] + data[1][:256] * gl))) < 1e-6
    assert np.max(np.abs(out[1] - data[1][:256] * gr)) < 1e-6


def test_stereo_panner_center_stereo_passthrough(rng):
    ctx = _ctx(1)
    buf, data = _noise_buffer(rng, 512, channels=2)
    src = _play(ctx, buf)
    pan = gat.StereoPannerNode(ctx)  # pan = 0: x = 1, gl = cos(pi/2) = 0, gr = 1
    src.connect(pan).connect(ctx.destination)
    out = ctx.render(256)
    assert np.max(np.abs(out[0] - data[0][:256])) < 1e-6
    assert np.max(np.abs(out[1] - data[1][:256])) < 1e-6


def test_splitter_merger_roundtrip(rng):
    ctx = _ctx(1)
    buf, data = _noise_buffer(rng, 512, channels=2)
    src = _play(ctx, buf)
    split = gat.ChannelSplitterNode(ctx, 2)
    merge = gat.ChannelMergerNode(ctx, 2)
    src.connect(split)
    split.connect(merge, output=0, input=1)  # swap the channels
    split.connect(merge, output=1, input=0)
    merge.connect(ctx.destination)
    out = ctx.render(256)
    assert np.max(np.abs(out[0] - data[1][:256])) < 1e-7
    assert np.max(np.abs(out[1] - data[0][:256])) < 1e-7


def test_splitter_extra_outputs_silent(rng):
    ctx = _ctx(1)
    buf, _ = _noise_buffer(rng, 512, channels=1)
    src = _play(ctx, buf)
    split = gat.ChannelSplitterNode(ctx, 4)
    src.connect(split)
    split.connect(ctx.destination, output=3)  # beyond the input's channels
    assert np.allclose(ctx.render(128), 0.0)


def test_delay_constant(rng):
    ctx = _ctx(2)
    buf, data = _noise_buffer(rng, 4096)
    src = _play(ctx, buf)
    d = gat.DelayNode(ctx, max_delay_time=0.1)
    d.delay_time.value = 200 / SR
    src.connect(d).connect(ctx.destination)
    out = ctx.render(1024)[0]
    n_delay = int((200 / SR) * SR)
    expect = np.zeros(1024, np.float32)
    expect[n_delay:] = data[0][: 1024 - n_delay]
    assert np.max(np.abs(out - expect)) < 1e-7


def test_delay_zero_is_silent(rng):
    ctx = _ctx(1)
    buf, _ = _noise_buffer(rng, 512)
    src = _play(ctx, buf)
    d = gat.DelayNode(ctx)
    d.delay_time.value = 0.0  # reads 0 (DelayNode.cs:143-144)
    src.connect(d).connect(ctx.destination)
    assert np.allclose(ctx.render(256)[0], 0.0)


def test_delay_tail_after_input_stops(rng):
    # The source's final block is cleared by the reference quirk, so only
    # block 0 enters the delay line (DelayNode.cs:61-76).
    ctx = _ctx(1)
    buf, data = _noise_buffer(rng, 256)
    src = _play(ctx, buf)
    d = gat.DelayNode(ctx, max_delay_time=0.05)
    d.delay_time.value = 256 / SR
    src.connect(d).connect(ctx.destination)
    out = ctx.render(640)[0]
    expect = np.zeros(640, np.float32)
    expect[256:256 + 128] = data[0][:128]
    assert np.max(np.abs(out - expect)) < 1e-7


def test_delay_automated_time(rng):
    ctx = _ctx(1)
    buf, data = _noise_buffer(rng, 2048)
    src = _play(ctx, buf)
    d = gat.DelayNode(ctx, max_delay_time=0.05)
    d.delay_time.set_value_at_time(100 / SR, 0.0)
    d.delay_time.set_value_at_time(150 / SR, 512 / SR)
    src.connect(d).connect(ctx.destination)
    out = ctx.render(1024)[0]
    expect = np.zeros(1024, np.float32)
    for i in range(1024):
        j = i - (100 if i < 512 else 150)
        if j >= 0:
            expect[i] = data[0][j]
    assert np.max(np.abs(out - expect)) < 1e-7


def test_delay_and_split_merge_match_oracle(rng):
    """tests/test_oracle.py:332-352: an automated a-rate delay into a
    splitter/merger channel swap, against the numpy oracle."""
    from graphaudio_tpu.testing.oracle import (
        OracleBufferSource, OracleChannelMerger, OracleChannelSplitter, OracleContext,
        OracleDelay,
    )

    left = (rng.standard_normal(SR // 4) * 0.4).astype(np.float32)
    right = (rng.standard_normal(SR // 4) * 0.4).astype(np.float32)

    def build(ctx, port):
        if port:
            src = gat.AudioBufferSourceNode(ctx)
            src.buffer = gat.PlayableAudioBuffer.from_stereo_arrays(left, right, SR)
            dl = gat.DelayNode(ctx, max_delay_time=0.05)
            sp, mg = gat.ChannelSplitterNode(ctx, 2), gat.ChannelMergerNode(ctx, 2)
        else:
            src = OracleBufferSource(ctx)
            src.set_buffer(np.stack([left, right]), SR)
            dl = OracleDelay(ctx, max_delay_time=0.05)
            sp, mg = OracleChannelSplitter(ctx, 2), OracleChannelMerger(ctx, 2)
        dl.delay_time.set_value_at_time(0.001, 0.0)
        dl.delay_time.linear_ramp_to_value_at_time(0.04, 0.2)
        src.connect(dl).connect(sp)
        sp.connect(mg, 0, 1)
        sp.connect(mg, 1, 0)
        mg.connect(ctx.destination)
        src.start(0)

    ctx, octx = _ctx(8), OracleContext(sample_rate=SR)
    build(ctx, True)
    build(octx, False)
    got, want = ctx.render(SR // 4), octx.render(SR // 4)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-6


# ---- the plain kernels against the JAX nodes ------------------------------------------


class _Signal:
    def __init__(self, values):
        self._values = values

    def per_sample(self):
        return self._values


@pytest.mark.parametrize("C,T,max_s,delays,w", [
    (1, 256, 96 / SR, "L", 40),          # d = L and T >= L (trailing L written)
    (2, 128, 200 / SR, "L", 150),        # d = L, T < L: reads the slot the step writes
    (2, 128, 400 / SR, "ramp", 7),       # 0 <= d <= L across the block, d > T
    (1, 512, 512 / SR, "ramp", 511),     # T = L
    (2, 256, 160 / SR, "zero", 3),       # d = 0 reads silence, T >= L
], ids=["d=L T>L mono", "d=L T<L stereo", "ramp d>T", "T=L", "d=0"])
def test_plain_k12_against_jax_process(C, T, max_s, delays, w):
    rng = np.random.default_rng(T + C)
    jnode = JaxDelay(ga.OfflineAudioContext(sample_rate=SR, superblock=1), max_s)
    L = jnode._max_delay_samples
    x = rng.standard_normal((C, T)).astype(np.float32)
    ring = rng.standard_normal((C, L)).astype(np.float32)
    if delays == "L":
        dt = np.full(T, np.float32(max_s), np.float32)
    elif delays == "zero":
        dt = np.zeros(T, np.float32)
    else:
        dt = np.linspace(0.0, max_s * 1.2, T).astype(np.float32)
    rc = types.SimpleNamespace(sample_rate=SR, frames=T)
    dt = np.minimum(dt, np.float32(max_s))  # the param's clamp
    jst, (jout,) = jnode.process({"ring": jnp.asarray(ring), "wpos": jnp.int32(w)},
                                 [jnp.asarray(x)], {"delayTime": _Signal(jnp.asarray(dt))}, rc)
    # the port's ring of the same history, its slot cursor away from w
    st = delay_state_from_jax({"ring": ring, "wpos": w}, T, "cpu", slot=3 * w + 1)
    out = delay_step_plain(torch.from_numpy(x), torch.from_numpy(dt), st, SR, L)
    view = delay_jax_view(st, L)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(view["ring"].numpy(), np.asarray(jst["ring"]))
    assert view["wpos"].dtype == torch.int32 and int(view["wpos"]) == int(jst["wpos"])
    if delays == "L":  # outputs before sample L read the old ring, not this step's write
        n = min(T, L)
        np.testing.assert_array_equal(out.numpy()[:, :n], ring[:, (w + np.arange(n) - L) % L])


@pytest.mark.parametrize("C", [1, 2], ids=["mono law", "stereo law"])
def test_plain_k13_against_jax_node(C):
    rng = np.random.default_rng(13 + C)
    V, T = 3, 1024
    x = (rng.standard_normal((V, C, T)) * 0.8).astype(np.float32)
    pan = np.concatenate([np.array([[-1.0, 0.0, 1.0, -1.5, 1.5] * 4] * V, np.float32),
                          rng.uniform(-1.0, 1.0, (V, T - 20)).astype(np.float32)], axis=1)
    jnode = JaxPanner(ga.OfflineAudioContext(sample_rate=SR, superblock=1))
    rc = types.SimpleNamespace(sample_rate=SR, frames=T)
    run = jax.jit(jax.vmap(lambda xv, pv: jnode.process({}, [xv], {"pan": _Signal(pv)}, rc)[1][0]))
    want = np.asarray(run(x, pan))
    got = stereo_pan_plain(torch.from_numpy(x), torch.from_numpy(pan)).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)
    # most samples agree bit for bit; the rest are XLA's trig ulps
    assert np.mean(got == want) > 0.95
    if C == 2:
        # XLA contracts in_l + in_r * gl and in_r + in_l * gr into fmas: the
        # separately rounded products agree with it on fewer samples
        p = np.clip(pan, -1.0, 1.0)
        left = p <= 0.0
        a = (np.where(left, p + np.float32(1.0), p) * np.float32(np.pi / 2)).astype(np.float32)
        gl = np.cos(a.astype(np.float64)).astype(np.float32)
        gr = np.sin(a.astype(np.float64)).astype(np.float32)
        l, r = x[:, 0], x[:, 1]
        unfused = np.stack([np.where(left, l + r * gl, l * gl),
                            np.where(left, r * gr, r + l * gr)], axis=1)
        assert np.mean(unfused == want) < np.mean(got == want) - 0.02
    # a pan without events: the broadcast view of one value a lane
    base = torch.from_numpy(pan[:, 7].copy())
    np.testing.assert_array_equal(
        stereo_pan_plain(torch.from_numpy(x), base[:, None].expand(V, T)).numpy(),
        stereo_pan_plain(torch.from_numpy(x), base[:, None].repeat(1, T)).numpy())


# ---- paths -------------------------------------------------------------------------


@pytest.mark.parametrize("builder, kw", [
    ("config4_pingpong", dict(superblock=16, voices=4)),
    ("config5_steplinear", dict(superblock=8, voices=8)),
])
def test_item10_paths_against_jax(builder, kw):
    """8 superblocks against the JAX render: the ping-pong's right delay
    (12000 samples) reads its ring from frame 12000 of 16384."""
    build = getattr(tconfigs, builder)
    T = kw["superblock"] * 128
    jctx = build(api=ga, **kw)
    want = np.asarray(jctx.render(8 * T))
    ctx = build(device="cpu", **kw)
    got = ctx.render(8 * T)
    # both packages fuse the same chains (the Kit's gain chains: D = 2)
    assert ctx._compiled.pipe_delay == jctx._compiled.pipe_delay
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    kinds = [key[0] for kind, nodes, key in ctx._compiled.stages if kind == "group"]
    assert "stereo-pan" in kinds
    if builder == "config4_pingpong":
        delays = [n for kind, ns, _ in ctx._compiled.stages for n in ns
                  if isinstance(n, gat.DelayNode)]
        assert len(delays) == 2 and all(int(ctx._states[ctx._compiled.state_ref[n.node_id][0]]
                                            ["wpos"]) == (8 * T) % 48000 for n in delays)


def test_kit_step_linear_sound_against_jax():
    """A step-linear sound to the left of and behind the listener: the Kit's
    pan, gain and pitch (below 1: the resampler) after ``update``."""

    def build(pkg, kit, ctx):
        engine = kit.AudioEngine(ctx)
        sig = np.sin(np.arange(48000) * 0.05).astype(np.float32) * 0.5
        sound = engine.create_sound_from_buffer(
            pkg.PlayableAudioBuffer.from_mono_array(sig, SR),
            mix_state=kit.SoundMixState.STEP_LINEAR_SPATIALIZED)
        sound.position = (-2.0, 0.0, -1.0)
        sound.play()
        engine.update()
        return ctx, sound

    jctx, jsound = build(ga, jkit, ga.OfflineAudioContext(sample_rate=SR, superblock=2))
    tctx, tsound = build(gat, tkit, _ctx(2))
    assert tsound._stereo_panner.pan.value == jsound._stereo_panner.pan.value < 0
    want = np.asarray(jctx.render(2048))
    got = tctx.render(2048)
    assert np.abs(want[0]).max() > np.abs(want[1]).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_delay_mid_render_handoff_from_jax(rng):
    """The delay's ring and cursor come across from a JAX render."""
    buf = (rng.standard_normal(8192) * 0.5).astype(np.float32)

    def build(pkg, ctx):
        src = pkg.AudioBufferSourceNode(ctx)
        src.buffer = pkg.PlayableAudioBuffer.from_mono_array(buf, SR)
        src.loop = True
        d = pkg.DelayNode(ctx, max_delay_time=0.02)  # L = 960
        d.delay_time.value = 0.015
        src.connect(d).connect(ctx.destination)
        src.start(0)
        return ctx

    jctx = build(ga, ga.OfflineAudioContext(sample_rate=SR, superblock=2))
    jctx.render(3 * 256)
    tctx = build(gat, _ctx(2))
    from_jax.load_render_state(tctx, jax.device_get(jctx._states), jax.device_get(jctx._consts),
                               jctx._current_frame, jctx._current_time)
    rings = [st for st in tctx._states.values() if "wpos" in st]
    assert len(rings) == 1 and rings[0]["wpos"].dtype == torch.int32 and int(rings[0]["wpos"]) > 0
    want = np.asarray(jctx.render(1024))
    np.testing.assert_array_equal(tctx.render(1024), want)


@pytest.mark.parametrize("build", [
    lambda: tconfigs.config3_wah(), lambda: tconfigs.config5_orbit(voices=2),
    lambda: tconfigs.config5_steplinear(voices=2), lambda: tconfigs.config4_pingpong(voices=2),
    lambda: groups.poly_group(4), lambda: groups.unity_group(4, True),
    lambda: groups.resample_group(4),
], ids=["config3_wah", "config5_orbit", "config5_steplinear", "config4_pingpong",
        "poly_group", "unity_group", "resample_group"])
def test_builders_default_to_the_card(build):
    """The path builders and the edge-case groups render on the card unless
    the CPU is asked for: without CUDA they raise, never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the builders would render on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
