"""The port's utils surface (graphaudio_tpu_torch/utils), on the CPU.

Twins of tests/test_utils.py: render statistics, graph inspection and
checkpoint/resume, and of tests/test_pipeline.py:111 (a fused chain's
checkpoint round trip). The port's ``RenderStats`` names its breakdown
afresh (``prep_s``, ``enqueue_s``, ``sync_s``, ``notify_s``;
utils/profiling.py), so the breakdown twin checks those fields. Each
resumed render is bit for bit the port's uninterrupted render of the same
graph, and within 1e-5 of the JAX package's.
"""

import numpy as np
import pytest

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.utils import (
    describe_graph,
    graph_to_dot,
    load_context_state,
    save_context_state,
)

SR = 48000
TOL = 1e-5


def _ctx(mod, **kw):
    if mod is gat:
        kw["device"] = "cpu"
    return mod.OfflineAudioContext(sample_rate=SR, **kw)


def _make_graph(superblock=2, mod=gat):
    ctx = _ctx(mod, superblock=superblock)
    osc = mod.OscillatorNode(ctx)
    osc.frequency.value = 220.0
    flt = mod.BiQuadFilterNode(ctx)
    flt.frequency.value = 800.0
    osc.connect(flt).connect(ctx.destination)
    osc.start(0)
    return ctx


def test_render_stats():
    ctx = _make_graph()
    ctx.render(1024)
    ctx.render(1024)
    s = ctx.stats.summary(SR)
    assert s["render_calls"] == 2
    assert s["frames_rendered"] == 2048
    assert ctx.stats.quanta_rendered == 16
    assert s["graph_builds"] >= 1
    assert s["wall_seconds"] > 0
    assert s["xrt"] > 0


def test_render_stats_wall_breakdown():
    """Every render call records its wall composition (prep / enqueue /
    sync / notify) so wall regressions get a name; the components are the
    whole call's wall, and the aggregated counters integrate them."""
    ctx = _make_graph()
    ctx.render(1024)
    s = ctx.stats
    b = s.last_breakdown
    for key in ("prep_s", "feed_s", "enqueue_s", "sync_s", "notify_s", "n_launches",
                "rows", "wall_s"):
        assert key in b, f"missing breakdown field {key}"
    assert b["n_launches"] >= 1 and b["rows"] == 1024 // 256
    parts = b["prep_s"] + b["enqueue_s"] + b["sync_s"] + b["notify_s"]
    assert parts == pytest.approx(s.wall_seconds)
    assert b["feed_s"] <= b["prep_s"]
    d = s.summary(SR)
    assert d["enqueue_seconds"] > 0 and d["sync_seconds"] >= 0


def test_describe_graph_and_dot():
    ctx = _make_graph()
    text = describe_graph(ctx)
    assert "Oscillator" in text and "BiQuadFilter" in text
    assert "schedule:" in text and "[sink]" in text
    dot = graph_to_dot(ctx)
    assert dot.startswith("digraph") and "->" in dot


def test_describe_graph_names_a_fused_chain():
    ctx = _ctx(gat, superblock=2)
    src = gat.ConstantSourceNode(ctx)
    node = src
    for _ in range(3):
        node = node.connect(gat.BiQuadFilterNode(ctx))
    node.connect(ctx.destination)
    src.start(0)
    assert "[pipe x3] BiQuadFilterNode (fused chain, delay 2" in describe_graph(ctx)


def _buffer_graph(mod, rng):
    ctx = _ctx(mod, superblock=2)
    data = rng.standard_normal(48000).astype(np.float32) * 0.3
    buf = mod.PlayableAudioBuffer.from_mono_array(data, SR)
    src = mod.AudioBufferSourceNode(ctx)
    src.buffer = buf
    src.loop = True
    flt = mod.BiQuadFilterNode(ctx)
    flt.frequency.value = 1200.0
    dly = mod.DelayNode(ctx, max_delay_time=0.05)
    dly.delay_time.value = 0.01
    src.connect(flt).connect(dly).connect(ctx.destination)
    src.start(0)
    return ctx


def test_checkpoint_resume_bit_exact(tmp_path, rng):
    # Render 1/3, checkpoint, render rest; vs uninterrupted render.
    rng_state = rng.bit_generator.state
    full = _buffer_graph(gat, rng).render(6144)

    rng.bit_generator.state = rng_state  # identical buffers
    ctx_b = _buffer_graph(gat, rng)
    first = ctx_b.render(2048)
    ckpt = tmp_path / "state.npz"
    save_context_state(ctx_b, ckpt)

    rng.bit_generator.state = rng_state
    ctx_c = _buffer_graph(gat, rng)
    ctx_c.render(512)  # desync on purpose
    load_context_state(ctx_c, ckpt)
    assert abs(ctx_c.current_time - 2048 / SR) < 1e-9
    rest = ctx_c.render(4096)

    got = np.concatenate([first, rest], axis=1)
    assert np.array_equal(got, full)
    rng.bit_generator.state = rng_state
    ref = _buffer_graph(ga, rng).render(6144)
    assert np.abs(got - ref).max() < TOL


def test_checkpoint_restores_param_events(tmp_path):
    ctx = _make_graph()
    g = gat.GainNode(ctx)
    # splice the gain between filter and destination
    flt = [n for n in ctx.get_all_nodes() if n.name == "BiQuadFilter"][0]
    flt.disconnect(ctx.destination)
    flt.connect(g).connect(ctx.destination)
    g.gain.set_value_at_time(1.0, 0.0)
    g.gain.linear_ramp_to_value_at_time(0.0, 1.0)
    ctx.render(1024)
    path = tmp_path / "s.npz"
    save_context_state(ctx, path)

    # Mutate, then restore.
    g.gain.value = 0.123
    assert g.gain.event_count() == 0
    load_context_state(ctx, path)
    assert g.gain.event_count() == 2
    assert g.gain.value == 1.0


def _filter_chain(mod):
    ctx = _ctx(mod, superblock=4, pipeline_chains=True)
    osc = mod.OscillatorNode(ctx)
    osc.frequency.value = 330.0
    node = osc
    filters = []
    for i in range(3):
        f = mod.BiQuadFilterNode(ctx)
        f.frequency.value = 900.0 * (i + 1)
        filters.append(f)
        node = node.connect(f)
    node.connect(ctx.destination)
    osc.start(0)
    return ctx, filters


def test_checkpoint_variant_change_restores_into_fresh_context(tmp_path):
    """Automation events flip the biquad's variant and chain-fusion
    grouping, so the loader restores the checkpoint's params BEFORE
    building the target context; a fresh context then builds the layout
    the checkpoint was saved with."""
    a, fa = _filter_chain(gat)
    a.render(8000)
    # event on ONE filter: its variant (and the fused chain's grouping)
    # changes relative to the all-static build
    fa[2].frequency.set_value_at_time(200.0, 0.0)
    a.render(8000)
    path = tmp_path / "variant.npz"
    save_context_state(a, path)
    cont = a.render(5000)

    b, _ = _filter_chain(gat)
    b._ensure_compiled()  # built against the WRONG (event-free) layout
    load_context_state(b, path)
    got = b.render(5000)
    np.testing.assert_array_equal(got, cont)
    j, fj = _filter_chain(ga)
    j.render(8000)
    fj[2].frequency.set_value_at_time(200.0, 0.0)
    j.render(8000)
    assert np.abs(got - j.render(5000)).max() < TOL


def test_checkpoint_rejects_mismatched_geometry(tmp_path):
    ctx = _make_graph()
    ctx.render(256)
    ckpt = tmp_path / "state.npz"
    save_context_state(ctx, ckpt)

    # Different superblock -> state shapes differ; must fail loudly.
    ctx2 = _make_graph()
    ctx2.superblock = ctx.superblock * 2
    with pytest.raises(ValueError, match="superblock"):
        load_context_state(ctx2, ckpt)


def test_checkpoint_rejects_different_topology(tmp_path):
    ctx = _make_graph()
    ctx.render(256)
    ckpt = tmp_path / "state.npz"
    save_context_state(ctx, ckpt)

    ctx2 = _ctx(gat, superblock=ctx.superblock)
    g = gat.GainNode(ctx2)
    g.connect(ctx2.destination)
    with pytest.raises(ValueError, match="leaves|layout|topology"):
        load_context_state(ctx2, ckpt)


def test_checkpoint_rejects_foreign_file(tmp_path):
    path = tmp_path / "foreign.npz"
    np.savez(
        path,
        __manifest__=np.frombuffer(b'{"format": "something-else"}', dtype=np.uint8),
    )
    ctx = _make_graph()
    with pytest.raises(ValueError, match="format"):
        load_context_state(ctx, path)


def test_static_fingerprint_not_id_based():
    """Cache-key hygiene: fingerprints use the monotonic node_id, so a dead
    node's fingerprint can never alias a new node's (object ids recycle)."""
    ctx = _make_graph()
    a = gat.GainNode(ctx)
    fp_a = a.static_fingerprint()
    assert fp_a[0] == a.node_id
    a.dispose()
    del a
    b = gat.GainNode(ctx)
    assert b.static_fingerprint()[0] != fp_a[0]


def _chain_ctx(mod, pipeline, n_filters=4, superblock=4):
    """tests/test_pipeline.py's ``_chain_ctx`` (biquads) in either package."""
    ctx = _ctx(mod, superblock=superblock, pipeline_chains=pipeline)
    rng = np.random.default_rng(7)
    src = mod.AudioBufferSourceNode(ctx)
    l = (rng.standard_normal(SR) * 0.3).astype(np.float32)
    r = (rng.standard_normal(SR) * 0.3).astype(np.float32)
    src.buffer = mod.PlayableAudioBuffer.from_stereo_arrays(l, r, SR)
    src.loop = True
    node = src
    for i in range(n_filters):
        bq = mod.BiQuadFilterNode(ctx)
        bq.frequency.value = 400.0 * (i + 1)
        bq.frequency.linear_ramp_to_value_at_time(600.0 * (i + 1), 0.5)
        node = node.connect(bq)
    node.connect(ctx.destination)
    src.start(0)
    return ctx


def test_pipeline_checkpoint_roundtrip(tmp_path):
    """A fused chain's checkpoint leaves out its register bank and clock
    ring (scratch) and still resumes bit for bit."""
    b = _chain_ctx(gat, True)
    b.render(9000)
    path = tmp_path / "pipe.gacp"
    save_context_state(b, path)
    cont = b.render(6000)

    b2 = _chain_ctx(gat, True)
    b2._ensure_compiled()
    load_context_state(b2, path)
    got = b2.render(6000)
    np.testing.assert_array_equal(got, cont)
    j = _chain_ctx(ga, True)
    j.render(9000)
    assert np.abs(got - j.render(6000)).max() < TOL


def test_checkpoint_resumes_config5_scene(tmp_path):
    """Config 5's Kit scene at a few voices (the convolver's host ring head,
    the panners' state, the listener): resumed bit for bit on a fresh
    context."""
    from graphaudio_tpu_torch.testing.configs import config5_spatial_scene

    def build():
        return config5_spatial_scene(superblock=4, voices=3, device="cpu")

    a = build()
    a.render(3 * 512)
    path = tmp_path / "c5.npz"
    save_context_state(a, path)
    cont = a.render(4 * 512 + 100)
    b = build()
    load_context_state(b, path)
    np.testing.assert_array_equal(b.render(4 * 512 + 100), cont)
