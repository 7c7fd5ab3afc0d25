"""Chain fusion in the port (core/graph.py ``_fuse_chains``), on the CPU.

Twins of tests/test_pipeline.py: a head-to-tail run of same-key one-lane
group stages renders as one pipelined "pipe" stage whose lane i processes
the superblock of i steps ago, and the port's fused render equals its
unfused render bit for bit, per render call, across calls of 20000, 13000
and 700 frames, through ``process_block``, after param, type and topology
edits, and for a mixed-type biquad chain (K8 takes the type per row on both
paths, so the JAX package's 2e-5 allowance for its dynamic kernel has no
cause here). The fused renders are also held against the JAX package's
fused renders within 1e-5 (2e-5 where the JAX test allows that between
its own fused and unfused renders).

Besides: for every config builder of ``graphaudio_tpu_torch.testing.configs``
at a small size, the port's plan kinds, levels and ``pipe_delay`` equal
the JAX package's; config 3 fused at superblock 32 over 2 + D steps is
within 1e-5 of the fused JAX render; a mid-render hand-off from a fused JAX
render (``utils.from_jax`` carries the register bank and the clock ring)
continues within 1e-5; and the plain K6 evaluates each table row at its own
clock: bit for bit the per-row evaluation at that clock, and within
2.5e-7 relative of ``eval_intrinsic`` there (exact rows bit for bit).

Twinned elsewhere: the checkpoint round trip (tests/test_pipeline.py:111)
in tests/test_torch_utils.py, the realtime context (:191) in
tests/test_torch_realtime.py, the meshes (:272, :292) in
tests/test_torch_parallel.py.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.ops import param_eval as tpe
from graphaudio_tpu_torch.testing import configs as tconfigs
from graphaudio_tpu_torch.testing import tables as ttab
from graphaudio_tpu_torch.utils import from_jax

import benchmarks.configs as bc

SR = 48000
TOL = 1e-5


def _ctx(mod, pipeline, superblock):
    kw = {} if mod is ga else {"device": "cpu"}
    return mod.OfflineAudioContext(sample_rate=SR, superblock=superblock,
                                   pipeline_chains=pipeline, **kw)


def _chain_ctx(mod, pipeline, n_filters=4, superblock=4, gains=False):
    """tests/test_pipeline.py's ``_chain_ctx`` in either package."""
    ctx = _ctx(mod, pipeline, superblock)
    rng = np.random.default_rng(7)
    src = mod.AudioBufferSourceNode(ctx)
    l = (rng.standard_normal(SR) * 0.3).astype(np.float32)
    r = (rng.standard_normal(SR) * 0.3).astype(np.float32)
    src.buffer = mod.PlayableAudioBuffer.from_stereo_arrays(l, r, SR)
    src.loop = True
    node = src
    for i in range(n_filters):
        if gains:
            g = mod.GainNode(ctx)
            g.gain.value = 0.9
            g.gain.linear_ramp_to_value_at_time(0.5 + 0.1 * i, 0.4)
            node = node.connect(g)
        else:
            bq = mod.BiQuadFilterNode(ctx)
            bq.frequency.value = 400.0 * (i + 1)
            bq.frequency.linear_ramp_to_value_at_time(600.0 * (i + 1), 0.5)
            node = node.connect(bq)
    node.connect(ctx.destination)
    src.start(0)
    return ctx


def _filters(ctx, mod):
    return [n for n in ctx._nodes.values() if isinstance(n, mod.BiQuadFilterNode)]


def _plan(ctx):
    ctx._ensure_compiled()
    c = ctx._compiled
    return c.pipe_delay, [(sp["kind"], sp["level"], sp["n_lanes"]) for sp in c.plan]


def test_biquad_chain_fuses_and_matches_exactly():
    a, b, j = _chain_ctx(gat, False), _chain_ctx(gat, True), _chain_ctx(ga, True)
    delay, kinds = _plan(b)
    assert delay == 3
    assert [k for k, _, _ in kinds] == ["group", "pipe", "dest"]  # source, pipe, out
    assert _plan(a)[0] == 0
    for frames in (20000, 13000, 700):
        oa, ob = a.render(frames), b.render(frames)
        np.testing.assert_array_equal(oa, ob)
        assert np.abs(ob - j.render(frames)).max() < TOL
    assert np.abs(ob).max() > 1e-2


def test_gain_chain_fuses_and_matches_exactly():
    a, b = _chain_ctx(gat, False, gains=True), _chain_ctx(gat, True, gains=True)
    assert _plan(b)[0] == 3
    ob = b.render(20000)
    np.testing.assert_array_equal(a.render(20000), ob)
    assert np.abs(ob - _chain_ctx(ga, True, gains=True).render(20000)).max() < TOL


def _osc_chain(mod, side_tap):
    ctx = _ctx(mod, True, 4)
    osc = mod.OscillatorNode(ctx)
    osc.frequency.value = 220.0
    b1, b2 = mod.BiQuadFilterNode(ctx), mod.BiQuadFilterNode(ctx)
    osc.connect(b1).connect(b2).connect(ctx.destination)
    if side_tap:
        g = mod.GainNode(ctx)
        g.gain.value = 0.2
        b1.connect(g).connect(ctx.destination)  # a side tap off the middle
    else:
        osc.connect(ctx.destination)  # a direct tap at level 0
    osc.start(0)
    return ctx


@pytest.mark.parametrize("side_tap", [False, True], ids=["mixed-level fan-in", "side tap"])
def test_unfusable_chain_refuses_fusion(side_tap):
    """A consumer mixing a direct source tap with a chained path, or a chain
    member with a second consumer: fusion is refused, as in the JAX
    package, and the render equals the JAX render."""
    ctx, jctx = _osc_chain(gat, side_tap), _osc_chain(ga, side_tap)
    assert _plan(ctx)[0] == 0 and _plan(jctx)[0] == 0
    assert all(sp["kind"] != "pipe" for sp in ctx._compiled.plan)
    out = ctx.render(8000)
    assert np.isfinite(out).all() and float(np.abs(out).max()) > 0
    assert np.abs(out - jctx.render(8000)).max() < TOL


def test_pipeline_respects_block_api():
    """process_block renders one quantum a call at D extra steps a call."""
    a, b = _chain_ctx(gat, False, superblock=2), _chain_ctx(gat, True, superblock=2)
    j = _chain_ctx(ga, True, superblock=2)
    for _ in range(5):
        ob = b.process_block()
        np.testing.assert_array_equal(a.process_block(), ob)
        assert np.abs(ob - j.process_block()).max() < TOL
    # superblock 2: every other quantum comes from the host carry
    assert b.stats.steps_rendered == 3 and b.stats.render_calls == 3
    assert b.stats.last_breakdown["rows"] == 1 + 3  # one step, three drain rows


def test_pipeline_topology_edit_keeps_exactness():
    """Retune a chain member between calls: the same edit on both graphs,
    the same audio."""
    a, b = _chain_ctx(gat, False), _chain_ctx(gat, True)
    np.testing.assert_array_equal(a.render(8000), b.render(8000))
    for ctx in (a, b):
        _filters(ctx, gat)[0].frequency.value = 1234.0
    np.testing.assert_array_equal(a.render(8000), b.render(8000))


def test_pipeline_rebuild_restarts_registers_silent():
    """A topology edit rebuilds the graph: the new pipe's register bank
    starts silent, the lanes keep their filter states, and the fused render
    still equals the unfused one (nothing a call delivers reads a register
    written before it)."""
    a, b = _chain_ctx(gat, False), _chain_ctx(gat, True)
    np.testing.assert_array_equal(a.render(9000), b.render(9000))
    key = b._compiled.plan[1]["key"]
    assert np.abs(b._states[key + ".pipe"]["reg"].numpy()).max() > 0
    w1 = b._states[key]["w1"].clone()
    for ctx in (a, b):
        g = gat.GainNode(ctx)
        g.gain.value = 0.5
        _filters(ctx, gat)[-1].connect(g).connect(ctx.destination)
    oa, ob = a.render(5000), b.render(5000)
    np.testing.assert_array_equal(oa, ob)
    assert b.stats.graph_builds == 2 and b._compiled.pipe_delay == 3
    assert b._compiled.plan[1]["key"] == key
    # the lanes migrated with their state (w1 moved on from the kept value)
    assert not torch.equal(b._states[key]["w1"], w1)


def test_pipeline_non_head_param_edit_between_calls_exact():
    """Editing a non-head chain member's params between calls behaves as
    the unfused graph: the drained lanes committed under the old params."""
    a, b = _chain_ctx(gat, False), _chain_ctx(gat, True)
    np.testing.assert_array_equal(a.render(9000), b.render(9000))
    for ctx in (a, b):
        filters = _filters(ctx, gat)
        filters[-1].frequency.set_value_at_time(777.0, 0.0)
        filters[2].q.linear_ramp_to_value_at_time(3.0, 0.4)
    np.testing.assert_array_equal(a.render(9000), b.render(9000))
    for ctx in (a, b):
        _filters(ctx, gat)[1].frequency.set_value_at_time(350.0, 0.0)
    np.testing.assert_array_equal(a.render(700), b.render(700))
    np.testing.assert_array_equal(a.render(5000), b.render(5000))


def test_pipeline_value_setter_edit_between_calls_exact():
    """``param.value = x`` clears the event list; in the JAX package the
    unfused filter then takes another kernel and the two renders agree to
    1e-6. In the port the filter stays on the time-varying path (its key
    remembers past events) in both, so they agree bit for bit."""
    a, b = _chain_ctx(gat, False), _chain_ctx(gat, True)
    np.testing.assert_array_equal(a.render(9000), b.render(9000))
    for ctx in (a, b):
        _filters(ctx, gat)[-1].frequency.value = 777.0
    np.testing.assert_array_equal(a.render(9000), b.render(9000))


@pytest.mark.parametrize("sched", ["1", "2,5", "64"])
@pytest.mark.parametrize("method", ["render", "render_pcm16", "render_mulaw", "render_adpcm"])
def test_launches_and_packing_match_unfused(method, sched):
    """A call's refill rows go with its first launch (a launch of one step,
    under the delay, delivers nothing) and its drain rows with the last;
    the wire formats pack only delivered frames, and frames over-rendered
    past a call carry as before: every format bit for bit the unfused
    render, over calls that end inside a superblock."""
    outs = {}
    for fused in (False, True):
        ctx = _chain_ctx(gat, fused)
        ctx.chunk_schedule = sched
        got = [getattr(ctx, method)(n) for n in (3000, 4100, 700, 2048)]
        outs[fused] = [g.blocks if method == "render_adpcm" else g for g in got]
        assert ctx._compiled.pipe_delay == (3 if fused else 0)
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


def test_timed_command_splits_a_fused_call():
    """A command posted for a block time inside a call splits it into two
    segments, each with its own refill and drain rows; the edit it makes
    lands on the same superblock as in the unfused graph."""
    outs = []
    for fused in (False, True):
        ctx = _chain_ctx(gat, fused)
        flt = _filters(ctx, gat)[2]
        ctx.post_at(0.05, lambda c, f=flt: setattr(f.frequency, "value", 2500.0))
        outs.append(ctx.render(6000))
        assert ctx.stats.render_calls == 2
    np.testing.assert_array_equal(*outs)


def _mixed_types(mod, pipeline):
    ctx = _ctx(mod, pipeline, 4)
    rng = np.random.default_rng(11)
    src = mod.AudioBufferSourceNode(ctx)
    sig = (rng.standard_normal(SR) * 0.3).astype(np.float32)
    src.buffer = mod.PlayableAudioBuffer.from_stereo_arrays(sig, sig[::-1].copy(), SR)
    src.loop = True
    node = src
    for i, t in enumerate([mod.FilterType.LOWPASS, mod.FilterType.PEAKING,
                           mod.FilterType.PEAKING, mod.FilterType.HIGHPASS]):
        f = mod.BiQuadFilterNode(ctx, type=t)
        f.frequency.value = 400.0 * (i + 1)
        f.frequency.linear_ramp_to_value_at_time(600.0 * (i + 1), 0.5)
        node = node.connect(f)
    node.connect(ctx.destination)
    src.start(0)
    return ctx


def test_mixed_type_biquad_chain_fuses_fully():
    """lowpass -> peaking -> peaking -> highpass is one pipe whose K8 rows
    carry each lane's type; fused equals unfused bit for bit."""
    a, b, j = _mixed_types(gat, False), _mixed_types(gat, True), _mixed_types(ga, True)
    assert _plan(b)[0] == 3 and _plan(j)[0] == 3
    assert len(set(b._compiled.plan[1]["lane_keys"])) == 3
    for frames in (20000, 700):
        ob = b.render(frames)
        np.testing.assert_array_equal(a.render(frames), ob)
        assert np.abs(ob - j.render(frames)).max() < 2e-5
    rows = b._encs[gat.core.graph.PROLOGUE]["0"]["table"]["rows"]
    assert rows[:, 0].tolist() == [0, 5, 5, 1]  # one K8 stage, a type a row


def _lowpass_pair(pipeline):
    ctx = _ctx(gat, pipeline, 4)
    osc = gat.OscillatorNode(ctx)
    osc.frequency.value = 440.0
    f1 = gat.BiQuadFilterNode(ctx, type=gat.FilterType.LOWPASS)
    f2 = gat.BiQuadFilterNode(ctx, type=gat.FilterType.LOWPASS)
    for f in (f1, f2):
        f.frequency.value = 300.0  # well below 440: strong attenuation
    osc.connect(f1).connect(f2).connect(ctx.destination)
    osc.start(0)
    return ctx, f2


def test_biquad_type_edit_resets_selector_in_fused_chain():
    """A type edit on a fused lane rebuilds the graph and re-derives the
    lane's type (its K8 row and its ``__type_sel__`` state)."""
    ctx, f2 = _lowpass_pair(True)
    ref, g2 = _lowpass_pair(False)
    low = ctx.render(8000)
    np.testing.assert_array_equal(low, ref.render(8000))
    f2.type = gat.FilterType.HIGHPASS
    g2.type = gat.FilterType.HIGHPASS
    high = ctx.render(8000)
    np.testing.assert_array_equal(high, ref.render(8000))
    assert np.abs(high - low).max() > 0.05
    key = ctx._compiled.plan[1]["key"]
    sel = ctx._states[key]["__type_sel__"].numpy()
    assert sel.argmax(1).tolist() == [0, 1]  # lowpass, highpass
    assert ctx._compiled.plan[1]["kind"] == "pipe"


def _builders():
    for name in sorted(n for n in dir(tconfigs) if n.startswith("config")):
        params = inspect.signature(getattr(tconfigs, name)).parameters
        if "api" in params or hasattr(bc, name):
            yield name


@pytest.mark.parametrize("name", list(_builders()))
def test_plan_kinds_match_jax(name, tmp_path):
    """Every config builder at a small size: the same stages, kinds, levels,
    lane counts and pipe delay as the JAX package's graph (a builder that
    streams media writes its files into a temporary directory)."""
    fn = getattr(tconfigs, name)
    params = inspect.signature(fn).parameters
    kw = {"superblock": 4, **({"voices": 4} if "voices" in params else {})}
    if "root" in params:
        kw["root"] = str(tmp_path)
    if "api" in params:
        jctx = fn(api=ga, **kw)
    else:
        jctx = getattr(bc, name)(**kw)
    tctx = fn(device="cpu", **kw)
    assert _plan(tctx) == _plan(jctx)
    assert [sp["lane_keys"] is not None for sp in tctx._compiled.plan] == \
        [sp["kind"] == "pipe" for sp in jctx._compiled.plan]


def test_config3_fused_side_by_side_with_jax():
    """Config 3 at its full superblock, 2 + D steps, both fused."""
    S = 32
    T = S * 128
    jctx = bc.config3_eq_chain(superblock=S)
    tctx = tconfigs.config3_eq_chain(superblock=S, device="cpu")
    assert _plan(tctx) == _plan(jctx) and tctx._compiled.pipe_delay == 3
    n = (2 + 3) * T
    want = jctx.render(n)
    got = np.concatenate([tctx.render(3000), tctx.render(n - 3000)], axis=1)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() < TOL


def test_mid_render_handoff_from_fused_jax():
    """Config 3 rendered fused in the JAX package for two calls, then handed
    over: the register bank, the lanes' filter states and the clock ring
    come across and both packages continue alike."""
    S = 4
    T = S * 128
    jctx = bc.config3_eq_chain(superblock=S)
    jctx.render(3 * T)
    jctx.render(T + 200)
    tctx = tconfigs.config3_eq_chain(superblock=S, device="cpu")
    jstates = jax.device_get(jctx._states)
    from_jax.load_render_state(tctx, jstates, jax.device_get(jctx._consts),
                               jctx._current_frame, jctx._current_time)
    key = tctx._compiled.plan[1]["key"]
    np.testing.assert_array_equal(tctx._states[key + ".pipe"]["reg"].numpy(),
                                  jstates[key + ".pipe"]["reg"])
    np.testing.assert_array_equal(tctx._states["__pipe_bt__"].numpy(), jstates["__pipe_bt__"])
    assert np.abs(tctx._states[key]["w1"].numpy()).max() > 0
    # the JAX context carries 312 rendered frames on its host: skip them
    jctx.render(T - 200)
    want = jctx.render(5 * T)
    got = tctx.render(5 * T)
    assert tctx.current_time == jctx.current_time
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() < TOL


# ---- K6: a clock a row ------------------------------------------------------------


def _clocked_table():
    """The mixed K6 table (every curve type, a-rate and k-rate) plus exact
    rows of linear ramps, each entry at another clock (one a lane where an
    entry has lanes), of a [4, S] clock matrix."""
    S = 4
    entries = ttab.mixed_param_entries(3, t_end=12 * S * ttab.BLOCK)
    lin = ttab.linear_param_entries(4, t_end=12 * S * ttab.BLOCK)
    rows = []
    for k, (key, enc, npb) in enumerate(entries):
        lanes = int(np.prod(np.shape(enc["base"]), dtype=np.int64))
        rows.append((key, enc, npb, False, (k + np.arange(lanes)) % 4))
    for k, (key, enc, npb) in enumerate(lin):
        rows.append((key, enc, npb, True, (3 - k) % 4))
    return tpe.pack_param_table(rows, S), rows, S


def _tensors(table):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in table.items()}


@pytest.mark.parametrize("step", [0, 6])
def test_k6_rows_at_their_own_clocks(step):
    table, rows, S = _clocked_table()
    assert table["rows"].shape[1] == tpe.ROW_WORDS == 4
    clock = ttab.block_clock(12 * S)
    clocks = torch.from_numpy(np.stack([clock[(step + c) * S:(step + c + 1) * S]
                                        for c in range(4)]))
    arena = tpe.eval_intrinsic_batch(_tensors(table), clocks, ttab.DT).numpy()
    # the same table at clock 0 everywhere reads clock row 0 alone
    flat = tpe.pack_param_table([r[:4] for r in rows], S)
    at0 = tpe.eval_intrinsic_batch(_tensors(flat), clocks[0], ttab.DT).numpy()
    n_exact = 0
    for key, enc, npb, exact, clk in rows:
        slot = table["slots"][key]
        lanes = slot.lanes
        got = arena[slot.off:slot.off + lanes * slot.per_lane].reshape(lanes, -1)
        flat_enc = {k: torch.from_numpy(np.asarray(v).reshape(lanes, *np.shape(v)[
            len(slot.shape):])) for k, v in enc.items()}
        for v, c in enumerate(np.broadcast_to(clk, (lanes,))):
            lane = {k: x[v:v + 1] for k, x in flat_enc.items()}
            bt = clocks[int(c)]
            want = tpe.eval_intrinsic_blocked_plain(lane, bt, npb, ttab.DT, exact=exact)
            np.testing.assert_array_equal(got[v], want[0].numpy())
            t = (bt[:, None] + torch.arange(npb, dtype=torch.float64) * ttab.DT).reshape(-1)
            ref = tpe.eval_intrinsic(lane, t)[0].numpy().astype(np.float64)
            if exact:  # the curve in f64, rounded once (here set values and ramps)
                n_exact += 1
                np.testing.assert_array_equal(got[v], ref.astype(np.float32))
            else:
                err = np.abs(got[v] - ref) / np.maximum(np.abs(ref), 1.0)
                assert err.max() < 2.5e-7
        if np.all(clk == 0):
            np.testing.assert_array_equal(got, at0[slot.off:slot.off + got.size].reshape(got.shape))
    assert n_exact == 1 + 4 + 4  # exact lanes (groups of three and a phantom copy)


def test_k6_clock_zero_is_the_parent_table():
    """Without pipes every clock is 0: the table's rows and arena are the
    one-clock table's, and a [1, S] clock matrix reads as f64[S]."""
    S = 4
    entries = ttab.mixed_param_entries(5, t_end=12 * S * ttab.BLOCK)
    table = tpe.pack_param_table(entries, S)
    assert (table["rows"][:, 3] == 0).all()
    bt = torch.from_numpy(ttab.block_clock(4 * S)[2 * S:3 * S])
    a = tpe.eval_intrinsic_batch(_tensors(table), bt, ttab.DT)
    b = tpe.eval_intrinsic_batch(_tensors(table), bt[None], ttab.DT)
    assert torch.equal(a, b)
