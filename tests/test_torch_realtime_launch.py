"""The launch's per-call checks (core/context.py), on the CPU.

A launch reads the context's two edit counts once
(``_param_edits``: every param mutation; ``_state_edits``: every
``update_node_state``) instead of walking every param's version and every
buffer source's kernel variant. These tests hold the counted checks to the
walks they replaced, step for step: a subclass that still walks
(``_Walk``) runs the same script of edits beside the port's context, and
both must re-encode at the same launches, rebuild at the same launches and
render the same audio bit for bit, in an offline and in a realtime
context. Besides: a launch after no edit reads no param and no variant,
the heap leaves the cyclic collector while a realtime context plays, and
``to_device`` keeps values and dtypes and never aliases its input. Of
the step's CUDA graph (core/stepgraph.py), what runs without a card: the
state's copy-back pairs and the convolver's ring head held as a tensor
(the card tests hold the graph itself to the kernel-by-kernel step).
"""

import numpy as np
import pytest
import torch

import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.core.graph import CompiledGraph, to_device
from graphaudio_tpu_torch.core.stepgraph import NotStatic, copy_back_pairs, hold_scalars_on_card
from graphaudio_tpu_torch.realtime import RealtimeAudioContext

SR = 48000


class _Walk:
    """The launch's checks as they were: every param's version compared
    with the last encoding's, every variant re-read, at every launch."""

    def _ensure_static_config(self):
        if self._compiled.static_config_stale():
            self._invalidate_topology()
            self._ensure_compiled()

    def _ensure_params_encoded(self):
        versions = {(n.node_id, k): p.version for n in self._compiled.topo
                    for k, p in n.params.items()}
        if self._encs is None or versions != getattr(self, "_walked", None):
            self._encs = to_device(self._compiled.encode_params(), self.device)
            self._walked = versions


class _WalkOffline(_Walk, gat.OfflineAudioContext):
    pass


class _WalkRealtime(_Walk, RealtimeAudioContext):
    pass


def _offline(walk):
    cls = _WalkOffline if walk else gat.OfflineAudioContext
    return cls(sample_rate=SR, superblock=2, pipeline_chains=False, device="cpu")


def _realtime(walk):
    cls = _WalkRealtime if walk else RealtimeAudioContext
    return cls(sample_rate=SR, superblock=2, device="cpu", auto_start_thread=False,
               output_device="null")


def _scene(ctx):
    """Two looped sources (48 kHz: the unity variant until a playbackRate
    is touched) into two gains in series; the second source starts later."""
    rng = np.random.default_rng(3)
    g = gat.GainNode(ctx)
    g.gain.value = 0.7
    g2 = gat.GainNode(ctx)
    g2.gain.value = 0.9
    g.connect(g2).connect(ctx.destination)
    srcs = []
    for v in range(2):
        src = gat.AudioBufferSourceNode(ctx)
        src.buffer = gat.PlayableAudioBuffer.from_mono_array(
            (rng.standard_normal(4096) * 0.3).astype(np.float32), SR)
        src.loop = True
        src.connect(g)
        srcs.append(src)
    srcs[0].start(0)
    return g, g2, srcs


def _script(ctx):
    """Render a step after each edit of a fixed script; per launch, whether
    it encoded and whether it rebuilt the graph, and the audio."""
    g, g2, srcs = _scene(ctx)
    edits = [
        lambda: None,
        lambda: None,                                     # nothing edited
        lambda: setattr(g.gain, "value", 0.3),            # a param value
        lambda: None,
        lambda: srcs[1].start(ctx.current_time + 0.001),  # a node state only
        lambda: g.gain.linear_ramp_to_value_at_time(0.9, ctx.current_time + 0.01),
        lambda: None,
        lambda: setattr(srcs[0].playback_rate, "value", 0.5),  # variant: unity -> poly
        lambda: None,
        lambda: setattr(srcs[0].playback_rate, "value", 0.75),  # another poly ratio
        lambda: g2.gain.set_value_at_time(0.4, ctx.current_time),
        lambda: None,
    ]
    log, audio = [], []
    for edit in edits:
        edit()
        encs, builds = ctx._encs, ctx.stats.graph_builds
        audio.append(ctx._render_steps(1))
        log.append((ctx._encs is not encs, ctx.stats.graph_builds - builds))
    return log, np.concatenate(audio, axis=1)


@pytest.mark.parametrize("make", [_offline, _realtime], ids=["offline", "realtime"])
def test_counted_checks_encode_and_rebuild_where_the_walk_does(make):
    """Re-encoding after an edit happens at the same launch as with the
    walk, and only there; a kernel-variant change rebuilds at the same
    launch; the audio is bit for bit the same."""
    counted, walked = make(False), make(True)
    try:
        log, out = _script(counted)
        want_log, want = _script(walked)
    finally:
        counted.dispose()
        walked.dispose()
    assert log == want_log
    np.testing.assert_array_equal(out, want)
    encoded = [e for e, _ in log]
    # the first launch builds and encodes; a param edit encodes; a state
    # edit, or none, does not
    assert encoded[1] is False and encoded[2] is True and encoded[3] is False
    assert encoded[4] is False and encoded[5] is True
    assert log[9][1] == 1, "a new playbackRate ratio must rebuild the poly variant"
    assert np.abs(out).max() > 0


def test_a_launch_after_no_edit_reads_no_param_and_no_variant(monkeypatch):
    ctx = _offline(False)
    g, _, _ = _scene(ctx)
    ctx._render_steps(1)
    reads = {"stale": 0, "encode": 0}
    stale0, encode0 = CompiledGraph.static_config_stale, CompiledGraph.encode_params

    def stale(self):
        reads["stale"] += 1
        return stale0(self)

    def encode(self):
        reads["encode"] += 1
        return encode0(self)

    monkeypatch.setattr(CompiledGraph, "static_config_stale", stale)
    monkeypatch.setattr(CompiledGraph, "encode_params", encode)
    for _ in range(5):
        ctx._render_steps(1)
    assert reads == {"stale": 0, "encode": 0}
    g.gain.value = 0.25
    ctx._render_steps(1)
    ctx._render_steps(1)
    assert reads == {"stale": 1, "encode": 1}


def test_the_heap_leaves_the_collector_while_a_context_plays():
    """While a realtime context plays, the objects that existed at its start
    are frozen out of the cyclic collector, so a full collection walks only
    what playback made; the last context to stop (or be disposed) gives
    them back."""
    import gc

    a, b = _realtime(False), _realtime(False)
    try:
        a.start()
        assert gc.get_freeze_count() > 0
        b.start()
        a.stop()
        assert gc.get_freeze_count() > 0, "b still plays"
        a.stop()  # a second stop releases nothing
        assert gc.get_freeze_count() > 0
        b.dispose()
        assert gc.get_freeze_count() == 0
        a.start()
        assert gc.get_freeze_count() > 0
    finally:
        a.dispose()
        b.dispose()
    assert gc.get_freeze_count() == 0


def test_to_device_keeps_values_and_dtypes():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": {"c": np.float64(2.5), "d": 7,
            "e": np.zeros((0, 4), np.int32), "f": np.array([True, False]),
            "g": np.array([1, -2], np.int64)}}
    out = to_device(tree, "cpu")
    assert out["b"]["d"] == 7
    for got, want in ((out["a"], tree["a"]), (out["b"]["c"], tree["b"]["c"]),
                      (out["b"]["e"], tree["b"]["e"]), (out["b"]["f"], tree["b"]["f"]),
                      (out["b"]["g"], tree["b"]["g"])):
        assert isinstance(got, torch.Tensor)
        assert got.numpy().dtype == np.asarray(want).dtype
        assert got.shape == np.asarray(want).shape
        np.testing.assert_array_equal(got.numpy(), want)
    out["a"][0, 0] = 99.0
    assert tree["a"][0, 0] == 0.0


# -- the step as a CUDA graph (core/stepgraph.py): what runs without a card --


def test_copy_back_pairs():
    """One pair a replaced leaf, none a kept one; a host value or a key that
    changes, or a leaf that changes shape, refuses."""
    a, b, c = torch.zeros(3), torch.ones(3), torch.zeros(2)
    old = {"s": {"x": a, "y": b, "n": 4}, "g": c}
    new_x = torch.full((3,), 2.0)
    pairs = copy_back_pairs(old, {"s": {"x": new_x, "y": b, "n": 4}, "g": c})
    assert len(pairs) == 1 and pairs[0][0] is a and pairs[0][1] is new_x
    assert copy_back_pairs(old, old) == []
    for bad in ({"s": {"x": a, "y": b, "n": 5}, "g": c},
                {"s": {"x": a, "y": b}, "g": c},
                {"s": {"x": torch.zeros(4), "y": b, "n": 4}, "g": c},
                {"s": {"x": a, "y": b.double(), "n": 4}, "g": c}):
        with pytest.raises(NotStatic):
            copy_back_pairs(old, bad)


def _reverb_scene(ctx):
    """A looped source into a convolver (a 0.2 s decaying IR) and the
    destination: the convolver's ring head advances every step."""
    rng = np.random.default_rng(26)
    src = gat.AudioBufferSourceNode(ctx)
    src.buffer = gat.PlayableAudioBuffer.from_mono_array(
        (rng.standard_normal(4096) * 0.3).astype(np.float32), SR)
    src.loop = True
    ir = (rng.standard_normal(9600) * np.exp(-np.arange(9600) / 2000.0)).astype(np.float32)
    conv = gat.ConvolverNode(ctx)
    conv.buffer = gat.PlayableAudioBuffer.from_mono_array(ir, SR)
    src.connect(conv).connect(ctx.destination)
    src.start(0)
    return conv


def test_heads_held_as_scalars_render_the_same_bits():
    """The convolver's ring head held as an int64 tensor (as a captured
    step holds it on the card) renders the bits of the host int, and stays
    a tensor that the step advances."""
    runs = []
    for hold in (False, True):
        ctx = _offline(False)
        conv = _reverb_scene(ctx)
        audio = [ctx._render_steps(1) for _ in range(3)]
        key = ctx._compiled.state_ref[conv.node_id][0]
        if hold:
            head = ctx._states[key]["head"]
            hold_scalars_on_card(ctx)
            held = ctx._states[key]["head"]
            assert isinstance(held, torch.Tensor) and held.dtype == torch.int64
            assert held.shape == () and int(held) == head
        audio += [ctx._render_steps(1) for _ in range(5)]
        runs.append((np.concatenate(audio, axis=1), ctx._states[key]["head"]))
    (plain, head), (held, held_head) = runs
    assert np.abs(plain).max() > 1e-3
    np.testing.assert_array_equal(held, plain)
    assert isinstance(held_head, torch.Tensor) and int(held_head) == head


def test_only_a_realtime_context_on_the_card_has_a_step_graph():
    assert _offline(False)._step_graph is None
    assert _realtime(False)._step_graph is None  # on the CPU: no CUDA graph


def test_a_held_head_survives_a_rebuild_and_a_checkpoint(tmp_path):
    """A held head is the host int's leaf: a rebuild (a source added) keeps
    the convolver's ring and head as it keeps them held as ints, and a
    checkpoint saved with the head held loads into a fresh context and
    resumes bit for bit."""
    from graphaudio_tpu_torch.utils import load_context_state, save_context_state

    runs = []
    for hold in (False, True):
        ctx = _offline(False)
        _reverb_scene(ctx)
        audio = [ctx._render_steps(1) for _ in range(3)]
        if hold:
            hold_scalars_on_card(ctx)
        extra = gat.OscillatorNode(ctx)
        extra.connect(ctx.destination)
        extra.start(0)
        audio += [ctx._render_steps(1) for _ in range(3)]
        path = tmp_path / f"held{int(hold)}.npz"
        save_context_state(ctx, path)
        audio += [ctx._render_steps(1) for _ in range(3)]
        runs.append((np.concatenate(audio, axis=1), path))
    (plain, plain_path), (held, held_path) = runs
    np.testing.assert_array_equal(held, plain)
    for path in (plain_path, held_path):
        fresh = _offline(False)
        _reverb_scene(fresh)
        extra = gat.OscillatorNode(fresh)
        extra.connect(fresh.destination)
        extra.start(0)
        load_context_state(fresh, path)
        resumed = np.concatenate([fresh._render_steps(1) for _ in range(3)], axis=1)
        np.testing.assert_array_equal(resumed, plain[:, -resumed.shape[1]:])
