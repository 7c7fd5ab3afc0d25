"""Timed command queue (``post_at``) of the port, on the CPU.

Twins of tests/test_commands.py: a timed command lands at the first
not-yet-rendered superblock boundary whose accumulated block time is >= the
requested time, and ``render`` splits the call into device segments at
those boundaries (with ``superblock=1`` that is the reference's per-block
granularity). They pin the landing boundary, ordering, equivalence with
manual split renders (also against the JAX package's render, to the bit:
the audio is a constant times a gain), topology edits and carry rules.
"""

import numpy as np

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat

SR = 48000


def _gain_ctx(superblock=1, gain=1.0, mod=gat):
    kw = {"device": "cpu"} if mod is gat else {}
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **kw)
    src = mod.ConstantSourceNode(ctx)
    src.offset.value = 0.5
    g = mod.GainNode(ctx)
    g.gain.value = gain
    src.connect(g).connect(ctx.destination)
    src.start(0)
    return ctx, g


def test_post_at_matches_manual_split_render():
    """A timed gain edit equals rendering up to the boundary, editing, and
    rendering on — the semantics a user would otherwise hand-roll."""
    blocks = 10  # superblock=1 -> boundary lands at an exact block index
    t_edit = blocks * 128 / SR

    a, ga_ = _gain_ctx()
    a.render(blocks * 128)
    ga_.gain.value = 0.25
    want = np.concatenate(
        [np.full((2, blocks * 128), 0.5, np.float32),
         a.render(6 * 128)], axis=1
    )

    b, gb = _gain_ctx()
    b.post_at(t_edit, lambda ctx: setattr(gb.gain, "value", 0.25))
    got = b.render(16 * 128)
    np.testing.assert_array_equal(got, want)
    j, gj = _gain_ctx(mod=ga)
    j.post_at(t_edit, lambda ctx: setattr(gj.gain, "value", 0.25))
    np.testing.assert_array_equal(j.render(16 * 128), got)


def test_post_at_superblock_granularity():
    """With superblock=4 a command due mid-superblock lands at the NEXT
    superblock boundary (blocks are computed in one device scan)."""
    ctx, g = _gain_ctx(superblock=4)
    t_edit = 2 * 128 / SR  # inside superblock 0 -> lands at block 4
    ctx.post_at(t_edit, lambda c: setattr(g.gain, "value", 0.0))
    out = ctx.render(8 * 128)
    assert np.all(out[:, : 4 * 128] == 0.5)
    assert np.all(out[:, 4 * 128:] == 0.0)


def test_post_at_past_time_runs_at_next_launch():
    ctx, g = _gain_ctx()
    ctx.render(4 * 128)
    ctx.post_at(0.0, lambda c: setattr(g.gain, "value", 0.0))
    out = ctx.render(2 * 128)
    assert np.all(out == 0.0)


def test_post_at_ordering_same_boundary():
    """Commands landing at one boundary run in (time, post-order) order."""
    ctx, g = _gain_ctx()
    t = 3 * 128 / SR
    ctx.post_at(t, lambda c: setattr(g.gain, "value", 0.125))
    ctx.post_at(t, lambda c: setattr(g.gain, "value", 0.75))  # wins
    out = ctx.render(6 * 128)
    assert np.all(out[:, : 3 * 128] == 0.5)
    assert np.allclose(out[:, 3 * 128:], 0.5 * 0.75)


def test_post_at_multiple_boundaries_one_call():
    # Edit times aim half a block EARLY: the accumulated block clock can
    # round an exact boundary time to either side (reference semantics:
    # first block whose accumulated time >= t), and a mid-block time pins
    # the landing block regardless of rounding direction.
    ctx, g = _gain_ctx()
    ctx.post_at((2 * 128 - 64) / SR, lambda c: setattr(g.gain, "value", 0.25))
    ctx.post_at((5 * 128 - 64) / SR, lambda c: setattr(g.gain, "value", 0.0))
    out = ctx.render(7 * 128)
    assert np.all(out[:, : 2 * 128] == 0.5)
    assert np.allclose(out[:, 2 * 128: 5 * 128], 0.5 * 0.25)
    assert np.all(out[:, 5 * 128:] == 0.0)


def test_post_at_topology_edit_recompiles_at_boundary():
    """Wiring a second source in via a timed command takes effect exactly at
    the boundary; the running source's state survives the recompile."""
    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=1, device="cpu")
    src = gat.ConstantSourceNode(ctx)
    src.offset.value = 0.5
    src.connect(ctx.destination)
    src.start(0)

    def add_source(c):
        s2 = gat.ConstantSourceNode(c)
        s2.offset.value = 0.25
        s2.connect(c.destination)
        s2.start(0)

    ctx.post_at(4 * 128 / SR, add_source)
    out = ctx.render(8 * 128)
    assert np.allclose(out[:, : 4 * 128], 0.5)
    assert np.allclose(out[:, 4 * 128:], 0.75)


def test_post_at_beyond_render_range_stays_queued():
    ctx, g = _gain_ctx()
    ctx.post_at(100 * 128 / SR, lambda c: setattr(g.gain, "value", 0.0))
    out = ctx.render(4 * 128)
    assert np.all(out == 0.5)
    assert len(ctx._timed) == 1
    # ...and still lands correctly on a later call
    out2 = ctx.render(200 * 128)
    assert np.all(out2[:, : 96 * 128] == 0.5)
    assert np.all(out2[:, 96 * 128:] == 0.0)


def test_post_at_never_rewrites_carried_frames():
    """Frames already computed and sitting in the host carry are history:
    a command due inside the carried region lands at the device clock."""
    ctx, g = _gain_ctx(superblock=4)
    out1 = ctx.render(300)  # device rendered 512 frames; 212 carried
    assert np.all(out1 == 0.5)
    ctx.post_at(350 / SR, lambda c: setattr(g.gain, "value", 0.0))
    out2 = ctx.render(512)
    # carried frames (to 512) keep the old gain; device frames are zero
    assert np.all(out2[:, :212] == 0.5)
    assert np.all(out2[:, 212:] == 0.0)


def test_post_at_pcm16_path():
    ctx, g = _gain_ctx()
    ctx.post_at(2 * 128 / SR, lambda c: setattr(g.gain, "value", 0.0))
    pcm = ctx.render_pcm16(4 * 128)
    pcm = pcm.reshape(-1, 2)
    assert np.all(pcm[: 2 * 128] == np.int16(round(0.5 * 32767)))
    assert np.all(pcm[2 * 128:] == 0)


def test_post_at_exception_swallowed_like_reference():
    ctx, g = _gain_ctx()

    def boom(c):
        raise RuntimeError("command failure")

    ctx.post_at(128 / SR, boom)
    ctx.post_at(128 / SR, lambda c: setattr(g.gain, "value", 0.0))
    out = ctx.render(3 * 128)  # must not raise; later command still runs
    assert np.all(out[:, 128:] == 0.0)


def test_post_at_disposed_raises():
    ctx, _ = _gain_ctx()
    ctx.dispose()
    try:
        ctx.post_at(0.0, lambda c: None)
    except RuntimeError:
        return
    raise AssertionError("expected RuntimeError on disposed context")
