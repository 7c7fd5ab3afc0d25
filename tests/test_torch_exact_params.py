"""The port's exact f64 automation (K6's exact rows, plain versions) and the
paths that integrate it, against the JAX package on the CPU.

* ``eval_intrinsic`` at arbitrary f64 times, on seeded event lists of all
  four types, within 1e-6 (the modules' tolerance), and bit for bit on a
  lane of set values and linear ramps;
* the K6 table with rows of the exact kind beside ordinary ones: each
  param's slot bit for bit its own ``eval_intrinsic_blocked_plain`` and
  within 1e-6 of the JAX function;
* an automated oscillator frequency (the phase twin of
  tests/test_sources.py:76-90), the Kit's ``BufferedSound.playback_rate``
  at 1.1, ``config4_pitched`` and ``config6_swept`` cut to 4 voices,
  ``config2_vibrato`` cut to 3, and a mid-render hand-off of the pitched
  graph through utils.from_jax, each within 1e-5 (the renders' tolerance)
  of the same graph rendered by the JAX package.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu import kit as jkit
from graphaudio_tpu.ops import param_eval as jpe
from graphaudio_tpu_torch import kit as tkit
from graphaudio_tpu_torch.core import graph as tgraph
from graphaudio_tpu_torch.ops import param_eval as tpe
from graphaudio_tpu_torch.testing import configs as tconfigs
from graphaudio_tpu_torch.utils import from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_param_eval import BLOCK, DT, _clock, _encodings  # noqa: E402

SR = 48000
MODULE_TOL = 1e-6
RENDER_TOL = 1e-5

_jax_intrinsic = jax.jit(jpe.eval_intrinsic)
_jax_blocked = jax.jit(jpe.eval_intrinsic_blocked, static_argnums=(2, 3, 4))


def _linear_lane(seed, cap=16):
    rng = np.random.default_rng(seed)
    evs = sorted(((int(rng.integers(0, 2)), float(rng.uniform(0, 40 * BLOCK)),
                   float(rng.uniform(0.05, 2.0)), 0.01) for _ in range(cap - 4)),
                 key=lambda e: e[1])
    return tpe.encode_events(0.5, evs, cap)


def test_eval_intrinsic_matches_jax():
    encs = _encodings(seed=11, lanes=4, cap=16, t_end=40 * BLOCK) + [_linear_lane(11)]
    stacked = {k: torch.from_numpy(np.stack([np.asarray(e[k]) for e in encs])) for k in encs[0]}
    rng = np.random.default_rng(12)
    t = np.sort(np.concatenate([rng.uniform(-0.01, 45 * BLOCK, 300),
                                np.arange(0, 45) * BLOCK, np.arange(0, 2000, 7) * DT]))
    got = tpe.eval_intrinsic(stacked, torch.from_numpy(t)).numpy()
    assert got.shape == (len(encs), len(t)) and got.dtype == np.float32
    for lane, e in enumerate(encs):
        want = np.asarray(_jax_intrinsic(e, t))
        if lane == len(encs) - 1:
            np.testing.assert_array_equal(got[lane], want)
        else:
            np.testing.assert_allclose(got[lane], want, rtol=0, atol=MODULE_TOL)


@pytest.mark.parametrize("step", [0, 5])
def test_k6_table_with_exact_rows(step):
    S = 8
    ordinary = _encodings(seed=21, lanes=4, cap=8, t_end=40 * BLOCK)
    exact = _encodings(seed=22, lanes=4, cap=16, t_end=40 * BLOCK)
    stack = lambda es: {k: np.stack([np.asarray(e[k]) for e in es]) for k in es[0]}  # noqa: E731
    entries = [("a", stack(ordinary), 128), ("b", stack(exact), 128, True),
               ("c", stack(exact), 1, True), ("d", stack(ordinary), 1, False)]
    table = tpe.pack_param_table(entries, S)
    assert table["rows"].shape == (16, tpe.ROW_WORDS)
    assert table["rows"][:, 2].tolist() == [0] * 4 + [1] * 8 + [0] * 4
    bt = _clock(8 * S)[step * S:(step + 1) * S]
    arena = tpe.eval_intrinsic_batch(tgraph.to_device(table, "cpu"), torch.from_numpy(bt), DT)
    for key, enc, npb, *ex in entries:
        ex = bool(ex and ex[0])
        slot = table["slots"][key]
        got = arena[slot.off:slot.off + slot.lanes * slot.per_lane].view(slot.lanes, -1)
        own = tpe.eval_intrinsic_blocked_plain(tgraph.to_device(enc, "cpu"), torch.from_numpy(bt),
                                               npb, DT, exact=ex)
        assert torch.equal(got, own), key
        for lane in range(slot.lanes):
            lane_enc = {k: np.asarray(v)[lane] for k, v in enc.items()}
            want = np.asarray(_jax_blocked(lane_enc, bt, npb, DT, ex))
            np.testing.assert_allclose(got[lane].numpy(), want, rtol=0, atol=MODULE_TOL)


def _mono(mod, superblock, **kw):
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **kw)
    ctx.destination.set_channel_count(1)
    ctx.destination.inputs[0].set_channel_count_mode(mod.ChannelCountMode.EXPLICIT)
    return ctx


def test_oscillator_frequency_ramp_phase():
    """tests/test_sources.py:76-90 in both packages: the frequency ramp is
    an exact a-rate row feeding K11's rows mode."""
    outs = []
    for mod, kw in ((ga, {}), (gat, {"device": "cpu"})):
        ctx = _mono(mod, 2, **kw)
        osc = mod.OscillatorNode(ctx)
        osc.frequency.set_value_at_time(100.0, 0.0)
        osc.frequency.linear_ramp_to_value_at_time(200.0, 0.1)
        osc.connect(ctx.destination)
        osc.start(0)
        outs.append(ctx.render(9600)[0])
    want, got = outs
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_TOL)
    t = np.arange(9600, dtype=np.float64) / SR
    f = np.where(t < 0.1, 100.0 + (200.0 - 100.0) * (t / 0.1), 200.0)
    phase = np.concatenate([[0.0], np.cumsum(2 * np.pi * f / SR)])[:-1]
    assert np.max(np.abs(got - np.sin(np.mod(phase, 2 * np.pi)))) < 1e-4


def test_kit_buffer_sound_playback_rate():
    """A Kit sound at playback_rate 1.1 renders (the time-varying resample
    variant) as the JAX Kit does."""
    outs = []
    for mod, kit, kw in ((ga, jkit, {}), (gat, tkit, {"device": "cpu"})):
        rng = np.random.default_rng(9)
        ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=4, **kw)
        engine = kit.AudioEngine(ctx)
        sig = (rng.standard_normal(SR // 2) * 0.2).astype(np.float32)
        s = engine.create_sound_from_buffer(mod.PlayableAudioBuffer.from_mono_array(sig, SR))
        s.is_looping = True
        s.playback_rate = 1.1
        s.play()
        outs.append(ctx.render(4 * 4 * 128))
        if mod is gat:
            assert s._source.kernel_variant()[0] == "resample"
    want, got = outs
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_TOL)


@pytest.mark.parametrize("builder, voices", [("config4_pitched", 4), ("config6_swept", 4),
                                             ("config2_vibrato", 3)])
def test_paths_cut_to_a_few_voices(builder, voices):
    build = getattr(tconfigs, builder)
    S = 4
    jctx = build(superblock=S, voices=voices, api=ga)
    tctx = build(superblock=S, voices=voices, device="cpu")
    for frames in (4 * S * 128, 4 * S * 128):
        want, got = jctx.render(frames), tctx.render(frames)
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_TOL)


def test_pitched_handoff_from_jax():
    S = 4
    T = S * 128
    jctx = tconfigs.config4_pitched(superblock=S, voices=4, api=ga)
    jctx.render(3 * T)
    tctx = tconfigs.config4_pitched(superblock=S, voices=4, device="cpu")
    tctx._ensure_compiled()
    from_jax.load_render_state(tctx, jax.device_get(jctx._states), jax.device_get(jctx._consts),
                               jctx._current_frame, jctx._current_time)
    want, got = jctx.render(3 * T), tctx.render(3 * T)
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_TOL)
