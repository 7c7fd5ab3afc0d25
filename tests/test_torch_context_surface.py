"""The port's context surface against the JAX context, on the CPU.

* ``pipeline_chains``: both packages take it with the same defaults (off on
  the base context, on for ``OfflineAudioContext``), and a render with it on
  equals one with it off, bit for bit. Both fuse config 3's four biquads
  into one pipelined stage of delay 3 with it on and none with it off;
  config 2 here has no chain to fuse.
* The block wrappers ``process_block``, ``process_block_interleaved``,
  ``process_blocks`` and ``render_interleaved`` match the JAX context's in
  shape, in layout (frame-major interleaving) and in value within 1e-5.

The graph is config 2 (``benchmarks/configs.py`` ``config2_mix_bus``: looped
mono voices through gains with linear and exponential ramps) cut to three
voices at superblock 2, so each wrapper also meets the carried partial
superblock.
"""

import inspect

import numpy as np
import pytest

import benchmarks.configs as bc
import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.core import context as jcontext
from graphaudio_tpu_torch.core import context as tcontext
from graphaudio_tpu_torch.testing import configs as tc

SR = 48000
TOL = 1e-5


def _mix_bus(mod, voices=3, **ctx_kw):
    rng = np.random.default_rng(2)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=2, **ctx_kw)
    for v in range(voices):
        sig = (rng.standard_normal(SR // 4) * 0.1).astype(np.float32)
        src = mod.AudioBufferSourceNode(ctx)
        src.buffer = mod.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        g = mod.GainNode(ctx)
        g.gain.set_value_at_time(0.05, 0.0)
        if v % 2 == 0:
            g.gain.linear_ramp_to_value_at_time(0.8, 0.01)
        else:
            g.gain.exponential_ramp_to_value_at_time(0.8, 0.01)
        src.connect(g).connect(ctx.destination)
        src.start(0)
    return ctx


def test_pipeline_chains_flag():
    for base, offline in ((jcontext.AudioContextBase, ga.OfflineAudioContext),
                          (tcontext.AudioContextBase, gat.OfflineAudioContext)):
        assert inspect.signature(base.__init__).parameters["pipeline_chains"].default is False
        assert inspect.signature(offline.__init__).parameters["pipeline_chains"].default is True
    assert _mix_bus(gat, device="cpu").pipeline_chains is True
    assert tcontext.AudioContextBase(device="cpu").pipeline_chains is False
    renders = {}
    for flag in (True, False):
        ctx = _mix_bus(gat, pipeline_chains=flag, device="cpu")
        assert ctx.pipeline_chains is flag
        renders[flag] = np.concatenate([ctx.render(300), ctx.render(724)], axis=1)
    assert np.abs(renders[True]).max() > 1e-3
    assert np.array_equal(renders[True], renders[False])
    for flag in (True, False):
        for ctx in (bc.config3_eq_chain(superblock=4),
                    tc.config3_eq_chain(superblock=4, device="cpu")):
            ctx.pipeline_chains = flag
            ctx._ensure_compiled()
            kinds = [sp["kind"] for sp in ctx._compiled.plan]
            assert ctx._compiled.pipe_delay == (3 if flag else 0)
            assert kinds.count("pipe") == int(flag)


# Each wrapper called twice in a row: (name, args, frames per call).
WRAPPERS = [
    ("process_block", (), 128),
    ("process_block_interleaved", (), 128),
    ("process_blocks", (3,), 384),
    ("render_interleaved", (300,), 300),
]


@pytest.mark.parametrize("name, args, frames", WRAPPERS, ids=[w[0] for w in WRAPPERS])
def test_block_wrappers_match_jax(name, args, frames):
    jctx, tctx = _mix_bus(ga), _mix_bus(gat, device="cpu")
    plain = _mix_bus(gat, device="cpu").render(2 * frames)  # [2, 2 * frames]
    for call in range(2):
        want = getattr(jctx, name)(*args)
        got = getattr(tctx, name)(*args)
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        assert np.abs(got - want).max() < TOL
        part = plain[:, call * frames:(call + 1) * frames]
        if name.endswith("interleaved"):
            assert got.shape == (2 * frames,)
            # frame-major: L0 R0 L1 R1 ...
            assert np.array_equal(got.reshape(frames, 2).T, part)
        else:
            assert np.array_equal(got, part)
    assert np.abs(plain).max() > 1e-3
