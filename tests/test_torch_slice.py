"""The port's config-4 slice end to end, on the CPU (plain kernel versions).

* the port's config 4 (64 voices, superblock 4, 8192 frames) against
  tests/goldens/config4_conv_reverb_64.npz (a JAX CPU render) within 1e-5;
* side-by-side JAX renders at superblock 8 (superblock-grain convolution)
  and 16 (sub-blocked grain) with 4 voices and a 0.25 s IR, within 1e-5;
* render_pcm16 with a partial-superblock carry, against the port's f32
  render of the same frames packed by the plain pack, bit-exact;
* a mid-render hand-off through utils.from_jax: JAX renders 2 steps, both
  packages continue 3 steps, within 1e-5;
* the package imports without jax; the device and chunk-schedule policies.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.core.context import pack_int16_plain
from graphaudio_tpu_torch.testing.configs import config4_conv_reverb
from graphaudio_tpu_torch.utils import from_jax

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "config4_conv_reverb_64.npz"
SR = 48000
TOL = 1e-5


def _small_config4(mod, superblock, voices=4, ir_seconds=0.25, **ctx_kw):
    """Config 4's wiring at a small size: ``voices`` looped 44.1 kHz
    voices -> stereo convolver -> gain 0.5 -> destination."""
    rng = np.random.default_rng(44)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **ctx_kw)
    master = mod.GainNode(ctx)
    master.gain.value = 0.5
    conv = mod.ConvolverNode(ctx)
    n = int(ir_seconds * SR)
    decay = np.exp(-np.arange(n) / (0.1 * SR))
    conv.buffer = mod.PlayableAudioBuffer.from_stereo_arrays(
        (rng.standard_normal(n) * decay).astype(np.float32),
        (rng.standard_normal(n) * decay).astype(np.float32),
        SR,
    )
    conv.connect(master).connect(ctx.destination)
    for v in range(voices):
        sig = (rng.standard_normal(4410 + 1000 * v) * 0.2).astype(np.float32)
        src = mod.AudioBufferSourceNode(ctx)
        src.buffer = mod.PlayableAudioBuffer.from_mono_array(sig, 44100)
        src.loop = True
        src.playback_rate.value = 1.0
        src.connect(conv)
        src.start(0.001 * v)
    return ctx


def test_config4_golden():
    out = config4_conv_reverb(superblock=4, device="cpu").render(8192)
    golden = np.load(GOLDEN)["out"]
    assert out.shape == golden.shape and out.dtype == np.float32
    assert np.isfinite(out).all()
    assert np.abs(out.astype(np.float64) - golden).max() < TOL


@pytest.mark.parametrize("superblock", [8, 16])
def test_side_by_side_with_jax(superblock):
    frames = 4 * superblock * 128 + 300  # ends mid-superblock: exercises the carry
    want = _small_config4(ga, superblock).render(frames)
    tctx = _small_config4(gat, superblock, device="cpu")
    got = np.concatenate([tctx.render(1000), tctx.render(frames - 1000)], axis=1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL
    assert np.abs(want).max() > 1e-3  # not comparing silence


def test_render_pcm16_with_partial_carry():
    ref = _small_config4(gat, 4, device="cpu").render(5000)
    ctx = _small_config4(gat, 4, device="cpu")
    parts = [
        pack_int16_plain(torch.from_numpy(ctx.render(700))).numpy(),  # f32, leaves a carry
        ctx.render_pcm16(1500),  # starts from the f32 carry, leaves a pcm16 carry
        ctx.render_pcm16(2000),
        pack_int16_plain(torch.from_numpy(ctx.render(800))).numpy(),
    ]
    got = np.concatenate(parts)
    want = pack_int16_plain(torch.from_numpy(ref)).numpy()
    assert got.dtype == np.int16 and got.shape == (2 * 5000,)
    np.testing.assert_array_equal(got, want)


def test_mid_render_handoff_from_jax():
    superblock = 8
    T = superblock * 128
    jctx = _small_config4(ga, superblock)
    jctx.render(2 * T)
    tctx = _small_config4(gat, superblock, device="cpu")
    from_jax.load_render_state(
        tctx,
        jax.device_get(jctx._states),
        jax.device_get(jctx._consts),
        jctx._current_frame,
        jctx._current_time,
    )
    want = jctx.render(3 * T)
    got = tctx.render(3 * T)
    assert tctx.current_time == jctx.current_time
    assert np.abs(got - want).max() < TOL
    assert np.abs(want).max() > 1e-3


def test_import_without_jax():
    code = (
        "import sys, graphaudio_tpu_torch, graphaudio_tpu_torch.utils.from_jax, "
        "graphaudio_tpu_torch.testing.configs, graphaudio_tpu_torch.kit, "
        "graphaudio_tpu_torch.nodes.spatial, graphaudio_tpu_torch.ops.hrtf, "
        "graphaudio_tpu_torch.ops.onepole; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'graphaudio_tpu' or m.startswith('graphaudio_tpu.')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_module_imports_jax_or_the_jax_package():
    for path in (ROOT / "graphaudio_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not (mod == "jax" or mod.startswith("jax.")), (path, s)
                assert not (mod == "graphaudio_tpu" or mod.startswith("graphaudio_tpu.")), (path, s)


def test_cuda_device_is_explicit(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        gat.OfflineAudioContext()
    with pytest.raises(RuntimeError, match="device='cuda'"):
        config4_conv_reverb(superblock=4, voices=1)
    assert gat.OfflineAudioContext(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("bad", [True, {"a": 1}, [2, False], "0", "x,3", 2.5])
def test_chunk_schedule_rejects(bad):
    ctx = _small_config4(gat, 4, voices=1, ir_seconds=0.01, device="cpu")
    ctx.chunk_schedule = bad
    with pytest.raises(ValueError):
        ctx.render(512)


def test_chunk_schedule_does_not_change_audio():
    want = _small_config4(gat, 4, voices=2, ir_seconds=0.05, device="cpu").render(4096)
    ctx = _small_config4(gat, 4, voices=2, ir_seconds=0.05, device="cpu")
    ctx.chunk_schedule = iter([1, 3])  # a one-shot iterable is materialized
    got = np.concatenate([ctx.render(2048), ctx.render(2048)], axis=1)
    assert ctx.chunk_schedule == "1,3"
    assert ctx.stats.last_breakdown["n_launches"] == 2  # 1 step, then 3
    np.testing.assert_array_equal(got, want)


def test_signature_is_structural():
    """Voice churn that keeps the graph's structure keeps its signature (the
    JAX package's program-cache identity); crossing a lane bucket does not."""
    ctx = _small_config4(gat, 4, voices=3, ir_seconds=0.01, device="cpu")
    ctx._ensure_compiled()
    before = ctx._compiled.signature()
    conv = next(n for n in ctx._nodes.values() if isinstance(n, gat.ConvolverNode))

    def add_voice():
        src = gat.AudioBufferSourceNode(ctx)
        src.buffer = gat.PlayableAudioBuffer.from_mono_array(np.ones(3000, np.float32), 44100)
        src.loop = True
        src.playback_rate.value = 1.0
        src.connect(conv)
        src.start(0)

    add_voice()  # 4 voices: same 4-lane bucket
    ctx._ensure_compiled()
    assert ctx._compiled.signature() == before
    add_voice()  # 5 voices pad to 8 lanes
    ctx._ensure_compiled()
    assert ctx._compiled.signature() != before
