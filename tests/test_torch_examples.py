"""The port's examples (graphaudio_tpu_torch/examples/) against the JAX
package's (examples/*.py), on the CPU.

* the repair: an exponentially (and linearly) ramped a-rate lowpass on four
  oscillators, 0.25 s, within 1e-5 of the JAX render; XLA's CPU build
  takes f32 sin and cos from glibc, and the biquad's RBJ terms follow it
  (``xla_rounding.sincosf``): with the correctly rounded sin and cos, an
  ulp of cos w0 at a low cutoff moved the output by up to 2.8e-4 of a 4.6
  peak (2.8e-6 with glibc's);
* every twin imports, renders on "cuda" by default and raises without it;
* each self-contained twin renders the JAX example's audio within 1e-5 max
  abs (captured at the module's ``write_wav`` / ``write_flac`` and at
  ``render_pcm16``); the int16 PCM within 1 LSB, each 24-bit FLAC lossless
  and its samples no further apart than the f32 mixes plus one LSB;
  ``offline_mixdown`` is cut to its first 1 s on both sides;
* ``multichip_scene`` on 2 gloo ranks: the ranks equal and within 1e-5 of
  the scene rendered on one device;
* importing the twins and running one leaves ``jax`` and ``graphaudio_tpu``
  out of ``sys.modules``.
"""

import importlib
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.examples import NAMES
from graphaudio_tpu_torch.ops import xla_rounding

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
EXAMPLES = os.path.join(ROOT, "examples")
TOL = 1e-5
LSB24 = 2.0 ** -23


def _jax_example(name, monkeypatch):
    monkeypatch.syspath_prepend(EXAMPLES)
    return importlib.import_module(name)


def _port_example(name):
    return importlib.import_module(f"graphaudio_tpu_torch.examples.{name}")


def _spy(monkeypatch, owner, attr):
    """Record every call's positional arguments of ``owner.attr`` (and its
    result under "out"), calling through."""
    calls = []
    real = getattr(owner, attr)

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append({"args": args, "out": out})
        return out

    monkeypatch.setattr(owner, attr, spy)
    return calls


def _cap_render_seconds(monkeypatch, cls, cap):
    real = cls.render_seconds
    monkeypatch.setattr(cls, "render_seconds", lambda self, s: real(self, min(s, cap)))


def _err(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got.astype(np.float64) - want).max())


# ---- the repair: the ramped a-rate lowpass ------------------------------------


def _ramped_lowpass(mod, wave, ramp, **kw):
    """Four oscillators into a LOWPASS of Q 1.2 whose frequency ramps from
    300 to 8000 Hz over 3 s (the scene of offline_mixdown's chord, without
    its 0.2 gain, which would only scale the error)."""
    ctx = mod.OfflineAudioContext(**kw)
    lp = mod.BiQuadFilterNode(ctx, type=mod.FilterType.LOWPASS)
    lp.frequency.set_value_at_time(300.0, 0.0)
    if ramp == "exponential":
        lp.frequency.exponential_ramp_to_value_at_time(8000.0, 3.0)
    else:
        lp.frequency.linear_ramp_to_value_at_time(8000.0, 3.0)
    lp.q.value = 1.2
    lp.connect(ctx.destination)
    for f in (110.0, 165.3, 220.9, 278.9):
        osc = mod.OscillatorNode(ctx, type=getattr(mod.OscillatorType, wave.upper()))
        osc.frequency.value = f
        osc.connect(lp)
        osc.start(0)
    return ctx


@pytest.mark.parametrize("wave,ramp", [("sine", "exponential"), ("sawtooth", "exponential"),
                                       ("sine", "linear")])
def test_ramped_lowpass_matches_jax(wave, ramp):
    frames = 12000  # 0.25 s
    want = _ramped_lowpass(ga, wave, ramp).render(frames)
    got = _ramped_lowpass(gat, wave, ramp, device="cpu").render(frames)
    assert np.abs(want).max() > 0.5
    assert _err(got, want) <= TOL


def test_sincosf_is_xlas():
    """``xla_rounding.sincosf`` bit for bit the jitted ``jnp.sin`` and
    ``jnp.cos`` on the biquad's w0 range (0, pi], across the branches
    (|x| < 2^-12, < 0.75, the reduced range up to 120) and at their edges."""
    rng = np.random.default_rng(27)
    edges = np.array([0.0, -0.0, 2.0 ** -12, 0.75, np.pi, 2 * np.pi, 119.99, -3.0],
                     np.float32)
    x = np.concatenate([
        rng.uniform(0.0, np.pi, 400_000), rng.uniform(-120.0, 120.0, 200_000),
        rng.uniform(-1e-3, 1e-3, 20_000), np.nextafter(edges, np.float32(np.inf)),
        np.nextafter(edges, np.float32(-np.inf)), edges]).astype(np.float32)
    s, c = xla_rounding.sincosf(torch.from_numpy(x))
    js, jc = (np.asarray(v) for v in jax.jit(lambda v: (jnp.sin(v), jnp.cos(v)))(x))
    np.testing.assert_array_equal(s.numpy().view(np.int32), js.view(np.int32))
    np.testing.assert_array_equal(c.numpy().view(np.int32), jc.view(np.int32))


# ---- the twins --------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_example_imports(name, monkeypatch):
    mod = _port_example(name)
    params = inspect.signature(mod.main).parameters
    assert params["device"].default == "cuda"
    want = list(inspect.signature(_jax_example(name, monkeypatch).main).parameters)
    assert [p for p in params if p != "device"] == want


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_cuda_by_default(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["x", str(tmp_path / "out.flac")])
    with pytest.raises(RuntimeError, match="cuda"):
        _port_example(name).main(device="cuda")
    assert os.listdir(tmp_path) == []


def test_offline_mixdown_matches_jax(tmp_path, monkeypatch):
    jmod, tmod = _jax_example("offline_mixdown", monkeypatch), _port_example("offline_mixdown")
    _cap_render_seconds(monkeypatch, ga.OfflineAudioContext, 1.0)
    _cap_render_seconds(monkeypatch, gat.OfflineAudioContext, 1.0)
    jw, tw = _spy(monkeypatch, jmod, "write_wav"), _spy(monkeypatch, tmod, "write_wav")
    jmod.main(str(tmp_path / "jax.wav"))
    tmod.main(str(tmp_path / "port.wav"), device="cpu")
    want, got = jw[0]["args"][1], tw[0]["args"][1]
    assert want.shape == (2, 48000) and np.abs(want).max() > 0.1
    assert _err(got, want) <= TOL
    assert os.path.getsize(tmp_path / "port.wav") == os.path.getsize(tmp_path / "jax.wav")


def test_timed_automation_matches_jax(tmp_path, monkeypatch):
    """One 3.5 s render call with a param edit at 1 s, a topology edit at
    2 s (a second graph build; the first oscillator keeps its phase across
    it) and a stop at 3 s."""
    monkeypatch.chdir(tmp_path)
    jmod, tmod = _jax_example("timed_automation", monkeypatch), _port_example("timed_automation")
    jw, tw = _spy(monkeypatch, jmod, "write_wav"), _spy(monkeypatch, tmod, "write_wav")
    builds = _spy(monkeypatch, gat.OfflineAudioContext, "_ensure_compiled")
    jmod.main()
    tmod.main(device="cpu")
    want, got = jw[0]["args"][1], tw[0]["args"][1]
    assert want.shape == (2, 168000) and np.abs(want[:, 96000:]).max() > 0.5
    assert _err(got, want) <= TOL
    ctx = builds[0]["args"][0]
    assert ctx.stats.graph_builds == 2
    assert os.path.getsize(tmp_path / "timed_automation.wav") > 44


def test_game_audio_matches_jax(tmp_path, monkeypatch):
    """60 ticks of render(2400), 18.75 quanta each: every call ends inside
    a superblock of 4."""
    jmod, tmod = _jax_example("game_audio", monkeypatch), _port_example("game_audio")
    jw, tw = _spy(monkeypatch, jmod, "write_wav"), _spy(monkeypatch, tmod, "write_wav")
    jmod.main(str(tmp_path / "jax.wav"))
    tmod.main(str(tmp_path / "port.wav"), device="cpu")
    # the asset files go through write_wav too; the mix is the last call
    want, got = jw[-1]["args"][1], tw[-1]["args"][1]
    assert want.shape == (2, 144000) and np.abs(want).max() > 0.5
    assert _err(got, want) <= TOL


def test_measured_hrtf_flac_matches_jax(tmp_path, monkeypatch):
    from graphaudio_tpu_torch.io import AudioDecoder

    jmod, tmod = _jax_example("measured_hrtf_flac", monkeypatch), \
        _port_example("measured_hrtf_flac")
    jf, tf = _spy(monkeypatch, jmod, "write_flac"), _spy(monkeypatch, tmod, "write_flac")
    monkeypatch.setattr(sys, "argv", ["x", str(tmp_path / "jax.flac")])
    jmod.main()
    monkeypatch.setattr(sys, "argv", ["x", str(tmp_path / "port.flac")])
    tmod.main(device="cpu")
    want, got = jf[0]["args"][1], tf[0]["args"][1]
    assert want.shape == (2, 192000) and np.abs(want).max() > 0.1
    assert _err(got, want) <= TOL
    decoded = {}
    for who in ("jax", "port"):
        with AudioDecoder(str(tmp_path / f"{who}.flac")) as dec:
            decoded[who] = dec.decode_planar(dec.frames)
    # Each file decodes to its own mix quantized (lossless), so the integer
    # samples differ by no more than the f32 mixes do, plus the one LSB that
    # rounding adds: 45746 samples 1 LSB apart and one 2 LSB apart here.
    for who, mix in (("jax", want), ("port", got)):
        q = np.clip(np.rint(mix.astype(np.float64) / LSB24), -(1 << 23), (1 << 23) - 1)
        np.testing.assert_array_equal(decoded[who], (q * LSB24).astype(np.float32))
    lsb = np.abs(decoded["port"].astype(np.float64) - decoded["jax"]) / LSB24
    assert (lsb <= np.floor(np.abs(got.astype(np.float64) - want) / LSB24 + 1)).all()


def test_pcm_delivery_matches_jax(tmp_path, monkeypatch):
    """``set_default_hrir`` and ``render_pcm16``: the int16 samples within
    1 LSB of the JAX example's."""
    jmod, tmod = _jax_example("pcm_delivery_opus", monkeypatch), \
        _port_example("pcm_delivery_opus")
    for mod in (jmod, tmod):  # the encode is the Opus test's
        monkeypatch.setattr(mod, "codec_capabilities", lambda: {})
    jp = _spy(monkeypatch, ga.OfflineAudioContext, "render_pcm16")
    tp = _spy(monkeypatch, gat.OfflineAudioContext, "render_pcm16")
    jmod.main(str(tmp_path / "jax.opus"))
    tmod.main(str(tmp_path / "port.opus"), device="cpu")
    want, got = jp[0]["out"], tp[0]["out"]
    assert want.dtype == got.dtype == np.int16 and want.shape == got.shape == (192000,)
    assert np.abs(want).max() > 1000
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    assert not os.path.exists(tmp_path / "port.opus")


def test_pcm_delivery_opus_runs(tmp_path):
    out = str(tmp_path / "tone.opus")
    try:
        _port_example("pcm_delivery_opus").main(out, device="cpu")
    except RuntimeError as e:
        # libopus/libogg are dlopen'd; their absence is the machine's, not the code's
        pytest.skip(f"opus libs unavailable: {e}")
    if not os.path.exists(out):
        pytest.skip("no Opus encoder on this machine (the example printed its skip)")
    with open(out, "rb") as f:
        assert f.read(4) == b"OggS"


def test_multichip_scene_two_ranks(tmp_path, monkeypatch):
    """2 gloo ranks on the CPU: every rank gets the whole mix, the same on
    both, within 1e-5 of the scene on one device, and rank 0 writes it."""
    monkeypatch.chdir(tmp_path)
    mod = _port_example("multichip_scene")
    ranks = mod.main(2, device="cpu")
    (out0, sharded, builds, _), (out1, *_) = ranks
    np.testing.assert_array_equal(out0, out1)
    assert sharded and builds == 1
    one = mod.build_scene(gat.OfflineAudioContext(sample_rate=mod.SR, superblock=8,
                                                  device="cpu"), 2)
    want = one.render_seconds(2.0)
    assert out0.shape == (2, 96000) and np.abs(want).max() > 0.05
    assert _err(out0, want) <= TOL
    assert os.path.getsize(tmp_path / "multichip_scene.wav") > 44


def test_examples_import_no_jax(tmp_path):
    """A fresh interpreter imports every twin and runs pcm_delivery_opus on
    the CPU without importing jax or graphaudio_tpu."""
    code = (
        "import sys\n"
        "import importlib\n"
        "from graphaudio_tpu_torch.examples import NAMES\n"
        "for n in NAMES:\n"
        "    importlib.import_module('graphaudio_tpu_torch.examples.' + n)\n"
        "from graphaudio_tpu_torch.examples import pcm_delivery_opus\n"
        f"pcm_delivery_opus.main({str(tmp_path / 'x.opus')!r}, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'graphaudio_tpu'))\n"
        "print('LEAKED', bad)\n"
        "assert not bad, bad\n"
    )
    path = [os.path.abspath(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LEAKED []" in res.stdout
