"""Multi-device rendering in the port (parallel/, ``set_mesh``, K14), on the CPU.

Twins of tests/test_parallel.py's eight tests, tests/test_pipeline.py:272
and :292 and tests/test_mod_groups.py:235. The port runs in 8 gloo ranks on
the CPU (``testing.mesh.run_ranks``, one spawn for the module); the JAX
package runs in this process on its 8 virtual devices, on the same seeded
numpy inputs (``testing.mesh``'s scenes build the same graph in either
package). Each twin holds:

* every rank's audio equal to rank 0's (each rank receives the whole
  output);
* the port's sharded render against its own single-device render within
  the JAX test's tolerance (1e-6 where voices shard, 1e-5 where
  partitions do: sums in another order);
* the port's sharded render against the JAX package's sharded render
  within 1e-5;
* the sharding the JAX test asserts (``sharded_stages``, ``part_sharded``,
  ``render_sharded``, the plan's pipes).

Besides: ``factor_mesh`` against the JAX package's ``make_mesh`` for 1-8
devices, ``make_mesh`` without a process group and ``set_mesh``'s errors
(no spawn); a hand-off of a JAX render's whole states and constants into
the port's sharded ranks (``utils.from_jax``); and K14a's and K14b's plain
versions: the slices' sum equals the whole MAC, zero-padded partitions add
nothing, and the slices sit at their global offsets.
"""

import numpy as np
import pytest
import torch

import jax
import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.parallel import ShardedVoiceScene as JaxScene
from graphaudio_tpu.parallel import make_mesh as jax_make_mesh
from graphaudio_tpu_torch.ops import convolve as tconv
from graphaudio_tpu_torch.ops import hrtf as thrtf
from graphaudio_tpu_torch.parallel import factor_mesh, make_mesh
from graphaudio_tpu_torch.testing import mesh as tmesh

WORLD = 8
VOICE_SCENE = dict(V=8, L=1000, ir=500, superblock=2, steps=4)


def _voice_scene_inputs():
    r = np.random.default_rng(1234)
    V = VOICE_SCENE["V"]
    arenas = (r.standard_normal((V, VOICE_SCENE["L"])) * 0.2).astype(np.float32)
    ir = (r.standard_normal(VOICE_SCENE["ir"]) * 0.3).astype(np.float32)
    gains = r.uniform(0.2, 1.0, V).astype(np.float32)
    pans = np.linspace(-1, 1, V).astype(np.float32)
    return arenas, ir, gains, pans


@pytest.fixture(scope="module")
def handoff():
    """A JAX render of the part-sharded convolver scene on its mesh, 2
    superblocks: its whole states and constants (host numpy), its clock,
    and its next 2 superblocks."""
    builder, mesh_name, _ = tmesh.SCENES["part_conv"]
    jctx = builder(ga)
    jctx.set_mesh(_jax_mesh(mesh_name))
    jctx.render(2 * 1024)
    # plain numpy all the way down: the ranks never import jax
    states = jax.tree_util.tree_map(np.asarray, jax.device_get(jctx._states))
    consts = jax.tree_util.tree_map(np.asarray, jax.device_get(jctx._consts))
    frame, t = int(jctx._current_frame), float(jctx._current_time)
    return ("part_conv", states, consts, frame, t, 2 * 1024), np.asarray(jctx.render(2 * 1024))


@pytest.fixture(scope="module")
def ranks(handoff):
    """Every scene, the voice scene and the hand-off on 8 gloo CPU ranks,
    in one spawn."""
    return tmesh.run_ranks(
        tmesh.render_scenes, WORLD, "gloo", timeout=300,
        args=(list(tmesh.SCENES), "cpu",
              (*_voice_scene_inputs(), VOICE_SCENE["superblock"], VOICE_SCENE["steps"]),
              handoff[0]))


def _jax_mesh(kind):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("the JAX side needs 8 virtual devices")
    if kind == "voice4":
        return jax.sharding.Mesh(np.array(devs[:4]).reshape(4), axis_names=("voice",))
    if kind == "4x2":
        return jax_make_mesh(devs[:8])
    return jax.sharding.Mesh(np.array(devs[:8]).reshape(8, 1), ("voice", "part"))


def _jax_render(name, mesh=True):
    builder, mesh_name, calls = tmesh.SCENES[name]
    ctx = builder(ga)
    if mesh:
        ctx.set_mesh(_jax_mesh(mesh_name))
    return [np.asarray(ctx.render(frames)) for frames in calls], ctx


def _port_single(name):
    builder, _, calls = tmesh.SCENES[name]
    ctx = builder(gat, "cpu")
    return [ctx.render(frames) for frames in calls]


def _check_scene(ranks, name, tol):
    """The ranks agree, match the port's single-device render within
    ``tol`` and the JAX package's sharded render within 1e-5; returns rank
    0's result and the JAX context."""
    held = [r[name] for r in ranks if name in r]
    first = held[0]
    for other in held[1:]:
        for a, b in zip(first["outs"], other["outs"]):
            np.testing.assert_array_equal(a, b)
    for got, want in zip(first["outs"], _port_single(name)):
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    jax_outs, jctx = _jax_render(name)
    for got, want in zip(first["outs"], jax_outs):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    return first, jctx


def test_sharded_scene_matches_reference(ranks):
    """tests/test_parallel.py:38: ``ShardedVoiceScene`` on a 4x2 mesh within
    1e-5 of the numpy mirror and of the JAX package's scene."""
    arenas, ir, gains, pans = _voice_scene_inputs()
    outs = [r["voice_scene"]["audio"] for r in ranks]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    got = outs[0]
    # the JAX test's numpy mirror
    V, L = arenas.shape
    frames = got.shape[1]
    mix = np.zeros((2, frames), np.float64)
    for v in range(V):
        s = arenas[v][np.arange(frames) % L].astype(np.float64) * gains[v]
        x = (pans[v] + 1.0) * 0.5
        mix[0] += s * np.cos(np.float32(x * np.pi / 2))
        mix[1] += s * np.sin(np.float32(x * np.pi / 2))
    ir_n = (ir * np.float32(tconv.normalization_scale(ir))).astype(np.float64)
    expect = np.stack([np.convolve(mix[c], ir_n)[:frames] for c in range(2)]) * 0.5
    assert np.max(np.abs(got - expect)) < 1e-5
    scene = JaxScene(jax_make_mesh(jax.devices()[:8]), arenas, ir, gains, pans,
                     superblock=VOICE_SCENE["superblock"])
    step, state, jouts = scene.jitted_step(), scene.init_state(), []
    for i in range(VOICE_SCENE["steps"]):
        state, out = step(state, i)
        jouts.append(np.asarray(out))
    np.testing.assert_allclose(got, np.concatenate(jouts, axis=1), atol=1e-5, rtol=0)
    assert ranks[0]["voice_scene"]["P"] == scene.P


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_factorization(n):
    """tests/test_parallel.py:63: the factorization of n ranks is the JAX
    package's of n devices (8 -> 4x2, a prime -> all voices)."""
    m = jax_make_mesh(jax.devices()[:n])
    assert factor_mesh(n) == (m.shape["voice"], m.shape["part"])


def test_mesh_factorization_sizes_and_errors():
    assert factor_mesh(16) == (4, 4) and factor_mesh(7) == (7, 1)
    assert factor_mesh(8, voice_axis=8) == (8, 1) and factor_mesh(8, part_axis=4) == (2, 4)
    with pytest.raises(ValueError):
        factor_mesh(8, voice_axis=3, part_axis=3)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


class _FakeMesh:
    """What ``set_mesh`` and the graph's sharding decisions read of a
    DeviceMesh (rank 0 of it; no process group, so no collective)."""

    def __init__(self, shape, names, device_type="cpu"):
        self.mesh = torch.zeros(shape)
        self.mesh_dim_names = names
        self.device_type = device_type

    def get_coordinate(self):
        return [0] * len(self.mesh_dim_names)

    def get_group(self, name):
        return None


def test_set_mesh_checks():
    ctx = gat.OfflineAudioContext(device="cpu")
    with pytest.raises(ValueError, match="voice"):
        ctx.set_mesh(_FakeMesh((2,), ("part",)))
    with pytest.raises(ValueError, match="power of two"):
        ctx.set_mesh(_FakeMesh((3, 2), ("voice", "part")))
    with pytest.raises(ValueError, match="cuda mesh"):
        ctx.set_mesh(_FakeMesh((2, 1), ("voice", "part"), "cuda"))
    ctx.set_mesh(None)
    assert ctx.mesh is None


def test_context_mesh_sharding_matches_single_device(ranks):
    """tests/test_parallel.py:72: voice groups shard over a 4-rank voice mesh;
    two calls (continuity)."""
    r, _ = _check_scene(ranks, "voice_gain", 1e-6)
    assert r["sharded_stages"], "voice groups did not shard"


def test_context_part_sharded_convolver_matches_single_device(ranks):
    """tests/test_parallel.py:110: the convolver's IR partitions shard over
    ``part`` (K14a) while voices shard over ``voice``."""
    r, jctx = _check_scene(ranks, "part_conv", 1e-5)
    assert r["part_sharded"], "convolver did not part-shard"
    assert r["part_sharded"] == sorted(jctx._compiled.part_sharded)
    assert r["sharded_stages"] == sorted(jctx._compiled.sharded_stages)


def test_context_mesh_shards_spatial_voices(ranks):
    """tests/test_parallel.py:146: the spatial-panner group shards over
    ``voice``."""
    r, _ = _check_scene(ranks, "spatial_voices", 1e-6)
    assert r["spatial_sharded"], "spatial-panner group did not shard"


def test_context_part_sharded_hrtf_matches_single_device(ranks):
    """tests/test_parallel.py:191: a moving panner with a 384-tap per-node
    HRIR part-shards (K14b) beside the voice groups; two calls; then
    ``set_mesh(None)`` renders unsharded."""
    r, jctx = _check_scene(ranks, "part_hrtf", 1e-5)
    assert r["part_panner"], "long-HRIR panner did not part-shard"
    assert r["sharded_stages"], "voice groups did not shard"
    assert r["sharded_stages"] == sorted(jctx._compiled.sharded_stages)
    assert np.isfinite(r["unsharded"]).all() and np.abs(r["unsharded"]).max() > 0
    assert r["unsharded_part_sharded"] == []


def test_part_sharded_hrtf_exact_partition_split(ranks):
    """tests/test_parallel.py:266: 512 taps, P = 4 over part = 2: no padding."""
    r, _ = _check_scene(ranks, "exact_split", 1e-5)
    assert r["part_panner"]


def test_part_only_sharding_engages(ranks):
    """tests/test_parallel.py:332: a part-shardable single and no voice
    group: the render runs sharded all the same."""
    r, _ = _check_scene(ranks, "part_only", 1e-5)
    assert r["part_sharded"] and not r["sharded_stages"]
    assert r["render_sharded"], "part-only plan fell back to single-device execution"


def test_pipeline_composes_with_mesh_eq_cascade(ranks):
    """tests/test_pipeline.py:272: the fused EQ cascade keeps its one pipe
    under a 4x2 mesh (pipes replicate)."""
    r, _ = _check_scene(ranks, "eq_cascade", 1e-5)
    assert r["pipe_delay"] == 5
    assert r["kinds"].count("pipe") == 1, r["kinds"]


def test_pipeline_coexists_with_voice_sharded_groups(ranks):
    """tests/test_pipeline.py:292: voice groups shard over an 8x1 mesh and
    feed a replicated pipe; two calls (register bank and filter carry)."""
    r, _ = _check_scene(ranks, "bus_eq", 1e-5)
    assert r["kinds"].count("pipe") == 1, r["kinds"]
    assert r["sharded_stages"], "voice groups did not shard"


def test_lfo_gain_under_voice_mesh_matches_unsharded(ranks):
    """tests/test_mod_groups.py:235: per-voice LFO -> gain CHAIN modulation
    shards over an 8x1 mesh."""
    r, _ = _check_scene(ranks, "lfo_gain", 1e-6)
    assert r["sharded_stages"]


def test_from_jax_handoff_into_sharded_ranks(ranks, handoff):
    """A JAX render of the part-sharded convolver scene (voices over
    ``voice``, IR partitions over ``part``) hands its whole states and
    constants to the port's 8 ranks (``utils.from_jax``: each rank keeps its
    share as its build does), which continue within 1e-5 of the JAX render's
    own continuation."""
    for r in ranks:
        np.testing.assert_allclose(r["handoff"], handoff[1], atol=1e-5, rtol=0)


# ---- K14's plain versions ------------------------------------------------------


def _mac_inputs(rng, K=2, L=3, P=8, NB=33):
    def c(*shape):
        return torch.complex(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
                             torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))

    R = P - 1 + L
    ring = torch.view_as_real(c(K, R, NB))
    H = torch.view_as_real(c(K, P, NB))
    return (c(K, L, NB), H[..., 0].contiguous(), H[..., 1].contiguous(),
            ring[..., 0].contiguous(), ring[..., 1].contiguous(), int(rng.integers(R)))


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("part", [2, 4])
def test_k14a_slices_sum_to_the_whole_mac(rng, rev, part):
    """K14a over every rank's slice sums to K2a's MAC (within 1e-6 x max:
    another order), and each slice writes the ring as K2a does."""
    X, hr, hi, ring_r, ring_i, head = _mac_inputs(rng)
    P = hr.shape[1]
    pl = P // part
    whole_ring = (ring_r.clone(), ring_i.clone())
    whole = tconv.spectral_mac_plain(X, hr, hi, *whole_ring, head, rev)
    total = torch.zeros_like(whole)
    for d in range(part):
        r = (ring_r.clone(), ring_i.clone())
        total += tconv.spectral_mac_slice(X, hr[:, d * pl:(d + 1) * pl].contiguous(),
                                          hi[:, d * pl:(d + 1) * pl].contiguous(), *r, head, rev,
                                          d * pl)
        assert torch.equal(r[0], whole_ring[0]) and torch.equal(r[1], whole_ring[1])
    assert float((total - whole).abs().max()) <= 1e-6 * float(whole.abs().max())


@pytest.mark.parametrize("rev", [False, True])
def test_k14a_zero_partitions_add_nothing_and_offsets_are_global(rng, rev):
    """Zero partitions padded where ``stage_consts`` pads them (before row 0
    when reversed, after the last in lag order) leave the sum as it was; a
    slice is the whole MAC of spectra zero outside it (its rows at their
    global lags)."""
    X, hr, hi, ring_r, ring_i, head = _mac_inputs(rng, P=6)
    K, P, NB = hr.shape
    L = X.shape[1]
    want = tconv.spectral_mac_plain(X, hr, hi, ring_r.clone(), ring_i.clone(), head, rev)
    # pad to 8 partitions: the ring grows with the padded P
    z = torch.zeros((K, 2, NB))
    hp = torch.cat([z, hr], 1) if rev else torch.cat([hr, z], 1)
    hip = torch.cat([z, hi], 1) if rev else torch.cat([hi, z], 1)
    R = P - 1 + L
    past = tconv.ring_slots(head, -(P - 1), P - 1, R, "cpu")
    R2 = 8 - 1 + L
    rr = torch.zeros((K, R2, NB))
    ri = torch.zeros((K, R2, NB))
    rr[:, tconv.ring_slots(0, -(P - 1), P - 1, R2, "cpu")] = ring_r[:, past]
    ri[:, tconv.ring_slots(0, -(P - 1), P - 1, R2, "cpu")] = ring_i[:, past]
    got = sum(tconv.spectral_mac_slice_plain(X, hp[:, d * 2:(d + 1) * 2].contiguous(),
                                             hip[:, d * 2:(d + 1) * 2].contiguous(),
                                             rr.clone(), ri.clone(), 0, rev, d * 2)
              for d in range(4))
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # an all-zero slice adds exactly nothing
    pad_slice = tconv.spectral_mac_slice_plain(X, z.contiguous(), z.contiguous(), rr.clone(),
                                               ri.clone(), 0, rev, 0 if rev else 6)
    assert torch.count_nonzero(pad_slice) == 0
    # global offsets: rows [2, 4) alone equal the whole MAC of spectra zero elsewhere
    keep = torch.zeros_like(hr)
    keep[:, 2:4] = 1.0
    alone = tconv.spectral_mac_plain(X, hr * keep, hi * keep, ring_r.clone(), ring_i.clone(),
                                     head, rev)
    sl = tconv.spectral_mac_slice_plain(X, hr[:, 2:4].contiguous(), hi[:, 2:4].contiguous(),
                                        ring_r.clone(), ring_i.clone(), head, rev, 2)
    assert float((sl - alone).abs().max()) <= 1e-6 * float(alone.abs().max())


def _hrtf_inputs(rng, P=6, S=5, V=2):
    hrir = (rng.standard_normal((8, 2, 128 * P)) * 0.05).astype(np.float32)
    grid = thrtf.load_hrir_grid({"hrir": hrir, "azimuth_deg": np.arange(8) * 45.0,
                                 "elevation_deg": np.zeros(8), "sample_rate": 48000}, 48000,
                                length=128 * P)
    sr, si = (torch.from_numpy(a) for a in thrtf.hrir_grid_spectra(grid))
    B = sr.shape[-1]

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    X = torch.complex(f(V, S, B), f(V, S, B))
    return X, f(V, P - 1, 2 * B), f(V, P - 1), f(V, P - 1) * 0.3, f(V, S), f(V, S) * 0.3, sr, si


@pytest.mark.parametrize("part", [2, 3, 6])
def test_k14b_slices_sum_to_the_whole_mac(rng, part):
    """K14b over every rank's slice sums to K10p-a's plain MAC (within 1e-6
    x max), each slice returns the whole next ring, and a slice equals
    K10p-a over spectra zero outside it (global offsets)."""
    X, hx, haz, hel, az, el, sr, si = _hrtf_inputs(rng)
    P = sr.shape[3]
    pl = P // part
    acc, *ring = thrtf.partitioned_mac_plain(X, hx, haz, hel, az, el, sr, si)
    total = torch.zeros_like(acc)
    for d in range(part):
        cut = slice(d * pl, (d + 1) * pl)
        got, *gring = thrtf.partitioned_mac_slice(X, hx, haz, hel, az, el,
                                                  sr[:, :, :, cut].contiguous(),
                                                  si[:, :, :, cut].contiguous(), d * pl)
        for g, w in zip(gring, ring):
            assert torch.equal(g, w)
        keep = torch.zeros(P)
        keep[cut] = 1.0
        alone = thrtf.partitioned_mac_plain(X, hx, haz, hel, az, el, sr * keep[:, None],
                                            si * keep[:, None])[0]
        assert float((got - alone).abs().max()) <= 1e-6 * float(alone.abs().max())
        total += got
    assert float((total - acc).abs().max()) <= 1e-6 * float(acc.abs().max())


def test_k14b_zero_partitions_add_nothing(rng):
    """Zero partitions appended to a 5-partition HRIR (as ``stage_consts``
    pads it for part = 2) leave the sums as they were; their slice adds
    exactly nothing."""
    X, hx, haz, hel, az, el, sr, si = _hrtf_inputs(rng, P=5)
    want = thrtf.partitioned_mac_plain(X, hx, haz, hel, az, el, sr, si)[0]
    z = torch.zeros(sr.shape[:3] + (1, sr.shape[4]))
    srp, sip = torch.cat([sr, z], 3), torch.cat([si, z], 3)
    hxp = torch.cat([torch.zeros_like(hx[:, :1]), hx], 1)  # the padded ring's oldest row
    hazp = torch.cat([torch.zeros_like(haz[:, :1]), haz], 1)
    hel_p = torch.cat([torch.zeros_like(hel[:, :1]), hel], 1)
    got = sum(thrtf.partitioned_mac_slice_plain(X, hxp, hazp, hel_p, az, el,
                                                srp[:, :, :, 3 * d:3 * (d + 1)].contiguous(),
                                                sip[:, :, :, 3 * d:3 * (d + 1)].contiguous(),
                                                3 * d)[0] for d in range(2))
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    zero = thrtf.partitioned_mac_slice_plain(X, hxp, hazp, hel_p, az, el, z.contiguous(),
                                             z.contiguous(), 5)[0]
    assert torch.count_nonzero(zero) == 0


@pytest.mark.parametrize("mod", ["", ".parallel", ".io", ".kit", ".realtime", ".utils", ".nodes"])
def test_exports_cover_the_jax_package(mod):
    """Every name of the JAX package's ``__all__`` lists (``parallel``'s
    included) is exported by the port's module of the same name."""
    import importlib

    jmod = importlib.import_module("graphaudio_tpu" + mod)
    tmod = importlib.import_module("graphaudio_tpu_torch" + mod)
    missing = [n for n in getattr(jmod, "__all__", []) if not hasattr(tmod, n)]
    assert not missing, missing
    if mod:
        assert mod[1:] in gat.__all__ or mod == ".nodes"


def test_config5_part_hrir_shards_as_the_jax_package_decides():
    """The scene of chip_smoke.py's phase 16 (c), at 16 voices: 8 panners
    with their own 1024-tap HRIR under a 2x2 mesh. The port shards the
    stages the JAX package shards: the 8 panners and the reverb send's
    convolver over ``part``, and no voice group (8 of the gain group's lanes
    feed single stages, a lane-indexed read that demotes it, and the CHAIN
    from the sources demotes them too)."""
    from graphaudio_tpu_torch.testing.configs import config5_part_hrir

    jctx = config5_part_hrir(voices=16, api=ga)
    jctx.set_mesh(jax_make_mesh(jax.devices()[:4]))
    jctx._ensure_compiled()
    ctx = config5_part_hrir(voices=16, device="cpu")
    ctx.set_mesh(_FakeMesh((2, 2), ("voice", "part")))
    ctx._ensure_compiled()
    assert sorted(ctx._compiled.part_sharded) == sorted(jctx._compiled.part_sharded)
    assert sorted(ctx._compiled.sharded_stages) == sorted(jctx._compiled.sharded_stages) == []
    kinds = sorted(type(ctx._compiled.plan[si]["rep"]).__name__ for si in ctx._compiled.part_sharded)
    assert kinds == ["ConvolverNode"] + ["SpatialPannerNode"] * 8
