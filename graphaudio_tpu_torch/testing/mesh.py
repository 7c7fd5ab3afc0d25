"""Multi-rank runs of the port on one host, and the scenes the mesh tests
render.

``run_ranks`` spawns ``world`` ranks with ``torch.multiprocessing`` (the
spawn start method), each of which joins a process group of the caller's
backend through a ``file://`` rendezvous in a fresh temporary directory
(never a fixed TCP port: several test processes run at once), selects its
card on a CUDA run, calls the job and sends back what it returns (numpy,
nothing on a device). A run past its ``timeout`` kills every rank and
raises, so a hung rendezvous or collective fails in seconds.

The scenes are tests/test_parallel.py's, tests/test_pipeline.py:272 and
:292's and tests/test_mod_groups.py:235's, each built by one function for
either package (``api``: ``graphaudio_tpu`` or ``graphaudio_tpu_torch``), so
the JAX package's render on its virtual devices and the port's on its
ranks start from the same seeded numpy inputs. ``render_scenes`` is the
job that renders them on every rank.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np

SR = 48000


# ---- the launcher ---------------------------------------------------------------


def _rank_main(job, rank, world, backend, init_file, args_file, results, cuda, timeout):
    import pickle

    import torch
    import torch.distributed as dist

    try:
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        torch.set_num_threads(1)
        if cuda:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout))
        try:
            out = job(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(job, world: int, backend: str, args=(), timeout: float = 120.0,
              cuda: bool = False):
    """Run ``job(rank, world, *args)`` on ``world`` spawned ranks joined in a
    ``backend`` process group ("gloo" or "nccl": the caller's choice); with
    ``cuda`` each rank first selects card ``rank % device_count``. ``job``
    must be importable by name (a module-level function) and return
    picklable host data. Returns the ranks' results in rank order; raises
    RuntimeError with a rank's traceback if one fails, TimeoutError (all
    ranks killed) past ``timeout`` seconds. ``args`` reach the ranks through
    a file, not the spawn pipe: a start that writes more than the pipe
    holds waits for its child to boot, and the ranks would boot one by
    one."""
    import pickle

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ga_mesh_")
    args_file = os.path.join(tmp, "args.pkl")
    with open(args_file, "wb") as f:
        pickle.dump(tuple(args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(job, r, world, backend, os.path.join(tmp, "rendezvous"),
                               args_file, results, cuda, timeout))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s "
                                   f"(finished: {sorted(got)})")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and len(got) < world and results.empty():
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError(f"a rank exited with code {dead[0]} before it "
                                           "reported") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the scenes -------------------------------------------------------------------


def _context(api, device, superblock, **kw):
    """An OfflineAudioContext of ``api`` (the port's on ``device``)."""
    if api.__name__ == "graphaudio_tpu_torch":
        kw["device"] = device
    return api.OfflineAudioContext(sample_rate=SR, superblock=superblock, **kw)


def voice_gain_scene(api, device="cpu"):
    """tests/test_parallel.py:61: 8 looped voices, each through its own
    gain, into a shared gain (voice groups, one bus fan-in)."""
    ctx = _context(api, device, 4)
    sink = api.GainNode(ctx)
    sink.gain.value = 0.8
    sink.connect(ctx.destination)
    r = np.random.default_rng(7)
    for v in range(8):
        buf = api.PlayableAudioBuffer.from_mono_array(
            (r.standard_normal(4800) * 0.1).astype(np.float32), SR)
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = buf
        src.loop = True
        g = api.GainNode(ctx)
        g.gain.value = 1.0 / (v + 1)
        src.connect(g).connect(sink)
        src.start(0)
    return ctx


def part_conv_scene(api, device="cpu"):
    """tests/test_parallel.py:103: 4 voices into a stereo convolver (3072-tap
    IR, superblock 8: the big grain) and a master gain."""
    ctx = _context(api, device, 8)
    r = np.random.default_rng(21)
    master = api.GainNode(ctx)
    master.gain.value = 0.7
    conv = api.ConvolverNode(ctx)
    ir = (r.standard_normal(1024 * 3) * 0.2).astype(np.float32)
    conv.buffer = api.PlayableAudioBuffer.from_stereo_arrays(ir, ir[::-1].copy(), SR)
    conv.connect(master).connect(ctx.destination)
    for _ in range(4):
        buf = api.PlayableAudioBuffer.from_mono_array(
            (r.standard_normal(4096) * 0.1).astype(np.float32), SR)
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = buf
        src.loop = True
        src.connect(conv)
        src.start(0)
    return ctx


def spatial_voices_scene(api, device="cpu"):
    """tests/test_parallel.py:147: 8 voices, each through a spatial panner on
    a circle, into the destination."""
    ctx = _context(api, device, 4)
    ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    r = np.random.default_rng(11)
    for v in range(8):
        buf = api.PlayableAudioBuffer.from_mono_array(
            (r.standard_normal(4800) * 0.1).astype(np.float32), SR)
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = buf
        src.loop = True
        pan = api.SpatialPannerNode(ctx)
        ang = 2 * np.pi * v / 8
        pan.position_x.value = 3 * np.cos(ang)
        pan.position_z.value = 3 * np.sin(ang)
        src.connect(pan).connect(ctx.destination)
        src.start(0)
    return ctx


def part_hrtf_scene(api, device="cpu"):
    """tests/test_parallel.py:191: 8 voices through gains into a bus and one
    moving panner with its own 384-tap HRIR (P = 3)."""
    r = np.random.default_rng(31)
    hrir_set = {
        "hrir": (r.standard_normal((6, 2, 384)) * 0.05).astype(np.float32),
        "azimuth_deg": np.array([0.0, 60.0, 120.0, 180.0, 240.0, 300.0]),
        "elevation_deg": np.array([-30.0, 0.0, 30.0, 0.0, -30.0, 30.0]),
        "sample_rate": SR,
    }
    ctx = _context(api, device, 4)
    ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    bus = api.GainNode(ctx)
    bus.gain.value = 0.8
    pan = api.SpatialPannerNode(ctx)
    pan.load_hrir(hrir_set)
    pan.position_x.set_value_at_time(-3.0, 0.0)
    pan.position_x.linear_ramp_to_value_at_time(3.0, 4096 / SR)
    pan.position_z.value = -2.0
    bus.connect(pan).connect(ctx.destination)
    rr = np.random.default_rng(13)
    for v in range(8):
        buf = api.PlayableAudioBuffer.from_mono_array(
            (rr.standard_normal(4800) * 0.1).astype(np.float32), SR)
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = buf
        src.loop = True
        g = api.GainNode(ctx)
        g.gain.value = 1.0 / (v + 1)
        src.connect(g).connect(bus)
        src.start(0)
    return ctx


def exact_split_scene(api, device="cpu"):
    """tests/test_parallel.py:266: an oscillator through a panner with its
    own 512-tap HRIR (P = 4), beside 8 looped voices."""
    r = np.random.default_rng(41)
    hrir_set = {
        "hrir": (r.standard_normal((4, 2, 512)) * 0.05).astype(np.float32),
        "azimuth_deg": np.array([0.0, 90.0, 180.0, 270.0]),
        "elevation_deg": np.zeros(4),
        "sample_rate": SR,
    }
    ctx = _context(api, device, 4)
    ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    rr = np.random.default_rng(5)
    osc = api.OscillatorNode(ctx)
    osc.frequency.value = 220.0
    pan = api.SpatialPannerNode(ctx)
    pan.load_hrir(hrir_set, length=512)
    pan.position_x.value = 1.5
    pan.position_z.value = -1.0
    osc.connect(pan).connect(ctx.destination)
    osc.start(0)
    for v in range(8):
        buf = api.PlayableAudioBuffer.from_mono_array(
            (rr.standard_normal(2400) * 0.05).astype(np.float32), SR)
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = buf
        src.loop = True
        src.connect(ctx.destination)
        src.start(0)
    return ctx


def part_only_scene(api, device="cpu"):
    """tests/test_parallel.py:332: a lone oscillator through a panner with
    its own 384-tap HRIR: nothing shards over ``voice``."""
    r = np.random.default_rng(53)
    hrir_set = {
        "hrir": (r.standard_normal((4, 2, 384)) * 0.05).astype(np.float32),
        "azimuth_deg": np.array([0.0, 90.0, 180.0, 270.0]),
        "elevation_deg": np.zeros(4),
        "sample_rate": SR,
    }
    ctx = _context(api, device, 4)
    ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    osc = api.OscillatorNode(ctx)
    osc.frequency.value = 440.0
    pan = api.SpatialPannerNode(ctx)
    pan.load_hrir(hrir_set)
    pan.position_x.value = 2.0
    pan.position_z.value = -1.0
    osc.connect(pan).connect(ctx.destination)
    osc.start(0)
    return ctx


def eq_cascade_scene(api, device="cpu"):
    """tests/test_pipeline.py:272 (its ``_chain_ctx(True, n_filters=6)``): a
    looped stereo buffer through six ramped biquads, fused into one pipe."""
    ctx = _context(api, device, 4, pipeline_chains=True)
    rng = np.random.default_rng(7)
    src = api.AudioBufferSourceNode(ctx)
    left = (rng.standard_normal(SR) * 0.3).astype(np.float32)
    right = (rng.standard_normal(SR) * 0.3).astype(np.float32)
    src.buffer = api.PlayableAudioBuffer.from_stereo_arrays(left, right, SR)
    src.loop = True
    node = src
    for i in range(6):
        bq = api.BiQuadFilterNode(ctx)
        bq.frequency.value = 400.0 * (i + 1)
        bq.frequency.linear_ramp_to_value_at_time(600.0 * (i + 1), 0.5)
        node = node.connect(bq)
    node.connect(ctx.destination)
    src.start(0)
    return ctx


def bus_eq_scene(api, device="cpu"):
    """tests/test_pipeline.py:292: 8 voices through gains into a bus that
    feeds four serial biquads (a pipe) into the destination."""
    ctx = _context(api, device, 4, pipeline_chains=True)
    rng = np.random.default_rng(17)
    bus = api.GainNode(ctx)
    bus.gain.value = 0.25
    node = bus
    for i in range(4):
        bq = api.BiQuadFilterNode(ctx)
        bq.frequency.value = 500.0 * (i + 1)
        node = node.connect(bq)
    node.connect(ctx.destination)
    for v in range(8):
        src = api.AudioBufferSourceNode(ctx)
        src.buffer = api.PlayableAudioBuffer.from_mono_array(
            (rng.standard_normal(4096) * 0.2).astype(np.float32), SR)
        src.loop = True
        g = api.GainNode(ctx)
        g.gain.value = 0.5 + 0.05 * v
        src.connect(g).connect(bus)
        src.start(0)
    return ctx


def lfo_gain_scene(api, device="cpu"):
    """tests/test_mod_groups.py:235 (its ``_lfo_gain_scene(ctx, 8)``): 8
    constant sources through gains, each gain modulated by its own LFO."""
    ctx = _context(api, device, 2)
    for v in range(8):
        src = api.ConstantSourceNode(ctx)
        src.offset.value = 0.5 + 0.05 * v
        lfo = api.OscillatorNode(ctx)
        lfo.frequency.value = 2.0 + v
        g = api.GainNode(ctx)
        g.gain.value = 0.25
        lfo.connect(g.gain)
        src.connect(g).connect(ctx.destination)
        src.start(0)
        lfo.start(0)
    return ctx


#: name -> (builder, mesh, the frames of each render call): the mesh
#: "voice4" is a 1-D ``voice`` mesh of 4 ranks, "4x2" and "8x1" ``(voice,
#: part)`` meshes of 8.
SCENES = {
    "voice_gain": (voice_gain_scene, "voice4", (4096, 4096)),
    "part_conv": (part_conv_scene, "4x2", (4096, 4096)),
    "spatial_voices": (spatial_voices_scene, "voice4", (2048,)),
    "part_hrtf": (part_hrtf_scene, "4x2", (2048, 2048)),
    "exact_split": (exact_split_scene, "4x2", (2048,)),
    "part_only": (part_only_scene, "4x2", (2048,)),
    "eq_cascade": (eq_cascade_scene, "4x2", (16 * 128,)),
    "bus_eq": (bus_eq_scene, "8x1", (12 * 128, 8 * 128)),
    "lfo_gain": (lfo_gain_scene, "8x1", (8 * 128,)),
}

MESH_SHAPES = {"voice4": (4,), "4x2": (4, 2), "8x1": (8, 1)}


def build_meshes(device_type: str):
    """The scenes' meshes on an 8-rank process group, made by every rank
    (a ``DeviceMesh``'s groups are made collectively)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from graphaudio_tpu_torch.parallel import make_mesh

    return {
        "voice4": DeviceMesh(device_type, torch.arange(4), mesh_dim_names=("voice",)),
        "4x2": make_mesh(device_type=device_type),
        "8x1": make_mesh(voice_axis=8, part_axis=1, device_type=device_type),
    }


def describe(ctx) -> dict:
    """The compiled graph's sharding as the JAX tests read it."""
    c = ctx._compiled
    kinds = [sp["kind"] for sp in c.plan]
    return {
        "sharded_stages": sorted(c.sharded_stages),
        "part_sharded": sorted(c.part_sharded),
        "render_sharded": bool(c.render_sharded),
        "kinds": kinds,
        "pipe_delay": c.pipe_delay,
        "spatial_sharded": any(
            c.plan[si]["group_key"] and c.plan[si]["group_key"][0] == "spatial-panner"
            for si in c.sharded_stages),
        "part_panner": any(type(c.plan[si]["rep"]).__name__ == "SpatialPannerNode"
                           for si in c.part_sharded),
    }


def render_scenes(rank, world, names, device="cpu", voice_scene=None, handoff=None):
    """The job of an 8-rank run: each scene of ``names`` built, put on its
    mesh (``SCENES``) and rendered by the mesh's ranks; a rank outside a
    scene's mesh renders nothing of it. Returns {name: {"outs": [each
    render call's f32[C, frames]], **describe(ctx)}}; for "part_hrtf" also
    the render after ``set_mesh(None)`` ("unsharded") with its
    ``part_sharded``. With ``voice_scene`` (arenas, ir, gains, pans,
    superblock, steps), also a ``ShardedVoiceScene`` on the "4x2" mesh:
    "voice_scene" its steps' audio joined. With ``handoff`` (name, states,
    consts, frame, time, frames), also "handoff": scene ``name`` on its
    mesh continuing the JAX package's render from its whole states and
    constants (``utils.from_jax``: each rank takes its share as its own
    build would) at its clock, ``frames`` frames."""
    import graphaudio_tpu_torch as gat
    from graphaudio_tpu_torch.parallel import ShardedVoiceScene

    meshes = build_meshes("cuda" if str(device).startswith("cuda") else "cpu")
    out = {}
    for name in names:
        builder, mesh_name, calls = SCENES[name]
        mesh = meshes[mesh_name]
        if mesh.get_coordinate() is None:
            continue
        ctx = builder(gat, device)
        ctx.set_mesh(mesh)
        res = {"outs": [ctx.render(frames) for frames in calls]}
        res.update(describe(ctx))
        if name == "part_hrtf":
            ctx.set_mesh(None)
            res["unsharded"] = ctx.render(calls[0])
            res["unsharded_part_sharded"] = sorted(ctx._compiled.part_sharded)
        out[name] = res
    if voice_scene is not None:
        *inputs, superblock, steps = voice_scene
        scene = ShardedVoiceScene(meshes["4x2"], *inputs, superblock=superblock, device=device)
        state, outs = scene.init_state(), []
        for i in range(steps):
            state, wet = scene.render_step(state, i)
            outs.append(wet.cpu().numpy())
        out["voice_scene"] = {"audio": np.concatenate(outs, axis=1), "P": scene.P,
                              "P_local": scene.p_local}
    if handoff is not None:
        name, *rest = handoff
        out["handoff"] = _continue(meshes, name, *rest, device=device)
    return out


def _continue(meshes, name, states, consts, frame, t, frames, device):
    """``render_scenes``'s hand-off: None on a rank outside the mesh."""
    import graphaudio_tpu_torch as gat
    from graphaudio_tpu_torch.utils.from_jax import load_render_state

    builder, mesh_name, _ = SCENES[name]
    mesh = meshes[mesh_name]
    if mesh.get_coordinate() is None:
        return None
    ctx = builder(gat, device)
    ctx.set_mesh(mesh)
    load_render_state(ctx, states, consts, frame, t)
    return ctx.render(frames)
