"""Buffer-source voice groups with every edge case of the group steps (K1,
K5, K7), for the CPU emulation test and the card tests.

Each builder returns a context whose stage 0 is one source group: looping
and one-shot voices, a loop shorter than a superblock (it wraps inside
one), a buffer that runs out and a duration that ends mid-superblock (the
clear and the shortened stop_time), a start inside a later superblock, a
stop before the second superblock, a start past the render, and phantom
lanes (the voice count is not a power of two). Buffer lengths and times
are in superblocks of the context's own length, so every superblock size
sees each case within five steps.
``group_inputs`` walks a group step by step along the plain composition
and yields each step's inputs; a time-varying group takes its per-quantum
playbackRate from ``step_rates``.
"""

from __future__ import annotations

import numpy as np
import torch

import graphaudio_tpu_torch as ga
from graphaudio_tpu_torch.core.graph import RenderContext

SR = 48000
BLOCK = 128

# (length, loop, loop_start, loop_end, when, offset, duration, stop): loop
# points and offsets in seconds, the rest in superblocks.
POLY_VOICES = [
    (4.3, True, 0.0, 0.0, 0.0, 0.0, None, None),
    (8, True, 0.01, 0.013, 0.5, 0.005, None, None),
    (1.7, False, 0.0, 0.0, 0.0, 0.01, None, None),
    (40, False, 0.0, 0.0, 0.1, 0.0, 1.5, None),
    (2, False, 0.0, 0.0, 2.5, 0.0, None, None),
    (5, True, 0.0, 0.0, 0.0, 0.0, None, 0.5),
    (5, False, 0.0, 0.0, 1000.0, 0.0, None, None),
]
# Aligned: positions and loop lengths are multiples of 128 frames (4.25
# superblocks are, from superblock 4 up).
UNITY_ALIGNED = [
    (1.7, False, 0.0, 0.0, 0.0, 0.0, None, None),
    (8, True, 128 / SR, 1152 / SR, 0.5, 256 / SR, None, None),
    (4.25, True, 0.0, 0.0, 0.0, 0.0, None, 1.5),
    (40, False, 0.0, 0.0, 0.1, 512 / SR, 1.5, None),
    (2, False, 0.0, 0.0, 2.5, 0.0, None, None),
    (5, False, 0.0, 0.0, 0.0, 0.0, None, 0.5),
]
UNITY_UNALIGNED = [
    (1.7, False, 0.0, 0.0, 0.0, 0.0013, None, None),
    (8, True, 0.01, 0.03, 0.5, 0.005, None, None),
    (4.3, True, 0.0, 0.0, 0.0, 0.001, None, 1.5),
    (40, False, 0.0, 0.0, 0.1, 0.02, 1.5, None),
    (2, False, 0.0, 0.0, 2.5, 0.0007, None, None),
    (5, True, 0.0, 0.0, 0.0, 0.0021, None, 0.5),
    (5, False, 0.0, 0.0, 1000.0, 0.003, None, None),
]


def voice_group(specs, superblock, buffer_rate, channels=1, device="cuda", seed=41,
                playback_rate=None):
    """A context whose stage 0 is one group of the voices ``specs``; with
    ``playback_rate`` every voice's playbackRate is set to it."""
    rng = np.random.default_rng(seed)
    step_s = superblock * BLOCK / SR
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock, device=device)
    for length, loop, ls, le, when, off, dur, stop in specs:
        n = max(16, int(length * superblock * BLOCK * buffer_rate / SR))
        chans = [(rng.standard_normal(n) * 0.3).astype(np.float32) for _ in range(channels)]
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = (ga.PlayableAudioBuffer.from_mono_array(chans[0], buffer_rate)
                      if channels == 1 else
                      ga.PlayableAudioBuffer.from_stereo_arrays(*chans, buffer_rate))
        src.loop = loop
        src.loop_start, src.loop_end = ls, le
        if playback_rate is not None:
            src.playback_rate.value = playback_rate
        src.connect(ctx.destination)
        src.start(when * step_s, off, float("inf") if dur is None else dur * step_s)
        if stop is not None:
            src.stop(stop * step_s)
    ctx._ensure_compiled()
    return ctx


def poly_group(superblock, device="cuda", buffer_rate=44100):
    """Mono voices at ``buffer_rate`` in a 48 kHz context: the ("poly", 147,
    160) variant at 44.1 kHz; at 10 Hz ("poly", 1, 4800), whose phase table
    is too large for K1 to stage in shared memory."""
    return voice_group(POLY_VOICES, superblock, buffer_rate, 1, device)


def unity_group(superblock, aligned, device="cuda"):
    """48 kHz stereo voices at the context's rate: the ("unity", aligned)
    variant."""
    return voice_group(UNITY_ALIGNED if aligned else UNITY_UNALIGNED, superblock, SR, 2,
                       device)


def resample_group(superblock, device="cuda", channels=1, specs=POLY_VOICES):
    """Voices at 44.1 kHz in a 48 kHz context with playbackRate 1.1: the
    ("resample", 2) variant (the rates of a step come from
    ``step_rates``)."""
    return voice_group(specs, superblock, 44100, channels, device, playback_rate=1.1)


def step_rates(ctx, k):
    """The playbackRate f32[V, S] of step ``k`` of ctx's stage-0 group, a
    seeded draw in [0.5, 2.1): past the window's rate bound of 2 now and
    then, so the kernel's clamp is exercised too."""
    V = ctx._compiled.stage_pad[0][1]
    rng = np.random.default_rng(1000 + k)
    return torch.from_numpy(rng.uniform(0.5, 2.1, (V, ctx.superblock)).astype(np.float32)).to(
        ctx.device)


def group_inputs(ctx, steps):
    """(states, rc) of each of the first ``steps`` steps of ctx's stage-0
    source group, the states advanced by the plain composition on ctx's
    device (a time-varying group at ``step_rates``)."""
    S = ctx.superblock
    cfg = ctx._compiled._bufsrc_cfg[0]
    w, variant, _ = cfg
    node = ctx._compiled.stages[0][1][0]
    consts, st = ctx._consts, ctx._states["st0"]
    clock = ctx._block_clock(steps * S)
    for k in range(steps):
        rc = RenderContext(ctx._compiled.info, k * S * BLOCK,
                           torch.from_numpy(clock[k * S:(k + 1) * S]).to(ctx.device))
        yield st, rc
        if variant[0] == "resample":
            st, _ = type(node).resample_group_step_plain(
                st, consts["st0/arena"], consts["st0/geom"], step_rates(ctx, k), rc, w)
        elif variant[0] == "poly":
            st, _ = type(node).poly_group_step_plain(
                st, consts["st0/arena"], consts["st0/geom"], rc, w, variant[1], variant[2],
                (consts["st0/poly_w"], consts["st0/poly_b"]))
        else:
            st, _ = type(node).unity_group_step_plain(
                st, consts["st0/arena"], consts["st0/geom"], rc, w, variant[1])


def vibrato_launches(device, steps):
    """The K7 arguments of the vibrato's ungrouped voices (V = 1, S = 32, a
    modulated playbackRate row through K6m; testing/configs.py
    config2_vibrato), as ``process_resample_group`` receives them at each of
    the first ``steps`` steps of a render on ``device``: a list of (states,
    arena, geom, gtab, rate f32[1, S], rc, w), eight a step, the states and
    rates copied."""
    from graphaudio_tpu_torch.testing.configs import config2_vibrato

    node = ga.AudioBufferSourceNode
    process = node.__dict__["process_resample_group"]
    seen = []

    def spy(cls, states, arena, geom, gtab, rate_pb, rc, w):
        seen.append(({k: v.clone() for k, v in states.items()}, arena, geom, gtab,
                     rate_pb.clone(), rc, w))
        return process.__func__(cls, states, arena, geom, gtab, rate_pb, rc, w)

    node.process_resample_group = classmethod(spy)
    try:
        config2_vibrato(superblock=32, device=device).render(steps * 32 * BLOCK)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    finally:
        node.process_resample_group = process
    return seen


def deferred_launches(ctx, steps):
    """The arguments of every deferred prologue launch (a stage whose K8 or
    K10b reads a modulated param, run at its turn) in the first ``steps``
    steps of a render of ``ctx``: a list of (stage key, table, arena, rc),
    the arena copied as the launch reads it (K6m's rows written)."""
    from graphaudio_tpu_torch.core.graph import DEFERRED

    ctx._ensure_compiled()
    ctx._ensure_params_encoded()
    seen = []
    for key, d in ctx._encs[DEFERRED].items():
        def spy(table, arena, rc, key=key, run=d["run"]):
            seen.append((key, table, arena.clone(), rc))
            return run(table, arena, rc)

        d["run"] = spy
    ctx.render(steps * ctx.superblock * BLOCK)
    return seen


def calls_of(module, name, build, steps):
    """The arguments of every call of ``module.name`` (a kernel wrapper a
    node looks up at call time) in the first ``steps`` steps of a render of
    ``build()``: a list of argument tuples, tensors copied, also those of a
    dict argument such as a state the call updates in place (a broadcast
    view, stride 0 somewhere, is kept as it is: its base values stay)."""
    fn = getattr(module, name)
    seen = []

    def keep(a):
        if isinstance(a, dict):
            return {k: keep(v) for k, v in a.items()}
        if not isinstance(a, torch.Tensor) or 0 in a.stride():
            return a
        return a.clone()

    def spy(*args):
        seen.append(tuple(keep(a) for a in args))
        return fn(*args)

    setattr(module, name, spy)
    try:
        ctx = build()
        ctx.render(steps * ctx.superblock * BLOCK)
    finally:
        setattr(module, name, fn)
    return seen
