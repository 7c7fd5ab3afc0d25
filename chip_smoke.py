"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives graphaudio_tpu_torch's main paths on the card and imports
nothing of JAX: BASELINE config 4 (64 looped 44.1 kHz voices -> 147/160
polyphase resampler -> 2 s stereo convolver -> gain -> destination),
BASELINE config 3 (a looped stereo 48 kHz buffer -> four biquads whose
frequency and Q ramp every 3 s -> destination) and BASELINE config 5 (Kit
engine: 128 looped mono voices -> gain -> HRTF spatial panner -> sfx bus
-> reverb send with a 1 s mono IR -> master -> destination), plus a small
occluded scene for the panner's 3-band split. Phases, one line each; any
failure raises and the script exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from graphaudio_tpu_torch/csrc (one nvcc per
     source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes its main path gives it, with the tolerance stated, and the
     median of 50 CUDA-event-timed calls of each (with the wrapper's
     Python) and its kernels' device time under torch.profiler (mean of 20
     calls): K1-K4 at config-4 shapes; K5, K6, K8 and P2 at config-3
     shapes, K5 and K6 also on config 2's 8-voice loop arena and
     exponential ramps, P2 also in the Pallas probe's own 128x128
     constant-pole form; P1 and K10b at config-5
     shapes taken mid-render with moving sources, P1 also in the probe's
     row form beside torch's grouped conv1d; K9 at the occluded scene's
     shapes. Each entry carries the bound (the larger of bytes over HBM
     rate and operations over peak rate) and, where one PyTorch call
     computes the same function, that call's time;
  4. configs 4, 3, 2 and 5 at superblock 4 over 8192 frames against
     tests/goldens/*.npz within 1e-5 max abs;
  5. config 4 at full size (64 voices, 2 s IR, superblock 64, 30 s rounded
     down to whole superblocks) through ``render`` and again through
     ``render_pcm16``: finite, non-silent, pcm16 bit-exact against the
     plain pack of the f32 render, every config-4 kernel launched by that
     run;
  6. config 3 at full size (superblock 32, 30 s rounded down to whole
     superblocks, 351 steps) through ``render``: finite, non-silent, its
     first 8192 frames within 1e-5 of the golden, every config-3 kernel
     launched by that run;
  7. config 5 at full size (128 voices, superblock 32, 351 superblocks)
     through ``render``, five fresh runs (median and spread): finite,
     non-silent, the first 8192 frames within 1e-5 of the golden, P1, K10b
     and the K2/K3/K5 calls launched by the first run; a torch.profiler
     window of 20 steps for the device time per step and per kernel, over
     the unprofiled host time per step for the device busy share;
  8. the occluded scene (config 5's Kit graph, 16 voices with occlusion
     and transmission, superblock 32, 8 steps): K9, P1 and K10b launched,
     within 1e-5 of the same render on the CPU (plain versions).

Each wrapper counts its launches in ``cudabuild.launches`` under its own
name; the counts are set to 0 just before each path's run and read just
after it.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 48000
GOLDENS = {n: os.path.join(ROOT, "tests", "goldens", f"{name}.npz") for n, name in (
    (2, "config2_mix_bus_ramps"), (3, "config3_biquad_eq_chain"), (4, "config4_conv_reverb_64"),
    (5, "config5_spatial_scene_128"))}
REPEATS = 50

# The card's published rates (NVIDIA H100 SXM data sheet, at its 700 W
# limit): HBM bytes/s, f32 and f64 non-tensor-core FLOP/s.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def median_ms(fn, repeats=REPEATS):
    """Median device time of ``fn`` over ``repeats`` launches, each between
    its own pair of CUDA events (after 3 warm-up calls)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, calls=20):
    """Mean device time of one call of ``fn``: the CUDA kernels'
    self time under torch.profiler over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(e, "self_cuda_time_total", 0.0)
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            total_us += t_us
    return total_us / calls / 1e3


def nbytes(*tensors):
    """Bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved_bytes, ops, peak=F32_FLOPS):
    """The least time the card could take: the larger of the bytes that
    must move over the HBM rate and the operations over the peak rate.
    Returns (ms, "bytes" or "operations")."""
    t_bytes, t_ops = moved_bytes / HBM_BYTES_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, route, source, replaces, kernel, plain, tol, bnd, rel=False,
            library=None):
    """Run kernel and plain version on the same inputs, check the error,
    time both (and ``library``, one PyTorch call computing the same
    function, where there is one). ``bnd`` is ``bound(...)`` of the
    kernel's work. Returns the kernel's JSON entry (launches filled later)."""
    import torch

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    if got.dtype.is_floating_point or got.is_complex():
        err = float((got - ref).abs().max().item())
    else:
        err = float((got.to(torch.int32) - ref.to(torch.int32)).abs().max().item())
    tol_abs = tol * max(1.0, float(ref.abs().max().item())) if rel else tol
    ms = median_ms(kernel)
    plain_ms = median_ms(plain)
    library_ms = median_ms(library) if library is not None else None
    dev_ms = device_ms(kernel)
    bound_ms, bound_by = bnd
    ok = err <= tol_abs
    phase("kernels", f"{name}: max_abs_err={err!r} (tolerance {tol_abs!r}{' = %g x max|ref|' % tol if rel else ''}) "
          f"kernel {ms!r} ms a call, {dev_ms!r} ms on the device; plain {plain_ms!r} ms, "
          f"library {library_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol_abs}")
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": dev_ms}


def config3_kernel_checks(dev):
    """K5, K6, K8 and P2 against their plain versions on the card, at the
    shapes config 3 gives them mid-render (superblock 32, step 9: the
    frequency and Q ramps are moving), K5 and K6 also on config 2's 8-voice
    loop arena and exponential ramps, P2 also in the Pallas probe's form.
    Returns the four JSON entries."""
    import torch

    import graphaudio_tpu_torch as gat
    from graphaudio_tpu_torch.core import graph as tgraph
    from graphaudio_tpu_torch.ops import biquad as tbq
    from graphaudio_tpu_torch.ops import param_eval as tpe
    from graphaudio_tpu_torch.ops import unity as tun
    from graphaudio_tpu_torch.testing.configs import config2_mix_bus, config3_eq_chain

    S, step = 32, 9
    T, dt = S * 128, 1.0 / SR

    def mid_render(ctx):
        """K5's arguments and the block clock of step ``step``, the voice
        states advanced through the steps before it."""
        ctx._ensure_compiled()
        ctx._ensure_params_encoded()
        w, variant, _ = ctx._compiled._bufsrc_cfg[0]
        clock = ctx._block_clock((step + 1) * S)
        st = ctx._states["st0"]
        for k in range(step + 1):
            bt = torch.from_numpy(clock[k * S:(k + 1) * S]).to(dev)
            rc = tgraph.RenderContext(ctx._compiled.info, k * T, bt)
            st, args = gat.AudioBufferSourceNode.unity_group_plan(
                st, ctx._consts["st0/geom"], rc, w, variant[1])
        return args, bt

    ctx3, ctx2 = (b(superblock=S, device=dev) for b in (config3_eq_chain, config2_mix_bus))
    (args3, bt3), (args2, bt2) = mid_render(ctx3), mid_render(ctx2)
    arena3, arena2 = ctx3._consts["st0/arena"], ctx2._consts["st0/arena"]

    def k5_bound(arena, args):
        # a copy: each output sample read once from the arena, written once
        out = tun.unity_gather(arena, **args)
        return bound(2 * nbytes(out) + nbytes(*(v for v in args.values() if torch.is_tensor(v))), 0)

    k5 = compare("K5 unity copy (config 3: V=1 C=2 S=32)", "cuda",
                 "graphaudio_tpu_torch/csrc/unity.cu", "graphaudio_tpu/nodes/sources.py:1104",
                 lambda: tun.unity_gather(arena3, **args3),
                 lambda: tun.unity_gather_plain(arena3, **args3), 0.0,
                 bnd=k5_bound(arena3, args3))
    compare("K5 unity copy (config 2: 8-voice loop arena, C=1 S=32)", "cuda",
            "graphaudio_tpu_torch/csrc/unity.cu", "graphaudio_tpu/nodes/sources.py:1104",
            lambda: tun.unity_gather(arena2, **args2),
            lambda: tun.unity_gather_plain(arena2, **args2), 0.0, bnd=k5_bound(arena2, args2))

    enc3, enc2 = ctx3._encs["st2/frequency"], ctx2._encs["st1/gain"]

    def k6_bound(enc, bt):
        # the event table and clock read once, the curve written once; about
        # ten flops a sample to locate its segment and interpolate
        out = tpe.eval_intrinsic_blocked(enc, bt, 128, dt)
        return bound(nbytes(*enc.values(), bt, out), 10 * out.numel())

    k6 = compare("K6 param curve (config 3 frequency: 1 lane, cap 32, a-rate S=32)", "cuda",
                 "graphaudio_tpu_torch/csrc/param_eval.cu", "graphaudio_tpu/ops/param_eval.py:175",
                 lambda: tpe.eval_intrinsic_blocked(enc3, bt3, 128, dt),
                 lambda: tpe.eval_intrinsic_blocked_plain(enc3, bt3, 128, dt), 1e-6, rel=True,
                 bnd=k6_bound(enc3, bt3))
    compare("K6 param curve (config 2 gains: 8 lanes, linear + exponential ramps)", "cuda",
            "graphaudio_tpu_torch/csrc/param_eval.cu", "graphaudio_tpu/ops/param_eval.py:175",
            lambda: tpe.eval_intrinsic_blocked(enc2, bt2, 128, dt),
            lambda: tpe.eval_intrinsic_blocked_plain(enc2, bt2, 128, dt), 1e-6, rel=True,
            bnd=k6_bound(enc2, bt2))

    f = tpe.eval_intrinsic_blocked(enc3, bt3, 128, dt)
    q = tpe.eval_intrinsic_blocked(ctx3._encs["st2/Q"], bt3, 128, dt)
    g = tpe.eval_intrinsic_blocked(ctx3._encs["st2/gain"], bt3, 1, dt).contiguous()

    def flat(outs):
        return torch.cat([torch.view_as_real(o).flatten() if o.is_complex() else o.flatten()
                          for o in outs])

    k8 = compare("K8 RBJ coefficients + pole split (config 3 peaking: V=1 T=4096)", "cuda",
                 "graphaudio_tpu_torch/csrc/biquad.cu", "graphaudio_tpu/ops/biquad.py:43",
                 lambda: flat(tbq.biquad_coefficients("peaking", f, q, g, SR)),
                 lambda: flat(tbq.biquad_coefficients_plain("peaking", f, q, g, SR)),
                 1e-6, rel=True,
                 # f, q, gain in, five coefficient rows out; ~40 flops a sample
                 bnd=bound(nbytes(f, q, g, *tbq.biquad_coefficients("peaking", f, q, g, SR)),
                           40 * f.numel()))

    coeffs = tbq.biquad_coefficients("peaking", f, q, g, SR)
    x = tun.unity_gather(arena3, **args3)  # [1, 2, 4096]
    w1 = torch.tensor([[0.01, -0.02]], device=dev)
    w2 = torch.tensor([[0.005, 0.01]], device=dev)
    p2 = compare("P2 biquad cascade, time-varying (config 3: V=1 C=2 T=4096)", "cuda",
                 "graphaudio_tpu_torch/csrc/first_order.cu",
                 "benchmarks/probes/hrtf_fir_pallas.py:290",
                 lambda: flat(tbq.biquad_apply(x, *coeffs, w1, w2, time_varying=True)),
                 lambda: flat(tbq.biquad_apply_plain(x, *coeffs, w1, w2, time_varying=True)),
                 1e-6, rel=True,
                 # two passes of two complex f64 multiply-adds a sample, plus
                 # the output taps: ~40 f64 flops per sample and channel
                 bnd=bound(nbytes(x, *coeffs, w1, w2)
                           + nbytes(*tbq.biquad_apply(x, *coeffs, w1, w2, time_varying=True)),
                           40 * x.numel(), F64_FLOPS))
    rng = np.random.default_rng(9)
    xr, xi = (torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)).to(dev)
              for _ in range(2))
    mag, ph = rng.uniform(0.5, 0.99, (1, 128)), rng.uniform(-np.pi, np.pi, (1, 128))
    ar, ai = (torch.from_numpy(v.astype(np.float32)).to(dev)
              for v in (mag * np.cos(ph), mag * np.sin(ph)))
    probe = compare("P2 in the probe's form fo_kernel (128x128, constant pole per column)",
                    "cuda", "graphaudio_tpu_torch/csrc/first_order.cu",
                    "benchmarks/probes/hrtf_fir_pallas.py:290",
                    lambda: flat(tbq.first_order_tb(xr, xi, ar, ai)),
                    lambda: flat(tbq.first_order_tb_plain(xr, xi, ar, ai)), 1e-5, rel=True,
                    bnd=bound(nbytes(xr, xi, ar, ai) + 2 * nbytes(xr), 8 * xr.numel()))
    p2["probe_form"] = {k: probe[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "device_ms")}
    for e, name in ((k5, "K5 unity copy"), (k6, "K6 param curve"),
                    (k8, "K8 RBJ coefficients"), (p2, "P2 biquad cascade")):
        e["name"] = name
    return [k5, k6, k8, p2]


def moving_config5(dev, superblock=32):
    """Config 5 with every source moving along the chord to the point a
    quarter turn further round the circle over 3 s (per-quantum position
    automation)."""
    from graphaudio_tpu_torch.testing.configs import config5_spatial_scene

    ctx = config5_spatial_scene(superblock=superblock, device=dev)
    for v, snd in enumerate(ctx._sounds):
        a = 2 * np.pi * v / len(ctx._sounds)
        pan = snd._spatial_panner
        for prm, fn in ((pan.position_x, np.cos), (pan.position_z, np.sin)):
            prm.set_value_at_time(float(5 * fn(a)), 0.0)
            prm.linear_ramp_to_value_at_time(float(5 * fn(a + np.pi / 2)), 3.0)
    return ctx


def occluded_scene(dev, voices=16):
    """Config 5's Kit graph with ``voices`` voices, every one occluded with
    transmission: the panner runs its 3-band split (two K9 crossovers)."""
    from graphaudio_tpu_torch.testing.configs import config5_spatial_scene

    ctx = config5_spatial_scene(superblock=32, voices=voices, device=dev)
    for snd in ctx._sounds:
        snd.occlusion = 0.5
        snd.set_transmission(0.8, 0.4, 0.1)
    return ctx


def config5_kernel_checks(dev):
    """P1 and K10b against their plain versions at config-5 shapes (128
    voices, superblock 32), on the arguments of the fourth step of a render
    whose sources move every quantum; P1 also in the Pallas probe's row form
    (x [4096, 191], h [4096, 128]) beside torch's grouped conv1d, the one
    PyTorch call that computes the probe's function; K9 on the arguments of
    the occluded scene's second step. Returns the three JSON entries."""
    from unittest import mock

    import torch

    from graphaudio_tpu_torch.nodes import spatial as tsp
    from graphaudio_tpu_torch.ops import hrtf as th
    from graphaudio_tpu_torch.ops import onepole as top

    # The panner looks its kernels up in its own module: spies there see
    # the arguments of each call.
    ctx = moving_config5(dev)
    with mock.patch.object(tsp, "hrtf_fir", wraps=tsp.hrtf_fir) as fir, \
            mock.patch.object(tsp, "spatial_gains", wraps=tsp.spatial_gains) as sg:
        ctx.render(4 * 32 * 128)
    fir_args = fir.call_args.args
    x, gain, az, el, blend, grid, ola = fir_args
    V, C, T = x.shape
    E, A, _, L = grid.shape
    moved = float(torch.remainder(az[:, -1] - az[:, 0] + np.pi, 2 * np.pi).sub(np.pi).abs().max())
    p1 = compare(f"P1 HRTF FIR (config 5 step 4: V={V} C={C} S={T // 128} L={L}; "
                 f"azimuth moves up to {moved:.3f} rad in the step)", "cuda",
                 "graphaudio_tpu_torch/csrc/hrtf_fir.cu", "benchmarks/probes/hrtf_fir_pallas.py:127",
                 lambda: torch.cat([o.flatten() for o in th.hrtf_fir(*fir_args)]),
                 lambda: torch.cat([o.flatten() for o in th.hrtf_fir_plain(*fir_args)]), 1e-6,
                 # every input read once (the grid too), output and tail
                 # written once; 2 ears x L multiply-adds per output sample
                 bnd=bound(nbytes(*fir_args) + nbytes(x) * 2 // C + nbytes(ola),
                           V * T * 2 * L * 2))
    rng = np.random.default_rng(15)
    R, F = V * T // 128, 128
    xr = torch.from_numpy(rng.standard_normal((R, F + L - 1)).astype(np.float32)).to(dev)
    hr = torch.from_numpy((rng.standard_normal((R, 2 * L)) * 0.2).astype(np.float32)).to(dev)
    w = hr.reshape(R, 2, L).flip(-1).reshape(2 * R, 1, L).contiguous()
    probe = compare(f"P1 in the probe's form fir_kernel (x [{R}, {F + L - 1}], h [{R}, {2 * L}])",
                    "cuda", "graphaudio_tpu_torch/csrc/hrtf_fir.cu",
                    "benchmarks/probes/hrtf_fir_pallas.py:127",
                    lambda: th.hrtf_fir_rows(xr, hr), lambda: th.hrtf_fir_rows_plain(xr, hr), 1e-6,
                    bnd=bound(nbytes(xr, hr) + R * 2 * F * 4, R * 2 * F * L * 2),
                    library=lambda: torch.nn.functional.conv1d(xr[None], w, groups=R))
    lib = torch.nn.functional.conv1d(xr[None], w, groups=R).reshape(R, 2 * F)
    lib_err = float((th.hrtf_fir_rows(xr, hr) - lib).abs().max())
    phase("kernels", f"P1 probe form vs conv1d: max_abs_err={lib_err!r} (cuDNN, TF32 off)")
    p1["probe_form"] = {k: probe[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "device_ms")}
    p1["probe_form"]["library_max_abs_err"] = lib_err

    pp, listener, model = sg.call_args.args
    k10b = compare(f"K10b spatial gains (config 5 step 4: V={pp.shape[1]} S={pp.shape[2]})", "cuda",
                   "graphaudio_tpu_torch/csrc/spatial_gains.cu",
                   "graphaudio_tpu/nodes/spatial.py:270",
                   lambda: tsp.spatial_gains(pp, listener, model),
                   lambda: tsp.spatial_gains_plain(pp, listener, model), 1e-6,
                   # 17 params in, 6 rows out; ~150 flops per (voice, quantum)
                   # counting each transcendental as ~10
                   bnd=bound(nbytes(pp) + 48 + 6 * pp[0].numel() * 4, 150 * pp[0].numel()))

    occ = occluded_scene(dev)
    with mock.patch.object(tsp, "onepole_lowpass", wraps=tsp.onepole_lowpass) as op:
        occ.render(2 * 32 * 128)
    xo, a, y0 = op.call_args.args
    k9 = compare(f"K9 one-pole lowpass (occluded scene step 2: x {list(xo.shape)}, a={a:.6f})",
                 "cuda", "graphaudio_tpu_torch/csrc/onepole.cu", "graphaudio_tpu/ops/onepole.py:62",
                 lambda: torch.cat([o.flatten() for o in top.onepole_lowpass(xo, a, y0)]),
                 lambda: torch.cat([o.flatten() for o in top.onepole_lowpass_plain(xo, a, y0)]),
                 1e-6, rel=True,
                 # x read once, y written once; two f64 sweeps of a multiply
                 # and an fma (3 flops) per sample
                 bnd=bound(2 * nbytes(xo) + 2 * nbytes(y0), 6 * xo.numel(), F64_FLOPS))
    p1["name"], k10b["name"], k9["name"] = "P1 HRTF FIR", "K10b spatial gains", "K9 one-pole lowpass"
    return [p1, k10b, k9]


def main(device="cuda"):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"python {sys.version.split()[0]}; cards {torch.cuda.device_count()}")

    sys.path.insert(0, ROOT)
    import graphaudio_tpu_torch as gat  # noqa: F401  (sets the TF32 policy)
    from graphaudio_tpu_torch.core import context as tcontext
    from graphaudio_tpu_torch.core import graph as tgraph
    from graphaudio_tpu_torch.core import mixing as tmixing
    from graphaudio_tpu_torch.ops import convolve as tconv
    from graphaudio_tpu_torch.ops import resample as tres
    from graphaudio_tpu_torch.testing.configs import config4_conv_reverb
    from graphaudio_tpu_torch.utils import cudabuild

    dev = torch.device(device)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = cudabuild.build()
    cudabuild.load()
    build_s = time.perf_counter() - t0
    log = lib_path.with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln] \
        if log.is_file() else []
    phase("build", f"{lib_path.name} in {build_s!r} s from {len(cudabuild.sources())} "
          f"sources; ptxas: {' | '.join(regs) or 'cached library, no compiler output'}")

    # -- 3. kernels against their plain versions, main-path shapes ------------
    entries = []
    ctx = config4_conv_reverb(superblock=64, voices=64, device=dev)
    ctx._ensure_compiled()
    S, T = 64, 64 * 128
    st0, consts = ctx._states["st0"], ctx._consts
    w, variant, _ = ctx._compiled._bufsrc_cfg[0]
    _, p, q = variant
    # Mid-render inputs: advance the voice states 3 steps first, so the
    # positions are not all at the buffer start.
    clock = np.add.accumulate(np.full(4 * S, 128.0 / SR) * (np.arange(4 * S) > 0))
    st = st0
    for k in range(4):
        rc = tgraph.RenderContext(ctx._compiled.info, k * T,
                                  torch.from_numpy(clock[k * S:(k + 1) * S]).to(dev))
        st, args = gat.AudioBufferSourceNode.poly_group_plan(
            st, consts["st0/geom"], rc, w, p, q)
    k1_in = dict(arena=consts["st0/arena"], wtab=consts["st0/poly_w"],
                 btab=consts["st0/poly_b"], p=p, q=q, **args)
    voices = tres.poly_resample(**k1_in)  # [64, 1, 8192]
    entries.append(compare(
        "K1 poly resample", "cuda", "graphaudio_tpu_torch/csrc/poly_resample.cu",
        "graphaudio_tpu/nodes/sources.py:1212",
        lambda: tres.poly_resample(**k1_in), lambda: tres.poly_resample_plain(**k1_in),
        1e-6,
        # p/q input samples read per output sample, 4 taps (7 flops) each
        bnd=bound(nbytes(voices) * (1 + p / q) + nbytes(k1_in["wtab"], k1_in["btab"]),
                  7 * voices.numel())))

    rng = np.random.default_rng(0)
    for label, cctx in (("bench shape, grain 1024", ctx),
                        ("128 grain", config4_conv_reverb(superblock=4, voices=1, device=dev))):
        cctx._ensure_compiled()
        si = next(sp["si"] for sp in cctx._compiled.plan if sp["kind"] == "single")
        hr, hi = cctx._consts[f"st{si}/conv_hr"], cctx._consts[f"st{si}/conv_hi"]
        K, P, NB = hr.shape
        B = NB - 1
        L = cctx.superblock * 128 // B
        rev = B != 128
        x = torch.from_numpy(rng.standard_normal((K, L, B)).astype(np.float32) * 0.4).to(dev)
        X = torch.fft.rfft(x, n=2 * B, dim=-1)
        ring0 = torch.from_numpy(rng.standard_normal((2, K, P - 1 + L, NB)).astype(np.float32) * 20).to(dev)
        # The MAC writes the ring; each call gets a fresh copy of the same ring.
        mac_k = lambda: tconv.spectral_mac(X, hr, hi, ring0[0].clone(), ring0[1].clone(), 5, rev)  # noqa: E731
        mac_p = lambda: tconv.spectral_mac_plain(X, hr, hi, ring0[0].clone(), ring0[1].clone(), 5, rev)  # noqa: E731
        e = compare(f"K2a spectral MAC ({label}: K={K} L={L} P={P} bins={NB})", "cuda",
                    "graphaudio_tpu_torch/csrc/conv.cu",
                    "graphaudio_tpu/ops/convolve.py:191" if rev else "graphaudio_tpu/ops/convolve.py:72",
                    mac_k, mac_p, 1e-5, rel=True,
                    # spectra, IR partitions and the ring once, the sum out;
                    # a complex multiply-add (8 flops) per (sub-block, lag, bin)
                    bnd=bound(nbytes(X, hr, hi, ring0, X), 8 * K * L * P * NB))
        yfull = torch.fft.irfft(mac_k(), n=2 * B, dim=-1).contiguous()
        ov0 = torch.from_numpy(rng.standard_normal((K, B)).astype(np.float32)).to(dev)
        f = compare(f"K2b overlap-add ({label}: K={K} L={L} B={B})", "cuda",
                    "graphaudio_tpu_torch/csrc/conv.cu",
                    "graphaudio_tpu/ops/convolve.py:229" if rev else "graphaudio_tpu/ops/convolve.py:120",
                    lambda: tconv.overlap_add(yfull, ov0.clone()),
                    lambda: tconv.overlap_add_plain(yfull, ov0.clone()), 0.0,
                    bnd=bound(nbytes(yfull) + 2 * nbytes(ov0) + K * L * B * 4, K * L * B))
        if rev:
            e["name"], f["name"] = "K2a spectral MAC", "K2b overlap-add"
            entries += [e, f]

    entries.append(compare(
        "K3 lane fan-in ([64, 1, 8192] -> [2, 8192])", "cuda",
        "graphaudio_tpu_torch/csrc/fan_in.cu", "graphaudio_tpu/core/graph.py:1119",
        lambda: tmixing.fan_in_lanes(voices, 2), lambda: tmixing.fan_in_lanes_plain(voices, 2),
        1e-5, bnd=bound(nbytes(voices) + 2 * T * 4, voices.numel()),
        library=lambda: torch.sum(voices, dim=0)))
    entries[-1]["name"] = "K3 lane fan-in"
    n_pack = 175 * T
    audio = torch.from_numpy((rng.standard_normal((2, n_pack)) * 0.5).astype(np.float32)).to(dev)
    entries.append(compare(
        "K4 int16 pack", "cuda", "graphaudio_tpu_torch/csrc/pack.cu",
        "graphaudio_tpu/core/context.py:37",
        lambda: tcontext.pack_int16(audio), lambda: tcontext.pack_int16_plain(audio), 0,
        bnd=bound(nbytes(audio) + audio.numel() * 2, 3 * audio.numel())))
    del ctx

    # -- 3b. the config-3 and config-5 paths' kernels ----------------------------
    entries += config3_kernel_checks(dev)
    entries += config5_kernel_checks(dev)

    # -- 4. goldens ----------------------------------------------------------
    from graphaudio_tpu_torch.testing.configs import (
        config2_mix_bus,
        config3_eq_chain,
        config5_spatial_scene,
    )

    golden_err = {}
    for n, builder in ((4, config4_conv_reverb), (3, config3_eq_chain), (2, config2_mix_bus),
                       (5, config5_spatial_scene)):
        out = builder(superblock=4, device=dev).render(8192)
        golden = np.load(GOLDENS[n])["out"]
        err = float(np.abs(out.astype(np.float64) - golden).max())
        golden_err[n] = err
        phase("golden", f"config {n}, superblock 4, 8192 frames: max_abs_err={err!r} vs "
              f"{os.path.relpath(GOLDENS[n], ROOT)} (tolerance 1e-05)")
        if not (out.shape == golden.shape and err < 1e-5):
            raise AssertionError(f"config-{n} golden mismatch: {err}")

    # -- 5. the config-4 path at full size -------------------------------------
    frames = 175 * T  # 30 s rounded down to whole superblocks (as bench.py does)
    t0 = time.perf_counter()
    warm = config4_conv_reverb(superblock=64, voices=64, device=dev)
    warm.render(T)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    phase("first", f"build graph + first superblock render: {first_s!r} s")
    del warm

    # Each entry's wrapper, by the name it counts its launches on.
    wrappers = {"K1 poly resample": "poly_resample", "K2a spectral MAC": "spectral_mac",
                "K2b overlap-add": "overlap_add", "K3 lane fan-in": "fan_in_lanes",
                "K4 int16 pack": "pack_int16"}
    cudabuild.launches.clear()
    ctx_f = config4_conv_reverb(superblock=64, voices=64, device=dev)
    ctx_f._ensure_compiled()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f32 = ctx_f.render(frames)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    ctx_p = config4_conv_reverb(superblock=64, voices=64, device=dev)
    ctx_p._ensure_compiled()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcm = ctx_p.render_pcm16(frames)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    launches = {name: cudabuild.launches[w] for name, w in wrappers.items()}
    render4 = {"frames": frames, "f32_wall_s": wall_f, "f32_xrt": frames / SR / wall_f}

    rms = float(np.sqrt(np.mean(f32.astype(np.float64) ** 2)))
    seconds = frames / SR
    bd_f, bd_p = ctx_f.stats.last_breakdown, ctx_p.stats.last_breakdown
    phase("render", f"f32: {f32.shape} in {wall_f!r} s = {seconds / wall_f!r} xRT; "
          f"rms {rms!r}; breakdown {json.dumps(bd_f)}")
    phase("render", f"pcm16: {pcm.shape} in {wall_p!r} s = {seconds / wall_p!r} xRT; "
          f"breakdown {json.dumps(bd_p)}")
    if not (f32.shape == (2, frames) and np.isfinite(f32).all() and rms > 0):
        raise AssertionError("f32 render is not finite, non-silent and [2, frames]")
    want = tcontext.pack_int16_plain(torch.from_numpy(f32)).numpy()
    if not np.array_equal(pcm, want):
        raise AssertionError("render_pcm16 differs from the plain pack of the f32 render")
    phase("render", f"pcm16 bit-exact against the plain pack of the f32 render; launches {launches}")
    for e in entries:
        if e["name"] in launches:
            e["launches"] = launches[e["name"]]
            if e["launches"] <= 0:
                raise AssertionError(f"{e['name']} was not launched by the config-4 path")

    # -- 6. the config-3 path at full size -----------------------------------
    T3 = 32 * 128
    frames3 = (30 * SR // T3) * T3  # 351 superblocks
    wrappers3 = {"K5 unity copy": "unity_gather", "K6 param curve": "eval_intrinsic_blocked",
                 "K8 RBJ coefficients": "biquad_coefficients", "P2 biquad cascade": "biquad_apply"}
    warm = config3_eq_chain(superblock=32, device=dev)
    warm.render(T3)
    torch.cuda.synchronize()
    del warm
    cudabuild.launches.clear()
    ctx3 = config3_eq_chain(superblock=32, device=dev)
    ctx3._ensure_compiled()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out3 = ctx3.render(frames3)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    launches3 = {name: cudabuild.launches[w] for name, w in wrappers3.items()}
    rms3 = float(np.sqrt(np.mean(out3.astype(np.float64) ** 2)))
    head_err = float(np.abs(out3[:, :8192].astype(np.float64)
                            - np.load(GOLDENS[3])["out"]).max())
    phase("render", f"config 3 f32: {out3.shape} in {wall3!r} s = {frames3 / SR / wall3!r} xRT; "
          f"rms {rms3!r}; first 8192 frames vs golden max_abs_err={head_err!r}; "
          f"breakdown {json.dumps(ctx3.stats.last_breakdown)}; launches {launches3}")
    if not (out3.shape == (2, frames3) and np.isfinite(out3).all() and rms3 > 0
            and head_err < 1e-5):
        raise AssertionError("config-3 render is not finite, non-silent, [2, frames] "
                             "and within 1e-5 of the golden at its start")
    for e in entries:
        if e["name"] in launches3:
            e["launches"] = launches3[e["name"]]
            if e["launches"] <= 0:
                raise AssertionError(f"{e['name']} was not launched by the config-3 path")

    # -- 7. the config-5 path at full size -----------------------------------
    T5 = 32 * 128
    frames5 = (30 * SR // T5) * T5  # 351 superblocks
    wrappers5 = {"P1 HRTF FIR": "hrtf_fir", "K10b spatial gains": "spatial_gains",
                 "K2a spectral MAC": "spectral_mac", "K2b overlap-add": "overlap_add",
                 "K3 lane fan-in": "fan_in_lanes", "K5 unity copy": "unity_gather",
                 "K6 param curve": "eval_intrinsic_blocked"}
    warm = config5_spatial_scene(superblock=32, device=dev)
    warm.render(T5)
    torch.cuda.synchronize()
    del warm
    walls5 = []
    for run in range(5):
        ctx5 = config5_spatial_scene(superblock=32, device=dev)
        ctx5._ensure_compiled()
        if run == 0:
            cudabuild.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out5 = ctx5.render(frames5)
        torch.cuda.synchronize()
        walls5.append(time.perf_counter() - t0)
        if run == 0:
            launches5 = {name: cudabuild.launches[w] for name, w in wrappers5.items()}
            first5, bd5 = out5, ctx5.stats.last_breakdown
        del ctx5
    rms5 = float(np.sqrt(np.mean(first5.astype(np.float64) ** 2)))
    head_err5 = float(np.abs(first5[:, :8192].astype(np.float64)
                             - np.load(GOLDENS[5])["out"]).max())
    wall5 = statistics.median(walls5)
    phase("render", f"config 5 f32: {first5.shape}; five runs {walls5!r} s, median {wall5!r} s = "
          f"{frames5 / SR / wall5!r} xRT; rms {rms5!r}; first 8192 frames vs golden "
          f"max_abs_err={head_err5!r}; first run breakdown {json.dumps(bd5)}; launches {launches5}")
    if not (first5.shape == (2, frames5) and np.isfinite(first5).all() and rms5 > 0
            and head_err5 < 1e-5):
        raise AssertionError("config-5 render is not finite, non-silent, [2, frames] "
                             "and within 1e-5 of the golden at its start")
    for name in ("P1 HRTF FIR", "K10b spatial gains", "K2a spectral MAC", "K3 lane fan-in",
                 "K5 unity copy"):
        if launches5[name] <= 0:
            raise AssertionError(f"{name} was not launched by the config-5 path")

    # Device time per step and per kernel over a window of 20 steps under
    # torch.profiler; the busy share divides it by the unprofiled host time
    # per step (the median run above), since the profiler slows the host.
    from torch.profiler import ProfilerActivity, profile

    ctxp = config5_spatial_scene(superblock=32, device=dev)
    ctxp.render(2 * T5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctxp.render(20 * T5)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    per_kernel = {}
    for e in prof.key_averages():
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(e, "self_cuda_time_total", 0.0)
        if t_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            per_kernel[e.key] = (t_us / 20.0, e.count / 20.0)
    device_us = sum(t for t, _ in per_kernel.values())
    top_kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    host_us5 = wall5 / (frames5 // T5) * 1e6
    profile5 = {"profiled_host_us_per_step": window_s / 20.0 * 1e6,
                "device_us_per_step": device_us, "device_busy": device_us / host_us5,
                "launches_per_step": sum(c for _, c in per_kernel.values()),
                "top_kernels_us_per_step": {k: round(t, 3) for k, (t, _) in top_kernels}}
    phase("profile", f"config 5, 20 steps under torch.profiler: {json.dumps(profile5)}")
    del ctxp, prof

    # -- 8. the occluded scene -------------------------------------------------
    wrappers_occ = {"K9 one-pole lowpass": "onepole_lowpass", "P1 HRTF FIR": "hrtf_fir",
                    "K10b spatial gains": "spatial_gains"}
    occ = occluded_scene(dev)
    occ._ensure_compiled()
    cudabuild.launches.clear()
    out_occ = occ.render(8 * T5)
    torch.cuda.synchronize()
    launches_occ = {name: cudabuild.launches[w] for name, w in wrappers_occ.items()}
    ref_occ = occluded_scene("cpu").render(8 * T5)
    err_occ = float(np.abs(out_occ.astype(np.float64) - ref_occ).max())
    phase("render", f"occluded scene (16 voices, superblock 32, 8 steps): max_abs_err={err_occ!r} "
          f"vs the CPU render (tolerance 1e-05), peak {float(np.abs(ref_occ).max())!r}; "
          f"launches {launches_occ}")
    if not (np.isfinite(out_occ).all() and err_occ < 1e-5 and np.abs(ref_occ).max() > 1e-3):
        raise AssertionError("the occluded scene differs from its CPU render or is silent")
    for name, n in launches_occ.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the occluded scene")
    for e in entries:
        if e["name"] in ("P1 HRTF FIR", "K10b spatial gains"):
            e["launches"] = launches5[e["name"]]
        elif e["name"] == "K9 one-pole lowpass":
            e["launches"] = launches_occ[e["name"]]

    print(json.dumps({"kernels": entries, "render": {
        "config4": dict(render4, pcm16_wall_s=wall_p, pcm16_xrt=seconds / wall_p,
                        first_render_s=first_s, golden_max_abs_err=golden_err[4]),
        "config3": {"frames": frames3, "f32_wall_s": wall3, "f32_xrt": frames3 / SR / wall3,
                    "golden_max_abs_err": golden_err[3], "head_vs_golden": head_err},
        "config5": {"frames": frames5, "f32_wall_s": walls5, "f32_wall_median_s": wall5,
                    "f32_xrt_median": frames5 / SR / wall5,
                    "f32_xrt_range": [frames5 / SR / max(walls5), frames5 / SR / min(walls5)],
                    "host_us_per_step_median": host_us5,
                    "golden_max_abs_err": golden_err[5], "head_vs_golden": head_err5,
                    "launches": launches5, "profile": profile5},
        "occluded": {"max_abs_err_vs_cpu": err_occ, "launches": launches_occ},
        "config2_golden_max_abs_err": golden_err[2],
        "build_s": build_s, "card": smi}}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
