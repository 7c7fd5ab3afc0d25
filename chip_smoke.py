"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives graphaudio_tpu_torch's two main paths on the card and imports
nothing of JAX: BASELINE config 4 (64 looped 44.1 kHz voices -> 147/160
polyphase resampler -> 2 s stereo convolver -> gain -> destination) and
BASELINE config 3 (a looped stereo 48 kHz buffer -> four biquads whose
frequency and Q ramp every 3 s -> destination). Phases, one line each; any
failure raises and the script exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from graphaudio_tpu_torch/csrc (one nvcc per
     source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes its main path gives it, with the tolerance stated, and the
     median of 50 CUDA-event-timed repeats of each: K1-K4 at config-4
     shapes; K5, K6, K8 and P2 at config-3 shapes, K5 and K6 also on
     config 2's 8-voice loop arena and exponential ramps, P2 also in the
     Pallas probe's own 128x128 constant-pole form;
  4. configs 4, 3 and 2 at superblock 4 over 8192 frames against
     tests/goldens/*.npz within 1e-5 max abs;
  5. config 4 at full size (64 voices, 2 s IR, superblock 64, 30 s rounded
     down to whole superblocks) through ``render`` and again through
     ``render_pcm16``: finite, non-silent, pcm16 bit-exact against the
     plain pack of the f32 render, every config-4 kernel launched by that
     run;
  6. config 3 at full size (superblock 32, 30 s rounded down to whole
     superblocks, 351 steps) through ``render``: finite, non-silent, its
     first 8192 frames within 1e-5 of the golden, every config-3 kernel
     launched by that run.

Each main path's launch counts are set to 0 just before its full-size run
and read just after it.

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
    (2, "config2_mix_bus_ramps"), (3, "config3_biquad_eq_chain"), (4, "config4_conv_reverb_64"))}
REPEATS = 50


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


def compare(name, route, source, replaces, kernel, plain, tol, rel=False):
    """Run kernel and plain version on the same inputs, check the error,
    time both. Returns the kernel's JSON entry (launches filled later)."""
    import torch

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    if got.dtype.is_floating_point or got.is_complex():
        err = float((got - ref).abs().max().item())
    else:
        err = float((got.to(torch.int32) - ref.to(torch.int32)).abs().max().item())
    bound = tol * max(1.0, float(ref.abs().max().item())) if rel else tol
    ms = median_ms(kernel)
    plain_ms = median_ms(plain)
    ok = err <= bound
    phase("kernels", f"{name}: max_abs_err={err!r} (tolerance {bound!r}{' = %g x max|ref|' % tol if rel else ''}) "
          f"kernel {ms!r} ms, plain {plain_ms!r} ms {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {bound}")
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    k5 = compare("K5 unity copy (config 3: V=1 C=2 S=32)", "cuda",
                 "graphaudio_tpu_torch/csrc/unity.cu", "graphaudio_tpu/nodes/sources.py:1104",
                 lambda: tun.unity_gather(arena3, **args3),
                 lambda: tun.unity_gather_plain(arena3, **args3), 0.0)
    compare("K5 unity copy (config 2: 8-voice loop arena, C=1 S=32)", "cuda",
            "graphaudio_tpu_torch/csrc/unity.cu", "graphaudio_tpu/nodes/sources.py:1104",
            lambda: tun.unity_gather(arena2, **args2),
            lambda: tun.unity_gather_plain(arena2, **args2), 0.0)

    enc3, enc2 = ctx3._encs["st2/frequency"], ctx2._encs["st1/gain"]
    k6 = compare("K6 param curve (config 3 frequency: 1 lane, cap 32, a-rate S=32)", "cuda",
                 "graphaudio_tpu_torch/csrc/param_eval.cu", "graphaudio_tpu/ops/param_eval.py:175",
                 lambda: tpe.eval_intrinsic_blocked(enc3, bt3, 128, dt),
                 lambda: tpe.eval_intrinsic_blocked_plain(enc3, bt3, 128, dt), 1e-6, rel=True)
    compare("K6 param curve (config 2 gains: 8 lanes, linear + exponential ramps)", "cuda",
            "graphaudio_tpu_torch/csrc/param_eval.cu", "graphaudio_tpu/ops/param_eval.py:175",
            lambda: tpe.eval_intrinsic_blocked(enc2, bt2, 128, dt),
            lambda: tpe.eval_intrinsic_blocked_plain(enc2, bt2, 128, dt), 1e-6, rel=True)

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
                 1e-6, rel=True)

    coeffs = tbq.biquad_coefficients("peaking", f, q, g, SR)
    x = tun.unity_gather(arena3, **args3)  # [1, 2, 4096]
    w1 = torch.tensor([[0.01, -0.02]], device=dev)
    w2 = torch.tensor([[0.005, 0.01]], device=dev)
    p2 = compare("P2 biquad cascade, time-varying (config 3: V=1 C=2 T=4096)", "cuda",
                 "graphaudio_tpu_torch/csrc/first_order.cu",
                 "benchmarks/probes/hrtf_fir_pallas.py:290",
                 lambda: flat(tbq.biquad_apply(x, *coeffs, w1, w2, time_varying=True)),
                 lambda: flat(tbq.biquad_apply_plain(x, *coeffs, w1, w2, time_varying=True)),
                 1e-6, rel=True)
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
                    lambda: flat(tbq.first_order_tb_plain(xr, xi, ar, ai)), 1e-5, rel=True)
    p2["probe_form"] = {k: probe[k] for k in ("max_abs_err", "ms", "plain_ms")}
    for e, name in ((k5, "K5 unity copy"), (k6, "K6 param curve"),
                    (k8, "K8 RBJ coefficients"), (p2, "P2 biquad cascade")):
        e["name"] = name
    return [k5, k6, k8, p2]


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
    entries.append(compare(
        "K1 poly resample", "cuda", "graphaudio_tpu_torch/csrc/poly_resample.cu",
        "graphaudio_tpu/nodes/sources.py:1212",
        lambda: tres.poly_resample(**k1_in), lambda: tres.poly_resample_plain(**k1_in),
        1e-6))
    voices = tres.poly_resample(**k1_in)  # [64, 1, 8192]

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
                    mac_k, mac_p, 1e-5, rel=True)
        yfull = torch.fft.irfft(mac_k(), n=2 * B, dim=-1).contiguous()
        ov0 = torch.from_numpy(rng.standard_normal((K, B)).astype(np.float32)).to(dev)
        f = compare(f"K2b overlap-add ({label}: K={K} L={L} B={B})", "cuda",
                    "graphaudio_tpu_torch/csrc/conv.cu",
                    "graphaudio_tpu/ops/convolve.py:229" if rev else "graphaudio_tpu/ops/convolve.py:120",
                    lambda: tconv.overlap_add(yfull, ov0.clone()),
                    lambda: tconv.overlap_add_plain(yfull, ov0.clone()), 0.0)
        if rev:
            e["name"], f["name"] = "K2a spectral MAC", "K2b overlap-add"
            entries += [e, f]

    entries.append(compare(
        "K3 lane fan-in ([64, 1, 8192] -> [2, 8192])", "cuda",
        "graphaudio_tpu_torch/csrc/fan_in.cu", "graphaudio_tpu/core/graph.py:1119",
        lambda: tmixing.fan_in_lanes(voices, 2), lambda: tmixing.fan_in_lanes_plain(voices, 2),
        1e-5))
    entries[-1]["name"] = "K3 lane fan-in"
    n_pack = 175 * T
    audio = torch.from_numpy((rng.standard_normal((2, n_pack)) * 0.5).astype(np.float32)).to(dev)
    entries.append(compare(
        "K4 int16 pack", "cuda", "graphaudio_tpu_torch/csrc/pack.cu",
        "graphaudio_tpu/core/context.py:37",
        lambda: tcontext.pack_int16(audio), lambda: tcontext.pack_int16_plain(audio), 0))
    del ctx

    # -- 3b. the config-3 path's kernels ---------------------------------------
    entries += config3_kernel_checks(dev)

    # -- 4. goldens ----------------------------------------------------------
    from graphaudio_tpu_torch.testing.configs import config2_mix_bus, config3_eq_chain

    golden_err = {}
    for n, builder in ((4, config4_conv_reverb), (3, config3_eq_chain), (2, config2_mix_bus)):
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

    wrappers = (tres.poly_resample, tconv.spectral_mac, tconv.overlap_add,
                tmixing.fan_in_lanes, tcontext.pack_int16)
    for fn in wrappers:
        fn.launches = 0
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
    launches = {fn.__name__: fn.launches for fn in wrappers}
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
    by_wrapper = {"K1 poly resample": "poly_resample", "K2a spectral MAC": "spectral_mac",
                  "K2b overlap-add": "overlap_add", "K3 lane fan-in": "fan_in_lanes",
                  "K4 int16 pack": "pack_int16"}
    for e in entries:
        if e["name"] in by_wrapper:
            e["launches"] = launches[by_wrapper[e["name"]]]
            if e["launches"] <= 0:
                raise AssertionError(f"{e['name']} was not launched by the config-4 path")


    # -- 6. the config-3 path at full size -----------------------------------
    from graphaudio_tpu_torch.ops import biquad as tbq
    from graphaudio_tpu_torch.ops import param_eval as tpe
    from graphaudio_tpu_torch.ops import unity as tun

    T3 = 32 * 128
    frames3 = (30 * SR // T3) * T3  # 351 superblocks
    wrappers3 = {"K5 unity copy": tun.unity_gather, "K6 param curve": tpe.eval_intrinsic_blocked,
                 "K8 RBJ coefficients": tbq.biquad_coefficients,
                 "P2 biquad cascade": tbq.biquad_apply}
    warm = config3_eq_chain(superblock=32, device=dev)
    warm.render(T3)
    torch.cuda.synchronize()
    del warm
    for fn in wrappers3.values():
        fn.launches = 0
    ctx3 = config3_eq_chain(superblock=32, device=dev)
    ctx3._ensure_compiled()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out3 = ctx3.render(frames3)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    launches3 = {name: fn.launches for name, fn in wrappers3.items()}
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

    print(json.dumps({"kernels": entries, "render": {
        "config4": dict(render4, pcm16_wall_s=wall_p, pcm16_xrt=seconds / wall_p,
                        first_render_s=first_s, golden_max_abs_err=golden_err[4]),
        "config3": {"frames": frames3, "f32_wall_s": wall3, "f32_xrt": frames3 / SR / wall3,
                    "golden_max_abs_err": golden_err[3], "head_vs_golden": head_err},
        "config2_golden_max_abs_err": golden_err[2],
        "build_s": build_s, "card": smi}}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
