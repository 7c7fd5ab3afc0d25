"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives graphaudio_tpu_torch's main paths on the card and imports
nothing of JAX: BASELINE config 4 (64 looped 44.1 kHz voices -> 147/160
polyphase resampler -> 2 s stereo convolver -> gain -> destination),
BASELINE config 3 (a looped stereo 48 kHz buffer -> four biquads whose
frequency and Q ramp every 3 s -> destination) and BASELINE config 5 (Kit
engine: 128 looped mono voices -> gain -> HRTF spatial panner -> sfx bus
-> reverb send with a 1 s mono IR -> master -> destination), config 5's
scene with every voice occluded (the panner's 3-band split), config 4
delivered as G.711 mu-law and IMA ADPCM, BASELINE config 6 (64 looped
voices, each gain modulated by its own oscillator), and the paths of a
time-varying rate: config 4 with ramped playbackRates, config 6 with swept
LFO frequencies and a vibrato on config 2's voices, and the paths of
phase 12 (a modulated biquad frequency and panner position, the Kit's
step-linear mode, a ping-pong delay send), in phase 13, config 5's
scene with a streamed music track and ambience and, in phase 14, config
5's scene on a measured-like HRIR set past 128 taps. Phases, one line each;
any failure raises and the script exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from graphaudio_tpu_torch/csrc (one nvcc per
     source, in parallel) and the native codec (g++); the device time of a
     one-element fill, the floor under every kernel's;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes its main path gives it, with the tolerance stated, and the
     median of 50 CUDA-event-timed calls of each (with the wrapper's
     Python) and its kernels' device time under torch.profiler (mean of 20
     calls, over the windows that lost no kernel events): K1 and K5 as
     whole voice-group steps through ``process_poly_group`` and
     ``process_unity_group``, mid-render, audio and new states bit for bit
     (K1 at config 4, K5 at configs 3, 2 and 5; the bound is the whole
     step's bytes); K2-K4 at config-4 shapes, K2 also at config 5's reverb
     send and the 128 grain (K2a beside one einsum over the unfolded delay
     line), K2b also with a true-stereo 4-channel IR's combine and beside
     ``torch.nn.functional.fold``, K3 also at the largest shape a config-5
     step gives it; K6, K8
     and P2 at config-3 shapes; K6 and K8 batched
     as the step launches them, bit for bit: K6 on config 3's step table
     (8 rows, capacity 32, the four biquads one pipe: each lane's rows at
     its own clock of a [4, S] clock matrix) and config 2's (8 lanes of
     linear and exponential gain ramps), K8 on config 3's pipe (four rows,
     a type each) and on eight stages of all eight filter types as data,
     and both through their one-entry names (one param, one stage of the
     unfused graph); P2 over the pipe's four lanes, and at one lane,
     with constant poles, on eight lanes, and in the Pallas probe's own
     128x128 constant-pole form; P1 and K10b at config-5 shapes taken
     mid-render with moving sources, P1 also in the probe's row form beside
     torch's grouped conv1d, K10b as the step's one batched launch (also
     over two panner groups under two distance models) and bit for bit
     against its one-entry name; K9's band split (both crossovers and the
     band combine, one launch) against its plain version at the
     full-size occluded scene's step-2 arguments and at S = 1, 4, 64 and
     one mono shape, and its one-pole mode at the same input; K4mu and K4a
     bit for bit at config 4's launch chunk (K4mu also timed cold, its
     inputs rotated through more than the card's L2; K4a with carry_len 0,
     1 and 504), K11 (four waveforms, base values and rows, within 1e-6; its
     constant-source mode bit for bit) and K6m (a-rate, k-rate, stereo
     CHAIN, explicit rows; bit for bit) at config 6's shapes; K7 (the
     time-varying resampler's group step) at config4_pitched's step, at
     one voice (S = 1, 4, 16, 64, a loop seam inside the step), stereo,
     the edge-case group and the vibrato's ungrouped launch (V = 1, S =
     32, its modulated rate row), the audio and the new states bit for
     bit, timed warm and cold (the arena out of the L2);
     K6's exact rows in config4_pitched's and config6_swept's step tables
     bit for bit and in a table of every curve type within one f32 ulp;
     K4a's streamed path at spb 65521 stereo and 131057 mono bit for bit
     the host encoder, timed by CUDA events over bursts. Each entry
     carries the bound (the larger of bytes over HBM rate and operations
     over peak rate) and, where one PyTorch call computes the same
     function, that call's time; K3's host time a call beside torch.sum's;
  4. configs 4, 3, 2, 5 and 6 at superblock 4 over 8192 frames against
     tests/goldens/*.npz within 1e-5 max abs;
  5. config 4 at full size (64 voices, 2 s IR, superblock 64, 30 s rounded
     down to whole superblocks) through ``render`` and again through
     ``render_pcm16``: finite, non-silent, pcm16 bit-exact against the
     plain pack of the f32 render, every config-4 kernel launched by those
     two runs, K1 and K2b once a step; four more f32 runs for the spread; a
     profiler window as for config 3, and the step's PyTorch ops by source
     line (``attribute_ops``);
  6. config 3 at full size (superblock 32, 30 s rounded down to whole
     superblocks, 351 steps) through ``render``, five fresh runs: finite,
     non-silent, the first 8192 frames within 1e-5 of the golden, every
     config-3 kernel launched by the first run, K5 once a step, K6, K8 and
     P2 once a row (the four biquads are one pipe of delay 3: 351 steps
     and 3 drain rows), the same render unfused bit for bit the same; a
     torch.profiler window of 20 steps for the device time per step, per
     kernel and per group (K6, K8), over the unprofiled host time per step
     for the device busy share; the step's PyTorch ops by source line;
  7. config 5 at full size (128 voices, superblock 32, 351 superblocks)
     through ``render``, five fresh runs: finite, non-silent, the first
     8192 frames within 1e-5 of the golden, P1, K10b and the K2/K3/K5
     calls launched by the first run, K5, K10b and K2b once a step; a
     profiler window and the ops by source line as for config 3;
  8. the occluded scene (config 5's Kit graph, every voice occluded with
     transmission, superblock 32): 16 voices for 8 steps within 1e-5 of
     the same render on the CPU (plain versions), K9, P1 and K10b
     launched; then all 128 voices for 351 superblocks through
     ``render``, five fresh runs (``render_runs``): finite, non-silent,
     the first 8 superblocks within 1e-5 of the CPU render, the band
     split once a step (one occluded panner stage), a profile window and
     the ops by source line;
  9. config 4 at full size through ``render_mulaw`` and ``render_adpcm``,
     five fresh runs each: bit for bit the host encoders of phase 5's f32
     render, K4mu or K4a once a launch chunk, the xRT spread, the wire
     bytes and each format's SNR against the f32 render;
 10. config 6 at full size (superblock 32, 351 superblocks), modulated and
     not, five fresh runs each (``render_runs``): the modulated one's
     first 8192 frames within 1e-5 of the golden, the other's within 1e-5
     of its CPU render, K11 once a step in both and K6m once a step in the
     modulated one;
 11. config4_pitched (config 4, each playbackRate ramped between 0.84 and
     1.19 every 2 s: one K7 and one K6 launch a step) and config6_swept
     (config 6, each LFO frequency ramped between f_v and 2 f_v every 3 s:
     K6's exact a-rate rows feeding K11) at full size, and the vibrato
     (config 2's 8 voices, a sine LFO on each playbackRate, one voice
     pushed past its window's bound by a constant: 8 ungrouped K7
     launches a step) at 64 superblocks,
     three runs each (``render_runs``), the first run within 1e-5 of the
     same graph's CPU render (config4_pitched and config6_swept over their
     first 8 superblocks, the vibrato over all 64); xRT, device us and
     launches a step and the sha256 of each;
 12. a modulated param that a stage's prologue reads, and item 10: K8 and
     K10b launched the new way (a one-item table at the stage's turn,
     reading K6m's reserved K6 arena rows) at config3_wah's four biquad
     stages and config5_orbit's panner group, bit for bit; K12 (the delay,
     in place) at config4_pingpong's two delays and at d < T, d > T, d =
     L, d = 0, T >= L, a stride-0 input, mono and stereo, bit for bit (the
     output, the ring and its JAX view, both cursors), its bound counted
     from the bytes each case's data needs; K13 (the stereo panner) at
     config5_steplinear's and config4_pingpong's steps and both laws at pan
     -1, 0, 1 and across the range, within one ulp; then config3_wah (an
     LFO on each biquad's frequency), config5_orbit (an LFO on each
     panner's positionX), config5_steplinear (the Kit's step-linear mode)
     and config4_pingpong (a ping-pong delay send) at full size, five 30 s
     runs each (``render_runs``), their first 8 superblocks within 1e-5 of
     their CPU renders, the kernels' launches a step checked;
 13. audio IO: K15 (the stream node's feed read, one launch a stream node
     a render call) bit for bit against its plain version over
     config5_streamed's two stream nodes in a 351-step call (the 44.1 kHz
     music resampled, the ambience's unity copy) and over calls at S = 1
     and 64, mono, rates 0.5 and 3.0 and a stream that runs out; then
     config5_streamed (config 5's Kit scene plus a streamed FLAC music
     track and a looped WAV ambience, their files written by the port's
     encoders and read through the Kit's data provider and the native
     codec, which must load) and config 5 beside it, five 30 s runs each
     (``stream_runs``), the streamed scene's first 8 superblocks within
     1e-5 of its CPU render, its sha256 and config 5's the recorded ones,
     K15 once a call for each stream node, K15's device time in a 30 s
     render, the call's peak device memory, and the feeds' staging costs a
     call (``prepare_feed`` with its decoding, the copy from pinned
     memory);
 14. a measured HRIR set past 128 taps: the input pass (the gain, the
     channel mean and the transform's zero half), K10p-a (the partitioned
     filter's spectral MAC, each partition's spectrum interpolated in the
     kernel once per direction run) and K10p-b (the inverse's scale, the
     overlap-add and the blend) against their plain versions within 1e-6 x
     max|ref| (bit for bit reported) on the fourth step of
     config5_measured with every source moving and with every source
     still (128 voices, superblock 32) at P = 2 (the loader's default 256
     taps of a 512-tap 44.1 kHz set) and P = 8 (1024 taps), K10p-a warm
     and cold on each, the moving steps beside one PyTorch call (an einsum
     over the interpolated spectra materialized beforehand; ``fold`` for
     the overlap-add), and at S = 1 and 4 with P = 8, one voice, a stereo
     input, the occluded route, P = 3, directions still and in runs of 1-5
     quanta at P = 2 and 8; then config5_measured at P = 2 and P = 8 at
     full size, five 30 s runs each (``measured_runs``): the first 8
     superblocks within 1e-5 of the CPU render, one input pass, one K10p-a
     and one K10p-b launch a step for each panner stage and no P1 launch.

 15. the realtime context (``realtime_phase``): configs 4 and 5 at full
     width built into a ``RealtimeAudioContext`` at superblock 2 (no
     render thread, the null output device), 64 steps of
     ``render_step_blocking`` bit for bit the same graph's unfused
     ``OfflineAudioContext`` render and within 1e-5 of its CPU render over
     8 steps, the step replayed as its CUDA graph (core/stepgraph.py) from
     the fourth (each run must replay it; captures, replays and any refusal
     printed); K2a against its plain version at the step's shape (its plan
     printed: the small-grain tiles); the same 64 steps pipelined as the
     render thread runs them (launch k+1, finish k) bit for bit, with the
     share of finishes at which the next step was still running and the
     synchronizing calls torch's sync debug mode caught in the launches
     and the finishes; config 5 live on its render thread, twice, for 10 s
     of wall time each into the native ring and the null output device,
     in a fresh process of this script (``--live-child``: a torch.profiler
     session leaves CUPTI's callbacks on every later CUDA call of its
     process, and the phases before open dozens; after them the child
     reads a torch op's host cost before and after one profiler session
     and runs config 5 live once more, 4 s, not gated):
     frames played and underrun, in the first second and after it (none
     allowed after it: the run raises), steps rendered, the host walls of
     launch, finish and launch-to-finish (p50, p99), every launch over 10
     ms with its parts, the render thread's CPU time in it and the garbage
     collections inside it, the ring's waits over 10 ms, the collections
     of each generation, the launch's per-call checks, the step graph's
     counts, the last render error (none allowed), a 20-step
     profile of single-step calls, the startup latency probe and the
     superblock ``auto_tune`` would pick; checkpoint resume
     (``utils.save_context_state`` / ``load_context_state``) of config 5 at
     superblock 32 and of config 3 fused, 8 superblocks bit for bit.
 16. multi-device rendering (``mesh_phase``): K14a (the convolver's
     partition-slice MAC) at config 4's part-sharded shapes and K14b (the
     partitioned HRTF's) at a 1024-tap per-node HRIR, every rank's slice of
     part = 2 and 4 within 1e-6 x max|ref| of its plain version (bit for
     bit reported) and the slices' sum within 1e-5 x max|ref| of the
     unsliced MAC; then four ranks on the card (gloo with CUDA tensors on
     one card, since NCCL refuses two ranks on one GPU; NCCL with a card a
     rank) render config 4 and config5_part_hrir (config 5 with 8
     panners on their own 1024-tap HRIR) at full width on a voice 2 x part
     2 mesh, 8 superblocks, every rank's audio equal and within 1e-5 of the
     single-card and the CPU render, with the sharding, the launches, the
     host and all_reduce ms a step; and ``ShardedVoiceScene`` (64 voices,
     2 s IR, superblock 8, 4 steps) within 1e-5 of its numpy mirror.
 17. the examples (``examples_phase``): every twin of
     graphaudio_tpu_torch/examples through its ``main`` on the card, twice,
     held to its own run on the CPU within 1e-5 max abs (offline_mixdown,
     timed_automation with its graph rebuilt at 2 s inside one render
     call, game_audio's 60 Kit ticks of 2400 frames, measured_hrtf_flac
     with its 24-bit FLAC round trip lossless, pcm_delivery_opus with its
     int16 bit for bit the plain pack of the card's f32 render of the same
     scene), the second run equal to the first, each with its wall and
     xRT, graph builds and the kernels it launched; then multichip_scene
     on four ranks of the card over gloo, the ranks equal and within 1e-5
     of the scene on one CPU context.
Each of ``--k2a``, ``--p1``, ``--k6k8``, ``--k1k5``, ``--k2bk10b`` and
``--k9`` runs phases 1 and 2, one kernel pair's checks and three 30 s
renders of the configs that run it, each render with its profile window
and its ops by source line (``render_runs``): K2 and config 4; P1 and config 5; K6 and
K8 through their one-entry names and config 3; K1 and K5 as group steps
through the public ``process_*_group`` names, the goldens and configs 4, 3
and 5; K2a and K2b at four shapes and K10b at two (a tree without the
batched K10b through its one-entry calls), the goldens and configs 4 and
5; the K9 checks (a tree without the band split timed as its panner
ran it: two one-pole launches and the torch combine), the goldens, the
full-size occluded scene and configs 4 and 5. ``--wire6`` runs phases 1
and 2, the K4mu, K4a, K11 and K6m checks, the goldens and phases 9 and 10
(after one 30 s f32 render of config 4). ``--k11k4a`` runs the K4a, K11
and K6m checks, the goldens, three 30 s ``render_adpcm`` of config 4 and
three 30 s renders each of config 6 modulated and not. ``--k7`` runs the
K7, K6 exact-row and K4a streamed-path checks, the goldens and phase 11.
``--mod8b`` runs the deferred K8 and K10b checks, the goldens and phase
12's config3_wah and config5_orbit; ``--item10`` the K12 and K13 checks,
the goldens and phase 12's config5_steplinear and config4_pingpong.
``--pipe`` runs the goldens and config 3 fused and unfused, five 30 s
renders each, alternated, every hash the unfused trees' config-3 hash,
with P2's launches, host and device time a step (``pipe_runs``).
``--stream`` runs phase 13 alone. ``--hrtfpart`` runs phase 14, the
goldens and three 30 s renders of config 5 (its recorded sha256).
``--realtime`` runs phase 15 alone, ``--mesh`` phase 16 alone,
``--examples`` phase 17 alone.
``--k10pa`` times K10p-a alone, warm and cold, at config5_measured's
fourth step and five seeded cases (``k10pa_times``; copied into the tree
that first had K10p, it times that tree's kernel the same way).
``--k4mu`` runs
K4mu at config 4's launch chunk and last chunk, a ragged T (scalar
loads), mono, three channels (through shared memory) and a base one float
off a 16-byte boundary, each bit for bit, warm and cold, and three 30 s
``render_mulaw`` of config 4 (each bit for bit the host encoder of an
f32 render and hashed, K4mu once a launch chunk) plus one under the
profiler for K4mu's device time a launch in the render. They print the launches and
host time a step, the device time a step by kernel group (the groups'
substrings match the kernel names of older trees too) and each first
render's sha256. Copied into another tree's checkout, each times that
tree's kernels the same way.

Each wrapper counts its launches in ``cudabuild.launches`` under its own
name; the counts are set to 0 just before each path's run and read just
after it.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 48000
GOLDENS = {n: os.path.join(ROOT, "tests", "goldens", f"{name}.npz") for n, name in (
    (2, "config2_mix_bus_ramps"), (3, "config3_biquad_eq_chain"), (4, "config4_conv_reverb_64"),
    (5, "config5_spatial_scene_128"), (6, "config6_lfo_tremolo_64"))}
REPEATS = 50
#: Voices of the full-size occluded scene (config 5's 128, every one occluded).
OCCLUDED_VOICES = 128

# The card's published rates (NVIDIA H100 SXM data sheet, at its 700 W
# limit): HBM bytes/s, f32 and f64 non-tensor-core FLOP/s.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
#: 32-bit integer operations a second: 64 INT32 lanes an SM a clock (Hopper
#: white paper) x 132 SMs x the 1,980 MHz boost clock.
INT32_OPS = 64 * 132 * 1.98e9
#: One dependent operation a clock on one thread: the least time a chain of
#: operations that each need the one before can take (the boost clock).
CHAIN_OPS = 1.98e9


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


def device_ms(fn, calls=20, windows=5, only=None, expect=None):
    """Device time of one call of ``fn``: the CUDA kernels' self time
    under torch.profiler over ``calls`` calls (with ``only``, of the
    kernels whose names hold it). Now and then a window loses
    some of its kernels' events (seen on the chip machine, for kernels
    launched through the ctypes library): of ``windows`` windows, the
    median of those that recorded the most kernel events; with
    ``expect`` (kernel events a call), of those that recorded them all,
    and None if none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    reads = []  # (kernel events, ms a call) per window
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us, events = 0.0, 0
        for e in prof.key_averages():
            t_us = getattr(e, "self_device_time_total", None)
            if t_us is None:
                t_us = getattr(e, "self_cuda_time_total", 0.0)
            if str(getattr(e, "device_type", "")).endswith("CUDA") and (only is None
                                                                       or only in e.key):
                total_us += t_us
                events += e.count
        reads.append((events, total_us / calls / 1e3))
    most = max(n for n, _ in reads) if expect is None else expect * calls
    kept = [t for n, t in reads if n == most]
    return statistics.median(kept) if kept else None


def burst_ms(fn, calls=5, bursts=3):
    """Device time a call of ``fn``, one read for each of ``bursts`` bursts
    of ``calls`` calls issued back to back between two CUDA events (after
    one warm call). For a kernel that runs far longer than the host takes
    to issue it, the stream stays busy from the first launch to the last,
    so the events' span over ``calls`` is the device time a launch; no
    profiler window is involved, so no lost event can skew it."""
    import torch

    fn()
    torch.cuda.synchronize()
    reads = []
    for _ in range(bursts):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        reads.append(a.elapsed_time(b) / calls)
    return reads


#: Kernel groups of config 3's profile, by a substring of the kernel's
#: name that this tree's and the parent trees' kernels share (K6's and K8's
#: kernels were renamed when they were batched).
K6K8_GROUPS = {"K6": "param_eval", "K8": "biquad_coeffs"}
#: The source group steps' kernels, likewise (poly_resample_kernel and
#: unity_gather_kernel in the trees whose plan ran as torch ops around a
#: gather kernel, poly_step_kernel and unity_step_kernel in the one-launch
#: steps).
K1K5_GROUPS = {"K1": "poly_", "K5": "unity_"}
#: K2b's and K10b's kernels (conv_ola_kernel and spatial_gains_kernel in
#: this tree and the parent trees).
K2BK10B_GROUPS = {"K2b": "conv_ola", "K10b": "spatial_gains"}
#: K9's kernel (onepole_kernel in the parent trees, onepole_split_kernel
#: since the band split).
K9_GROUPS = {"K9": "onepole"}
#: This slice's kernels: the wire packs and config 6's source and
#: modulation steps.
WIRE_GROUPS = {"K4mu": "pack_mulaw", "K4a": "ima_encode"}
K11K6M_GROUPS = {"K11": "oscillator_kernel", "K6m": "apply_modulation", "K5": "unity_",
                 "K3": "fan_in"}


def profile_steps(ctx, step_frames, host_us, steps=20, groups=None, step_calls=False):
    """Device time a step and per kernel over ``steps`` steps of ``ctx``
    under torch.profiler (after two warm-up steps), in one render call or,
    with ``step_calls``, in one call a step as a realtime context renders;
    the busy share divides it by ``host_us``, the unprofiled host time a
    step, since the profiler slows the host. ``groups`` ({label: substring
    of kernel names}) adds each group's device time and launches a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ctx.render(2 * step_frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps if step_calls else 1):
            ctx.render(step_frames if step_calls else steps * step_frames)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    # a graph with pipes runs its pipe delay's rows more than it delivers
    rows = ctx.stats.last_breakdown.get("rows", steps) * (steps if step_calls else 1)
    per_kernel = {}
    for e in prof.key_averages():
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(e, "self_cuda_time_total", 0.0)
        if t_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            per_kernel[e.key] = (t_us / steps, e.count / steps)
    device_us = sum(t for t, _ in per_kernel.values())
    top_kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    out = {"profiled_host_us_per_step": window_s / steps * 1e6, "rows_per_step": rows / steps,
           "device_us_per_step": device_us, "device_busy": device_us / host_us,
           "launches_per_step": sum(c for _, c in per_kernel.values()),
           "top_kernels_us_per_step": {k: round(t, 3) for k, (t, _) in top_kernels}}
    if groups:
        out["groups_per_step"] = {
            label: {"device_us": sum(t for k, (t, _) in per_kernel.items() if sub in k),
                    "launches": sum(c for k, (_, c) in per_kernel.items() if sub in k),
                    "kernels": sorted(k for k in per_kernel if sub in k)}
            for label, sub in groups.items()}
    return out


def attribute_ops(ctx, step_frames, steps=10):
    """The step's device work that is not a hand kernel, by source line:
    ``steps`` steps of ``ctx`` (after two warm-up steps) under
    torch.profiler, with every PyTorch call inside a ``record_function``
    range named after its call site (the innermost frame in
    graphaudio_tpu_torch, found by a ``TorchFunctionMode``) and the call;
    each range's device time is that of the kernels its call launched
    (the profiler also records a device-side copy of each range, which is
    left out).
    Returns {"file:line function | call": [device us a step, launches a
    step]}, largest first. The hand kernels, launched through ctypes, are
    no PyTorch call and belong to no range."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.profiler import ProfilerActivity, profile, record_function

    pkg = os.path.join(ROOT, "graphaudio_tpu_torch")

    class CallSites(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            f = sys._getframe(1)
            while f is not None and not f.f_code.co_filename.startswith(pkg):
                f = f.f_back
            where = "(outside the package)" if f is None else (
                f"{os.path.relpath(f.f_code.co_filename, ROOT)}:{f.f_lineno} {f.f_code.co_name}")
            with record_function(f"@{where} | {getattr(func, '__name__', func)}"):
                return func(*args, **(kwargs or {}))

    def kernels(e):
        """The device kernels under ``e``: its own and its children's, not
        the device-side copies of the ``record_function`` ranges."""
        own = [k for k in getattr(e, "kernels", []) or [] if not k.name.startswith("@")]
        return own + [k for c in e.cpu_children for k in kernels(c)]

    ctx.render(2 * step_frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with CallSites():
            ctx.render(steps * step_frames)
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if not e.name.startswith("@"):
            continue
        ks = kernels(e)
        if not ks:
            continue
        us, n = rows.get(e.name[1:], (0.0, 0.0))
        rows[e.name[1:]] = (us + sum(k.duration for k in ks) / steps, n + len(ks) / steps)
    return {k: [round(us, 3), round(n, 3)]
            for k, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])}


def timed_render(build, frames, method="render"):
    """One render of ``frames`` frames from a fresh context, built and
    compiled before the clock starts: (output, wall seconds, the context's
    stats breakdown)."""
    import torch

    ctx = build()
    ctx._ensure_compiled()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = getattr(ctx, method)(frames)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, ctx.stats.last_breakdown


def spread(frames, walls):
    """xRT of the median run and of the slowest and fastest."""
    return {"wall_s": walls, "xrt_median": frames / SR / statistics.median(walls),
            "xrt_range": [frames / SR / max(walls), frames / SR / min(walls)]}


def render_runs(n, build, step_frames, frames, counts, groups=None, runs=3, ref=None):
    """``runs`` renders of ``frames`` frames of config ``n``, each from a
    fresh context of ``build`` (after a one-step warm-up), then a profile
    window (``profile_steps`` with ``groups``). The first run must be
    finite, non-silent and within 1e-5 of ``ref`` over its first frames
    (by default the config's golden, 8192 frames). ``counts`` ({label: wrapper names}) gives the first
    run's launches under each label, the names summed so that an older
    tree's names count too. Returns the host time a step of each run, the
    profile, the xRT spread, the launches and the first run's sha256."""
    import torch

    from graphaudio_tpu_torch.utils import cudabuild

    steps = frames // step_frames
    build().render(step_frames)
    torch.cuda.synchronize()
    cudabuild.launches.clear()
    out, wall, bd = timed_render(build, frames)
    launches = {label: sum(cudabuild.launches[w] for w in names)
                for label, names in counts.items()}
    walls = [wall] + [timed_render(build, frames)[1] for _ in range(runs - 1)]
    sha = hashlib.sha256(np.ascontiguousarray(out, dtype=np.float32).tobytes()).hexdigest()
    if ref is None:
        ref = np.load(GOLDENS[n])["out"]
    head_err = float(np.abs(out[:, :ref.shape[1]].astype(np.float64) - ref).max())
    host = [w / steps * 1e6 for w in walls]
    prof = profile_steps(build(), step_frames, statistics.median(host), groups=groups)
    ops = attribute_ops(build(), step_frames)
    phase("ops", f"config {n}, the step's PyTorch ops by source line (device us, launches a "
          f"step): {json.dumps(ops)}")
    phase("render", f"config {n} f32: {out.shape}; {runs} runs {walls!r} s; host us a step "
          f"{host!r}; launches a step { {k: v / steps for k, v in launches.items()} }; "
          f"sha256 of the first run {sha}; first {ref.shape[1]} frames vs "
          f"{'golden' if n in GOLDENS else 'reference'} max_abs_err="
          f"{head_err!r}; first run breakdown {json.dumps(bd)}")
    phase("profile", f"config {n}, 20 steps under torch.profiler: {json.dumps(prof)}")
    if not (np.isfinite(out).all() and float(np.abs(out).max()) > 0 and head_err < 1e-5):
        raise AssertionError(f"config-{n} render is not finite, non-silent and within 1e-5 "
                             "of its reference at its start")
    return {"host_us_per_step_median": statistics.median(host), "host_us_per_step": host,
            "profile": prof, "f32": spread(frames, walls), "sha256": sha, "breakdown": bd,
            "head_vs_golden": head_err, "launches": launches, "torch_ops": ops,
            "launches_per_step": {k: v / steps for k, v in launches.items()}}


def host_us(fn, calls=10000):
    """Mean host time of one call of ``fn`` in microseconds, over ``calls``
    calls in a loop (the device drains at the end)."""
    import torch

    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def nbytes(*tensors):
    """Bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved_bytes, ops, peak=F32_FLOPS, int_ops=0):
    """The least time the card could take: the larger of the bytes that
    must move over the HBM rate and the operations over the peak rate
    (``int_ops`` more 32-bit integer operations at ``INT32_OPS``, added).
    Returns (ms, "bytes" or "operations")."""
    t_bytes, t_ops = moved_bytes / HBM_BYTES_S, ops / peak + int_ops / INT32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, route, source, replaces, kernel, plain, tol, bnd, rel=False,
            library=None, device_times=False):
    """Run kernel and plain version on the same inputs, check the error,
    time both (and ``library``, one PyTorch call computing the same
    function, where there is one). ``bnd`` is ``bound(...)`` of the
    kernel's work. With ``device_times`` the plain version's and the
    library call's device times are read too. Returns the kernel's JSON
    entry (launches filled later)."""
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
    extra = {}
    if device_times:
        extra["plain_device_ms"] = device_ms(plain)
        extra["library_device_ms"] = device_ms(library) if library is not None else None
        phase("kernels", f"{name}: device ms, plain {extra['plain_device_ms']!r}, "
              f"library {extra['library_device_ms']!r}")
    ok = err <= tol_abs
    phase("kernels", f"{name}: max_abs_err={err!r} (tolerance {tol_abs!r}{' = %g x max|ref|' % tol if rel else ''}) "
          f"kernel {ms!r} ms a call, {dev_ms!r} ms on the device; plain {plain_ms!r} ms, "
          f"library {library_ms!r} ms, bound {bound_ms!r} ms ({bound_by}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol_abs}")
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": dev_ms, **extra}


def flat(outs):
    """One f32 vector of a kernel's outputs (complex ones as (re, im))."""
    import torch

    return torch.cat([torch.view_as_real(o).flatten() if o.is_complex() else o.flatten()
                      for o in outs])


def group_step_fns(ctx):
    """(si, fused, plain) for ctx's first buffer-source group, stage si:
    ``fused(st, rc)`` is the public ``process_poly_group`` or
    ``process_unity_group`` (with the packed geometry table where the tree
    has one: on the card, then one launch a step), ``plain(st, rc)``
    the plan then the plain gather; both return (new states, audio). Only
    names that the parent trees have too are used."""
    import graphaudio_tpu_torch as gat
    from graphaudio_tpu_torch.ops import resample as tres
    from graphaudio_tpu_torch.ops import unity as tun

    node = gat.AudioBufferSourceNode
    ctx._ensure_compiled()
    si = min(ctx._compiled._bufsrc_cfg)
    w, variant, _ = ctx._compiled._bufsrc_cfg[si]
    c = ctx._consts
    arena, geom = c[f"st{si}/arena"], c[f"st{si}/geom"]
    # By keyword after geom: this tree takes gtab next to geom, older trees
    # took it last or not at all.
    kw = {"gtab": c[f"st{si}/gtab"]} if f"st{si}/gtab" in c else {}
    if variant[0] == "poly":
        _, p, q = variant
        taps = (c[f"st{si}/poly_w"], c[f"st{si}/poly_b"])

        def fused(st, rc):
            return node.process_poly_group(st, arena, geom, rc=rc, w=w, p=p, q=q, taps=taps,
                                           **kw)

        def plain(st, rc):
            new, args = node.poly_group_plan(st, geom, rc, w, p, q)
            return new, tres.poly_resample_plain(arena, wtab=taps[0], btab=taps[1], p=p, q=q,
                                                 **args)
    else:
        def fused(st, rc):
            return node.process_unity_group(st, arena, geom, rc=rc, w=w, aligned=variant[1],
                                            **kw)

        def plain(st, rc):
            new, args = node.unity_group_plan(st, geom, rc, w, variant[1])
            return new, tun.unity_gather_plain(arena, **args)
    return si, fused, plain


def mid_render(ctx, dev, step=9):
    """The source group's states and step context at step ``step`` of
    ``ctx`` (its first buffer-source group), the states advanced by the
    plain composition through the steps before it; the params encoded."""
    import torch

    from graphaudio_tpu_torch.core import graph as tgraph

    ctx._ensure_compiled()
    ctx._ensure_params_encoded()
    S, T = ctx.superblock, ctx.superblock * 128
    si, _, plain = group_step_fns(ctx)
    clock = ctx._block_clock((step + 1) * S)
    st = ctx._states[f"st{si}"]
    for k in range(step + 1):
        rc = tgraph.RenderContext(ctx._compiled.info, k * T,
                                  torch.from_numpy(clock[k * S:(k + 1) * S]).to(dev))
        if k < step:
            st, _ = plain(st, rc)
    return st, rc


def group_step_check(label, name, ctx, dev, step=9):
    """The group step of ctx's first source group against its plain
    composition at step ``step``, bit for bit: the audio (tolerance 0,
    equal as integers) and every new state field (equal as integers). The bound is the whole
    step's bytes: the states read and written, the geometry, the clocks,
    the tap table, the audio written and the arena samples that this
    step's valid outputs read (each once). Returns (JSON entry, audio)."""
    import torch

    import graphaudio_tpu_torch as gat

    si, fused, plain = group_step_fns(ctx)
    st, rc = mid_render(ctx, dev, step)
    w, variant, _ = ctx._compiled._bufsrc_cfg[si]
    c = ctx._consts
    new_f, out = fused(st, rc)
    new_p, want = plain(st, rc)
    torch.cuda.synchronize()
    fields = ("x", "primed", "stop_time") if variant[0] == "poly" else ("pos", "stop_time")
    as_int = lambda t: t.view(torch.int64 if t.element_size() == 8 else torch.int32) \
        if t.is_floating_point() else t  # noqa: E731
    # The one-launch steps are held to 0; a tree without the packed table
    # ran its plan as torch ops around a gather kernel whose K1 let nvcc
    # contract the tap sum, held to 1e-6 (its states are the plain plan's).
    tol = 0.0 if f"st{si}/gtab" in c else (1e-6 if variant[0] == "poly" else 0.0)
    differ = [f for f in fields if not torch.equal(as_int(new_f[f]), as_int(new_p[f]))]
    err = float((out - want).abs().max())
    if differ or err > tol or (tol == 0.0 and not torch.equal(as_int(out), as_int(want))):
        raise AssertionError(f"{label}: the group step differs from its plain composition "
                             f"(states {differ}, audio max_abs_err {err!r})")
    V, C, T = out.shape
    i = torch.arange(128, device=out.device)
    if variant[0] == "poly":
        _, p, q = variant
        _, args = gat.AudioBufferSourceNode.poly_group_plan(st, c[f"st{si}/geom"], rc, w, p, q)
        jpos = args["bidx"].long()[:, :, None] * 128 + i
        ok = args["blk_ok"][:, :, None] & (args["looping"][:, None, None]
                                            | (jpos.float() < args["jlim"][:, None, None]))
        n = ok.sum(dim=(1, 2)).double()
        read = int(torch.where(n > 0, torch.ceil(n * p / q) + 3, n).sum()) * C * 4
        extra = nbytes(c[f"st{si}/poly_w"], c[f"st{si}/poly_b"])
    else:
        _, args = gat.AudioBufferSourceNode.unity_group_plan(st, c[f"st{si}/geom"], rc, w,
                                                             variant[1])
        ok = args["blk_ok"][:, :, None] & (
            args["looping"][:, None, None]
            | (args["g0"].long()[:, :, None] + i < args["end_bound"].long()[:, None, None]))
        read, extra = int(ok.sum()) * C * 4, 0
    gbytes = nbytes(c[f"st{si}/gtab"]) if f"st{si}/gtab" in c else 0
    moved = (nbytes(*st.values()) + nbytes(*(new_f[f] for f in fields)) + gbytes
             + nbytes(rc.block_times) * 2 + extra + nbytes(out) + read)
    src = "poly_resample.cu" if variant[0] == "poly" else "unity.cu"
    e = compare(f"{name} ({label}: V={V} C={C} S={T // 128}, mid-render step {step})", "cuda",
                f"graphaudio_tpu_torch/csrc/{src}",
                "graphaudio_tpu/nodes/sources.py:1212" if variant[0] == "poly"
                else "graphaudio_tpu/nodes/sources.py:1104",
                lambda: fused(st, rc)[1], lambda: plain(st, rc)[1], tol,
                # 4 multiplies and 3 adds an output sample (K1), a copy (K5)
                bnd=bound(moved, 7 * out.numel() if variant[0] == "poly" else 0))
    e["states_bit_exact"] = list(fields)
    return e, out


def k1k5_checks(dev):
    """K1 and K5, each a whole group step, against their plain composition
    through the public ``process_*_group`` names, mid-render (step 9): K1
    at config 4 (64 voices, superblock 64), K5 at config 3 (superblock 32),
    and at config 2's and config 5's groups under "shapes". Returns the K1
    and K5 entries and config 4's voices (K3's input)."""
    from graphaudio_tpu_torch.testing.configs import (config2_mix_bus, config3_eq_chain,
                                                      config4_conv_reverb, config5_spatial_scene)

    keys = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms")
    k1, voices = group_step_check("config 4", "K1 polyphase group step",
                                  config4_conv_reverb(superblock=64, voices=64, device=dev), dev)
    k5, _ = group_step_check("config 3", "K5 unity group step",
                             config3_eq_chain(superblock=32, device=dev), dev)
    k5["shapes"] = [{k: e[k] for k in keys} for e, _ in (
        group_step_check("config 2", "K5 unity group step",
                         config2_mix_bus(superblock=32, device=dev), dev),
        group_step_check("config 5", "K5 unity group step",
                         config5_spatial_scene(superblock=32, device=dev), dev))]
    k1["name"], k5["name"] = "K1 polyphase group step", "K5 unity group step"
    return [k1, k5], voices


def k6k8_checks(dev):
    """K6 and K8 through their one-param and one-stage names
    (``eval_intrinsic_blocked``, ``biquad_coefficients``), which the parent
    trees have too, so ``--k6k8`` times both trees the same way: K6 at
    config 3's frequency and config 2's 8-lane gain ramps, K8 at config 3's
    first peaking stage, all mid-render (superblock 32, step 9). Returns
    the K6 and K8 entries, config 2's K6 under "shapes"."""
    from graphaudio_tpu_torch.ops import biquad as tbq
    from graphaudio_tpu_torch.ops import param_eval as tpe
    from graphaudio_tpu_torch.testing.configs import config2_mix_bus, config3_eq_chain

    dt = 1.0 / SR
    ctx3, ctx2 = unfused(config3_eq_chain(superblock=32, device=dev)), \
        config2_mix_bus(superblock=32, device=dev)
    bt3, bt2 = (mid_render(c, dev)[1].block_times for c in (ctx3, ctx2))
    enc3, enc2 = ctx3._encs["st2/frequency"], ctx2._encs["st1/gain"]

    def k6_bound(enc, bt):
        # the event table and clock read once, the curve written once; about
        # ten flops a sample to locate its segment and interpolate
        out = tpe.eval_intrinsic_blocked(enc, bt, 128, dt)
        return bound(nbytes(*enc.values(), bt, out), 10 * out.numel())

    k6 = compare("K6 param curve, one param (config 3 frequency: 1 lane, cap 32, a-rate S=32)",
                 "cuda", "graphaudio_tpu_torch/csrc/param_eval.cu",
                 "graphaudio_tpu/ops/param_eval.py:175",
                 lambda: tpe.eval_intrinsic_blocked(enc3, bt3, 128, dt),
                 lambda: tpe.eval_intrinsic_blocked_plain(enc3, bt3, 128, dt), 1e-6, rel=True,
                 bnd=k6_bound(enc3, bt3))
    k6_2 = compare("K6 param curve, one param (config 2 gains: 8 lanes, linear + exponential "
                   "ramps)", "cuda", "graphaudio_tpu_torch/csrc/param_eval.cu",
                   "graphaudio_tpu/ops/param_eval.py:175",
                   lambda: tpe.eval_intrinsic_blocked(enc2, bt2, 128, dt),
                   lambda: tpe.eval_intrinsic_blocked_plain(enc2, bt2, 128, dt), 1e-6, rel=True,
                   bnd=k6_bound(enc2, bt2))
    k6["shapes"] = [{k: k6_2[k] for k in ("name", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "device_ms")}]
    f = tpe.eval_intrinsic_blocked(enc3, bt3, 128, dt)
    q = tpe.eval_intrinsic_blocked(ctx3._encs["st2/Q"], bt3, 128, dt)
    g = tpe.eval_intrinsic_blocked(ctx3._encs["st2/gain"], bt3, 1, dt).contiguous()
    k8 = compare("K8 RBJ coefficients + pole split, one stage (config 3 peaking: V=1 T=4096)",
                 "cuda", "graphaudio_tpu_torch/csrc/biquad.cu", "graphaudio_tpu/ops/biquad.py:43",
                 lambda: flat(tbq.biquad_coefficients("peaking", f, q, g, SR)),
                 lambda: flat(tbq.biquad_coefficients_plain("peaking", f, q, g, SR)),
                 1e-6, rel=True,
                 # f, q, gain in, five coefficient rows out; ~40 flops a sample
                 bnd=bound(nbytes(f, q, g, *tbq.biquad_coefficients("peaking", f, q, g, SR)),
                           40 * f.numel()))
    return k6, k8


def unfused(ctx):
    """``ctx`` with chain fusion off (as every tree before the fusion
    rendered), before its graph is built."""
    ctx.pipeline_chains = False
    return ctx


def step_clocks(dev, ctx, step):
    """The clock matrix ``ctx``'s step ``step`` hands K6: the block clocks
    of steps step - D .. step, f64[D + 1, S] (D its pipe delay; the one row
    f64[S] where it has none)."""
    import torch

    ctx._ensure_compiled()
    S, D = ctx.superblock, getattr(ctx._compiled, "pipe_delay", 0)
    clock = ctx._block_clock((step + 1) * S).reshape(step + 1, S)
    rows = torch.from_numpy(clock[step - D:step + 1]).to(dev)
    return rows if D else rows[0]


def k6k8_batch_checks(dev):
    """The batched K6 and K8 as the step's prologue launches them, bit for
    bit (tolerance 0): K6 on config 3's pipe table (8 rows, capacity 32,
    a-rate, S=32, lane i's rows at the clock of i steps back: a [4, S]
    clock matrix) and config 2's (8 lanes of linear and exponential gain
    ramps), mid-render at step 9; K8 on config 3's pipe (four typed rows)
    over that step's K6 arena and on eight stages of all eight types as
    data (graphaudio_tpu_torch/testing/tables.py). Returns the K6 and K8
    entries, the other shapes under "shapes"."""
    from graphaudio_tpu_torch.core import graph as tgraph
    from graphaudio_tpu_torch.core.graph import to_device
    from graphaudio_tpu_torch.ops import biquad as tbq
    from graphaudio_tpu_torch.ops import param_eval as tpe
    from graphaudio_tpu_torch.testing import tables as ttab
    from graphaudio_tpu_torch.testing.configs import config2_mix_bus, config3_eq_chain

    dt = 1.0 / SR
    keys = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms")

    def k6_check(label, table, bt):
        out = tpe.eval_intrinsic_batch(table, bt, dt)
        fields = [table[k] for k in ("times", "tcs", "values", "types", "boundary", "n",
                                     "base", "rows")]
        return compare(f"K6 param curves, one launch ({label})", "cuda",
                       "graphaudio_tpu_torch/csrc/param_eval.cu",
                       "graphaudio_tpu/ops/param_eval.py:175",
                       lambda: tpe.eval_intrinsic_batch(table, bt, dt),
                       lambda: tpe.eval_intrinsic_batch_plain(table, bt, dt), 0.0,
                       # the table and clock read once, the arena written
                       # once; about ten flops a sample
                       bnd=bound(nbytes(*fields, bt, out), 10 * out.numel()))

    def k8_check(label, table, arena):
        outs = tbq.biquad_coefficients_batch(table, arena, SR)
        rows = table["rows"].cpu().long()
        T = table["frames"]
        # each row's sources read once (a-rate T floats, k-rate S, a
        # constant 1), five coefficient rows written; ~40 flops a sample
        per = {tbq.SRC_ARATE: T, tbq.SRC_KRATE: T // 128, tbq.SRC_CONST: 1}
        src_bytes = 4 * sum(per[int(w) & 3] for w in rows[:, 1:4].flatten())
        moved = src_bytes + nbytes(table["rows"], *(o for st in outs for o in st))
        return compare(f"K8 RBJ coefficients + pole split, one launch ({label})", "cuda",
                       "graphaudio_tpu_torch/csrc/biquad.cu", "graphaudio_tpu/ops/biquad.py:43",
                       lambda: flat([o for st in tbq.biquad_coefficients_batch(table, arena, SR)
                                     for o in st]),
                       lambda: flat([o for st in tbq.biquad_coefficients_batch_plain(table, arena, SR)
                                     for o in st]), 0.0,
                       bnd=bound(moved, 40 * rows.shape[0] * T))

    ctx3, ctx2 = (b(superblock=32, device=dev) for b in (config3_eq_chain, config2_mix_bus))
    ctx3._ensure_compiled()
    bt3 = step_clocks(dev, ctx3, 9)
    bt2 = mid_render(ctx2, dev)[1].block_times
    mid_render(ctx3, dev)  # encodes the params
    t3, t2 = ctx3._encs[tgraph.PARAM_TABLE], ctx2._encs[tgraph.PARAM_TABLE]
    R3, cap3 = t3["times"].shape
    clocks = sorted(set(t3["rows"][:, 3].tolist())) if t3["rows"].shape[1] > 3 else [0]
    k6 = k6_check(f"config 3 step table: {R3} rows, cap {cap3}, a-rate S=32, at clocks "
                  f"{clocks} of {tuple(bt3.shape)}", t3, bt3)
    R2, cap2 = t2["times"].shape
    k6_2 = k6_check(f"config 2 step table: {R2} lanes of gain ramps, cap {cap2}", t2, bt2)
    k6["shapes"] = [{k: k6_2[k] for k in keys}]

    arena3 = tpe.eval_intrinsic_batch(t3, bt3, dt)
    kt3 = ctx3._encs[tgraph.PROLOGUE]["0"]["table"]
    types3 = "/".join(tbq.FILTER_TYPES[int(c)] for c in kt3["rows"][:, 0].cpu())
    k8 = k8_check(f"config 3's {len(kt3['stages'])} stage(s) of {kt3['rows'].shape[0]} rows, "
                  f"{types3}, T=4096", kt3, arena3)
    t8, stages = ttab.eight_type_stages(3, 32, 8 * 32 * ttab.BLOCK)
    t8 = to_device(t8, dev)
    bt8 = torch_clock(dev, 8 * 32, 5, 32)
    arena8 = tpe.eval_intrinsic_batch(t8, bt8, dt)
    kt8 = to_device(tbq.pack_coefficient_table(stages, 32), dev)
    k8_8 = k8_check(f"all eight types as data: {kt8['rows'].shape[0]} rows, a-rate, k-rate and "
                    "constant sources, T=4096", kt8, arena8)
    k8["shapes"] = [{k: k8_8[k] for k in keys}]
    return k6, k8


def torch_clock(dev, n_blocks, step, S):
    """The block clock of step ``step`` (superblock ``S``) on ``dev``."""
    import torch

    from graphaudio_tpu_torch.testing import tables as ttab

    return torch.from_numpy(ttab.block_clock(n_blocks)[step * S:(step + 1) * S]).to(dev)


def config3_kernel_checks(dev):
    """K6, K8 and P2 against their plain versions on the card, at the
    shapes config 3 gives them mid-render (superblock 32, step 9: the
    frequency and Q ramps are moving): K6 and K8 batched as the step
    launches them (``k6k8_batch_checks``) and through their one-entry names
    (``k6k8_checks``); P2 over the pipe's four lanes (lowpass, peaking,
    peaking, highpass, their coefficients from that step's K8), and at one
    lane, with constant poles, on eight lanes and in the Pallas probe's
    form. Returns the three JSON entries."""
    import torch

    from graphaudio_tpu_torch.core import graph as tgraph
    from graphaudio_tpu_torch.ops import biquad as tbq
    from graphaudio_tpu_torch.ops import param_eval as tpe
    from graphaudio_tpu_torch.testing.configs import config3_eq_chain

    dt = 1.0 / SR
    ctx3 = unfused(config3_eq_chain(superblock=32, device=dev))
    st3, rc3 = mid_render(ctx3, dev)
    bt3 = rc3.block_times

    k6, k8 = k6k8_batch_checks(dev)
    k6["one_entry"], k8["one_entry"] = k6k8_checks(dev)

    f = tpe.eval_intrinsic_blocked(ctx3._encs["st2/frequency"], bt3, 128, dt)
    q = tpe.eval_intrinsic_blocked(ctx3._encs["st2/Q"], bt3, 128, dt)
    g = tpe.eval_intrinsic_blocked(ctx3._encs["st2/gain"], bt3, 1, dt).contiguous()
    coeffs = tbq.biquad_coefficients("peaking", f, q, g, SR)
    x = group_step_fns(ctx3)[2](st3, rc3)[1]  # the source's audio, [1, 2, 4096]
    w1 = torch.tensor([[0.01, -0.02]], device=dev)
    w2 = torch.tensor([[0.005, 0.01]], device=dev)

    def p2_check(label, x, coeffs, w1, w2, tv):
        return compare(f"P2 biquad cascade, {label}", "cuda",
                       "graphaudio_tpu_torch/csrc/first_order.cu",
                       "benchmarks/probes/hrtf_fir_pallas.py:290",
                       lambda: flat(tbq.biquad_apply(x, *coeffs, w1, w2, time_varying=tv)),
                       lambda: flat(tbq.biquad_apply_plain(x, *coeffs, w1, w2, time_varying=tv)),
                       1e-6, rel=True,
                       # two passes of two complex f64 multiply-adds a sample,
                       # plus the output taps: ~40 f64 flops per sample and channel
                       bnd=bound(nbytes(x, *coeffs, w1, w2)
                                 + nbytes(*tbq.biquad_apply(x, *coeffs, w1, w2, time_varying=tv)),
                                 40 * x.numel(), F64_FLOPS))

    # The pipe's launch: its four lanes' coefficients from the fused
    # graph's K6 and K8 at step 9; lane 0 the source's audio, lanes 1-3
    # stand-ins for the register bank (the source's audio, scaled).
    pipe = config3_eq_chain(superblock=32, device=dev)
    mid_render(pipe, dev)
    arena = tpe.eval_intrinsic_batch(pipe._encs[tgraph.PARAM_TABLE], step_clocks(dev, pipe, 9),
                                     dt)
    batch = pipe._encs[tgraph.PROLOGUE]["0"]
    (coeffs4,) = tbq.biquad_coefficients_batch(batch["table"], arena, SR)
    K = coeffs4[0].shape[0]
    x4 = (x * torch.tensor([1.0, 0.8, 0.6, 0.4][:K], device=dev)[:, None, None]).contiguous()
    w4 = [w.expand(K, -1).contiguous() for w in (w1, w2)]
    types = "/".join(tbq.FILTER_TYPES[int(c)] for c in batch["table"]["rows"][:, 0].cpu())
    p2 = p2_check(f"time-varying, config 3's pipe: V={K} C=2 T=4096, {types}", x4, coeffs4,
                  *w4, True)
    one = p2_check("time-varying (config 3 unfused: V=1 C=2 T=4096)", x, coeffs, w1, w2, True)
    # Constant poles (the node's kernel until a pole param gets an event),
    # and eight lanes of peaking filters on the same ramps, their centre
    # frequencies spread over three octaves.
    const = [c[:, :1].expand_as(c).contiguous() for c in coeffs]
    scale = torch.tensor([2.0 ** (k * 3.0 / 7.0) for k in range(8)], device=dev)[:, None]
    coeffs8 = tbq.biquad_coefficients("peaking", (f * scale).contiguous(), q.expand(8, -1).contiguous(),
                                      g.expand(8, -1).contiguous(), SR)
    x8 = (x * torch.linspace(0.5, 1.5, 8, device=dev)[:, None, None]).contiguous()
    w8 = [w.expand(8, -1).contiguous() for w in (w1, w2)]
    const8 = [c[:, :1].expand_as(c).contiguous() for c in coeffs8]
    p2["shapes"] = [
        {k: e[k] for k in ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                           "device_ms")}
        for e in (one, p2_check("constant poles (V=1 C=2 T=4096)", x, const, w1, w2, False),
                  p2_check("time-varying (V=8 C=2 T=4096)", x8, coeffs8, *w8, True),
                  p2_check("constant poles (V=8 C=2 T=4096)", x8, const8, *w8, False))]
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
    for e, name in ((k6, "K6 param curve"), (k8, "K8 RBJ coefficients"),
                    (p2, "P2 biquad cascade")):
        e["name"] = name
    return [k6, k8, p2]


def moving_config5(dev, superblock=32, linear_half=False):
    """Config 5 with every source moving along the chord to the point a
    quarter turn further round the circle over 3 s (per-quantum position
    automation); with ``linear_half`` every other voice's panner is under
    the linear distance model with an 8 m maximum, so the panners form two
    groups."""
    from graphaudio_tpu_torch.testing.configs import config5_spatial_scene

    ctx = config5_spatial_scene(superblock=superblock, device=dev)
    for v, snd in enumerate(ctx._sounds):
        a = 2 * np.pi * v / len(ctx._sounds)
        pan = snd._spatial_panner
        for prm, fn in ((pan.position_x, np.cos), (pan.position_z, np.sin)):
            prm.set_value_at_time(float(5 * fn(a)), 0.0)
            prm.linear_ramp_to_value_at_time(float(5 * fn(a + np.pi / 2)), 3.0)
        if linear_half and v % 2:
            pan.distance_model = type(pan.distance_model).LINEAR
            pan.max_distance.value = 8.0
    return ctx


def true_stereo_config4(dev, superblock=64):
    """Config 4's wiring with a 4-channel 2 s IR under the true-stereo
    matrix (outL = L*ir0 + R*ir2, outR = L*ir1 + R*ir3): 8 voices into
    the convolver, four instances a step at grain 1024."""
    import graphaudio_tpu_torch as gat

    rng = np.random.default_rng(41)
    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=superblock, device=dev)
    conv = gat.ConvolverNode(ctx)
    n = 2 * SR
    decay = np.exp(-np.arange(n) / (0.3 * SR))
    conv.buffer = gat.PlayableAudioBuffer.from_channel_arrays(
        [(rng.standard_normal(n) * decay).astype(np.float32) for _ in range(4)], SR)
    conv.connect(ctx.destination)
    for v in range(8):
        src = gat.AudioBufferSourceNode(ctx)
        src.buffer = gat.PlayableAudioBuffer.from_stereo_arrays(
            *(rng.standard_normal((2, SR)) * 0.2).astype(np.float32), SR)
        src.loop = True
        src.connect(conv)
        src.start(0.001 * v)
    return ctx


def occluded_scene(dev, voices=16):
    """Config 5's Kit graph with ``voices`` voices, every one occluded with
    transmission: the panners form one group that runs the 3-band split
    (K9's band split)."""
    from graphaudio_tpu_torch.testing.configs import config5_spatial_scene

    ctx = config5_spatial_scene(superblock=32, voices=voices, device=dev)
    for snd in ctx._sounds:
        snd.occlusion = 0.5
        snd.set_transmission(0.8, 0.4, 0.1)
    return ctx


def occluded_split_args(dev, steps=2):
    """The band split's arguments (x, a_low, a_high, y0_low, y0_high, gl,
    gm, gh) at step ``steps`` of the full-size occluded scene (128 voices),
    read from the panner's ``process`` (spied on its class, where the step
    looks it up), so that a tree without the band split gives them too."""
    import math
    from unittest import mock

    from graphaudio_tpu_torch.nodes import spatial as tsp

    seen = []
    process = tsp.SpatialPannerNode.process

    def spy(self, state, inputs, params, rc):
        if self._occlusion_active():
            _, _, gl, gm, gh, _ = rc.prologue_result
            seen.append((inputs[0], state["xlow"], state["xhigh"], gl, gm, gh, rc.sample_rate))
        return process(self, state, inputs, params, rc)

    occ = occluded_scene(dev, OCCLUDED_VOICES)
    with mock.patch.object(tsp.SpatialPannerNode, "process", spy):
        occ.render(steps * 32 * 128)
    x, y0l, y0h, gl, gm, gh, sr = seen[-1]
    al, ah = (math.exp(-2.0 * math.pi * hz / sr) for hz in (tsp.XOVER_LOW_HZ, tsp.XOVER_HIGH_HZ))
    return x, al, ah, y0l, y0h, gl, gm, gh


def split_fns(args):
    """(kernel, plain) calls of the band split on ``args``, each returning
    (direct, new y0_low, new y0_high). A tree without ``band_split`` is
    timed as its panner ran it: two one-pole launches and the torch
    combine."""
    import torch

    from graphaudio_tpu_torch.ops import onepole as top

    if hasattr(top, "band_split"):
        return lambda: top.band_split(*args), lambda: top.band_split_plain(*args)
    x, al, ah, y0l, y0h, gl, gm, gh = args

    def composed(lowpass):
        low, xlow = lowpass(x, al, y0l)
        lowmid, xhigh = lowpass(x, ah, y0h)

        def expand(g):  # [V, S] -> [V, 1, T]
            return torch.repeat_interleave(g, 128, dim=-1)[:, None, :]

        return (low * expand(gl) + (lowmid - low) * expand(gm) + (x - lowmid) * expand(gh),
                xlow, xhigh)

    return lambda: composed(top.onepole_lowpass), lambda: composed(top.onepole_lowpass_plain)


def k9_checks(dev):
    """K9's band split against its plain version within 1e-6 x max at the
    full-size occluded scene's step-2 arguments (``occluded_split_args``)
    and on seeded inputs at S = 1, 4 and 64 (V=128, C=2) and one mono shape
    (V=128, C=1, S=32), each carry-out checked too; its one-pole mode
    against ``onepole_lowpass_plain`` at the scene's x. The timed calls
    return the signal alone (no concatenation). Returns the band split's
    entry, the one-pole mode's under "one_pole_mode" (the panner does not
    call it, so it is no kernel of a main path)."""
    import torch

    from graphaudio_tpu_torch.ops import onepole as top

    keys = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms")

    def split_check(label, args):
        kernel, plain = split_fns(args)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        for g, w, name in zip(got[1:], want[1:], ("y0_low", "y0_high")):
            err = float((g - w).abs().max())
            if err > 1e-6 * max(1.0, float(w.abs().max())):
                raise AssertionError(f"K9 band split's carry-out {name} is {err} off ({label})")
        x, gains, y0 = args[0], args[5:], args[3]
        n = x.numel()
        return compare(f"K9 band split ({label}: x {list(x.shape)})", "cuda",
                       "graphaudio_tpu_torch/csrc/onepole.cu", "graphaudio_tpu/nodes/spatial.py:350",
                       lambda: kernel()[0], lambda: plain()[0], 1e-6, rel=True,
                       # x read once, direct written once, the gains read,
                       # two carries in and out; per sample two poles' f64
                       # steps (3 flops each) and the f32 combine's 7 flops,
                       # counted in f64 time
                       bnd=bound(2 * nbytes(x) + nbytes(*gains) + 4 * nbytes(y0),
                                 6 * n + 7 * n * F64_FLOPS / F32_FLOPS, F64_FLOPS))

    args = occluded_split_args(dev)
    split = split_check("occluded config 5 step 2", args)
    rng = np.random.default_rng(12)
    shapes = []
    for V, C, S in ((128, 2, 1), (128, 2, 4), (128, 2, 64), (128, 1, 32)):
        x = rng.standard_normal((V, C, S * 128)) * 0.05
        y0 = rng.standard_normal((2, V, C)) * 0.05
        g = rng.uniform(0.0, 1.0, (3, V, S))
        t = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (x, *y0, *g)]
        shapes.append(split_check(f"seeded, S={S} C={C}", (t[0], *args[1:3], *t[1:])))
    split["shapes"] = [{k: e[k] for k in keys} for e in shapes]
    split["name"] = "K9 band split"

    x, al, y0 = args[0], args[1], args[3]
    got, want = top.onepole_lowpass(x, al, y0)[1], top.onepole_lowpass_plain(x, al, y0)[1]
    if float((got - want).abs().max()) > 1e-6 * max(1.0, float(want.abs().max())):
        raise AssertionError("K9 one-pole carry-out disagrees with its plain version")
    onepole = compare(f"K9 one-pole lowpass (one-pole mode, occluded config 5 step 2: x "
                      f"{list(x.shape)}, a={al:.6f})", "cuda",
                      "graphaudio_tpu_torch/csrc/onepole.cu", "graphaudio_tpu/ops/onepole.py:62",
                      lambda: top.onepole_lowpass(x, al, y0)[0],
                      lambda: top.onepole_lowpass_plain(x, al, y0)[0], 1e-6, rel=True,
                      # x read once, y written once, the carry in and out;
                      # one f64 step (3 flops) a sample
                      bnd=bound(2 * nbytes(x) + 2 * nbytes(y0), 3 * x.numel(), F64_FLOPS))
    split["one_pole_mode"] = {k: onepole[k] for k in (
        "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "device_ms")}
    return split


def k3_check(label, x, dst):
    """K3 against its plain version on ``x`` f32[V, C, T] into ``dst``
    channels, beside ``torch.sum`` over the lanes (and ``expand`` for the
    mono up-mix), the one PyTorch call that computes the same function."""
    import torch

    from graphaudio_tpu_torch.core import mixing as tmixing

    T = x.shape[2]
    return compare(f"K3 lane fan-in ({label})", "cuda", "graphaudio_tpu_torch/csrc/fan_in.cu",
                   "graphaudio_tpu/core/graph.py:1119",
                   lambda: tmixing.fan_in_lanes(x, dst), lambda: tmixing.fan_in_lanes_plain(x, dst),
                   # lane sums in another order: a few ulps of the largest sum
                   4e-6, rel=True, bnd=bound(nbytes(x) + dst * T * 4, x.numel()),
                   library=lambda: torch.sum(x, dim=0).expand(dst, -1))


def p1_checks(dev):
    """P1 against its plain version, bit for bit (tolerance 0), at config-5
    shapes (128 voices, superblock 32) on the arguments of the fourth step
    of a render whose sources move every quantum, and in the Pallas
    probe's row form (x [4096, 191], h [4096, 128]) beside torch's grouped
    conv1d, the one PyTorch call that computes the probe's function.
    Returns the JSON entry."""
    from unittest import mock

    import torch

    from graphaudio_tpu_torch.nodes import spatial as tsp
    from graphaudio_tpu_torch.ops import hrtf as th

    # The panner looks its kernel up in its own module: a spy there sees
    # the arguments of each call.
    ctx = moving_config5(dev)
    with mock.patch.object(tsp, "hrtf_fir", wraps=tsp.hrtf_fir) as fir:
        ctx.render(4 * 32 * 128)
    fir_args = fir.call_args.args
    x, gain, az, el, blend, grid, ola = fir_args
    V, C, T = x.shape
    E, A, _, L = grid.shape
    moved = float(torch.remainder(az[:, -1] - az[:, 0] + np.pi, 2 * np.pi).sub(np.pi).abs().max())
    flat = lambda outs: torch.cat([o.flatten() for o in outs])  # noqa: E731
    p1 = compare(f"P1 HRTF FIR (config 5 step 4: V={V} C={C} S={T // 128} L={L}; "
                 f"azimuth moves up to {moved:.3f} rad in the step)", "cuda",
                 "graphaudio_tpu_torch/csrc/hrtf_fir.cu", "benchmarks/probes/hrtf_fir_pallas.py:127",
                 lambda: flat(th.hrtf_fir(*fir_args)), lambda: flat(th.hrtf_fir_plain(*fir_args)),
                 0.0,
                 # every input read once (the grid too), output and tail
                 # written once; 2 ears x L multiply-adds per output sample
                 bnd=bound(nbytes(*fir_args) + nbytes(x) * 2 // C + nbytes(ola),
                           V * T * 2 * L * 2))
    want = flat(th.hrtf_fir_plain(*fir_args)).view(torch.int32)
    if not torch.equal(flat(th.hrtf_fir(*fir_args)).view(torch.int32), want):
        raise AssertionError("P1 differs from its plain version in some bit")
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
    p1["name"] = "P1 HRTF FIR"
    return p1


def config5_kernel_checks(dev):
    """P1 (``p1_checks``) and K10b (``k10b_checks``) against their plain
    versions at config-5 shapes (128 voices, superblock 32); K9
    (``k9_checks``) at the full-size occluded scene's; K3 on the largest of
    the fan-ins of the fourth step of a render whose sources move every
    quantum. Returns the three JSON entries and K3's."""
    from unittest import mock

    from graphaudio_tpu_torch.core import graph as tgraph

    p1 = p1_checks(dev)
    k10b = k10b_checks(dev)
    # The step function looks K3 up in its own module: a spy there sees
    # the arguments of each call.
    ctx = moving_config5(dev)
    with mock.patch.object(tgraph, "fan_in_lanes", wraps=tgraph.fan_in_lanes) as fan:
        ctx.render(4 * 32 * 128)
    xf, dst = max((c.args[:2] for c in fan.call_args_list), key=lambda a: a[0].numel())
    k3 = k3_check(f"config 5 step 4, its largest: {list(xf.shape)} -> [{dst}, {xf.shape[2]}]",
                  xf, dst)
    return [p1, k10b, k9_checks(dev)], k3


def ola_fns(yfull, ov0, combine):
    """(kernel, plain) calls of K2b on ``yfull`` and a copy each of the
    carried tail ``ov0``, with the convolver's ``combine``. A tree whose
    K2b takes no combine (before it wrote the true-stereo sums) is timed
    with the stack of sums its convolver issued after it."""
    import inspect

    import torch

    from graphaudio_tpu_torch.ops import convolve as tconv

    # Each call replaces its tail with yfull's last one: the first call of
    # each reads ov0, every later one the same new tail, the same work.
    ov_k, ov_p = ov0.clone(), ov0.clone()
    if "combine" in inspect.signature(tconv.overlap_add).parameters:
        return (lambda: tconv.overlap_add(yfull, ov_k, combine),
                lambda: tconv.overlap_add_plain(yfull, ov_p, combine))

    def stacked(fn, ov):
        y = fn(yfull, ov)
        return y if combine is None else torch.stack([y[a] + y[b] for a, b in combine])

    return (lambda: stacked(tconv.overlap_add, ov_k),
            lambda: stacked(tconv.overlap_add_plain, ov_p))


def k2_checks(dev):
    """K2a and K2b against their plain versions at the shapes the main paths
    give them: config 4's (grain 1024), config 5's reverb send (K, L and P
    read from its compiled plan), the 128 grain (superblock 4, the goldens'
    grain) and a true-stereo 4-channel IR at config 4's grain
    (``true_stereo_config4``), K2b with the convolver's combine there. K2a
    also beside the library call: one einsum over the unfolded delay line,
    the JAX reference's form (without the ring write), on a contiguous
    complex delay line and correlation-order spectra built before the clock
    starts; K2b beside ``torch.nn.functional.fold`` (stride B, the carried
    tail as the first block, the blocks built before the clock), except
    with the combine, which no one call computes. Returns the K2a and K2b
    entries at config 4's shape, each with the other shapes under
    "shapes"."""
    import torch

    from graphaudio_tpu_torch.ops import convolve as tconv
    from graphaudio_tpu_torch.testing.configs import config4_conv_reverb, config5_spatial_scene

    rng = np.random.default_rng(0)
    macs, olas = [], []
    for label, cctx in (("config 4, grain 1024", config4_conv_reverb(superblock=64, voices=64, device=dev)),
                        ("config 5 reverb send, grain 1024", config5_spatial_scene(superblock=32, device=dev)),
                        ("128 grain", config4_conv_reverb(superblock=4, voices=1, device=dev)),
                        ("true-stereo 4-channel IR, grain 1024", true_stereo_config4(dev))):
        cctx._ensure_compiled()
        sp = next(sp for sp in cctx._compiled.plan
                  if sp["kind"] == "single" and f"st{sp['si']}/conv_hr" in cctx._consts)
        si = sp["si"]
        combine = ((0, 2), (1, 3)) if sp["rep"]._is_true_stereo else None
        hr, hi = cctx._consts[f"st{si}/conv_hr"], cctx._consts[f"st{si}/conv_hi"]
        K, P, NB = hr.shape
        B = NB - 1
        L = cctx.superblock * 128 // B
        R, head = P - 1 + L, 5
        rev = B != 128
        x = torch.from_numpy(rng.standard_normal((K, L, B)).astype(np.float32) * 0.4).to(dev)
        X = torch.fft.rfft(x, n=2 * B, dim=-1)
        ring0 = torch.from_numpy(rng.standard_normal((2, K, R, NB)).astype(np.float32) * 20).to(dev)
        # The MAC writes this step's spectra into slots it never reads, so
        # repeated calls on one ring give the same sum: no copy is timed.
        rk, rp = ring0.clone(), ring0.clone()
        mac_k = lambda: tconv.spectral_mac(X, hr, hi, rk[0], rk[1], head, rev)  # noqa: E731
        mac_p = lambda: tconv.spectral_mac_plain(X, hr, hi, rp[0], rp[1], head, rev)  # noqa: E731
        past = tconv.ring_slots(head, -(P - 1), P - 1, R, dev)
        seq = torch.complex(torch.cat([ring0[0][:, past], X.real], 1),
                            torch.cat([ring0[1][:, past], X.imag], 1)).contiguous()  # [K, R, NB]
        hc = torch.complex(hr, hi)
        hc = (hc if rev else hc.flip(1)).contiguous()  # correlation order
        mac_lib = lambda: torch.einsum("klpb,kpb->klb", seq.unfold(1, P, 1).transpose(-1, -2), hc)  # noqa: E731
        e = compare(f"K2a spectral MAC ({label}: K={K} L={L} P={P} bins={NB})", "cuda",
                    "graphaudio_tpu_torch/csrc/conv.cu",
                    "graphaudio_tpu/ops/convolve.py:191" if rev else "graphaudio_tpu/ops/convolve.py:72",
                    mac_k, mac_p, 1e-5, rel=True,
                    # spectra, IR partitions and the ring once, the sum out;
                    # a complex multiply-add (8 flops) per (sub-block, lag, bin)
                    bnd=bound(nbytes(X, hr, hi, ring0, X), 8 * K * L * P * NB), library=mac_lib,
                    device_times=True)
        e["library_max_abs_err"] = float((mac_lib() - mac_p()).abs().max())
        if not torch.equal(rk, rp):
            raise AssertionError(f"K2a's ring writes differ from the plain version's ({label})")
        phase("kernels", f"K2a library einsum vs plain: max_abs_err={e['library_max_abs_err']!r}")
        macs.append(e)
        yfull = torch.fft.irfft(mac_k(), n=2 * B, dim=-1).contiguous()
        ov0 = torch.from_numpy(rng.standard_normal((K, B)).astype(np.float32)).to(dev)
        ola_k, ola_p = ola_fns(yfull, ov0, combine)
        lib = None
        if combine is None:
            # fold's blocks: the carried tail behind B zeros, then the L rows
            cols = torch.cat([torch.cat([torch.zeros_like(ov0), ov0], 1)[:, None], yfull], 1)
            cols = cols.transpose(1, 2).contiguous()  # [K, 2B, L + 1]
            lib = lambda: torch.nn.functional.fold(  # noqa: E731
                cols, (1, (L + 2) * B), (1, 2 * B), stride=(1, B))
        C = K if combine is None else len(combine)
        f = compare(f"K2b overlap-add ({label}: K={K} L={L} B={B}"
                    f"{', combine ' + str(combine) if combine else ''})", "cuda",
                    "graphaudio_tpu_torch/csrc/conv.cu",
                    "graphaudio_tpu/ops/convolve.py:229" if rev else "graphaudio_tpu/ops/convolve.py:120",
                    ola_k, ola_p, 0.0, library=lib, device_times=True,
                    # yfull read once, the tails read and written, y written;
                    # an add a sample and instance
                    bnd=bound(nbytes(yfull) + 2 * nbytes(ov0) + C * L * B * 4, K * L * B))
        want = ola_p()
        if not torch.equal(ola_k().view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"K2b differs from its plain version in some bit ({label})")
        if lib is not None:
            folded = lib()[:, 0, 0]
            ov1 = ov0.clone()
            y1 = tconv.overlap_add_plain(yfull, ov1)
            f["library_max_abs_err"] = max(float((folded[:, B:(L + 1) * B] - y1).abs().max()),
                                           float((folded[:, (L + 1) * B:] - ov1).abs().max()))
            phase("kernels", f"K2b library fold vs plain: max_abs_err={f['library_max_abs_err']!r}")
        olas.append(f)
    keys = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "plain_device_ms", "library_device_ms", "library_max_abs_err")
    for group, name in ((macs, "K2a spectral MAC"), (olas, "K2b overlap-add")):
        group[0]["shapes"] = [{k: e[k] for k in keys if k in e} for e in group[1:]]
        group[0]["name"] = name
    return [macs[0], olas[0]]


def k10b_checks(dev):
    """K10b against its plain version at config 5 step 4 (sources moving
    every quantum, ``moving_config5``) and at step 4 of the same scene with
    every other panner under the linear model (two panner groups), on the
    arguments the render gave it: this tree's batch of every panner stage
    (``spatial_gains_batch``, spied where the step's prologue calls it),
    bit-identical too to the one-entry ``spatial_gains`` on each stage's
    params as the kernel reads them. A tree without the batch is timed
    through its one-entry calls of that step (one a group, then one
    concatenation). Returns the entry at config 5, the other shape under
    "shapes"."""
    from unittest import mock

    import torch

    from graphaudio_tpu_torch.nodes import spatial as tsp

    batched = hasattr(tsp, "spatial_gains_batch")
    found = []
    for label, linear_half in (("config 5 step 4", False),
                               ("two panner groups, inverse and linear, step 4", True)):
        ctx = moving_config5(dev, linear_half=linear_half)
        name = "spatial_gains_batch" if batched else "spatial_gains"
        with mock.patch.object(tsp, name, wraps=getattr(tsp, name)) as spy:
            ctx.render(4 * 32 * 128)
        if batched:
            table, arena, listener = spy.call_args.args
            S = table["superblock"]
            n_pairs = sum(V for _, V, _, _ in table["stages"]) * S

            def kernel(table=table, arena=arena, listener=listener):
                outs = tsp.spatial_gains_batch(table, arena, listener)
                if outs[0].untyped_storage().nbytes() == 4 * table["size"]:
                    return outs[0].as_strided((table["size"],), (1,), 0)  # the one arena
                return flat(outs)

            def plain(table=table, arena=arena, listener=listener):
                return flat(tsp.spatial_gains_batch_plain(table, arena, listener))

            # bytes: each (lane, param) read once (a constant one float, an
            # arena row S floats), the plans, the listener, the rows out
            read = sum(V * (1 if w & 3 == 2 else S) for _, V, _, words in table["stages"]
                       for w in words) * 4
            moved = read + sum(len(p) for p in table["plans"]) + 48 + table["size"] * 4
            shapes = [f"V={V} model {code}" for _, V, code, _ in table["stages"]]
            # the one-entry name on each stage's params as the kernel reads them
            models = {0: tsp.DistanceModelType.LINEAR, 1: tsp.DistanceModelType.INVERSE,
                      2: tsp.DistanceModelType.EXPONENTIAL}
            for out, (_, V, code, words) in zip(tsp.spatial_gains_batch(table, arena, listener),
                                                table["stages"]):
                p = tsp._stage_sources(words, V, S, arena, table["consts"]).contiguous()
                if not torch.equal(tsp.spatial_gains(p, listener, models[code]).view(torch.int32),
                                   out.view(torch.int32)):
                    raise AssertionError(f"K10b's batch differs from the one-entry spatial_gains "
                                         f"on the same rows ({label})")
        else:
            per_step = spy.call_count // 4
            calls = [c.args for c in spy.call_args_list[-per_step:]]

            def kernel(calls=calls):
                outs = [tsp.spatial_gains(*a) for a in calls]
                return outs[0].flatten() if len(outs) == 1 else flat(outs)

            def plain(calls=calls):
                return flat([tsp.spatial_gains_plain(*a) for a in calls])

            n_pairs = sum(a[0][0].numel() for a in calls)
            moved = sum(nbytes(a[0]) for a in calls) + 48 + 6 * n_pairs * 4
            shapes = [f"V={a[0].shape[1]} {a[2].value}" for a in calls]
        found.append(compare(
            f"K10b spatial gains ({label}: {', '.join(shapes)}, {n_pairs} (lane, quantum) pairs"
            f"{', one launch' if batched else ''})", "cuda",
            "graphaudio_tpu_torch/csrc/spatial_gains.cu", "graphaudio_tpu/nodes/spatial.py:270",
            kernel, plain, 1e-6,
            # ~150 flops per (lane, quantum), each transcendental as ~10
            bnd=bound(moved, 150 * n_pairs)))
    k10b = found[0]
    k10b["shapes"] = [{k: e[k] for k in ("name", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "device_ms")} for e in found[1:]]
    k10b["one_entry_bit_identical"] = batched
    k10b["name"] = "K10b spatial gains"
    return k10b


def wire_checks(dev, frames, mulaw=True):
    """K4mu (unless not ``mulaw``) and K4a against their plain versions,
    bit for bit, at config 4's launch chunk ([2, frames] f32): K4mu as
    ``k4mu_case`` (warm and cold), K4a with carry_len 0, 1 and 504 (the
    new carry row checked too; the timed calls return the blocks alone).
    Each bound counts the function's fewest operations, not the kernel's.
    K4a: the dependent chain of one block, one operation a clock at the
    boost clock. The header index first, as trees: |diff| (a subtract and an
    absolute value) summed over 504 in 9 levels, then 89 independent
    compares counted in 7 levels and a clamp: 2 + 9 + 1 + 7 + 1 = 20. Then
    each of the 504 steps: from one step's index to the next, the
    step-table read, the magnitude's compare, subtract, compare, subtract
    and compare, forming delta, the index-table read, the add and the
    clamp's two: 11; the predictor's path through the same step (the
    difference, its absolute value, the same five, the vp sum, the signed
    add and the clamp's two) is 11 as well and runs beside it. Returns the
    entries, K4mu's first."""
    import torch

    from graphaudio_tpu_torch.ops import wire as twire

    rng = np.random.default_rng(13)
    audio = torch.from_numpy((rng.standard_normal((2, frames)) * 0.3).astype(np.float32)).to(dev)
    entries = []
    if mulaw:
        mu = k4mu_case(f"config 4 launch chunk: {list(audio.shape)}", audio)
        entries.append(dict(mu, name="K4mu mu-law pack"))
    spb = 505
    cases = []
    for carry_len in (0, 1, spb - 1):
        carry = torch.from_numpy(rng.integers(-30000, 30000, (2, spb - 1)).astype(np.int16)).to(dev)
        got = twire.ima_chunk_encode(audio, carry, carry_len)
        want = twire.ima_chunk_encode_plain(audio, carry, carry_len)
        torch.cuda.synchronize()
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"K4a's new carry differs from its plain version (carry_len "
                                 f"{carry_len})")
        ncap = got[0].shape[0]
        chain = 20 + 11 * (spb - 1)
        cases.append(compare(
            f"K4a IMA ADPCM chunk encoder (config 4 launch chunk: {list(audio.shape)}, "
            f"carry_len {carry_len}, {ncap} blocks a channel)", "cuda",
            "graphaudio_tpu_torch/csrc/adpcm.cu", "graphaudio_tpu/ops/wire.py:338",
            lambda: twire.ima_chunk_encode(audio, carry, carry_len)[0],
            lambda: twire.ima_chunk_encode_plain(audio, carry, carry_len)[0], 0,
            # audio and carry read once, blocks and carry written once; the
            # serial chain of one block, one dependent operation a clock
            bnd=max(bound(nbytes(audio, carry, got[0], got[1]), 0),
                    (chain / CHAIN_OPS * 1e3, "operations"))))
    ima = dict(cases[0], name="K4a IMA ADPCM chunk encoder",
               carry_cases=[{k: c[k] for k in ("name", "max_abs_err", "ms", "plain_ms",
                                               "device_ms")} for c in cases],
               long_block=k4a_long_block(dev))
    return entries + [ima]


#: Bytes of inputs a cold timing rotates through: more than the H100's 50
#: MB L2, so each call finds its input in device memory.
COLD_BYTES = 64 << 20


def cold_times(fn, x, **dev):
    """(call ms, device ms) of ``fn`` for a cold caller: ``fn`` takes
    copies of ``x`` in turn, more than ``COLD_BYTES`` of them in all, so no
    call finds its input in L2 (each copy has ``x``'s offset in its
    storage). The call time is ``median_ms``'s, the device time
    ``device_ms``'s (``dev`` its ``only`` and ``expect``)."""
    import itertools

    import torch

    base = x.storage_offset()
    copies = []
    for _ in range(COLD_BYTES // nbytes(x) + 2):
        buf = torch.empty(base + x.numel(), dtype=x.dtype, device=x.device)
        copies.append(buf[base:].view(x.shape).copy_(x))
    turn = itertools.cycle(copies)
    return median_ms(lambda: fn(next(turn))), device_ms(lambda: fn(next(turn)), **dev)


def k4mu_case(label, audio):
    """K4mu on f32 ``audio`` [C, T]: bit for bit its plain version and
    ``mulaw_encode_np``, one launch counted; warm (``compare``) and cold
    (``cold_times``) times. The bound counts the function's fewest
    operations: per sample 4 f32 operations (clip as max and min, the
    multiply, the rounding conversion) and 14 integer ones (sign,
    magnitude, clamp, bias; the exponent from a count of leading zeros, a
    subtract and a max; the mantissa's add, shift and mask; the byte's two
    shifts, a three-input or and the inverting xor), under its bytes (4
    read and 1 written a sample). Only public names of ``ops/wire.py`` are
    used, so an older tree runs it too."""
    import torch

    from graphaudio_tpu_torch.ops import wire as twire
    from graphaudio_tpu_torch.utils import cudabuild

    n = audio.numel()
    before = cudabuild.launches["pack_mulaw"]
    got = twire.pack_mulaw(audio)
    torch.cuda.synchronize()
    if cudabuild.launches["pack_mulaw"] != before + 1:
        raise AssertionError(f"K4mu ({label}) did not count one launch")
    if not np.array_equal(got.cpu().numpy(), twire.mulaw_encode_np(audio.cpu().numpy())):
        raise AssertionError(f"K4mu ({label}) differs from mulaw_encode_np")
    e = compare(f"K4mu mu-law pack ({label})", "cuda", "graphaudio_tpu_torch/csrc/pack.cu",
                "graphaudio_tpu/ops/wire.py:66", lambda: twire.pack_mulaw(audio),
                lambda: twire.pack_mulaw_plain(audio), 0,
                bnd=bound(nbytes(audio) + n, 4 * n, int_ops=14 * n))
    e["cold_ms"], e["cold_device_ms"] = cold_times(twire.pack_mulaw, audio)
    e["base_mod_16"] = audio.data_ptr() % 16
    phase("kernels", f"K4mu mu-law pack ({label}): cold {e['cold_ms']!r} ms a call, "
          f"{e['cold_device_ms']!r} ms on the device (inputs rotated through "
          f"{COLD_BYTES} bytes); warm {e['device_ms']!r} ms on the device; bound "
          f"{e['bound_ms']!r} ms; base address mod 16: {e['base_mod_16']}")
    return e


def k4mu_checks(dev):
    """K4mu at config 4's launch chunk [2, 524288], its last chunk [2,
    385024] (47 steps), a ragged [2, 380931] (the cut end of a render
    call), mono [1, 524288], three channels [3, 524288] and the launch
    chunk one float past a 16-byte boundary (a contiguous view into a
    larger buffer), each ``k4mu_case``. Returns the entries, the launch
    chunk's first, which carries the others as ``cases``."""
    import torch

    rng = np.random.default_rng(15)

    def noise(C, T, offset=0):
        buf = torch.from_numpy((rng.standard_normal(offset + C * T) * 0.3).astype(np.float32))
        return buf.to(dev)[offset:offset + C * T].view(C, T)

    cases = [k4mu_case(label, noise(*shape)) for label, shape in (
        ("config 4 launch chunk: [2, 524288]", (2, 524288)),
        ("config 4 last chunk: [2, 385024]", (2, 385024)),
        ("ragged: [2, 380931]", (2, 380931)),
        ("mono: [1, 524288]", (1, 524288)),
        ("three channels: [3, 524288]", (3, 524288)),
        ("misaligned base, one float off: [2, 524288]", (2, 524288, 1)))]
    keys = ("name", "max_abs_err", "ms", "device_ms", "cold_ms", "cold_device_ms", "plain_ms",
            "bound_ms", "bound_by", "base_mod_16")
    return [dict(cases[0], name="K4mu mu-law pack",
                 cases=[{k: c[k] for k in keys} for c in cases])]


def k4a_long_block(dev, spb=32769):
    """K4a on a mono chunk of three blocks of ``spb`` samples (a stage over
    the 48 KB shared-memory default) with carry_len 3 (every slot off its
    16-byte boundary): bit for bit its plain version, which runs on the CPU
    (its spb-1 sequential torch steps take seconds on the card) and is
    timed once; the kernel timed as the other cases, and on the device by
    CUDA events over bursts of back-to-back launches (``burst_ms``; a call
    is one launch of about 2 ms). torch.profiler is not used here: its
    windows lose most of this kernel's launches on the chip machine (2 of
    5 recorded in some runs, none in others)."""
    import torch

    from graphaudio_tpu_torch.ops import wire as twire

    rng = np.random.default_rng(32769)
    F = 3 * spb - 100
    audio = torch.from_numpy((rng.standard_normal((1, F)) * 0.3).astype(np.float32)).to(dev)
    carry = torch.from_numpy(rng.integers(-30000, 30000, (1, spb - 1)).astype(np.int16)).to(dev)
    name = f"K4a IMA ADPCM chunk encoder (mono, spb {spb}, [1, {F}], carry_len 3)"
    got = twire.ima_chunk_encode(audio, carry, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = twire.ima_chunk_encode_plain(audio.cpu(), carry.cpu(), 3)
    plain_s = time.perf_counter() - t0
    if not (torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])):
        raise AssertionError(f"{name} differs from its plain version")
    ms = median_ms(lambda: twire.ima_chunk_encode(audio, carry, 3), repeats=10)
    calls = 5
    reads = burst_ms(lambda: twire.ima_chunk_encode(audio, carry, 3), calls)
    dev_ms = statistics.median(reads)
    bound_ms = (20 + 11 * (spb - 1)) / CHAIN_OPS * 1e3
    phase("kernels", f"{name}: bit for bit the plain version (on the CPU, {plain_s!r} s); "
          f"kernel {ms!r} ms a call, {dev_ms!r} ms a launch on the device (CUDA events "
          f"over bursts of {calls} launches: {reads}); bound {bound_ms!r} ms "
          "(operations: one block's chain)")
    return {"name": name, "max_abs_err": 0, "ms": ms, "device_ms": dev_ms,
            "device_bursts_ms": reads, "plain_cpu_s": plain_s, "bound_ms": bound_ms,
            "bound_by": "operations"}


def mid_config6(dev, step=9):
    """Config 6 (superblock 32) rendered ``step`` steps on ``dev``: the
    context, its oscillator stage's key and the block clock of step
    ``step``."""
    from graphaudio_tpu_torch.nodes.sources import OscillatorNode
    from graphaudio_tpu_torch.testing.configs import config6_lfo_tremolo

    ctx = config6_lfo_tremolo(superblock=32, device=dev)
    ctx.render(step * 32 * 128)
    key = next(sp["key"] for sp in ctx._compiled.plan if isinstance(sp["rep"], OscillatorNode))
    return ctx, key, torch_clock(dev, (step + 1) * 32, step, 32)


def k11k6m_checks(dev):
    """K11 and K6m against their plain versions at config 6's shapes (64
    lanes, superblock 32) on the oscillator stage's state after 9 steps of
    a config-6 render: K11 for the four waveforms over the base-value view
    of the frequency (config 6's case) and over per-sample rows, within
    1e-6, the new phase bit for bit; its constant-source mode bit for bit;
    K6m bit for bit, a-rate over the gain's base values with a CHAIN
    stereo modulation and the gain's clamp range (config 6's case: the
    depth group's stereo output), a mono CHAIN, k-rate, and an explicit
    route's rows. K11's bound is the larger of its bytes and its serial
    chain (16 adds of a run, thread 0's f64 anchors: 10 operations a
    quantum, the run prefix and one sample's phase and sine, about 60).
    Returns the two entries."""
    import torch

    from graphaudio_tpu_torch.ops import oscillator as tosc
    from graphaudio_tpu_torch.ops import param_eval as tpe

    ctx, key, bt = mid_config6(dev)
    st = ctx._states[key]
    V, S = st["phase"].shape[0], bt.shape[0]
    T = S * 128
    base = ctx._encs[f"{key}/frequency"]["base"]
    views = {"base values": base[:, None].expand(V, T),
             "rows": (base[:, None] * torch.linspace(0.5, 2.0, T, device=dev)).contiguous()}
    sched = (st["started"], st["start_time"], st["stop_time"])
    chain = 16 + 10 * S + 7 + 60
    osc = []
    for wave in tosc.WAVE_CODES:
        for label, f in views.items():
            args = (f, *sched, st["phase"], bt, 48000, wave)
            got = tosc.oscillator_group_step(*args)
            want = tosc.oscillator_group_step_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got[1], want[1]):
                raise AssertionError(f"K11's new phase differs from its plain version ({wave})")
            osc.append(compare(
                f"K11 oscillator group step (config 6 step 9: {wave}, frequency {label}, "
                f"[{V}, {T}])", "cuda", "graphaudio_tpu_torch/csrc/oscillator.cu",
                "graphaudio_tpu/nodes/sources.py:294",
                lambda args=args: tosc.oscillator_group_step(*args)[0],
                lambda args=args: tosc.oscillator_group_step_plain(*args)[0], 1e-6,
                # f (rows or base values) and the states read once, out and
                # the phase written once; or the serial chain
                bnd=max(bound(nbytes(f if f.is_contiguous() else base, *sched, st["phase"], bt)
                              + V * T * 4 + V * 8, 0),
                        (chain / CHAIN_OPS * 1e3, "operations"))))
    k11_shapes = k11_superblocks(dev)
    off = views["base values"] * 0.5
    const = compare(f"K11 constant-source mode (config 6 step 9 states, [{V}, {T}])", "cuda",
                    "graphaudio_tpu_torch/csrc/oscillator.cu",
                    "graphaudio_tpu/nodes/sources.py:231",
                    lambda: tosc.constant_group_step(off, *sched, bt, 48000),
                    lambda: tosc.constant_group_step_plain(off, *sched, bt, 48000), 0,
                    bnd=bound(nbytes(base, *sched, bt) + V * T * 4, 0))
    k11 = dict(osc[0], name="K11 oscillator group step", superblocks=k11_shapes,
               cases=[{k: c[k] for k in ("name", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "device_ms")} for c in osc],
               constant_mode={k: const[k] for k in ("name", "route", "source", "replaces",
                                                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                    "bound_by", "library_ms", "device_ms")})

    rng = np.random.default_rng(14)
    gain = torch.full((V,), 0.6, device=dev)
    mods = {c: torch.from_numpy((rng.standard_normal((V, c, T)) * 0.35).astype(np.float32)).to(dev)
            for c in (1, 2)}
    rows = torch.from_numpy(rng.standard_normal((V, T)).astype(np.float32)).to(dev)
    fmax = float(np.finfo(np.float32).max)  # GainNode.gain's range
    mcases = []
    for label, intr, mod, a_rate, lo, hi in (
            ("config 6: a-rate, gain base values, CHAIN stereo", gain[:, None].expand(V, T),
             mods[2], True, -fmax, fmax),
            ("a-rate, base values, CHAIN mono", gain[:, None].expand(V, T), mods[1], True,
             -1e9, 1e9),
            ("k-rate, base values, CHAIN mono", gain[:, None].expand(V, S), mods[1], False,
             -1e9, 1e9),
            ("a-rate, rows, explicit route", rows, mods[1], True, -1e9, 1e9)):
        L, Cm = intr.shape[1], mod.shape[1]
        scale = float(np.float32(1.0 / np.sqrt(Cm)))
        mcases.append(compare(
            f"K6m param modulation ({label}: mod {list(mod.shape)})", "cuda",
            "graphaudio_tpu_torch/csrc/param_eval.cu", "graphaudio_tpu/ops/param_eval.py:339",
            lambda intr=intr, mod=mod, a=a_rate, lo=lo, hi=hi:
                tpe.apply_modulation(intr, mod, lo, hi, a),
            lambda intr=intr, mod=mod, a=a_rate, lo=lo, hi=hi:
                tpe.apply_modulation_plain(intr, mod, lo, hi, a), 0,
            # intr (rows, or one value a lane) and mod read once (k-rate:
            # one sample a quantum), out written once; flops a sample: the
            # add and the clamp's two (mono), or Cm - 1 adds, an fma (2)
            # and the clamp's two (Cm channels)
            bnd=bound(nbytes(intr if intr.is_contiguous() else gain)
                      + (nbytes(mod) if a_rate else V * S * 4 * Cm) + V * L * 4,
                      (3 if Cm == 1 else Cm + 3) * V * L),
            library=(lambda intr=intr, mod=mod, lo=lo, hi=hi, scale=scale:
                     torch.clamp(intr + (mod[:, 0] if mod.shape[1] == 1
                                         else mod.sum(1) * scale), lo, hi))
            if a_rate else None, device_times=True))
    k6m = dict(mcases[0], name="K6m param modulation",
               cases=[{k: c[k] for k in ("name", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "library_ms", "device_ms")} for c in mcases])
    return [k11, k6m]


def k11_superblocks(dev, L=64):
    """K11 against its plain version at superblocks 1, 8, 33 and 128 (one
    quantum, one tile, a partial last tile, up to four passes of sums), seeded
    states whose starts and stops fall on and inside quanta: sine and
    square bit for bit, sawtooth and triangle within 1e-6, the new phase
    bit for bit, over base values and rows. Returns the errors."""
    import torch

    from graphaudio_tpu_torch.ops import oscillator as tosc

    dt = 128 / SR
    errs = {}
    for S in (1, 8, 33, 128):
        rng = np.random.default_rng(S)
        start = 5 * dt + dt * rng.integers(0, S + 1, L) + dt * np.where(rng.random(L) < 0.5,
                                                                         rng.random(L), 0.0)
        stop = np.where(rng.random(L) < 0.3, np.inf, start + dt * rng.integers(0, S + 1, L)
                        + dt * rng.random(L))
        st = [torch.from_numpy(a).to(dev) for a in (
            (rng.random(L) < 0.9).astype(np.int32), start, stop, rng.uniform(0, 2 * np.pi, L),
            5 * dt + np.arange(S) * dt)]
        rows = torch.from_numpy((rng.random((L, S * 128)) * 20000).astype(np.float32)).to(dev)
        base = rows[:, 0].contiguous()
        for label, f in (("base values", base[:, None].expand(L, S * 128)), ("rows", rows)):
            for wave in tosc.WAVE_CODES:
                args = (f, *st, SR, wave)
                got = tosc.oscillator_group_step(*args)
                want = tosc.oscillator_group_step_plain(*args)
                err = float((got[0] - want[0]).abs().max())
                exact = wave in ("sine", "square")
                if (err > 0 if exact else err > 1e-6) or not torch.equal(got[1], want[1]):
                    raise AssertionError(f"K11 at S={S} ({wave}, {label}) differs from its "
                                         f"plain version: {err}")
                errs[f"S={S} {wave} {label}"] = err
    phase("kernels", f"K11 at superblocks 1, 8, 33 and 128: max_abs_err "
          f"{max(errs.values())!r} (sine and square 0, others 1e-6; new phase bit for bit) OK")
    return errs


def wire_runs(dev, build, step_frames, frames, f32, runs=5,
              methods=("render_mulaw", "render_adpcm"), profile=False):
    """``runs`` 30 s renders each through ``render_mulaw`` and
    ``render_adpcm`` of config 4 from fresh contexts: each packed render
    equal to the host encoders of ``f32`` (a 30 s f32 render from the same
    tree) bit for bit (every run, each run's sha256 kept), K4mu and K4a
    launched once a launch chunk; the xRT
    spread, the wire bytes, and each format's SNR against ``f32``. Then one
    render of each 4321 frames shorter, which ends inside a superblock
    (its kept frames packed on the device, the rest carried as f32), timed and
    held to the host encoders of ``f32``'s first frames bit for bit. Only
    ``methods`` run; with ``profile``, one more render of each under
    torch.profiler gives its pack kernel's device time a launch."""
    from graphaudio_tpu_torch.ops import wire as twire
    from graphaudio_tpu_torch.utils import cudabuild

    def snr_db(got):
        ref = f32.astype(np.float64)
        return float(10 * np.log10(np.sum(ref ** 2) / np.sum((got - ref) ** 2)))

    q = twire.quantize_i16(f32)
    spb = twire.DEFAULT_SAMPLES_PER_BLOCK
    padded = np.concatenate([q, np.zeros((q.shape[0], (-frames) % spb), np.int16)], axis=1)
    want = {"render_mulaw": twire.mulaw_encode_np(f32),
            "render_adpcm": twire.ima_encode_np(padded, spb)}
    ragged = frames - 4321
    q_r = np.concatenate([q[:, :ragged], np.zeros((q.shape[0], (-ragged) % spb), np.int16)],
                         axis=1)
    want_ragged = {"render_mulaw": twire.mulaw_encode_np(f32[:, :ragged]),
                   "render_adpcm": twire.ima_encode_np(q_r, spb)}
    counts = {"render_mulaw": "pack_mulaw", "render_adpcm": "ima_chunk_encode"}
    out = {}
    for method in methods:
        wrapper = counts[method]
        build().render(step_frames)
        cudabuild.launches.clear()
        got, wall, bd = timed_render(build, frames, method)
        launches = cudabuild.launches[wrapper]
        walls, shas = [], []
        for run in range(runs):
            if run:
                got, wall, _ = timed_render(build, frames, method)
            data = got if method == "render_mulaw" else got.blocks
            if not np.array_equal(data, want[method]):
                raise AssertionError(f"{method} (run {run}) differs from the host encoder of "
                                     "the f32 render")
            walls.append(wall)
            shas.append(hashlib.sha256(np.ascontiguousarray(data).tobytes()).hexdigest())
        if launches != bd["n_launches"]:
            raise AssertionError(f"{method}: {launches} {wrapper} launches for "
                                 f"{bd['n_launches']} launch chunks")
        decoded = (twire.mulaw_decode_np(got, f32.shape[0]) if method == "render_mulaw"
                   else got.decode())
        got_r, wall_r, _ = timed_render(build, ragged, method)
        if not np.array_equal(got_r if method == "render_mulaw" else got_r.blocks,
                              want_ragged[method]):
            raise AssertionError(f"{method} of {ragged} frames differs from the host encoder "
                                 "of the f32 render's first frames")
        sha = shas[0]
        out[method] = {"wire_bytes": int(data.nbytes), "f32_bytes": int(f32.nbytes),
                       "sha256": sha, "sha256_runs": shas,
                       "snr_db_vs_f32": snr_db(decoded), "launches": launches,
                       "launch_chunks": bd["n_launches"], **spread(frames, walls),
                       "breakdown": bd, "ragged": {"frames": ragged, "wall_s": wall_r,
                                                   "xrt": ragged / SR / wall_r}}
        phase("render", f"config 4 {method}: {data.shape} {data.dtype}, {data.nbytes} bytes "
              f"({f32.nbytes} as f32); bit for bit the host encoder of the f32 render; "
              f"SNR {out[method]['snr_db_vs_f32']!r} dB against it; {runs} runs {walls!r} s, "
              f"median {out[method]['xrt_median']!r} xRT; {launches} launches for "
              f"{bd['n_launches']} launch chunks; first run breakdown {json.dumps(bd)}; "
              f"{ragged} frames (ragged end) {wall_r!r} s, bit for bit; sha256 of each run "
              f"{shas}")
        if profile:
            out[method]["profile"] = profile_render(build, frames, method, WIRE_GROUPS)
            phase("profile", f"config 4 {method}, one 30 s render under torch.profiler: "
                  f"{json.dumps(out[method]['profile'])}")
    return out


def profile_render(build, frames, method, groups):
    """One render of ``frames`` frames through ``method`` from a fresh
    context under torch.profiler: each kernel group's device time in all
    and a launch, and its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ctx = build()
    ctx._ensure_compiled()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        getattr(ctx, method)(frames)
        torch.cuda.synchronize()
    out = {}
    for label, sub in groups.items():
        us, n = 0.0, 0
        for e in prof.key_averages():
            t_us = getattr(e, "self_device_time_total", None)
            if t_us is None:
                t_us = getattr(e, "self_cuda_time_total", 0.0)
            if sub in e.key and str(getattr(e, "device_type", "")).endswith("CUDA"):
                us, n = us + t_us, n + e.count
        out[label] = {"device_us": us, "launches": n, "us_a_launch": us / n if n else None}
    return out


def config6_runs(dev, runs=5):
    """Config 6 at full size (64 voices, superblock 32, 351 superblocks),
    modulated and not, ``runs`` renders each (``render_runs``): the
    modulated one's first 8192 frames within 1e-5 of the golden, the
    unmodulated one's of its CPU render; K11 once a step in both, K6m once
    a step in the modulated one and never in the other."""
    from graphaudio_tpu_torch.testing.configs import config6_lfo_tremolo

    T6 = 32 * 128
    frames6 = (30 * SR // T6) * T6
    steps = frames6 // T6
    counts = {"K11": ("oscillator_group_step",), "K11 constant": ("constant_group_step",),
              "K6m": ("apply_modulation",), "K5": ("unity_group_step",),
              "K3": ("fan_in_lanes",)}
    ref_u = config6_lfo_tremolo(superblock=32, modulated=False, device="cpu").render(2 * T6)
    out = {
        "modulated": render_runs(6, lambda: config6_lfo_tremolo(superblock=32, device=dev), T6,
                                 frames6, counts, K11K6M_GROUPS, runs=runs),
        "unmodulated": render_runs(
            "6 unmodulated",
            lambda: config6_lfo_tremolo(superblock=32, modulated=False, device=dev), T6,
            frames6, counts, K11K6M_GROUPS, runs=runs, ref=ref_u),
    }
    for variant, k6m in (("modulated", steps), ("unmodulated", 0)):
        got = out[variant]["launches"]
        if got["K11"] != steps or got["K6m"] != k6m:
            raise AssertionError(f"config 6 {variant}: K11 {got['K11']} and K6m {got['K6m']} "
                                 f"launches in {steps} steps, not {steps} and {k6m}")
    return out


#: This slice's kernels by a substring of their names: K7 and K6 (whose
#: exact rows run in the same kernel), and K11 and K6m beside them.
K7_GROUPS = {"K7": "resample_step", "K6": "param_eval", "K11": "oscillator_kernel",
             "K6m": "apply_modulation"}


def resample_mid_render(ctx, dev, step=9):
    """K7's arguments at step ``step`` of ctx's time-varying source group:
    (states, arena, geom, gtab, playbackRate rows f32[V, S] from the
    step's K6 arena, rc, w), the states advanced by the plain step through
    the steps before."""
    import torch

    import graphaudio_tpu_torch as gat
    from graphaudio_tpu_torch.core import graph as tgraph
    from graphaudio_tpu_torch.ops import param_eval as tpe

    node = gat.AudioBufferSourceNode
    ctx._ensure_compiled()
    ctx._ensure_params_encoded()
    si = min(ctx._compiled._bufsrc_cfg)
    w, variant, _ = ctx._compiled._bufsrc_cfg[si]
    assert variant[0] == "resample", variant
    c = ctx._consts
    arena, geom, gtab = c[f"st{si}/arena"], c[f"st{si}/geom"], c[f"st{si}/gtab"]
    table = ctx._encs[tgraph.PARAM_TABLE]
    slot = table["slots"][f"st{si}/playbackRate"]
    S, T = ctx.superblock, ctx.superblock * 128
    clock = ctx._block_clock((step + 1) * S)
    st = ctx._states[f"st{si}"]
    for k in range(step + 1):
        rc = tgraph.RenderContext(ctx._compiled.info, k * T,
                                  torch.from_numpy(clock[k * S:(k + 1) * S]).to(dev))
        rows = tpe.eval_intrinsic_batch(table, rc.block_times, rc.dt)
        rate = rows.narrow(0, slot.off, slot.lanes * slot.per_lane).view(slot.lanes, S)
        if k < step:
            st, _ = node.resample_group_step_plain(st, arena, geom, rate, rc, w)
    return st, arena, geom, gtab, rate, rc, w


def vibrato_launch(dev, step=9):
    """K7's arguments as the vibrato's first ungrouped stage (V = 1, S = 32,
    its rate through K6m) passes them at step ``step`` of a render on the
    card (``groups.vibrato_launches``)."""
    from graphaudio_tpu_torch.testing import groups

    seen = groups.vibrato_launches(dev, step + 1)
    assert len(seen) == 8 * (step + 1), len(seen)
    return seen[8 * step]


def k7_case(label, args, step):
    """K7 against its plain version on ``args`` (``resample_mid_render``'s),
    taken at ``step``: the audio, the new x, primed and stop_time bit for
    bit. Timed warm (``compare``) and cold: each call after a write of
    ``COLD_BYTES`` x 2, more than the L2 holds, K7's own device time
    (``cold_device_ms``). The bound is the step's bytes: states read and
    written, the geometry, the clocks, the rates, the audio written and the
    arena samples the valid outputs read (each once: a voice's advance, 128
    x its clamped rate over its active quanta, plus its 3 extra taps),
    beside ~20 f32 operations an output (the split, the weights, 4 taps)."""
    import torch

    import graphaudio_tpu_torch as gat
    from graphaudio_tpu_torch.ops import voice_group

    node = gat.AudioBufferSourceNode
    st, arena, geom, gtab, rate, rc, w = args

    def fused():
        return node.process_resample_group(st, arena, geom, gtab, rate, rc, w)

    def plain():
        return node.resample_group_step_plain(st, arena, geom, rate, rc, w)

    new_f, out = fused()
    new_p, want = plain()
    torch.cuda.synchronize()
    as_int = lambda t: t.view(torch.int64 if t.element_size() == 8 else torch.int32) \
        if t.is_floating_point() else t  # noqa: E731
    differ = [f for f in ("x", "primed", "stop_time")
              if not torch.equal(as_int(new_f[f]), as_int(new_p[f]))]
    if not torch.equal(as_int(out), as_int(want)):
        differ.insert(0, "audio")
    if differ:
        raise AssertionError(f"K7 ({label}): {differ} differ from the plain version")
    V, C, T = out.shape
    # the advance from the rates, not from the new x, which a loop wrap moves back
    cap = voice_group.resample_geometry(T // 128, w)[0]
    rate_b = torch.clamp((geom["rate"] / float(rc.sample_rate))[:, None] * rate.double(),
                         max=float(cap))
    adv = torch.where(node._active_mask(st, rc), 128.0 * rate_b, 0.0).sum(dim=1)
    read = int(torch.where(adv > 0, torch.ceil(adv) + 3, 0.0).sum()) * C * 4
    moved = (nbytes(*st.values()) + nbytes(new_f["x"], new_f["primed"], new_f["stop_time"])
             + nbytes(gtab, rate, out) + 2 * nbytes(rc.block_times) + read)
    e = compare(f"K7 time-varying resample group step ({label}: V={V} C={C} S={T // 128}, "
                f"mid-render step {step})", "cuda", "graphaudio_tpu_torch/csrc/resample.cu",
                "graphaudio_tpu/nodes/sources.py:783", lambda: fused()[1], lambda: plain()[1],
                0.0, bnd=bound(moved, 20 * out.numel()))
    e["bit_exact"] = ["audio", "x", "primed", "stop_time"]
    flush = torch.empty(2 * COLD_BYTES // 4, device=out.device)
    e["cold_device_ms"] = device_ms(lambda: (flush.zero_(), fused()), only="resample_step")
    phase("kernels", f"K7 ({label}): bit for bit; cold {e['cold_device_ms']!r} ms on the device")
    return e


def k7_checks(dev):
    """K7 at config4_pitched's step (64 voices, superblock 64), and at one
    voice with a loop shorter than a superblock (S = 1, 4, 16, 64), stereo
    (S = 32), the edge-case group (S = 4) and the vibrato's ungrouped launch
    (V = 1, S = 32) under "shapes" (graphaudio_tpu_torch/testing/groups.py,
    rates at ``step_rates``)."""
    from graphaudio_tpu_torch.testing import groups
    from graphaudio_tpu_torch.testing.configs import config4_pitched

    keys = ("name", "max_abs_err", "bit_exact", "ms", "plain_ms", "bound_ms", "bound_by",
            "device_ms", "cold_device_ms")
    e = k7_case("config4_pitched", resample_mid_render(
        config4_pitched(superblock=64, voices=64, device=dev), dev), 9)
    cases = [(f"one voice S={S}", groups.resample_group(S, dev, specs=groups.POLY_VOICES[1:2]))
             for S in (1, 4, 16, 64)]
    cases += [("stereo", groups.resample_group(32, dev, channels=2)),
              ("edge cases", groups.resample_group(4, dev))]
    shapes = [k7_case(label, resample_mid_render(_with_rates(ctx, dev), dev, 4), 4)
              for label, ctx in cases]
    shapes.append(k7_case("the vibrato's ungrouped voice", vibrato_launch(dev), 9))
    e["shapes"] = [{k: x[k] for k in keys} for x in shapes]
    e["name"] = "K7 time-varying resample group step"
    e["library_ms"] = None
    return e


def _with_rates(ctx, dev):
    """ctx with a playbackRate ramp on every voice (events, so the K6 table
    holds the group's k-rate exact rows)."""
    for n in ctx._compiled.stages[0][1]:
        n.playback_rate.set_value_at_time(0.7, 0.0)
        n.playback_rate.linear_ramp_to_value_at_time(1.9, 0.05)
    ctx._ensure_compiled()
    return ctx


def k6x_case(label, table, bt, ulp_only=False):
    """K6 over ``table`` (rows of the exact kind among them) against its
    plain version: bit for bit, or (``ulp_only``: exponential and setTarget
    curves in f64) within one f32 ulp of each value."""
    import torch

    from graphaudio_tpu_torch.ops import param_eval as tpe

    dt = 1.0 / SR
    got = tpe.eval_intrinsic_batch(table, bt, dt)
    want = tpe.eval_intrinsic_batch_plain(table, bt, dt)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy().astype(np.float64), want.cpu().numpy()
    ulps = float((np.abs(g - w) / np.spacing(np.abs(w).astype(np.float32))).max()) \
        if w.size else 0.0
    if ulps > (1.0 if ulp_only else 0.0):
        raise AssertionError(f"K6 exact rows ({label}): {ulps} ulps from the plain version")
    fields = [table[k] for k in ("times", "tcs", "values", "types", "boundary", "n", "base",
                                 "rows")]
    e = compare(f"K6 exact rows ({label})", "cuda", "graphaudio_tpu_torch/csrc/param_eval.cu",
                "graphaudio_tpu/ops/param_eval.py:213",
                lambda: tpe.eval_intrinsic_batch(table, bt, dt),
                lambda: tpe.eval_intrinsic_batch_plain(table, bt, dt),
                float(np.spacing(np.float32(max(1.0, np.abs(w).max())))) if ulp_only else 0.0,
                # the table and clock read once, the arena written once;
                # about ten operations a value (f64 at k-rate)
                bnd=bound(nbytes(*fields, bt, got), 10 * got.numel(), F64_FLOPS))
    e["max_ulps"] = ulps
    return e


def k6x_checks(dev):
    """K6's exact rows as the step launches them, mid-render at step 9:
    config4_pitched's table (64 k-rate exact rows, the f64 curve at the
    block times) and config6_swept's (64 exact a-rate rows of linear
    ramps), bit for bit; a seeded table of every curve type in exact rows
    beside ordinary ones within one f32 ulp (CUDA's f64 pow/exp)."""
    from graphaudio_tpu_torch.core import graph as tgraph
    from graphaudio_tpu_torch.core.graph import to_device
    from graphaudio_tpu_torch.ops import param_eval as tpe
    from graphaudio_tpu_torch.testing import tables as ttab
    from graphaudio_tpu_torch.testing.configs import config4_pitched, config6_swept

    keys = ("name", "max_abs_err", "max_ulps", "ms", "plain_ms", "bound_ms", "bound_by",
            "device_ms")
    out = []
    for label, ctx, S in (
            ("config4_pitched: 64 k-rate rows", config4_pitched(superblock=64, device=dev), 64),
            ("config6_swept: 64 a-rate rows", config6_swept(superblock=32, device=dev), 32)):
        ctx._ensure_compiled()
        ctx._ensure_params_encoded()
        table = ctx._encs[tgraph.PARAM_TABLE]
        assert int(table["rows"][:, 2].sum()) == 64, label
        out.append(k6x_case(label, table, torch_clock(dev, 10 * S, 9, S)))
    S = 32
    entries = ttab.mixed_param_entries(0, 12 * S * ttab.BLOCK)
    table = to_device(tpe.pack_param_table(
        entries + [(f"x{k}", e[1], e[2], True) for k, e in enumerate(entries)], S), dev)
    out.append(k6x_case("every curve type, 21 exact rows beside 21 ordinary",
                        table, torch_clock(dev, 12 * S, 9, S), ulp_only=True))
    e = dict(out[0], name="K6 exact rows", library_ms=None)
    e["shapes"] = [{k: x[k] for k in keys} for x in out[1:]]
    return e


def k4a_streamed(dev):
    """K4a's streamed path at WAV's longest stereo (65521) and mono
    (131057) blocks: each chunk of two blocks and a part, bit for bit the
    host encoder (``ima_encode_np``) of its stream buffer; timed by CUDA
    events over bursts (``burst_ms``; a launch takes milliseconds). Bound:
    one block's chain, 20 + 11 (spb - 1) dependent operations at one a
    clock."""
    import torch

    from graphaudio_tpu_torch.ops import wire as twire

    out = []
    for spb, C in ((65521, 2), (131057, 1)):
        rng = np.random.default_rng(spb)
        F, carry_len = 2 * spb + 1000, 7
        x = (rng.standard_normal((C, F)) * 0.5).astype(np.float32)
        carry = rng.integers(-32768, 32768, (C, spb - 1)).astype(np.int16)
        audio, carry_t = torch.from_numpy(x).to(dev), torch.from_numpy(carry).to(dev)
        blocks, _ = twire.ima_chunk_encode(audio, carry_t, carry_len)
        torch.cuda.synchronize()
        ncap = twire.ima_chunk_slots(F, spb)
        buf = np.zeros((C, ncap * spb), np.int16)
        buf[:, :spb - 1] = carry
        buf[:, carry_len:carry_len + F] = twire.quantize_i16(x)
        if not np.array_equal(blocks.cpu().numpy(), twire.ima_encode_np(buf, spb)):
            raise AssertionError(f"K4a streamed (spb {spb}, C {C}) differs from the host encoder")
        reads = burst_ms(lambda: twire.ima_chunk_encode(audio, carry_t, carry_len), 3)
        bound_ms = (20 + 11 * (spb - 1)) / CHAIN_OPS * 1e3
        name = f"K4a IMA ADPCM streamed path (spb {spb}, [{C}, {F}], carry_len {carry_len})"
        phase("kernels", f"{name}: bit for bit the host encoder; {statistics.median(reads)!r} "
              f"ms a launch on the device (CUDA events over bursts of 3: {reads}); bound "
              f"{bound_ms!r} ms (operations: one block's chain)")
        out.append({"name": name, "max_abs_err": 0, "device_ms": statistics.median(reads),
                    "device_bursts_ms": reads, "bound_ms": bound_ms, "bound_by": "operations"})
    return out


def slice16_runs(dev, runs=3):
    """The paths of the time-varying rate, each against its own CPU render
    within 1e-5: config4_pitched at full size (64 voices, superblock 64,
    175 superblocks), K7 and K6 once a step, and config6_swept at full size
    (superblock 32, 351 superblocks), K6, K11 and K6m once a step, over
    their first 8 superblocks; the vibrato (config 2's 8 voices,
    superblock 32, 64 superblocks), K7 and K6m 8 times a step (8 ungrouped
    stages), over all 64 (a sine LFO's ulps would grow through the
    integrated playhead). Each ``runs`` renders with a profile window
    (``render_runs``)."""
    from graphaudio_tpu_torch.testing.configs import (config2_vibrato, config4_pitched,
                                                      config6_swept)

    T4, T6 = 64 * 128, 32 * 128
    frames4, frames6 = 175 * T4, (30 * SR // T6) * T6
    counts = {"K7": ("resample_group_step",), "K6": ("eval_intrinsic_batch",),
              "K11": ("oscillator_group_step",), "K6m": ("apply_modulation",),
              "K2a": ("spectral_mac",), "K2b": ("overlap_add",), "K3": ("fan_in_lanes",),
              "K5": ("unity_group_step",)}
    out = {}
    for key, build, T, frames, head, want in (
            ("config4_pitched", lambda d: config4_pitched(superblock=64, device=d), T4, frames4,
             8, {"K7": 1, "K6": 1, "K2b": 1}),
            ("config6_swept", lambda d: config6_swept(superblock=32, device=d), T6, frames6,
             8, {"K6": 1, "K11": 1, "K6m": 1}),
            ("vibrato", lambda d: config2_vibrato(superblock=32, device=d), T6, 64 * T6,
             64, {"K7": 8, "K6m": 8, "K11": 1})):
        ref = build("cpu").render(head * T)
        r = render_runs(key, lambda: build(dev), T, frames, counts, K7_GROUPS, runs=runs,
                        ref=ref)
        steps = frames // T
        for label, n in want.items():
            if r["launches"][label] != n * steps:
                raise AssertionError(f"{key}: {label} launched {r['launches'][label]} times in "
                                     f"{steps} steps, not {n} a step")
        phase("render", f"{key}: xRT median {r['f32']['xrt_median']!r}, device us a step "
              f"{r['profile']['device_us_per_step']!r}, launches a step "
              f"{r['profile']['launches_per_step']!r}, sha256 {r['sha256']}, first {head} "
              f"superblocks vs the CPU render {r['head_vs_golden']!r}")
        out[key] = r
    return out


#: The kernel groups of the modulated-prologue and item-10 paths.
PROLOGUE_ITEM10_GROUPS = {"K8": "biquad_coeffs", "P2": "biquad_cascade", "K10b": "spatial_gains",
                  "P1": "hrtf_fir", "K6m": "apply_modulation", "K12": "delay_kernel",
                  "K13": "stereo_pan", "K6": "param_eval"}


def same_bits(label, got, want):
    """Raise unless each pair of tensors is equal bit for bit."""
    import torch

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    torch.cuda.synchronize()
    differ = [i for i, (g, w) in enumerate(zip(got, want)) if not torch.equal(bits(g), bits(w))]
    if differ or len(got) != len(want):
        raise AssertionError(f"{label}: outputs {differ} differ from the plain version")


def deferred_checks(dev, step=9):
    """K8 and K10b launched the new way: the one-item table of a stage
    whose prologue param is modulated, at its turn, reading K6m's reserved
    rows. config3_wah's four biquad stages and config5_orbit's panner group
    (128 lanes, positionX k-rate) at step ``step`` of a render on the card,
    every output bit for bit against its plain version on the same arena;
    timed alone (``compare`` on the first output, no concatenation). Bounds:
    K8 reads each source once (a-rate T floats, k-rate S, a constant 1) and
    writes b f32[3, V, T] and p c64[2, V, T], ~40 f32 operations a sample;
    K10b reads positionX's k-rate rows and the constants and writes f32[6,
    V, S], ~100 operations a (voice, quantum)."""
    from graphaudio_tpu_torch.nodes import spatial as tsp
    from graphaudio_tpu_torch.ops import biquad as tbq
    from graphaudio_tpu_torch.testing import groups
    from graphaudio_tpu_torch.testing.configs import config3_wah, config5_orbit

    keys = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms")
    seen = groups.deferred_launches(config3_wah(superblock=32, device=dev), step + 1)
    assert len(seen) == 4 * (step + 1), len(seen)
    per = {tbq.SRC_ARATE: 0, tbq.SRC_KRATE: 0, tbq.SRC_CONST: 1}
    k8 = []
    for key, table, arena, rc in seen[-4:]:
        label = f"K8 RBJ coefficients, deferred (config3_wah {key}, step {step})"
        (got,), (want,) = (f(table, arena, rc.sample_rate) for f in (
            tbq.biquad_coefficients_batch, tbq.biquad_coefficients_batch_plain))
        same_bits(label, got, want)
        rows = table["rows"].cpu().long()
        V, T = rows.shape[0], table["frames"]
        per[tbq.SRC_ARATE], per[tbq.SRC_KRATE] = T, T // 128
        src_bytes = 4 * sum(per[int(w) & 3] for w in rows[:, 1:4].flatten())
        e = compare(f"{label[:-1]}: V={V} T={T})", "cuda", "graphaudio_tpu_torch/csrc/biquad.cu",
                    "graphaudio_tpu/ops/biquad.py:43",
                    lambda: tbq.biquad_coefficients_batch(table, arena, rc.sample_rate)[0][0],
                    lambda: tbq.biquad_coefficients_batch_plain(table, arena,
                                                                rc.sample_rate)[0][0],
                    0.0, bnd=bound(src_bytes + nbytes(table["rows"], *got), 40 * V * T))
        e["bit_exact"] = ["b0", "b1", "b2", "p1", "p2"]
        k8.append(e)
    e8 = dict(k8[0], name="K8 RBJ coefficients, deferred", library_ms=None)
    e8["shapes"] = [{k: x[k] for k in keys} for x in k8[1:]]
    seen = groups.deferred_launches(config5_orbit(superblock=32, voices=128, device=dev),
                                    step + 1)
    assert len(seen) == step + 1, len(seen)
    key, table, arena, rc = seen[-1]
    (_, V, _, words), = table["stages"]
    S = table["superblock"]
    label = f"K10b spatial gains, deferred (config5_orbit {key}, step {step}: V={V} S={S})"
    same_bits(label, tsp.spatial_gains_batch(table, arena, rc.globals),
              tsp.spatial_gains_batch_plain(table, arena, rc.globals))
    rows = sum(1 for w in words if w & 3 != tbq.SRC_CONST)  # params read from arena rows
    e10 = compare(
        label, "cuda", "graphaudio_tpu_torch/csrc/spatial_gains.cu",
        "graphaudio_tpu/nodes/spatial.py:270",
        lambda: tsp.spatial_gains_batch(table, arena, rc.globals)[0],
        lambda: tsp.spatial_gains_batch_plain(table, arena, rc.globals)[0], 0.0,
        bnd=bound(4 * rows * V * S + nbytes(table["consts"]) + 24 * V * S, 100 * V * S))
    e10.update(name="K10b spatial gains, deferred", library_ms=None, bit_exact=["gains"])
    return [e8, e10]


def delay_expression(x, dt, ring, wpos, sr):
    """The delay step as one would write it in PyTorch (a yardstick for K12,
    not used by the port): the ring unrolled oldest first before the input,
    each output one gather from that history, the new ring its last L
    samples rolled to the new cursor."""
    import torch

    C, T = x.shape
    L = ring.shape[1]
    k = torch.arange(L, device=x.device)
    hist = torch.cat([ring[:, (k + wpos) % L], x], dim=1)
    d = torch.clamp(dt * torch.tensor(np.float32(sr), device=x.device), 0.0, float(L)).long()
    out = torch.where(d > 0, hist[:, L + torch.arange(T, device=x.device) - d], 0.0)
    return out, hist[:, T:][:, (k - wpos - T) % L]


def pan_expression(x, pan):
    """The stereo panner as one would write it in PyTorch (a yardstick for
    K13, not used by the port): f32 trig, no fma."""
    import torch

    p = torch.clamp(pan, -1.0, 1.0)
    if x.shape[1] == 1:
        a = (p + 1.0) * (np.pi / 4)
        return torch.stack([x[:, 0] * torch.cos(a), x[:, 0] * torch.sin(a)], dim=1)
    left = p <= 0.0
    a = torch.where(left, p + 1.0, p) * (np.pi / 2)
    gl, gr = torch.cos(a), torch.sin(a)
    l, r = x[:, 0], x[:, 1]
    return torch.stack([torch.where(left, l + r * gl, l * gl),
                        torch.where(left, r * gr, r + l * gr)], dim=1)


def delay_reads(dt, T, L, sr):
    """What one delay step's data makes it read, a channel: (the ring
    slots, the distinct samples i - d_i before the step over the frames i
    with 0 < d_i and i < d_i; the input samples, the distinct x[i - d_i]
    over the frames with 0 < d_i <= i and the min(T, L) trailing ones that
    go to the ring)."""
    import torch

    d = torch.clamp(dt * torch.tensor(np.float32(sr), device=dt.device), 0.0, float(L)).long()
    i = torch.arange(T, device=dt.device)
    s = i - d
    ring = (d > 0) & (s < 0)
    from_x = torch.cat([s[(d > 0) & (s >= 0)], i[T - min(T, L):]])
    return int(torch.unique(s[ring]).numel()), int(torch.unique(from_x).numel())


def k12_case(label, args, library=False):
    """K12 against its plain version on ``args`` (x, delay times, a delay
    state, sample rate, max delay L), each on its own copy of the state,
    which both update in place: the output, the ring (whole and its JAX
    view), the slot cursor (a copy for each block) and ``wpos`` bit for
    bit; the launch timed alone on a copy of the state that it moves along.
    Bound: the bytes the function must move, counted from this run's data
    (``delay_reads``): the distinct input samples it reads (4 each, one row
    for a stride-0 x, else C), the output (4 C T), the delay times (4 T, or
    4 for one base value), the ring slots it reads and the min(T, L) it
    writes (4 C each) and the cursor (8, read and written); the f32
    multiply a frame and ~8 integer operations an element are far under
    it. ``ring_copy_bytes`` is 0 (no copy). Also the device time of the
    delay kernel alone and, for an x that is a view, of the copy that a
    wrapper making x contiguous would add. With ``library`` the PyTorch
    expression (``delay_expression``, on the JAX view) is checked against
    the kernel and timed beside it."""
    from graphaudio_tpu_torch.nodes import delay as td

    x, dt, st, sr, L = args
    C, T = x.shape
    R, W = st["ring"].shape[1], min(T, L)
    view = ", x a stride-0 view" if x.stride(0) == 0 else ""
    name = f"K12 delay ({label}: C={C} T={T} L={L}{view})"

    def copy():
        return {k: v.clone() for k, v in st.items()}

    got_st, want_st = copy(), copy()
    got = td.delay_step(x, dt, got_st, sr, L)
    want = td.delay_step_plain(x, dt, want_st, sr, L)
    got_view, want_view = td.delay_jax_view(got_st, L), td.delay_jax_view(want_st, L)
    keys = ("ring", "slot", "wpos")
    same_bits(name, [got, got_view["ring"], *(got_st[k] for k in keys)],
              [want, want_view["ring"], *(want_st[k] for k in keys)])
    moved_to = (got_st["slot"].tolist(), int(got_st["wpos"]))
    if moved_to != ([(int(st["slot"][0]) + W) % R] * st["slot"].numel(),
                    (int(st["wpos"]) + T) % L):
        raise AssertionError(f"{name}: cursors moved to {moved_to}")
    jax_in = td.delay_jax_view(st, L)
    if library:
        same_bits(f"{name}, the PyTorch expression", [got, got_view["ring"]],
                  delay_expression(x, dt, jax_in["ring"], jax_in["wpos"], sr))
    reads, x_reads = delay_reads(dt, T, L, sr)
    x_rows = C if x.stride(0) else 1
    moved = (4 * x_rows * x_reads + 4 * C * T + (4 * T if dt.stride(0) else 4)
             + 4 * C * (reads + W) + 8)
    timed_st, plain_st = copy(), copy()

    def kernel():
        return td.delay_step(x, dt, timed_st, sr, L)

    e = compare(name, "cuda", "graphaudio_tpu_torch/csrc/delay.cu",
                "graphaudio_tpu/nodes/delay.py:54", kernel,
                lambda: td.delay_step_plain(x, dt, plain_st, sr, L), 0.0,
                bnd=bound(moved, T, int_ops=8 * C * (T + W)),
                library=((lambda: delay_expression(x, dt, jax_in["ring"], jax_in["wpos"], sr)[0])
                         if library else None),
                device_times=library)
    e.update(bit_exact=["out", "ring", "jax view", "slot", "wpos"],
             bound_bytes=moved, ring_slots_read=reads, input_samples_read=x_reads,
             ring_copy_bytes=0, kernel_device_ms=device_ms(kernel, only="delay_kernel"))
    if not x.is_contiguous():
        e["input_copy_device_ms"] = device_ms(lambda: x.contiguous())
    phase("kernels", f"{name}: the function moves {moved} bytes ({x_rows} x {x_reads} input "
          f"samples, {reads} ring slots read, {W} written); the delay kernel alone "
          f"{e['kernel_device_ms']!r} ms on the device"
          + (f", x made contiguous {e['input_copy_device_ms']!r} ms" if view else ""))
    return e


def _seeded_delay(dev, C, T, L, delays, w, seed, broadcast=False):
    import torch

    from graphaudio_tpu_torch.nodes import delay as td

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((C, T)).astype(np.float32)).to(dev)
    if broadcast:  # a mono row up-mixed to C channels, as the splitter feeds a delay
        x = x[:1].expand(C, T)
    ring = rng.standard_normal((C, L)).astype(np.float32)
    st = td.delay_state_from_jax({"ring": ring, "wpos": w}, T, dev, slot=3 * w + 1)
    max_s = np.float32(L / SR)
    if delays == "L":
        dt = torch.full((T,), float(max_s), device=dev)
    elif delays == "zero":
        dt = torch.zeros((), device=dev).expand(T)
    elif delays == "short":  # one base value, d < T
        dt = torch.full((), float(np.float32(0.1 * T / SR)), device=dev).expand(T)
    else:
        dt = torch.from_numpy(np.minimum(np.linspace(0.0, 1.2 * max_s, T), max_s)
                              .astype(np.float32)).to(dev)
    return x, dt, st, SR, L


def k12_checks(dev, step=9):
    """K12 at config4_pingpong's two delays at step ``step`` of a render on
    the card (C = 2, the splitter's mono row up-mixed as a stride-0 view, T
    = 8192, L = 48000: the right one's exact a-rate rows, d > T, ring
    reads; the left one's base value, d = 4800 < T), and seeded: d = L with
    T < L (every read the sample L back) and with T >= L, T = L, a ramp
    through d = 0 to past T, d = 0 throughout, a stride-0 input, mono and
    stereo; each bit for bit, timed (``k12_case``)."""
    from graphaudio_tpu_torch.nodes import delay as td
    from graphaudio_tpu_torch.testing import groups
    from graphaudio_tpu_torch.testing.configs import config4_pingpong

    keys = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
            "kernel_device_ms", "input_copy_device_ms", "bound_bytes", "ring_slots_read",
            "input_samples_read", "ring_copy_bytes")
    seen = groups.calls_of(td, "delay_step",
                           lambda: config4_pingpong(superblock=64, voices=64, device=dev),
                           step + 1)
    assert len(seen) == 2 * (step + 1), len(seen)
    at = seen[-2:]
    right, left = (at[0], at[1]) if at[0][1].stride(0) else (at[1], at[0])
    out = [k12_case(f"config4_pingpong right, step {step}", right, library=True),
           k12_case(f"config4_pingpong left, step {step}", left)]
    for label, shape, broadcast in (
            ("d = L, T < L", (2, 4096, 6000, "L", 5999), False),
            ("d = L, T >= L", (1, 8192, 4800, "L", 17), False),
            ("T = L", (2, 4096, 4096, "ramp", 4095), False),
            ("ramp through d = 0 past T", (1, 8192, 48000, "ramp", 31000), False),
            ("d < T, one base value", (2, 8192, 48000, "short", 123), False),
            ("d = 0", (2, 4096, 960, "zero", 3), False),
            ("d = L, T < L", (2, 8192, 48000, "L", 47999), True)):
        out.append(k12_case(label, _seeded_delay(dev, *shape, seed=len(out),
                                                 broadcast=broadcast)))
    e = dict(out[0], name="K12 delay")
    e["shapes"] = [{k: x.get(k) for k in keys} for x in out[1:]]
    return e


def k13_checks(dev, step=9):
    """K13 at config5_steplinear's step ``step`` (128 lanes of the Kit's
    up-mixed mono, the stereo law, one base pan a lane) and
    config4_pingpong's (one lane, the stereo law, a row of ramped pans), and
    seeded: both laws with pan rows through -1.5 to 1.5 (clipped; -1, 0
    and 1 exactly among them) and with base values -1, 0 and 1. Tolerance:
    one f32 ulp of the output's largest value (the plain version's fma is an
    f64 sum rounded to f32). Bound: bytes, x, the pans and the output read
    or written once; the two f64 transcendentals a frame (~40 f64
    operations) under it. The first case also times the PyTorch expression
    (``pan_expression``: f32 trig, no fma)."""
    import torch

    from graphaudio_tpu_torch.nodes import panner as tp
    from graphaudio_tpu_torch.testing import groups
    from graphaudio_tpu_torch.testing.configs import config4_pingpong, config5_steplinear

    keys = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms")
    cases = []
    for label, build in (
            ("config5_steplinear", lambda: config5_steplinear(superblock=32, device=dev)),
            ("config4_pingpong", lambda: config4_pingpong(superblock=64, device=dev))):
        seen = groups.calls_of(tp, "stereo_pan", build, step + 1)
        assert len(seen) == step + 1, len(seen)
        cases.append((f"{label}, step {step}", seen[-1]))
    rng = np.random.default_rng(13)
    for C in (1, 2):
        x = torch.from_numpy(rng.standard_normal((8, C, 4096)).astype(np.float32)).to(dev)
        pan = np.linspace(-1.5, 1.5, 8 * 4096).astype(np.float32).reshape(8, 4096)
        pan[:, :3] = (-1.0, 0.0, 1.0)
        cases.append((f"{'mono' if C == 1 else 'stereo'} law, pan rows",
                      (x, torch.from_numpy(pan).to(dev))))
        base = torch.tensor([-1.0, 0.0, 1.0], device=dev)
        cases.append((f"{'mono' if C == 1 else 'stereo'} law, pan -1, 0, 1",
                      (x[:3].contiguous(), base[:, None].expand(3, 4096))))
    out = []
    for label, (x, pan) in cases:
        V, C, T = x.shape
        moved = nbytes(x) + (4 * V * T if pan.stride(-1) else 4 * V) + 8 * V * T
        first = not out
        out.append(compare(f"K13 stereo pan ({label}: V={V} C={C} T={T})", "cuda",
                           "graphaudio_tpu_torch/csrc/stereo_pan.cu",
                           "graphaudio_tpu/nodes/panner.py:44", lambda: tp.stereo_pan(x, pan),
                           lambda: tp.stereo_pan_plain(x, pan), 2.0 ** -23, rel=True,
                           bnd=bound(moved, 40 * V * T, F64_FLOPS),
                           library=(lambda: pan_expression(x, pan)) if first else None,
                           device_times=first))
    e = dict(out[0], name="K13 stereo pan")
    e["shapes"] = [{k: x[k] for k in keys} for x in out[1:]]
    return e


def prologue_item10_runs(dev, which=("config3_wah", "config5_orbit", "config5_steplinear",
                             "config4_pingpong"), runs=5):
    """The paths of a modulated prologue param and of item 10 at full size,
    30 s rounded down to whole superblocks, each ``runs`` renders with a
    profile window (``render_runs``), its first 8 superblocks within 1e-5 of
    the same graph's CPU render: config3_wah (superblock 32: four deferred
    K8 launches, four K6m and four P2 a step), config5_orbit (128 voices,
    superblock 32: one deferred K10b and one K6m a step), config5_steplinear
    (128 voices: one K13 a step) and config4_pingpong (64 voices, superblock
    64: two K12 and one K13 a step)."""
    from graphaudio_tpu_torch.testing import configs

    counts = {"K8": ("biquad_coefficients_batch",), "P2": ("biquad_apply",),
              "K10b": ("spatial_gains_batch",), "P1": ("hrtf_fir",),
              "K6m": ("apply_modulation",), "K6": ("eval_intrinsic_batch",),
              "K12": ("delay_step",), "K13": ("stereo_pan",), "K7": ("resample_group_step",),
              "K5": ("unity_group_step",), "K1": ("poly_group_step",),
              "K11": ("oscillator_group_step",), "K2b": ("overlap_add",)}
    paths = {"config3_wah": (32, {"K8": 4, "P2": 4, "K6m": 4, "K6": 1, "K11": 1}),
             "config5_orbit": (32, {"K10b": 1, "K6m": 1, "P1": 1, "K11": 1}),
             "config5_steplinear": (32, {"K13": 1, "K2b": 1}),
             "config4_pingpong": (64, {"K12": 2, "K13": 1, "K6": 1, "K1": 1, "K2b": 1})}
    out = {}
    for key in which:
        S, want = paths[key]
        T = S * 128
        frames = (30 * SR // T) * T
        build = getattr(configs, key)
        ref = build(superblock=S, device="cpu").render(8 * T)
        r = render_runs(key, lambda: build(superblock=S, device=dev), T, frames, counts,
                        PROLOGUE_ITEM10_GROUPS, runs=runs, ref=ref)
        steps = frames // T
        for label, n in want.items():
            if r["launches"][label] != n * steps:
                raise AssertionError(f"{key}: {label} launched {r['launches'][label]} times in "
                                     f"{steps} steps, not {n} a step")
        phase("render", f"{key}: xRT median {r['f32']['xrt_median']!r}, device us a step "
              f"{r['profile']['device_us_per_step']!r}, launches a step "
              f"{r['profile']['launches_per_step']!r}, sha256 {r['sha256']}, first 8 "
              f"superblocks vs the CPU render {r['head_vs_golden']!r}")
        out[key] = r
    return out


#: The sha256 of config 3's 30 s render (superblock 32, 351 steps) on the
#: H100, four biquad stages unfused, which the fused pipe renders too; since
#: K8 takes glibc's sin and cos (before that, 8f976460eb32...).
CONFIG3_UNFUSED_SHA256 = "610d771ebbf581e0f1d4720ae61466391ecda891dae1515cca1feff4ee24e67a"

#: Every earlier path's sha256 on the H100 as the earlier trees rendered it,
#: by its place in the main run's ``render`` object (for config4_wire, of
#: the 30 s ``render_mulaw`` and ``render_adpcm`` bytes; config5_streamed's
#: as the tree that read its feeds a step at a time rendered it;
#: config5_measured's as the first tree with the partitioned filter did).
EARLIER_SHA256 = {
    "config4/sha256": "cc19c4b404ddd256d994e9d6cf33fd356eaf1aa4dc87da3e398da3416701bac2",
    "config3/sha256": CONFIG3_UNFUSED_SHA256,
    "config3/sha256_unfused": CONFIG3_UNFUSED_SHA256,
    "config5/sha256": "45734c209b2a8184d7b144f5cb3932a5fc191762e9e10584e3e2ba53f93a3932",
    "occluded_full/sha256": "d12534ae218f7b533bdd2cca5d245a11647772e95130d25d34e371a288d31de2",
    "config4_wire/render_mulaw/sha256":
        "4e58c167c42fec1619ad25f5934191b903b600c0b1b50407dbb10852bf4c324b",
    "config4_wire/render_adpcm/sha256":
        "a01b8a984366d8807e5928d99c31c0f1c582b52611cb0bbd21906d86cec41fab",
    "config6/modulated/sha256": "4a2b56f0ad6e0771f611fa21302e185af69d5e773b57030a84a568047c54dee3",
    "config6/unmodulated/sha256":
        "05e94ff0b2d5c3ccc5fad31e92c73527ef03f965b5d038b25eaf3c1fd807ccd2",
    "config4_pitched/sha256": "47ac125434899eaa387f53e0a6d105283d9ccac5b0389f8f70ab219acc8b23a8",
    "config6_swept/sha256": "4062606068b8129edcbb535dff02aac7a95e120849264b19941a3e1d44572d53",
    "vibrato/sha256": "447a969c533c83dd11c41133833c65a530567bb63a79962311850ff4d46e84d9",
    # since K8 takes glibc's sin and cos (before that, 25875997cae7...)
    "config3_wah/sha256": "ac05c245b454de52b093d0ac5c02d0b532b2cf516e2d05e9b23766d2960fdd34",
    "config5_orbit/sha256": "7d46cd5da5abe58b4d8b88d87bf51b1c8289293955e29ec583810680fa626e85",
    "config5_steplinear/sha256":
        "f524448e0781b08db2d77739dbcbd762aced3dee260d4ef01c652fb20d314b4f",
    "config4_pingpong/sha256": "0e2ca53785726174d257b8b535ceb40e203fffa92955317daaab34b340018bdd",
    "config5_beside_streamed/sha256":
        "45734c209b2a8184d7b144f5cb3932a5fc191762e9e10584e3e2ba53f93a3932",
    "config5_streamed/sha256": "6c5ef658c1272bbf94186e3e4e6863062bec20ab151b73cc8bb9dfd22b6de783",
    "config5_measured/p2/sha256":
        "276b4ab9498d89b6e98141073c437261c08b4cdfdfa815b44e42c7a7ad1e8847",
    "config5_measured/p8/sha256":
        "b4772c54d337a98908ee8c02781aa9764773371f300f9114b16f4da4b99fdcb4",
    "examples/offline_mixdown/sha256":
        "e3b6550b8a47231a9a3eb7a29285a42755f8844121a4e250f658410b5c5c8d04",
    "examples/timed_automation/sha256":
        "5724afe719ab5fe0107aa21452d9baec8832e61d40db58544b40d0fe8a6945bd",
    "examples/game_audio/sha256":
        "da82539f391ad187e87c4075cedb0036c055b8fcad7244c8d4849f72599772a8",
    "examples/measured_hrtf_flac/sha256":
        "cb477d1fc40a55f5132027f7aae1ff59c2892d28f3d9181d68c174cae114d511",
    "examples/pcm_delivery_opus/sha256":
        "d770501a0b9debdfc3b4862c6c30be5aaea3b8967efd3d231ecf757dc1d52060",
}


def check_earlier_hashes(render):
    """Fail unless every path in ``EARLIER_SHA256`` rendered its recorded
    sha256 in this run (``render``: the main run's ``render`` object), each
    run of a path with ``sha256_runs`` included."""
    wrong = {}
    for where, want in EARLIER_SHA256.items():
        *keys, field = where.split("/")
        r = render
        for k in keys:
            r = r[k]
        got = {r[field], *r.get("sha256_runs", ())} if field == "sha256" else {r[field]}
        if got != {want}:
            wrong[where] = sorted(got)
    phase("render", f"{len(EARLIER_SHA256) - len(wrong)} of {len(EARLIER_SHA256)} earlier "
          f"paths render their recorded sha256{'' if not wrong else f'; not {wrong}'}")
    if wrong:
        raise AssertionError(f"earlier paths' hashes changed: {wrong}")


def pipe_runs(dev, runs=5):
    """Config 3 at full size fused (its four biquads one pipe, the default)
    and unfused (``pipeline_chains=False``), ``runs`` fresh 30 s renders
    each, alternated (fused, unfused, unfused, fused, ...): every render's
    sha256, which must all be equal and equal to ``CONFIG3_UNFUSED_SHA256``;
    the first 8192 frames against the golden; launches and host us a step;
    and for each a profile window of 100 steps (the fused one runs 103
    rows) for the device time a step, P2's, K6's and K8's."""
    from graphaudio_tpu_torch.testing.configs import config3_eq_chain
    from graphaudio_tpu_torch.utils import cudabuild

    T = 32 * 128
    frames = (30 * SR // T) * T
    steps = frames // T
    golden = np.load(GOLDENS[3])["out"]
    builds = {"fused": lambda: config3_eq_chain(superblock=32, device=dev),
              "unfused": lambda: unfused(config3_eq_chain(superblock=32, device=dev))}
    names = {"P2": "biquad_apply", "K6": "eval_intrinsic_batch",
             "K8": "biquad_coefficients_batch", "K5": "unity_group_step"}
    for b in builds.values():
        b().render(T)
    res = {k: {"wall_s": [], "sha256": [], "rows": None, "launches": None} for k in builds}
    order = [("fused", "unfused", "unfused", "fused")[i % 4] for i in range(2 * runs)]
    for key in order:
        cudabuild.launches.clear()
        out, wall, bd = timed_render(builds[key], frames)
        r = res[key]
        r["wall_s"].append(wall)
        r["sha256"].append(hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest())
        r["rows"] = bd["rows"]
        r["launches"] = {k: cudabuild.launches[w] for k, w in names.items()}
        r["golden_max_abs_err"] = float(np.abs(out[:, :golden.shape[1]].astype(np.float64)
                                               - golden).max())
    groups = {"P2": "biquad_cascade", **K6K8_GROUPS}
    for key, r in res.items():
        host = [w / steps * 1e6 for w in r["wall_s"]]
        r.update(host_us_per_step=host, host_us_per_step_median=statistics.median(host),
                 f32=spread(frames, r["wall_s"]),
                 launches_per_step={k: v / steps for k, v in r["launches"].items()},
                 profile=profile_steps(builds[key](), T, statistics.median(host), steps=100,
                                       groups=groups))
        phase("pipe", f"config 3 {key}: rows {r['rows']} for {steps} steps; host us a step "
              f"{host!r}; launches a step {r['launches_per_step']}; sha256 {set(r['sha256'])}; "
              f"golden max_abs_err {r['golden_max_abs_err']!r}; profile "
              f"{json.dumps(r['profile'])}")
    hashes = {h for r in res.values() for h in r["sha256"]}
    if hashes != {CONFIG3_UNFUSED_SHA256}:
        raise AssertionError(f"config 3's hashes {hashes} are not the unfused trees' "
                             f"{CONFIG3_UNFUSED_SHA256}")
    if res["fused"]["launches"]["P2"] != steps + 3 or res["unfused"]["launches"]["P2"] != 4 * steps:
        raise AssertionError(f"P2 launches {res['fused']['launches']['P2']} fused, "
                             f"{res['unfused']['launches']['P2']} unfused in {steps} steps")
    if max(r["golden_max_abs_err"] for r in res.values()) >= 1e-5:
        raise AssertionError("config 3 is not within 1e-5 of its golden")
    return res


def k15_bound(feed, n_steps, S, x0, rate):
    """``bound`` of one K15 call from this call's data: the feed frames its
    taps touch (counted: the distinct clamped taps of every output) read
    once, the output written once; about 20 f32 operations an output."""
    import torch

    C, n = feed.shape
    frames = n_steps * S * 128
    if x0 is None:
        touched = frames
    else:
        from graphaudio_tpu_torch.ops.resample import split_positions
        from graphaudio_tpu_torch.ops.stream import block_positions

        f64 = dict(dtype=torch.float64, device=feed.device)
        x0t, rt = torch.tensor(x0, **f64), torch.tensor(rate, **f64)
        base, _ = split_positions(block_positions(x0t, rt, 0, n_steps * S), rt.expand(n_steps * S),
                                  contract=False)
        taps = base.reshape(-1, 1).long() + torch.arange(-1, 3, device=feed.device)
        touched = int(torch.unique(taps.clamp(0, n - 1)).numel())
    return bound(C * touched * 4 + C * frames * 4, 20 * C * frames)


def k15_checks(dev, root):
    """K15 against its plain version on the card, bit for bit, over the
    whole render calls of ``testing/streams.feed_cases`` (config5_streamed's
    two stream nodes in a 351-step call, S = 1 and 64, mono, rates 0.5 and
    3.0, a stream that runs out), each timed as ``compare`` times with
    device times, and config5_streamed's two also cold (``cold_times``: the
    feed rotated through more than the L2), both device times counted only
    from profiler windows that recorded every launch. A unity case is also timed
    against the one PyTorch expression that computes it, the feed's first
    n_steps * T frames reshaped to [C, n_steps, T], transposed and made
    contiguous; no PyTorch call interpolates at the resample mode's
    positions. Returns two entries, one a mode (the template flag): the
    resample mode at config5_streamed's music node and the unity mode at
    its ambience, each with its mode's cases under ``cases``."""
    from graphaudio_tpu_torch.ops import stream as tstr
    from graphaudio_tpu_torch.testing import streams

    fields = ("max_abs_err", "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
              "library_device_ms", "bound_ms", "bound_by")
    entries = {}
    for name, args in streams.feed_cases(dev, root).items():
        feed, n_steps, S, x0, _ = args
        T = S * 128
        library = (lambda f=feed, k=n_steps, t=T: f[:, :k * t].reshape(f.shape[0], k, t)
                   .transpose(0, 1).contiguous()) if x0 is None else None
        e = compare(f"K15 stream feed read, {name}", "cuda", "graphaudio_tpu_torch/csrc/stream.cu",
                    "graphaudio_tpu/io/stream.py:304",
                    lambda a=args: tstr.stream_feed_call(*a),
                    lambda a=args: tstr.stream_feed_call_plain(*a),
                    0, bnd=k15_bound(*args), library=library, device_times=True)
        mode = "unity" if x0 is None else "resample"
        if mode not in entries:  # the first case of a mode is config5_streamed's node
            checked = dict(only="stream_feed", expect=1)
            warm = device_ms(lambda a=args: tstr.stream_feed_call(*a), **checked)
            cold_ms, cold_dev = cold_times(
                lambda f, a=args: tstr.stream_feed_call(f, *a[1:]), feed, **checked)
            phase("kernels", f"K15 stream feed read, {name}: every launch recorded, {warm!r} ms "
                  f"warm and {cold_dev!r} ms cold on the device; cold {cold_ms!r} ms a call")
            entries[mode] = dict(e, name=f"K15 stream feed read, {mode}", cases={},
                                 device_ms=warm, cold_ms=cold_ms, cold_device_ms=cold_dev)
        entries[mode]["cases"][name] = {f: e[f] for f in fields}
    return [entries["resample"], entries["unity"]]


def k15_in_render(build, frames, windows=3):
    """K15's device time in a ``frames``-frame render call: for each of
    ``windows`` fresh ``build()``s (after a one-step call), the kernels whose
    names hold ``stream_feed`` under torch.profiler, CUDA activity only,
    each mode's events against its launches counted by the wrapper. The
    profiler can lose kernel events, so only windows that recorded every
    launch count. Returns {mode: {"launches", "us" (summed), "us_per_launch"}}
    (the mode ``resample`` for the template's ``<true>`` instance), the
    median of the windows kept, or None if no window kept them all (not
    measured), and the number of windows kept."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphaudio_tpu_torch.utils import cudabuild

    kept = []
    for _ in range(windows):
        gc.collect()
        ctx = build()
        ctx.render(128 * ctx.superblock)
        torch.cuda.synchronize()
        cudabuild.launches.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ctx.render(frames)
            torch.cuda.synchronize()
        read = {}
        for e in prof.key_averages():
            t_us = getattr(e, "self_device_time_total", None)
            if t_us is None:
                t_us = getattr(e, "self_cuda_time_total", 0.0)
            if "stream_feed" in e.key and t_us > 0:
                r = read.setdefault("resample" if "<true>" in e.key else "unity",
                                    {"launches": 0, "us": 0.0})
                r["launches"] += e.count
                r["us"] += t_us
        counted = {m: cudabuild.launches[f"stream_feed/{m}"] for m in ("resample", "unity")}
        if {m: r["launches"] for m, r in read.items()} == {m: n for m, n in counted.items() if n}:
            kept.append(read)
    if not kept:
        return None, 0
    out = {}
    for mode in sorted({m for read in kept for m in read}):
        us = statistics.median(read[mode]["us"] for read in kept)
        n = kept[0][mode]["launches"]
        out[mode] = {"launches": n, "us": us, "us_per_launch": us / n}
    return out, len(kept)


def peak_memory(build, frames):
    """Device memory of one ``frames``-frame render call of a fresh
    ``build()`` (after Python's garbage is collected and a one-step call):
    allocated before it and the peak during it
    (``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
    in bytes."""
    import gc

    import torch

    gc.collect()
    ctx = build()
    ctx.render(128 * ctx.superblock)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ctx.render(frames)
    torch.cuda.synchronize()
    return {"before_call": before, "peak": torch.cuda.max_memory_allocated(),
            "call": torch.cuda.max_memory_allocated() - before}


def feed_costs(dev, build, frames):
    """A render call's feed staging on a fresh ``build()``: ``prepare_feed``
    of every stream node for ``frames`` frames (decoding included) on the
    host's clock, and the copy of those feeds from pinned memory to the
    card (the median of 10 CUDA-event-timed copies of all of them)."""
    import torch

    ctx = build()
    ctx._ensure_compiled()
    ctx._ensure_params_encoded()
    nodes = [n for n in ctx._compiled.topo if hasattr(n, "prepare_feed")]
    t0 = time.perf_counter()
    host = [n.prepare_feed(frames) for n in nodes]
    prep_s = time.perf_counter() - t0
    pinned = [torch.from_numpy(a).pin_memory() for a in host]
    copy_ms = median_ms(lambda: [p.to(dev, non_blocking=True) for p in pinned], repeats=10)
    out = {"prepare_feed_s": prep_s, "copy_ms": copy_ms,
           "bytes": int(sum(a.nbytes for a in host)),
           "shapes": [list(a.shape) for a in host]}
    phase("feeds", f"config5_streamed, one {frames}-frame call: {json.dumps(out)}")
    return out


def stream_runs(dev, root, runs=5):
    """config5_streamed (config 5's Kit scene plus a streamed 44.1 kHz FLAC
    music track and a looped 48 kHz WAV ambience on a music bus) and config
    5 at full size (128 voices, superblock 32, 351 superblocks), ``runs``
    renders each in this call (``render_runs``): the streamed scene's first
    8 superblocks within 1e-5 of its CPU render, K15 once a call for each
    of its two stream nodes (one in each mode); K15's device time in a 30 s
    render (``k15_in_render``), the peak device memory of a 30 s call
    (``peak_memory``) and the feeds' staging costs (``feed_costs``).
    The native codec must have loaded, with FLAC."""
    from graphaudio_tpu_torch.io import codec_capabilities, native
    from graphaudio_tpu_torch.testing.configs import config5_spatial_scene, config5_streamed

    caps = codec_capabilities()
    if native.load() is None or not caps["flac"]:
        raise AssertionError(f"the native codec did not load with FLAC: {caps}")
    phase("codec", f"native codec {native.load()._name}; capabilities {json.dumps(caps)}")
    T = 32 * 128
    frames = (30 * SR // T) * T
    steps = frames // T
    build = lambda: config5_streamed(superblock=32, device=dev, root=root)  # noqa: E731
    ref = config5_streamed(superblock=32, device="cpu", root=root).render(8 * T)
    counts = {"K15": ("stream_feed",), "K15 resample": ("stream_feed/resample",),
              "K15 unity": ("stream_feed/unity",), "K5": ("unity_group_step",),
              "P1": ("hrtf_fir",), "K10b": ("spatial_gains_batch",), "K2b": ("overlap_add",)}
    groups = {"K15": "stream_feed", **K2BK10B_GROUPS}
    out = {"config5_streamed": render_runs("5 streamed", build, T, frames, counts, groups,
                                           runs=runs, ref=ref),
           "config5": render_runs(5, lambda: config5_spatial_scene(superblock=32, device=dev),
                                  T, frames, counts, groups, runs=runs)}
    for key, where in (("config5_streamed", "config5_streamed"),
                       ("config5", "config5_beside_streamed")):
        if out[key]["sha256"] != EARLIER_SHA256[f"{where}/sha256"]:
            raise AssertionError(f"{key} rendered {out[key]['sha256']}, not its recorded "
                                 f"{EARLIER_SHA256[where + '/sha256']}")
    launches = out["config5_streamed"]["launches"]
    if not launches["K15 resample"] == launches["K15 unity"] == 1:
        raise AssertionError(f"K15 launched {launches} in a {steps}-step call, not once a "
                             f"call for each stream node (one resampled, one at unity)")
    r = out["config5_streamed"]
    r["k15_in_render"], kept = k15_in_render(build, frames)
    r["memory"] = peak_memory(build, frames)
    r["feeds"] = feed_costs(dev, build, frames)
    in_render = json.dumps(r["k15_in_render"]) if kept else "not measured"
    phase("stream", f"config5_streamed, one {steps}-step call: K15 in the render "
          f"{in_render} ({kept} of 3 profiler windows recorded every launch); device "
          f"memory {json.dumps(r['memory'])}")
    for key, r in out.items():
        phase("render", f"{key}: xRT median {r['f32']['xrt_median']!r}, host us a step "
              f"{r['host_us_per_step_median']!r}, device us a step "
              f"{r['profile']['device_us_per_step']!r}, launches a step "
              f"{r['profile']['launches_per_step']!r}, sha256 {r['sha256']}")
    return out


#: K10p's kernels (hrtf_part_input_kernel, hrtf_part_mac_kernel,
#: hrtf_part_ola_kernel), cuFFT's transforms around them and P1's kernel,
#: which the measured scene must not launch.
K10P_GROUPS = {"K10p-in": "hrtf_part_input", "K10p-a": "hrtf_part_mac",
               "K10p-b": "hrtf_part_ola", "FFT": "fft", "P1": "hrtf_fir_kernel"}

#: The measured scene's HRIR lengths: the loader's default cut of the 512-tap
#: 44.1 kHz set (256 taps, P = 2) and the longest set (1024 taps, P = 8).
MEASURED_TAPS = {"p2": None, "p8": 1024}


def measured_scene(dev, taps, superblock=32, moving=False):
    """config5_measured (config 5's Kit scene on a measured-like HRIR set);
    with ``moving`` every source moves along the chord to the point a
    quarter turn further round over 3 s (per-quantum positions), as in
    ``moving_config5``."""
    from graphaudio_tpu_torch.testing.configs import config5_measured

    ctx = config5_measured(superblock=superblock, device=dev, taps=taps)
    if moving:
        for v, snd in enumerate(ctx._sounds):
            a = 2 * np.pi * v / len(ctx._sounds)
            pan = snd._spatial_panner
            for prm, fn in ((pan.position_x, np.cos), (pan.position_z, np.sin)):
                prm.set_value_at_time(float(5 * fn(a)), 0.0)
                prm.linear_ramp_to_value_at_time(float(5 * fn(a + np.pi / 2)), 3.0)
    return ctx


def k10p_case(label, args, library=False, cold=False):
    """The input pass, K10p-a and K10p-b against their plain versions on one
    call's arguments (``testing.hrtf_part.kernel_inputs``), within 1e-6 x
    max|ref| (the kernels spell the plain versions' operations in their
    order, so bit for bit is expected and reported). With ``library``,
    K10p-a and K10p-b each beside one PyTorch call: K10p-a's MAC as one
    ``torch.einsum`` over the interpolated spectra materialized beforehand
    (its windows of the concatenated timeline gathered outside the
    timing), K10p-b's overlap-add as ``torch.nn.functional.fold``; the
    input pass has none (a multiply, a mean and a pad are three calls).
    With ``cold``, K10p-a is also timed cold (``cold_times``: copies of X
    rotated through more than the L2). Returns the three entries."""
    import torch

    from graphaudio_tpu_torch.ops import hrtf as th
    from graphaudio_tpu_torch.testing import hrtf_part

    inp, mac, ola = hrtf_part.kernel_inputs(args)
    X, hx, haz, hel, az, el, sr, si = mac
    y, ola0, x, gain, blend = ola
    V, S, B = X.shape
    E, A, _, P, _ = sr.shape
    C = x.shape[1]
    lib_a = lib_b = None
    if library:
        xcat = torch.cat([torch.complex(hx[..., :B], hx[..., B:]), X], 1)  # [V, P-1+S, B]
        azc, elc = torch.cat([haz, az], 1), torch.cat([hel, el], 1)
        H = torch.complex(th.interp_hrir(sr, azc, elc), th.interp_hrir(si, azc, elc))
        u = (torch.arange(S, device=X.device)[:, None] - torch.arange(P, device=X.device)
             + P - 1)  # [S, P]: the input quantum of (s, p)
        xw = xcat[:, u].contiguous()  # [V, S, P, B]
        # partition p of the spectra interpolated at (s, p)'s input quantum
        hw = H[:, u].diagonal(dim1=2, dim2=4).permute(0, 1, 4, 2, 3).contiguous()  # [V, S, P, 2, B]
        lib_a = lambda: torch.einsum("vspb,vspeb->vseb", xw, hw)  # noqa: E731
        cols = torch.cat([torch.cat([torch.zeros_like(ola0), ola0], -1)[:, :, None],
                          y.transpose(1, 2) * (1.0 / 256)], 2)  # [V, 2, S + 1, 256]
        cols = cols.reshape(V * 2, S + 1, 256).transpose(1, 2).contiguous()
        lib_b = lambda: torch.nn.functional.fold(  # noqa: E731
            cols, (1, (S + 2) * 128), (1, 256), stride=(1, 128))
    ringb = nbytes(hx, haz, hel)
    i = compare(f"K10p input pass ({label}: V={V} C={C} S={S})", "cuda",
                "graphaudio_tpu_torch/csrc/hrtf_part.cu", "graphaudio_tpu/nodes/spatial.py:392",
                lambda: th.partitioned_input(*inp), lambda: th.partitioned_input_plain(*inp),
                1e-6, rel=True, device_times=library,
                # x and the gain read once, the transform input written
                # once; the gain multiply a sample of a channel, two for
                # the mean
                bnd=bound(nbytes(x, gain) + V * S * 256 * 4,
                          (C if gain is not None else 0) * V * S * 128 + 2 * (C - 1) * V * S * 128))
    a = compare(f"K10p-a partitioned HRTF MAC ({label}: V={V} S={S} P={P} grid {E}x{A})", "cuda",
                "graphaudio_tpu_torch/csrc/hrtf_part.cu", "graphaudio_tpu/ops/hrtf.py:302",
                lambda: flat(th.partitioned_mac(*mac)), lambda: flat(th.partitioned_mac_plain(*mac)),
                1e-6, rel=True, library=lib_a, device_times=library,
                # X, the ring, the directions and the grid spectra read once,
                # the sums and the next ring written once; a (v, s, p, ear,
                # bin) interpolates re and im (8 mul, 6 add) and multiplies
                # in (4 mul, 4 add)
                bnd=bound(nbytes(X, az, el, sr, si) + 2 * ringb + V * S * 2 * B * 8,
                          22 * V * S * P * 2 * B))
    b = compare(f"K10p-b partitioned HRTF overlap-add ({label}: V={V} C={C} S={S})", "cuda",
                "graphaudio_tpu_torch/csrc/hrtf_part.cu", "graphaudio_tpu/ops/hrtf.py:380",
                lambda: flat(th.partitioned_ola(*ola)), lambda: flat(th.partitioned_ola_plain(*ola)),
                1e-6, rel=True, library=lib_b, device_times=library,
                # y, x, gain, blend and the tail read once, out and the tail
                # written once; the scale twice, an add, the gain, three for
                # the blend a sample
                bnd=bound(nbytes(y, x, gain, blend, ola0) + V * 2 * S * 128 * 4 + nbytes(ola0),
                          7 * V * 2 * S * 128))
    if cold:
        # The kernel alone (``compare``'s device time also holds ``flat``'s
        # concatenation), warm and cold.
        a["alone_device_ms"] = device_ms(lambda: th.partitioned_mac(*mac), only="hrtf_part_mac",
                                         expect=1)
        a["cold_ms"], a["cold_device_ms"] = cold_times(
            lambda X_: th.partitioned_mac(X_, *mac[1:]), X, only="hrtf_part_mac", expect=1)
        phase("kernels", f"K10p-a ({label}), the kernel alone: warm {a['alone_device_ms']!r} ms "
              f"on the device; cold {a['cold_ms']!r} ms a call, {a['cold_device_ms']!r} ms on the "
              f"device (X rotated through {COLD_BYTES} bytes); bound {a['bound_ms']!r} ms")
    for e, kernel, plain, kargs in (
            (i, lambda *q: (th.partitioned_input(*q),),
             lambda *q: (th.partitioned_input_plain(*q),), inp),
            (a, th.partitioned_mac, th.partitioned_mac_plain, mac),
            (b, th.partitioned_ola, th.partitioned_ola_plain, ola)):
        got, want = kernel(*kargs), plain(*kargs)
        torch.cuda.synchronize()
        e["bit_for_bit"] = all(torch.equal(torch.view_as_real(g).view(torch.int32) if g.is_complex()
                                           else g.view(torch.int32),
                                           torch.view_as_real(w).view(torch.int32) if w.is_complex()
                                           else w.view(torch.int32))
                               for g, w in zip(got, want))
    if library:
        want_a = th.partitioned_mac_plain(*mac)[0]
        a["library_max_abs_err"] = float((lib_a() - want_a).abs().max())
        fo = lib_b()[:, 0, 0].reshape(V, 2, -1)
        ys = y * (1.0 / 256)
        prev = torch.cat([ola0[:, None], ys[..., 128:][:, :-1]], 1)
        wet = (ys[..., :128] + prev).permute(0, 2, 1, 3).reshape(V, 2, S * 128)
        b["library_max_abs_err"] = float((fo[..., 128:(S + 1) * 128] - wet).abs().max())
    phase("kernels", f"K10p ({label}): bit for bit {i['bit_for_bit']}, {a['bit_for_bit']} and "
          f"{b['bit_for_bit']}; library vs plain {a.get('library_max_abs_err')!r}, "
          f"{b.get('library_max_abs_err')!r}")
    if not (i["bit_for_bit"] and a["bit_for_bit"] and b["bit_for_bit"]):
        raise AssertionError(f"K10p ({label}): a kernel is not bit for bit its plain version")
    return i, a, b


def measured_step_args(dev, taps, moving):
    """The arguments of config5_measured's fourth ``hrtf_fir_partitioned``
    call (its fourth step), sources moving or still."""
    from unittest import mock

    from graphaudio_tpu_torch.nodes import spatial as tsp

    ctx = measured_scene(dev, taps, moving=moving)
    # The panner looks the filter up in its own module: a spy there sees
    # the arguments of each call.
    with mock.patch.object(tsp, "hrtf_fir_partitioned", wraps=tsp.hrtf_fir_partitioned) as fir:
        ctx.render(4 * 32 * 128)
    return list(fir.call_args.args)


def k10p_checks(dev):
    """The input pass, K10p-a and K10p-b against their plain versions: on
    the arguments of the fourth step of config5_measured (V=128, C=2,
    S=32) at P = 2 and P = 8 with every source moving, beside their
    library calls, and with every source still, K10p-a warm and cold on
    all four; and at the seeded ``testing.hrtf_part.PART_CASES`` (S = 1
    and 4 at P = 8, the ring longer than the superblock; one voice; stereo
    input; the occluded route without a gain; P = 3 with a zero-padded
    partition; directions still, and in runs of 1-5 quanta, at P = 2 and
    8). Returns the three entries, each with the other shapes under
    ``shapes``."""
    from graphaudio_tpu_torch.testing import hrtf_part

    cases = []
    for key, taps in MEASURED_TAPS.items():
        cases.append((f"config5_measured {key} step 4", measured_step_args(dev, taps, True),
                      True, True))
        cases.append((f"config5_measured {key} static step 4",
                      measured_step_args(dev, taps, False), False, True))
    for label, case in hrtf_part.PART_CASES.items():
        cases.append((label, hrtf_part.seeded_case(dev, *case), False, False))
    groups = [k10p_case(*c) for c in cases]
    keys = ("name", "max_abs_err", "bit_for_bit", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "plain_device_ms", "library_device_ms",
            "library_max_abs_err", "alone_device_ms", "cold_ms", "cold_device_ms")
    out = []
    for i, name in enumerate(("K10p input pass", "K10p-a partitioned HRTF MAC",
                              "K10p-b partitioned HRTF overlap-add")):
        group = [g[i] for g in groups]
        group[0]["shapes"] = [{k: e[k] for k in keys if k in e} for e in group[1:]]
        group[0]["name"] = name
        out.append(group[0])
    return out


def k10pa_times(dev):
    """K10p-a alone (the profiler's device time of ``hrtf_part_mac``
    kernels), warm (20 calls on the same inputs) and cold (``cold_times``:
    copies of X rotated through more than the L2), in µs, at
    config5_measured's fourth step with sources moving and still, P = 2
    and 8, and at five seeded cases whose sources cross a grid cell every
    1-2 quanta; where the tree picks a block length
    (``ops.hrtf.mac_block_quanta``), also at each length it may pick. It
    uses only names the tree that first had K10p has too, so copied into
    that tree's checkout it times its kernel the same way. Returns {case:
    [warm, cold]}."""
    from graphaudio_tpu_torch.ops import hrtf as th
    from graphaudio_tpu_torch.testing import hrtf_part

    cases = [(f"{key} {'moving' if moving else 'still'}", measured_step_args(dev, taps, moving))
             for key, taps in MEASURED_TAPS.items() for moving in (True, False)]
    for label in ("S=1 P=8", "S=4 P=8", "V=1 P=8", "stereo P=2", "occluded P=2"):
        cases.append((label, hrtf_part.seeded_case(dev, *hrtf_part.PART_CASES[label][:5])))
    rule = getattr(th, "mac_block_quanta", None)
    out = {}
    for label, args in cases:
        mac = hrtf_part.kernel_inputs(args)[-2]
        for q in (None,) + (() if rule is None else th.MAC_BLOCK_QUANTA):
            if q is not None:
                th.mac_block_quanta = lambda V, S, sms, q=q: q
            try:
                warm = device_ms(lambda: th.partitioned_mac(*mac), only="hrtf_part_mac", expect=1)
                _, cold = cold_times(lambda X_: th.partitioned_mac(X_, *mac[1:]), mac[0],
                                     only="hrtf_part_mac", expect=1)
            finally:
                if rule is not None:
                    th.mac_block_quanta = rule
            key = label if q is None else f"{label} q={q}"
            out[key] = [None if t is None else t * 1e3 for t in (warm, cold)]
            phase("kernels", f"K10p-a alone ({key}): warm {out[key][0]!r} us, cold "
                  f"{out[key][1]!r} us on the device")
    return out


def measured_runs(dev, runs=5):
    """config5_measured at full size (128 voices, superblock 32, 351
    superblocks) at P = 2 and P = 8, ``runs`` renders each
    (``render_runs``): each within 1e-5 of its CPU render over its first 8
    superblocks, one input pass, one K10p-a and one K10p-b launch a step
    for each panner stage and no P1; the device time, launches and host
    time a step, xRT."""
    from graphaudio_tpu_torch.nodes.spatial import SpatialPannerNode

    T = 32 * 128
    frames = (30 * SR // T) * T
    steps = frames // T
    counts = {"K10p-in": ("hrtf_part_input",), "K10p-a": ("hrtf_part_mac",),
              "K10p-b": ("hrtf_part_ola",), "P1": ("hrtf_fir",),
              "K10b": ("spatial_gains_batch",), "K5": ("unity_group_step",)}
    out = {}
    for key, taps in MEASURED_TAPS.items():
        ref = measured_scene("cpu", taps).render(8 * T)
        probe = measured_scene(dev, taps)
        probe._ensure_compiled()
        stages = sum(isinstance(sp["rep"], SpatialPannerNode) for sp in probe._compiled.plan)
        r = render_runs(f"5 measured {key}", lambda: measured_scene(dev, taps), T, frames,  # noqa: B023
                        counts, K10P_GROUPS, runs=runs, ref=ref)
        n = r["launches"]
        phase("render", f"config5_measured {key}: {stages} panner stage(s); launches {n} in "
              f"{steps} steps")
        if not (n["K10p-in"] == n["K10p-a"] == n["K10p-b"] == stages * steps and n["P1"] == 0
                and stages >= 1):
            raise AssertionError(f"config5_measured {key}: launches {n} in {steps} steps, not one "
                                 f"input pass, one K10p-a and one K10p-b a step for each of "
                                 f"{stages} panner stages and no P1")
        want = EARLIER_SHA256[f"config5_measured/{key}/sha256"]
        if r["sha256"] != want:
            raise AssertionError(f"config5_measured {key} rendered {r['sha256']}, not {want}")
        r["panner_stages"] = stages
        out[key] = r
    return out


#: Steps of the realtime phase's parity and pipelining checks.
RT_STEPS = 64
#: Seconds of wall time the live realtime run plays.
RT_LIVE_S = 10.0


def step_graph_stats(ctx):
    """A realtime context's CUDA-graph counts (core/stepgraph.py): captures,
    launches replayed, and why a capture was refused (None: none was)."""
    sg = ctx._step_graph
    if sg is None:
        return {"captures": 0, "replays": 0, "refused": "no step graph"}
    return {"captures": sg.captures, "replays": sg.replays, "refused": sg.refused}


def rt_context(dev, **kw):
    """A ``RealtimeAudioContext`` factory for the config builders' ``context``
    argument: no render thread, the null output device."""
    from graphaudio_tpu_torch.realtime import RealtimeAudioContext

    def make(**geom):
        return RealtimeAudioContext(device=dev, auto_start_thread=False, output_device="null",
                                    **kw, **geom)
    return make


def offline_unfused(dev):
    """An ``OfflineAudioContext`` factory with chain fusion off, as in a
    realtime context."""
    from graphaudio_tpu_torch.core.context import OfflineAudioContext

    return lambda **geom: OfflineAudioContext(device=dev, pipeline_chains=False, **geom)


def pipelined_steps(ctx, n):
    """``n`` steps as the render thread runs them: launch step k+1, then
    finish step k. Returns (the steps' audio, counts of the finishes at which
    the next launch's event had not yet completed ("next_running") and at
    which the finished step's own event had completed before the wait
    ("own_done"), and the synchronizing CUDA calls that torch's sync debug
    mode caught: in the first launch (which builds the graph), in the later
    launches and in the finishes, each by the innermost line of the package
    that made it)."""
    import traceback
    import warnings
    from collections import Counter

    import torch

    pkg = os.path.join(ROOT, "graphaudio_tpu_torch")
    outs, seen = [], {"next_running": 0, "own_done": 0}
    syncs = {"first_launch": Counter(), "launches": Counter(), "finishes": Counter()}

    def counted(where, fn, *args):
        def show(message, category, filename, lineno, file=None, line=None):
            frames = [f for f in traceback.extract_stack() if f.filename.startswith(pkg)]
            at = (f"{os.path.relpath(frames[-1].filename, ROOT)}:{frames[-1].lineno}" if frames
                  else f"{os.path.relpath(filename, ROOT)}:{lineno}")
            syncs[where][at] += "synchroniz" in str(message)

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    pending = counted("first_launch", ctx._render_steps_launch, 1)
    for _ in range(n - 1):
        nxt = counted("launches", ctx._render_steps_launch, 1)
        seen["next_running"] += not nxt.ready()
        seen["own_done"] += pending.ready()
        outs.append(counted("finishes", ctx._render_steps_finish, pending))
        pending = nxt
    outs.append(counted("finishes", ctx._render_steps_finish, pending))
    return outs, seen, {k: dict(v) for k, v in syncs.items()}


def k2a_live_check(dev, build):
    """K2a against its plain version on the arguments that the first
    realtime step at superblock 2 of ``build`` gives it (captured by a spy on
    the name ``conv_step`` looks up), within 1e-5 x max|ref| as in
    ``k2_checks``; the ring writes bit for bit. Returns the entry."""
    import torch

    from graphaudio_tpu_torch.ops import convolve as tconv

    seen = []
    orig = tconv.spectral_mac

    def spy(X, hr, hi, ring_r, ring_i, head, rev):
        if not seen:
            seen.append((X.clone(), hr, hi, ring_r.clone(), ring_i.clone(), head, rev))
        return orig(X, hr, hi, ring_r, ring_i, head, rev)

    ctx = build(superblock=2, context=rt_context(dev))
    tconv.spectral_mac = spy
    try:
        ctx.render_step_blocking()
    finally:
        tconv.spectral_mac = orig
        ctx.dispose()
    X, hr, hi, ring_r, ring_i, head, rev = seen[0]
    K, L, NB = X.shape
    P = hr.shape[1]
    plan = tconv.mac_plan(K, L, P, NB)
    rk = (ring_r.clone(), ring_i.clone())
    rp = (ring_r.clone(), ring_i.clone())
    e = compare(f"K2a spectral MAC (realtime step, superblock 2: K={K} L={L} P={P} bins={NB}, "
                f"plan lt={plan[0]} clusters={plan[1]} groups={plan[2]} lags={plan[3]})", "cuda",
                "graphaudio_tpu_torch/csrc/conv.cu",
                "graphaudio_tpu/ops/convolve.py:191" if rev else "graphaudio_tpu/ops/convolve.py:72",
                lambda: tconv.spectral_mac(X, hr, hi, *rk, head, rev),
                lambda: tconv.spectral_mac_plain(X, hr, hi, *rp, head, rev), 1e-5, rel=True,
                bnd=bound(nbytes(X, hr, hi, ring_r, ring_i, X), 8 * K * L * P * NB))
    if not (torch.equal(rk[0], rp[0]) and torch.equal(rk[1], rp[1])):
        raise AssertionError("K2a's ring writes differ from the plain version's at superblock 2")
    e["shape"] = {"K": K, "L": L, "P": P, "bins": NB, "lt": plan[0], "clusters": plan[1],
                  "groups": plan[2], "lags": plan[3]}
    return e


def realtime_parity(dev, n, build, steps=RT_STEPS):
    """(a) and (b) of the realtime phase for config ``n``: ``steps`` steps of
    ``render_step_blocking`` in a ``RealtimeAudioContext`` at superblock 2,
    bit for bit the same graph's ``OfflineAudioContext(superblock=2,
    pipeline_chains=False)`` render of as many steps in one call and within
    1e-5 of the port's CPU render over the first 8; then the same steps run
    pipelined (launch k+1, finish k), bit for bit (a)'s audio. Both runs
    must have replayed the step's CUDA graph (core/stepgraph.py), so the
    comparisons hold the graph to the kernel-by-kernel offline render."""
    import torch

    T = 2 * 128
    ctx = build(superblock=2, context=rt_context(dev))
    try:
        t0 = time.perf_counter()
        got = np.concatenate([ctx.render_step_blocking() for _ in range(steps)], axis=1)
        wall = time.perf_counter() - t0
        graph_blocking = step_graph_stats(ctx)
    finally:
        ctx.dispose()
    want = build(superblock=2, context=offline_unfused(dev)).render(steps * T)
    cpu = build(superblock=2, context=offline_unfused("cpu")).render(8 * T)
    err = float(np.abs(got[:, :8 * T].astype(np.float64) - cpu).max())
    same = bool(np.array_equal(got, want))
    ctx = build(superblock=2, context=rt_context(dev))
    try:
        torch.cuda.synchronize()
        outs, seen, syncs = pipelined_steps(ctx, steps)
        graph_piped = step_graph_stats(ctx)
    finally:
        ctx.dispose()
    piped = np.concatenate(outs, axis=1)
    same_piped = bool(np.array_equal(piped, got))
    out = {"steps": steps, "bit_for_bit_offline": same, "max_abs_err_vs_cpu_8_steps": err,
           "cpu_peak": float(np.abs(cpu).max()), "wall_s_blocking": wall,
           "sha256": hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest(),
           "pipelined_bit_for_bit": same_piped,
           "next_step_running_share": seen["next_running"] / (steps - 1),
           "own_step_done_before_finish_share": seen["own_done"] / (steps - 1),
           "sync_calls": syncs,
           "step_graph": {"blocking": graph_blocking, "pipelined": graph_piped}}
    phase("realtime", f"config {n}, superblock 2, {steps} steps of render_step_blocking: "
          f"bit for bit the unfused offline render {same}; vs the CPU render over 8 steps "
          f"max_abs_err={err!r} (tolerance 1e-05); pipelined (launch k+1, finish k) bit for "
          f"bit {same_piped}; of {steps - 1} finishes, the next step still running at "
          f"{seen['next_running']}, the finished step's own work done before its wait at "
          f"{seen['own_done']}; synchronizing calls (torch sync debug mode) {json.dumps(syncs)}; "
          f"the step's CUDA graph, blocking and pipelined: {json.dumps(out['step_graph'])}")
    if not (same and same_piped and err < 1e-5 and np.isfinite(got).all()
            and out["cpu_peak"] > 1e-3 and graph_blocking["replays"] > 0
            and graph_piped["replays"] > 0):
        raise AssertionError(f"config {n}'s realtime steps differ from the offline or the CPU "
                             f"render, or from each other: {out}")
    return out


#: A launch slower than this is a hitch: its parts are kept and printed.
RT_HITCH_S = 0.010


def thread_cpu_s():
    """CPU seconds (user + system) of each of this process's threads, by
    native thread id, from /proc/self/task (empty where there is none)."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                st = f.read()
        except OSError:
            continue
        fields = st[st.rindex(")") + 2:].split()
        out[int(tid)] = (int(fields[11]) + int(fields[12])) / tick
    return out


def live_run(dev, label, seconds=RT_LIVE_S, gate=True):
    """(c): config 5 at full width in a ``RealtimeAudioContext`` (superblock
    2, the null output device) playing for ``seconds`` of wall time on its
    render thread. The steps' host walls come from wrappers of the
    context's launch and finish: the launch alone, the finish alone, a
    step's launch start to its finish end, and the wait for a step's audio
    and its join (``audio``: before the next launch where the step was
    done, else inside the finish). Every launch slower than
    ``RT_HITCH_S`` is kept with what names its cause: its parts (the
    launch breakdown's ``parts``: drain, graph build, static-config check,
    param encode, block clock and its pinned copy, feeds, the step loop's
    enqueue, the copies back), the render thread's CPU time in it (a wall
    far above it is time the thread did not run: contention or a wait),
    and the Python garbage collections that ran inside it (``gc.callbacks``,
    each with its generation and duration). One full collection is forced
    a second in, while the context plays (its heap frozen at start), and
    timed beside the same collection once the context has stopped. The CPU
    time each thread of the process used while it played is read from
    /proc. The ring's waits for space
    past ``RT_HITCH_S`` are kept too. Raises unless no frame underran after
    the first second (with ``gate``)."""
    import gc
    import threading

    from graphaudio_tpu_torch.realtime import RealtimeAudioContext
    from graphaudio_tpu_torch.realtime import ring as tring
    from graphaudio_tpu_torch.testing.configs import config5_spatial_scene

    ctx = config5_spatial_scene(superblock=2, context=rt_context(dev))
    walls = {"launch": [], "finish": [], "launch_to_finish": [], "audio": []}
    starts, hitches, waits, collections, parts = {}, [], [], [], {}
    # where frames underran: seen at the next launch, with the ring's fill
    # there and the launches before it
    underruns, seen = [], {"frames": 0, "t": None}
    launch0, finish0, audio0 = (ctx._render_steps_launch, ctx._render_steps_finish,
                                ctx._render_steps_audio)
    wait0 = ctx.ring.wait_for_space
    t_base = time.perf_counter()

    def on_gc(phase_, info):
        if phase_ == "start":
            collections.append([time.perf_counter(), None, info["generation"],
                                threading.current_thread().name])
        elif collections and collections[-1][1] is None:
            collections[-1][1] = time.perf_counter()

    def launch(n_steps, pack=None, keep=None):
        t0, c0, n_gc = time.perf_counter(), time.thread_time(), len(collections)
        under = ctx.underrun_frames
        if under != seen["frames"]:
            underruns.append({"at_s": t0 - t_base, "frames": under - seen["frames"],
                              "ring_frames": ctx.ring.available_read(),
                              "since_last_launch_ms": None if seen["t"] is None
                              else (t0 - seen["t"]) * 1e3,
                              "last_launches_ms": [w * 1e3 for w in walls["launch"][-4:]]})
            seen["frames"] = under
        seen["t"] = t0
        h = launch0(n_steps, pack, keep)
        t1, c1 = time.perf_counter(), time.thread_time()
        starts[id(h)] = t0
        walls["launch"].append(t1 - t0)
        for k, v in h.breakdown["parts"].items():
            parts.setdefault(k, []).append(v)
        if t1 - t0 > RT_HITCH_S:
            gcs = [{"generation": g, "ms": (e - b) * 1e3, "thread": th}
                   for b, e, g, th in collections[n_gc:] if e is not None]
            hitches.append({"at_s": t0 - t_base, "wall_ms": (t1 - t0) * 1e3,
                            "thread_cpu_ms": (c1 - c0) * 1e3,
                            "parts_ms": {k: v * 1e3 for k, v in h.breakdown["parts"].items()},
                            "gc": gcs})
        return h

    def finish(h):
        t0 = time.perf_counter()
        out = finish0(h)
        t1 = time.perf_counter()
        walls["finish"].append(t1 - t0)
        walls["launch_to_finish"].append(t1 - starts.pop(id(h)))
        return out

    def audio(h):
        if h.audio is not None:
            return h.audio
        t0 = time.perf_counter()
        out = audio0(h)
        walls["audio"].append(time.perf_counter() - t0)
        return out

    def wait_for_space(frames, timeout_ms):
        t0 = time.perf_counter()
        r = wait0(frames, timeout_ms)
        if time.perf_counter() - t0 > RT_HITCH_S:
            waits.append({"at_s": t0 - t_base, "ms": (time.perf_counter() - t0) * 1e3})
        return r

    # The process's other threads (an idle stream node's decoder thread of
    # an earlier phase's context, say): each contends for the GIL.
    from collections import Counter

    threads = dict(Counter(t.name.split("-")[0] if t.name.startswith("Thread-") else t.name
                           for t in threading.enumerate()))
    cpu0 = thread_cpu_s()
    gc.callbacks.append(on_gc)
    try:
        ctx._ensure_compiled()
        ctx._ensure_params_encoded()
        ctx._render_steps_launch, ctx._render_steps_finish = launch, finish
        ctx._render_steps_audio = audio
        ctx.ring.wait_for_space = wait_for_space
        t_base = time.perf_counter()
        ctx._start_render_thread()
        ctx.start()
        t0 = time.perf_counter()
        time.sleep(1.0)
        at1 = (ctx.frames_played, ctx.underrun_frames, ctx.stats.steps_rendered)
        # A full collection on this thread while the context plays (it
        # holds the GIL, as one on the render thread would): the heap as it
        # was at start is frozen out of it. (Nothing here counts the frozen
        # objects while it plays: gc.get_freeze_count walks them all,
        # holding the GIL.)
        t_gc = time.perf_counter()
        gc.collect()
        gc_playing_ms = (time.perf_counter() - t_gc) * 1e3
        time.sleep(max(0.0, seconds - (time.perf_counter() - t0)))
        ctx.stop()
        elapsed = time.perf_counter() - t0
        end = (ctx.frames_played, ctx.underrun_frames, ctx.stats.steps_rendered)
        # Who used the CPU while it played: this process's threads (Python's
        # by name, the others as "native").
        cpu1 = thread_cpu_s()
        names = {t.native_id: t.name.split("-")[0] if t.name.startswith("Thread-") else t.name
                 for t in threading.enumerate()}
        by_thread = Counter()
        for tid, c in cpu1.items():
            by_thread[names.get(tid, "native")] += (c - cpu0.get(tid, 0.0)) * 1e3
        cpu_use = {"threads_ms": dict(by_thread.most_common(8)), "wall_ms": elapsed * 1e3,
                   "cpus": os.cpu_count()}
        native = ctx.ring.native_handle is not None and tring.load_native() is not None
        backend, error = ctx.device_backend, ctx.last_render_error
        graph = step_graph_stats(ctx)
        ctx._thread_quit = True
        ctx._render_thread.join(timeout=5.0)
        gc.callbacks.remove(on_gc)
        # What every launch checks on the host before it enqueues a kernel,
        # the mean of 50 calls each once the thread has stopped: the two
        # checks as the launch makes them (one read of the edit count each).
        checks = {name: host_us(fn, calls=50) for name, fn in (
            ("params_encoded", ctx._ensure_params_encoded),
            ("static_config", ctx._ensure_static_config),
            ("notify_refs", ctx._notify_refs), ("drain_commands", ctx._drain_commands))}
    finally:
        if on_gc in gc.callbacks:
            gc.callbacks.remove(on_gc)
        ctx.dispose()
    # the same collection with no context playing: the whole heap
    t_gc = time.perf_counter()
    gc.collect()
    gc_stopped_ms = (time.perf_counter() - t_gc) * 1e3

    def pct(xs):
        xs = sorted(xs)
        return {"p50_us": xs[len(xs) // 2] * 1e6, "p99_us": xs[int(0.99 * (len(xs) - 1))] * 1e6,
                "max_us": xs[-1] * 1e6, "n": len(xs)} if xs else None

    rtt = RealtimeAudioContext._measure_step_rtt(dev)
    tuned = RealtimeAudioContext._tune_geometry(rtt, SR, 2, 256)[0]
    done = [(b, e, g, th) for b, e, g, th in collections if e is not None]
    gc_ms = {g: sorted((e - b) * 1e3 for b, e, gg, _ in done if gg == g) for g in (0, 1, 2)}
    hitches.sort(key=lambda h: -h["wall_ms"])
    out = {"label": label, "seconds": elapsed, "frames_played": end[0],
           "underrun_frames": end[1], "steps_rendered": end[2],
           "frames_played_after_1s": end[0] - at1[0],
           "underrun_frames_first_s": at1[1], "underrun_frames_after_1s": end[1] - at1[1],
           "steps_after_1s": end[2] - at1[2],
           "step_audio_us": 256 / SR * 1e6, "walls": {k: pct(v) for k, v in walls.items()},
           "launch_parts_p50_us": {k: statistics.median(v) * 1e6 for k, v in parts.items()},
           "native_ring": native, "device_backend": backend,
           "last_render_error": None if error is None else repr(error),
           "render_errors": ctx.stats.render_errors,
           "measure_step_rtt_us": rtt * 1e6, "auto_tune_superblock": tuned,
           "step_graph": graph,
           "launch_host_checks_us": checks, "threads_at_start": threads,
           "hitches": {"n": len(hitches), "slowest": hitches[:8]},
           "ring_waits_over_10ms": waits[:8], "underruns": underruns[:12],
           "gc": {f"gen{g}": {"n": len(v), "max_ms": v[-1] if v else None,
                              "sum_ms": sum(v)} for g, v in gc_ms.items()},
           "full_collection_ms": {"playing": gc_playing_ms, "stopped": gc_stopped_ms},
           "cpu_while_playing": cpu_use}
    phase("realtime", f"config 5 live ({label}), superblock 2, null output, {elapsed!r} s: "
          f"{json.dumps({k: v for k, v in out.items() if k != 'hitches'})}")
    phase("realtime", f"config 5 live ({label}): {len(hitches)} launches over "
          f"{RT_HITCH_S * 1e3:g} ms, the slowest first: {json.dumps(hitches[:8])}")
    if error is not None or not native or backend not in ("null", "alsa") or end[2] <= 0:
        raise AssertionError(f"the live realtime run failed: {out}")
    if gate and out["underrun_frames_after_1s"] != 0:
        raise AssertionError(f"config 5 live ({label}): {out['underrun_frames_after_1s']} "
                             "frames underran after the first second (the limit is 0)")
    return out


#: Seconds the process of the two live runs may take, its start and build
#: included, before it is killed.
RT_LIVE_TIMEOUT_S = 300


def live_runs(dev):
    """Config 5's two live runs (``live_run``, each raising if a frame
    underran after its first second), in a fresh process of this script
    (``--live-child``), as a realtime application runs: no earlier phase's
    contexts, threads or heap, and no torch.profiler session before it (a
    session leaves CUPTI's callbacks on later CUDA calls of its process;
    the child measures what one costs, and the phases before this one
    open dozens). The child's phase lines go to this process's output; its
    results come back through a file. Raises if the child fails or
    outlives ``RT_LIVE_TIMEOUT_S``. Returns {"runs": [the
    two runs' results], "after_profiler": ``live_child``'s reading of what a
    profiler session leaves behind}."""
    sys.stdout.flush()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_live_") as d:
        path = os.path.join(d, "live.json")
        try:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--live-child",
                                   path, "--device", str(dev)], timeout=RT_LIVE_TIMEOUT_S)
        except subprocess.TimeoutExpired as exc:
            raise AssertionError(f"the live runs' process outlived {RT_LIVE_TIMEOUT_S} s") \
                from exc
        if proc.returncode != 0:
            raise AssertionError(f"the live runs' process exited with {proc.returncode} "
                                 "(its error is above)")
        with open(path) as f:
            return json.load(f)


def live_child(path, device="cuda"):
    """``--live-child PATH``: build (or load) the kernels, run config 5 live
    twice, then read what one torch.profiler session (50 launches) leaves
    behind in the process: a torch op's host cost before and after it
    (``op_host_us``) and a third live run after it, not gated; write the
    results to ``PATH`` as JSON. Exits 1 if either gated run fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import graphaudio_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from graphaudio_tpu_torch.utils import cudabuild

    from graphaudio_tpu_torch.testing.configs import config5_spatial_scene

    cudabuild.build()
    cudabuild.load()
    dev = torch.device(device)
    # The kernels' modules and cuFFT's plans loaded before playback, as they
    # are in the script's process by phase 15 (else the first launch of run
    # 1 loads them: 271 ms on an H100 host, 16128 frames in its first second).
    warm = config5_spatial_scene(superblock=2, context=rt_context(dev))
    try:
        for _ in range(8):
            warm.render_step_blocking()
    finally:
        warm.dispose()
    runs = [live_run(dev, f"run {i}, a fresh process") for i in (1, 2)]
    from torch.profiler import ProfilerActivity, profile

    op_before = op_host_us(dev)
    x = torch.zeros(1024, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(50):
            x.add_(1)
        torch.cuda.synchronize()
    op_after = op_host_us(dev)
    post = live_run(dev, "run 3, after one profiler session (not gated)", seconds=4.0,
                    gate=False)
    after = {"op_host_us": {"before": op_before, "after": op_after},
             "launch_p50_us": {"runs_1_2": [r["walls"]["launch"]["p50_us"] for r in runs],
                               "run_3": post["walls"]["launch"]["p50_us"]},
             "launch_parts_p50_us_run_3": post["launch_parts_p50_us"],
             "underrun_frames_after_1s_run_3": post["underrun_frames_after_1s"]}
    phase("realtime", f"what one torch.profiler session leaves in its process: {json.dumps(after)}")
    with open(path, "w") as f:
        json.dump({"runs": runs, "after_profiler": after}, f)
    return 0


def op_host_us(dev, calls=3000):
    """Host µs a torch op takes to issue (the mean of ``calls`` in-place adds
    to a small tensor on the card, one sync at the end)."""
    import torch

    x = torch.zeros(1024, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def checkpoint_resume(dev, label, build, T, steps=8):
    """(d): render ``steps`` superblocks, save, render ``steps`` more; a fresh
    context that loads the file renders those same ``steps`` bit for bit."""
    from graphaudio_tpu_torch.utils import load_context_state, save_context_state

    a = build()
    a.render(steps * T)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_ckpt_") as d:
        path = os.path.join(d, "state.npz")
        save_context_state(a, path)
        cont = a.render(steps * T)
        b = build()
        load_context_state(b, path)
        got = b.render(steps * T)
        size = os.path.getsize(path)
    same = bool(np.array_equal(got, cont))
    phase("realtime", f"checkpoint, {label}: {steps} superblocks resumed from a {size}-byte file "
          f"bit for bit {same}")
    if not (same and np.abs(cont).max() > 0):
        raise AssertionError(f"{label}: the resumed render differs from the uninterrupted one")
    return {"bit_for_bit": same, "file_bytes": size}


def realtime_phase(dev):
    """Phase 15, ``--realtime``: (a) configs 4 and 5 at full width in a
    ``RealtimeAudioContext`` at superblock 2 against their offline and CPU
    renders (``realtime_parity``), K2a against its plain version at the
    step's shape; (b) the same steps pipelined; (c) config 5 live for
    ``RT_LIVE_S`` s, twice, in a fresh process (``live_runs``; ``live_run``:
    each raises if a frame underran after its first second), and a 20-step
    profile of single-step calls
    at superblock 2; (d) checkpoint resume of config 5 at superblock 32 and
    of config 3 fused. Returns ([the K2a entry], results)."""
    from graphaudio_tpu_torch.testing.configs import (config3_eq_chain, config4_conv_reverb,
                                                      config5_spatial_scene)

    res = {}
    k2a = k2a_live_check(dev, config5_spatial_scene)
    for n, build in ((4, config4_conv_reverb), (5, config5_spatial_scene)):
        res[f"config{n}"] = realtime_parity(dev, n, build)
    live = live_runs(dev)
    res["live"], res["live_2"] = live["runs"]
    res["live_after_profiler"] = live["after_profiler"]
    host = (res["live"]["walls"]["launch"]["p50_us"] + res["live"]["walls"]["finish"]["p50_us"])
    prof = profile_steps(config5_spatial_scene(superblock=2, context=rt_context(dev)), 256, host,
                         groups={**K2BK10B_GROUPS, "K5": "unity_", "P1": "hrtf_fir",
                                 "K2a": "conv_mac", "K3": "fan_in"}, step_calls=True)
    phase("profile", f"config 5 realtime, superblock 2, 20 single-step calls under "
          f"torch.profiler: {json.dumps(prof)}")
    res["live"]["profile"] = prof
    res["checkpoint"] = {
        "config5_superblock32": checkpoint_resume(
            dev, "config 5, superblock 32", lambda: config5_spatial_scene(superblock=32, device=dev),
            32 * 128),
        "config3_fused": checkpoint_resume(
            dev, "config 3 fused (superblock 32)", lambda: config3_eq_chain(superblock=32, device=dev),
            32 * 128)}
    return [k2a], res


#: Superblocks the mesh renders of phase 16 run.
MESH_STEPS = 8
#: Ranks of phase 16's meshes: voice 2 x part 2.
MESH_SHAPE = (2, 2)


def k14a_checks(dev):
    """(a) K14a alone: config 4's part-sharded shapes (K = 2, L = 1, T =
    8192, 8193 bins, P = 12 partitions of the 2 s IR at grain T, padded for
    ``part`` = 2 and 4, rows reversed), every rank's slice against its
    plain version within 1e-6 x max|ref| (bit for bit reported) and its ring
    writes bit for bit, then the slices' sum against the unsliced MAC
    (``spectral_mac_plain`` over every row) within 1e-5 x max|ref| (sums in
    another order). The entry times rank 0's slice at part = 2, beside one
    ``torch.einsum`` over its delay-line rows gathered beforehand; the
    kernel alone (``alone_time``) there and at ``ShardedVoiceScene``'s
    slice (K = 2, L = 8, 129 bins, 375 of 750 rows), each with its share of
    its bound."""
    import torch

    from graphaudio_tpu_torch.ops import convolve as tconv

    rng = np.random.default_rng(14)
    T, K, L = 8192, 2, 1
    NB = T + 1
    decay = np.exp(-np.arange(2 * SR) / (0.4 * SR))
    irs = [(rng.standard_normal(2 * SR) * decay).astype(np.float32) for _ in range(K)]
    prep = [tconv.prepare_ir_big(ir, T) for ir in irs]
    H, Hi = np.stack([p[0] for p in prep]), np.stack([p[1] for p in prep])
    P0 = H.shape[1]

    def cplx(*shape):
        return torch.complex(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
                             torch.from_numpy(rng.standard_normal(shape).astype(np.float32))).to(dev)

    entry, cases = None, []
    for part in (2, 4):
        P = -(-P0 // part) * part
        Hp = np.pad(H, ((0, 0), (P - P0, 0), (0, 0)))
        Hip = np.pad(Hi, ((0, 0), (P - P0, 0), (0, 0)))
        R = P - 1 + L
        X = cplx(K, L, NB)
        ring = torch.view_as_real(cplx(K, R, NB))
        ring_r, ring_i = ring[..., 0].contiguous(), ring[..., 1].contiguous()
        head = int(rng.integers(R))
        pl = P // part
        whole = tconv.spectral_mac_plain(X, torch.from_numpy(Hp).to(dev), torch.from_numpy(Hip).to(dev),
                                         ring_r.clone(), ring_i.clone(), head, True)
        total = torch.zeros_like(whole)
        for d in range(part):
            hr = torch.from_numpy(np.ascontiguousarray(Hp[:, d * pl:(d + 1) * pl])).to(dev)
            hi = torch.from_numpy(np.ascontiguousarray(Hip[:, d * pl:(d + 1) * pl])).to(dev)
            rk, rp = (ring_r.clone(), ring_i.clone()), (ring_r.clone(), ring_i.clone())
            got = tconv.spectral_mac_slice(X, hr, hi, *rk, head, True, d * pl)
            want = tconv.spectral_mac_slice_plain(X, hr, hi, *rp, head, True, d * pl)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            peak = float(want.abs().max())
            same = bool(torch.equal(torch.view_as_real(got), torch.view_as_real(want)))
            rings = bool(torch.equal(rk[0], rp[0]) and torch.equal(rk[1], rp[1]))
            cases.append({"part": part, "rank": d, "P": P, "P_local": pl, "max_abs_err": err,
                          "peak": peak, "bit_for_bit": same, "ring_bit_for_bit": rings})
            if not (err <= 1e-6 * peak and rings):
                raise AssertionError(f"K14a slice {d} of part {part}: {err} > 1e-6 x {peak}, "
                                     f"or its ring writes differ")
            total = total + want
            if part == 2 and d == 0:
                # one einsum over the slice's delay-line rows (slot of row j:
                # sub-block -(P-1-j) for j < P-1, X for the last)
                lags = [P - 1 - j for j in range(pl)]
                slots = [(head - lag) % R for lag in lags]
                win = torch.complex(ring_r[:, slots], ring_i[:, slots])
                Hc = torch.complex(hr, hi)
                # read: X, the slice's spectra, its ring rows; written: the
                # sums and this step's ring row, each (re, im) f32
                moved = nbytes(X, hr, hi) + 2 * K * len(slots) * NB * 4 + 2 * K * L * NB * 8
                entry = compare(
                    f"K14a partition-slice MAC (config 4 under part = 2, rank 0: K={K} L={L} "
                    f"P_local={pl} of P={P}, {NB} bins)", "cuda", "graphaudio_tpu_torch/csrc/conv.cu",
                    "graphaudio_tpu/ops/convolve.py:236",
                    lambda: tconv.spectral_mac_slice(X, hr, hi, *rk, head, True, 0),
                    lambda: tconv.spectral_mac_slice_plain(X, hr, hi, *rp, head, True, 0),
                    1e-6, rel=True, bnd=bound(moved, 8 * K * L * NB * pl),
                    library=lambda: torch.einsum("kjb,kjb->kb", Hc, win), device_times=True)
                entry["alone"] = alone_time(
                    "K14a (config 4 under part = 2, rank 0)",
                    lambda: tconv.spectral_mac_slice(X, hr, hi, *rk, head, True, 0),
                    "conv_mac_slice", entry["bound_ms"])
        err_sum = float((total - whole).abs().max())
        peak = float(whole.abs().max())
        cases.append({"part": part, "slices_sum_vs_whole": err_sum, "peak": peak})
        if err_sum > 1e-5 * peak:
            raise AssertionError(f"K14a: the slices' sum at part {part} is {err_sum} off the "
                                 f"unsliced MAC (peak {peak})")
    # ShardedVoiceScene's slice: the 128 grain, a 2 s IR (750 rows) over
    # part = 2, rank 0; its delay-line rows read once (Pl + L - 1 a channel)
    K, L, NB, P, pl = 2, 8, 129, 750, 375
    R = P - 1 + L
    X = cplx(K, L, NB)
    ring = torch.view_as_real(cplx(K, R, NB))
    ring_r, ring_i = ring[..., 0].contiguous(), ring[..., 1].contiguous()
    hr, hi = (torch.from_numpy(rng.standard_normal((K, pl, NB)).astype(np.float32)).to(dev)
              for _ in range(2))
    head = int(rng.integers(R))
    got = tconv.spectral_mac_slice(X, hr, hi, ring_r.clone(), ring_i.clone(), head, False, 0)
    want = tconv.spectral_mac_slice_plain(X, hr, hi, ring_r.clone(), ring_i.clone(), head, False, 0)
    same = bool(torch.equal(torch.view_as_real(got), torch.view_as_real(want)))
    if not same:
        raise AssertionError("K14a at ShardedVoiceScene's slice is not bit for bit its plain "
                             "version")
    moved = nbytes(X, hr, hi) + 2 * K * (pl + L - 1) * NB * 4 + 2 * K * L * NB * 8
    bnd = bound(moved, 8 * K * L * NB * pl)[0]
    entry["scene_slice"] = dict(alone_time(
        f"K14a (ShardedVoiceScene's slice: K={K} L={L} P_local={pl} of P={P}, {NB} bins)",
        lambda: tconv.spectral_mac_slice(X, hr, hi, ring_r, ring_i, head, False, 0),
        "conv_mac_slice", bnd), bound_ms=bnd, bit_for_bit=same)
    entry["cases"] = cases
    phase("kernels", f"K14a slices: {json.dumps(cases)}")
    return entry


def alone_time(label, fn, only, bound_ms):
    """The device time of one call of ``fn`` counting only the kernels whose
    names hold ``only`` (``device_ms`` over windows that recorded every
    launch: one a call), beside ``bound_ms``; printed with the share of the
    bound. Returns {"device_ms", "pct_of_bound"} (None where no window was
    complete: "not measured")."""
    ms = device_ms(fn, only=only, expect=1)
    pct = None if ms is None else 100.0 * bound_ms / ms
    phase("kernels", f"{label}, the kernel alone: "
          f"{'not measured' if ms is None else repr(ms) + ' ms'} on the device, bound "
          f"{bound_ms!r} ms, {'not measured' if pct is None else '%.1f %%' % pct} of it")
    return {"device_ms": ms, "pct_of_bound": pct}


def k14b_checks(dev):
    """(a) K14b alone: one voice of a per-node 1024-tap HRIR (P = 8; the
    synthetic set of config5_measured), S = 32, its source moving, split
    over ``part`` = 2 and 4: every rank's slice against its plain version
    within 1e-6 x max|ref| (bit for bit reported), the next ring bit for
    bit, and the slices' sum against K10p-a's plain version over every
    partition within 1e-5 x max|ref|. The entry times rank 0's slice at
    part = 2, beside one ``torch.einsum`` over the slice's spectra
    interpolated beforehand. Then config5_part_hrir's static shape (the same
    voice, one direction for the ring and the superblock, as a Kit sound
    that stands still): every slice bit for bit. The kernel alone
    (``alone_time``, without ``flat``'s concatenation, which ``compare``'s
    device time holds) at rank 0 of part = 2 and 4, moving and static,
    each with its share of its bound."""
    import torch

    from graphaudio_tpu_torch.ops import hrtf as th
    from graphaudio_tpu_torch.testing.sofa import synthetic_hrir_set

    rng = np.random.default_rng(15)
    hrir, az_d, el_d = synthetic_hrir_set(sample_rate=SR, n_directions=72, length=1024, seed=9)
    grid = th.load_hrir_grid({"hrir": hrir, "azimuth_deg": az_d, "elevation_deg": el_d,
                              "sample_rate": SR}, SR, length=1024)
    sr_np, si_np = th.hrir_grid_spectra(grid)
    E, A, _, P, B = sr_np.shape
    V, S = 1, 32

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    X = torch.complex(f32(V, S, B), f32(V, S, B))
    hx = f32(V, P - 1, 2 * B)
    # a source sweeping a quarter turn over the superblock and its ring
    sweep = np.linspace(-1.2, 0.4, P - 1 + S).astype(np.float32)[None]
    haz, az = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (sweep[:, :P - 1],
                                                                          sweep[:, P - 1:]))
    hel = torch.full((V, P - 1), 0.1, device=dev)
    el = torch.full((V, S), 0.1, device=dev)
    whole = th.partitioned_mac_plain(X, hx, haz, hel, az, el, torch.from_numpy(sr_np).to(dev),
                                     torch.from_numpy(si_np).to(dev))

    def spectra(part, d):
        pl = P // part
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, :, :, d * pl:(d + 1) * pl])).to(dev)
                     for a in (sr_np, si_np))

    def slice_bound(args, pl):
        """K14b's bound at rank 0's slice of ``pl`` partitions: X, the
        directions, the ring rows it reads, the whole ring and next ring,
        the sums, and the corner spectra this run's directions touch, once
        each; 22 flops a (quantum, partition, ear, bin)."""
        X_, hx_, haz_, hel_, az_, el_, sr_, si_ = args[:8]
        a_c = torch.cat([haz_, az_], 1)[0].cpu()
        e_c = torch.cat([hel_, el_], 1)[0].cpu()
        rows = set()
        for j in range(pl):
            c = (P - 1) + np.arange(S) - j
            r, _ = th.interp_corners(a_c[c], e_c[c], E, A)
            rows |= {(int(x), j) for x in torch.stack(list(r)).flatten()}
        corner_bytes = len(rows) * 2 * B * 8
        ring_rows = {s - p + P - 1 for s in range(S) for p in range(pl) if s < p} | set(
            range(S, P - 1))
        moved = (nbytes(X_, az_, el_) + len(ring_rows) * V * (2 * B + 2) * 4
                 + nbytes(hx_, haz_, hel_) + V * S * 2 * B * 8 + corner_bytes)
        return bound(moved, 22 * V * S * pl * 2 * B), corner_bytes

    entry, cases, alone = None, [], {}
    for part in (2, 4):
        pl = P // part
        total = torch.zeros_like(whole[0])
        for d in range(part):
            sr, si = spectra(part, d)
            args = (X, hx, haz, hel, az, el, sr, si, d * pl)
            got, want = th.partitioned_mac_slice(*args), th.partitioned_mac_slice_plain(*args)
            torch.cuda.synchronize()
            err = float((got[0] - want[0]).abs().max())
            peak = float(want[0].abs().max())
            same = bool(torch.equal(torch.view_as_real(got[0]), torch.view_as_real(want[0])))
            rings = all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
            cases.append({"part": part, "rank": d, "P_local": pl, "max_abs_err": err,
                          "peak": peak, "bit_for_bit": same, "ring_bit_for_bit": rings})
            if not (err <= 1e-6 * peak and rings):
                raise AssertionError(f"K14b slice {d} of part {part}: {err} > 1e-6 x {peak}, "
                                     "or its next ring differs")
            total = total + want[0]
            if part == 2 and d == 0:
                u = (torch.arange(S, device=dev)[:, None] - torch.arange(pl, device=dev) + P - 1)
                xcat = torch.cat([torch.complex(hx[..., :B], hx[..., B:]), X], 1)
                azc, elc = torch.cat([haz, az], 1), torch.cat([hel, el], 1)
                Hs = torch.complex(th.interp_hrir(sr, azc, elc), th.interp_hrir(si, azc, elc))
                xw = xcat[:, u].contiguous()  # [V, S, pl, B]
                hw = Hs[:, u].diagonal(dim1=2, dim2=4).permute(0, 1, 4, 2, 3).contiguous()
                bnd, corner_bytes = slice_bound(args, pl)
                entry = compare(
                    f"K14b partitioned HRTF slice MAC (a 1024-tap per-node HRIR under part = 2, "
                    f"rank 0: V={V} S={S} P_local={pl} of P={P}, grid {E}x{A})", "cuda",
                    "graphaudio_tpu_torch/csrc/hrtf_part.cu", "graphaudio_tpu/ops/hrtf.py:345",
                    lambda: flat(th.partitioned_mac_slice(*args)),
                    lambda: flat(th.partitioned_mac_slice_plain(*args)), 1e-6, rel=True,
                    bnd=bnd,
                    library=lambda: torch.einsum("vspb,vspeb->vseb", xw, hw), device_times=True)
                entry["corner_spectra_bytes"] = corner_bytes
            if d == 0:
                (bnd_ms, _), _ = slice_bound(args, pl)
                alone[f"moving, part = {part}"] = dict(alone_time(
                    f"K14b (moving, part = {part}, rank 0: P_local={pl})",
                    lambda a=args: th.partitioned_mac_slice(*a), "hrtf_part_mac_slice",
                    bnd_ms), bound_ms=bnd_ms)
        err_sum = float((total - whole[0]).abs().max())
        peak = float(whole[0].abs().max())
        cases.append({"part": part, "slices_sum_vs_whole": err_sum, "peak": peak})
        if err_sum > 1e-5 * peak:
            raise AssertionError(f"K14b: the slices' sum at part {part} is {err_sum} off K10p-a's "
                                 f"plain MAC (peak {peak})")
    # config5_part_hrir's static shape: one direction, the ring's too
    still = (torch.full((V, P - 1), 0.5236, device=dev), torch.full((V, P - 1), 0.1, device=dev),
             torch.full((V, S), 0.5236, device=dev), torch.full((V, S), 0.1, device=dev))
    for part in (2, 4):
        pl = P // part
        for d in range(part):
            args = (X, hx, still[0], still[1], still[2], still[3], *spectra(part, d), d * pl)
            got, want = th.partitioned_mac_slice(*args), th.partitioned_mac_slice_plain(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(torch.view_as_real(g) if g.is_complex() else g,
                                   torch.view_as_real(w) if w.is_complex() else w)
                       for g, w in zip(got, want))
            cases.append({"part": part, "rank": d, "P_local": pl, "static": True,
                          "bit_for_bit": same})
            if not same:
                raise AssertionError(f"K14b static slice {d} of part {part} is not bit for bit "
                                     "its plain version")
            if d == 0:
                (bnd_ms, _), _ = slice_bound(args, pl)
                alone[f"static, part = {part}"] = dict(alone_time(
                    f"K14b (config5_part_hrir's static shape, part = {part}, rank 0: "
                    f"P_local={pl})", lambda a=args: th.partitioned_mac_slice(*a),
                    "hrtf_part_mac_slice", bnd_ms), bound_ms=bnd_ms)
    entry["alone"] = alone
    entry["cases"] = cases
    phase("kernels", f"K14b slices: {json.dumps(cases)}")
    return entry


def mesh_job(rank, world, steps):
    """One rank of phase 16's (b)-(d), on ``cuda:0`` with the others (a
    ``MESH_SHAPE`` mesh): config 4 at full width, config5_part_hrir at full
    width (``steps`` superblocks each, after one warm superblock of another
    context), and ``ShardedVoiceScene`` (64 voices, 2 s IR, superblock 8, 4
    steps). Returns, for each, the audio, the sharding, the K14 launches a
    step, the host ms a step and the all_reduce wall ms a step; for config
    4 and config5_part_hrir also K14a's and K14b's device time in the
    render (``k14_in_render``: rank 0 under torch.profiler for ``steps``
    more superblocks, which every rank renders)."""
    import torch
    import torch.distributed as dist

    from graphaudio_tpu_torch.parallel import ShardedVoiceScene, make_mesh
    from graphaudio_tpu_torch.testing.configs import config4_conv_reverb, config5_part_hrir
    from graphaudio_tpu_torch.utils import cudabuild

    mesh = make_mesh(voice_axis=MESH_SHAPE[0], part_axis=MESH_SHAPE[1], device_type="cuda")
    reduce0 = dist.all_reduce
    walls = []

    def timed_reduce(*a, **kw):
        t0 = time.perf_counter()
        r = reduce0(*a, **kw)
        walls.append(time.perf_counter() - t0)
        return r

    dist.all_reduce = timed_reduce
    out = {"backend": dist.get_backend(), "rank": rank}
    try:
        for name, build, T in (("config4", lambda: config4_conv_reverb(superblock=64, voices=64),
                                64 * 128),
                               ("config5_part_hrir", lambda: config5_part_hrir(superblock=32), 32 * 128)):
            warm = build()
            warm.set_mesh(mesh)
            warm.render(T)  # the kernels' first launches, cuFFT plans
            ctx = build()
            ctx.set_mesh(mesh)
            ctx._ensure_compiled()
            ctx._ensure_params_encoded()
            torch.cuda.synchronize()
            dist.barrier()
            cudabuild.launches.clear()
            walls.clear()
            t0 = time.perf_counter()
            audio = ctx.render(steps * T)
            wall = time.perf_counter() - t0
            c = ctx._compiled
            out[name] = {
                "audio": audio, "sharded_stages": sorted(c.sharded_stages),
                "part_sharded": sorted(c.part_sharded),
                "part_sharded_nodes": sorted(type(c.plan[si]["rep"]).__name__ for si in c.part_sharded),
                "render_sharded": c.render_sharded,
                "launches": dict(cudabuild.launches),
                "host_ms_a_step": wall / steps * 1e3,
                "all_reduce_ms_a_step": sum(walls) / steps * 1e3,
                "all_reduces_a_step": len(walls) / steps,
                "k14_in_render": k14_in_render(ctx, rank, steps * T, steps)}
        rng = np.random.default_rng(16)
        V, S = 64, 8
        arenas = (rng.standard_normal((V, 24000)) * 0.2).astype(np.float32)
        ir = (rng.standard_normal(2 * SR) * np.exp(-np.arange(2 * SR) / (0.4 * SR))).astype(np.float32)
        gains = rng.uniform(0.2, 1.0, V).astype(np.float32)
        pans = np.linspace(-1, 1, V).astype(np.float32)
        scene = ShardedVoiceScene(mesh, arenas, ir, gains, pans, superblock=S)
        state = scene.init_state()
        cudabuild.launches.clear()
        walls.clear()
        t0 = time.perf_counter()
        outs = []
        for i in range(4):
            state, wet = scene.render_step(state, i)
            outs.append(wet.cpu().numpy())
        wall = time.perf_counter() - t0
        out["scene"] = {"audio": np.concatenate(outs, axis=1), "launches": dict(cudabuild.launches),
                        "host_ms_a_step": wall / 4 * 1e3,
                        "all_reduce_ms_a_step": sum(walls) / 4 * 1e3,
                        "P": scene.P, "P_local": scene.p_local,
                        "inputs": (arenas, ir, gains, pans) if rank == 0 else None}
    finally:
        dist.all_reduce = reduce0
    return out


#: K14's wrapper counts and a substring of their kernels' names.
K14_KERNELS = {"K14a": ("spectral_mac_slice", "conv_mac_slice"),
               "K14b": ("hrtf_part_mac_slice", "hrtf_part_mac_slice")}


def k14_in_render(ctx, rank, frames, steps):
    """K14a's and K14b's device time in ``steps`` more superblocks of
    ``ctx``'s mesh render: on rank 0 under torch.profiler (the other ranks
    render alongside, unprofiled), each kernel's events summed and held to
    the launches its wrapper counted. Returns {kernel: {"launches", "events",
    "us_a_step", "us_a_launch"}} on rank 0, the times None ("not measured")
    where the window lost events; None on the other ranks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphaudio_tpu_torch.utils import cudabuild

    torch.cuda.synchronize()
    before = dict(cudabuild.launches)
    if rank != 0:
        ctx.render(frames)
        torch.cuda.synchronize()
        return None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ctx.render(frames)
        torch.cuda.synchronize()
    out = {}
    for k, (count, name) in K14_KERNELS.items():
        n = cudabuild.launches.get(count, 0) - before.get(count, 0)
        events, total_us = 0, 0.0
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA") and name in e.key:
                t_us = getattr(e, "self_device_time_total", None)
                total_us += t_us if t_us is not None else getattr(e, "self_cuda_time_total", 0.0)
                events += e.count
        full = n > 0 and events == n
        out[k] = {"launches": n, "events": events,
                  "us_a_step": total_us / steps if full else None,
                  "us_a_launch": total_us / n if full else None}
    return out


def scene_mirror(arenas, ir, gains, pans, frames, master=0.5):
    """The numpy mirror of tests/test_parallel.py:22-35: loop voices,
    equal-power pan, mix, convolve with the normalized IR, master gain."""
    from graphaudio_tpu_torch.ops.convolve import normalization_scale

    V, L = arenas.shape
    mix = np.zeros((2, frames), np.float64)
    for v in range(V):
        idx = np.arange(frames) % L
        s = arenas[v][idx].astype(np.float64) * gains[v]
        x = (pans[v] + 1.0) * 0.5
        mix[0] += s * np.cos(np.float32(x * np.pi / 2))
        mix[1] += s * np.sin(np.float32(x * np.pi / 2))
    ir_n = (ir.astype(np.float32) * np.float32(normalization_scale(ir))).astype(np.float64)
    return np.stack([np.convolve(mix[c], ir_n)[:frames] for c in range(2)]) * master


def mesh_phase(dev):
    """Phase 16, ``--mesh``: (a) K14a and K14b alone (``k14a_checks``,
    ``k14b_checks``); then ``MESH_SHAPE``'s four ranks on one card
    (``testing.mesh.run_ranks``; gloo with CUDA tensors where there is one
    card, since NCCL refuses two ranks on one GPU; NCCL with a card a rank
    otherwise) run ``mesh_job``: (b) config 4 and (c) config5_part_hrir at
    full width, ``MESH_STEPS`` superblocks, every rank's audio equal to every
    other's and within 1e-5 of the single-device render on the card and of
    the CPU render; (d) ``ShardedVoiceScene`` within 1e-5 of its numpy
    mirror. Returns ([the K14a and K14b entries], results)."""
    import torch

    from graphaudio_tpu_torch.testing.configs import config4_conv_reverb, config5_part_hrir
    from graphaudio_tpu_torch.testing.mesh import run_ranks

    t_phase = time.perf_counter()
    entries = [k14a_checks(dev), k14b_checks(dev)]
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= world else "gloo"
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_job, world, backend, args=(MESH_STEPS,), timeout=600, cuda=True)
    spawn_s = time.perf_counter() - t0
    res = {"backend": backend, "world": world, "cards": cards, "mesh": list(MESH_SHAPE),
           "ranks_s": spawn_s}
    phase("mesh", f"{world} ranks on {cards} card(s) over {backend} "
          f"(ranks report {sorted({r['backend'] for r in ranks})}) in {spawn_s!r} s")
    for name, build, T in (("config4", lambda d: config4_conv_reverb(superblock=64, voices=64, device=d),
                            64 * 128),
                           ("config5_part_hrir", lambda d: config5_part_hrir(superblock=32, device=d),
                            32 * 128)):
        got = [r[name]["audio"] for r in ranks]
        equal = all(np.array_equal(g, got[0]) for g in got[1:])
        single = build(dev).render(MESH_STEPS * T)
        cpu = build("cpu").render(MESH_STEPS * T)
        err_card = float(np.abs(got[0].astype(np.float64) - single).max())
        err_cpu = float(np.abs(got[0].astype(np.float64) - cpu).max())
        r0 = {k: v for k, v in ranks[0][name].items() if k != "audio"}
        res[name] = dict(r0, ranks_equal=equal, max_abs_err_vs_single_card=err_card,
                         max_abs_err_vs_cpu=err_cpu, peak=float(np.abs(cpu).max()),
                         per_rank=dict({k: [r[name][k] for r in ranks] for k in (
                             "host_ms_a_step", "all_reduce_ms_a_step")}, k14_launches_a_step=[
                             sum(v for k, v in r[name]["launches"].items() if "_slice" in k)
                             / MESH_STEPS for r in ranks]))
        phase("mesh", f"{name}, {MESH_STEPS} superblocks on a {MESH_SHAPE[0]}x{MESH_SHAPE[1]} mesh: "
              f"ranks equal {equal}; vs the single-card render max_abs_err={err_card!r}, vs the "
              f"CPU render {err_cpu!r} (tolerance 1e-05); {json.dumps(res[name])}")
        for k, r in res[name]["k14_in_render"].items():
            if r["launches"]:
                phase("mesh", f"{k} in {name}'s mesh render (rank 0, {MESH_STEPS} superblocks "
                      f"profiled): " + ("not measured (the profiler recorded "
                                        f"{r['events']} of {r['launches']} launches)"
                                        if r["us_a_step"] is None else
                                        f"{r['us_a_step']!r} us a step, {r['us_a_launch']!r} "
                                        f"us a launch, {r['launches']} launches"))
        if not (equal and err_card < 1e-5 and err_cpu < 1e-5 and np.isfinite(got[0]).all()
                and res[name]["peak"] > 1e-3):
            raise AssertionError(f"{name} under the mesh differs across ranks or from the "
                                 f"single-device render: {res[name]}")
    sc = ranks[0]["scene"]
    got = [r["scene"]["audio"] for r in ranks]
    want = scene_mirror(*sc["inputs"], got[0].shape[1])
    err = float(np.abs(got[0] - want).max())
    equal = all(np.array_equal(g, got[0]) for g in got[1:])
    res["scene"] = {k: v for k, v in sc.items() if k not in ("audio", "inputs")}
    res["scene"].update(ranks_equal=equal, max_abs_err_vs_mirror=err,
                        peak=float(np.abs(want).max()))
    phase("mesh", f"ShardedVoiceScene (64 voices, 2 s IR, superblock 8, 4 steps): ranks equal "
          f"{equal}; vs the numpy mirror max_abs_err={err!r} (tolerance 1e-05); "
          f"{json.dumps(res['scene'])}")
    if not (equal and err < 1e-5):
        raise AssertionError(f"ShardedVoiceScene differs from its mirror: {res['scene']}")
    k14a = res["config4"]["launches"].get("spectral_mac_slice", 0)
    k14b = res["config5_part_hrir"]["launches"].get("hrtf_part_mac_slice", 0)
    if k14a <= 0 or k14b <= 0:
        raise AssertionError(f"the mesh renders did not launch K14a ({k14a}) or K14b ({k14b})")
    entries[0]["launches"], entries[1]["launches"] = k14a, k14b
    res["phase_s"] = time.perf_counter() - t_phase
    phase("mesh", f"phase 16 in {res['phase_s']!r} s; K14a launches {k14a}, K14b {k14b} "
          f"(rank 0, {MESH_STEPS} superblocks)")
    return entries, res


EXAMPLE_ARGS = {  # each twin's main arguments, its output in the working directory
    "offline_mixdown": ("mixdown.wav",),
    "timed_automation": (),
    "game_audio": ("game_scene.wav",),
    "measured_hrtf_flac": (),
    "pcm_delivery_opus": ("scene.opus",),
}
#: the functions a twin's audio is read at: (owner, attribute, which call)
EXAMPLE_TAPS = {"offline_mixdown": ("write_wav", -1), "timed_automation": ("write_wav", -1),
                "game_audio": ("write_wav", -1), "measured_hrtf_flac": ("write_flac", -1),
                "pcm_delivery_opus": ("render_pcm16", 0)}


def run_example(name, device, workdir, pcm_as_f32=False):
    """Run the twin ``graphaudio_tpu_torch.examples.<name>`` on ``device``
    from ``workdir`` (its files land there), reading its audio where it is
    written (``EXAMPLE_TAPS``; ``render_pcm16``'s result for
    pcm_delivery_opus, or with ``pcm_as_f32`` the f32 ``render`` of the same
    frames in its place). Returns the audio, main's wall seconds, the graph
    builds of its contexts, the launches of each kernel wrapper in the run
    and what it printed."""
    import contextlib
    import importlib
    import io
    from unittest import mock

    import torch

    import graphaudio_tpu_torch as gat
    from graphaudio_tpu_torch.utils import cudabuild

    mod = importlib.import_module(f"graphaudio_tpu_torch.examples.{name}")
    attr, which = EXAMPLE_TAPS[name]
    owner = gat.OfflineAudioContext if attr == "render_pcm16" else mod
    real = getattr(owner, attr)
    calls, contexts = [], []

    def tap(*args, **kw):
        if pcm_as_f32:
            out = args[0].render(*args[1:], **kw)
        else:
            out = real(*args, **kw)
        calls.append(out if attr == "render_pcm16" else args[1])
        return out

    real_compile = gat.OfflineAudioContext._ensure_compiled

    def compiled(ctx, *args, **kw):
        if all(c is not ctx for c in contexts):
            contexts.append(ctx)
        return real_compile(ctx, *args, **kw)

    on_card = torch.device(device).type == "cuda"
    argv = [name, os.path.join(workdir, "hrtf_scene.flac")] if name == "measured_hrtf_flac" \
        else [name]
    cwd = os.getcwd()
    printed = io.StringIO()
    os.chdir(workdir)
    try:
        with mock.patch.object(owner, attr, tap), \
                mock.patch.object(gat.OfflineAudioContext, "_ensure_compiled", compiled), \
                mock.patch.object(sys, "argv", argv), contextlib.redirect_stdout(printed):
            if on_card:
                torch.cuda.synchronize()
            cudabuild.launches.clear()
            t0 = time.perf_counter()
            mod.main(*EXAMPLE_ARGS[name], device=device)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in sorted(cudabuild.launches.items()) if v}
    finally:
        os.chdir(cwd)
    return {"audio": calls[which], "wall_s": wall, "launches": launches,
            "graph_builds": sum(c.stats.graph_builds for c in contexts),
            "printed": printed.getvalue().strip().splitlines()}


def examples_phase(dev):
    """Phase 17, ``--examples``: every twin of graphaudio_tpu_torch/examples
    on the card through its ``main``, held to the same twin's run on the CPU
    within 1e-5 max abs (the audio where the twin writes it): offline_mixdown
    (5 s), timed_automation (3.5 s in one call, a graph rebuild at 2 s; the
    error after the rebuild reported apart), game_audio (60 Kit ticks of 2400
    frames), measured_hrtf_flac (the 24-bit FLAC round trip lossless) and
    pcm_delivery_opus (its int16 PCM within 1 LSB of the CPU's, and bit for
    bit the plain pack of the same scene's f32 render on the card, which is
    within 1e-5 of the CPU's); each run twice on the card, the second's audio
    equal to the first's; then multichip_scene on four ranks on the card
    (gloo), the ranks equal and within 1e-5 of the scene on one CPU context.
    Prints each twin's wall seconds and xRT (main's wall, so set-up and file
    writes included), graph builds, the kernels it launched and its error.
    Returns the results."""
    import torch

    import graphaudio_tpu_torch as gat
    from graphaudio_tpu_torch.core import context as tcontext
    from graphaudio_tpu_torch.examples import multichip_scene
    from graphaudio_tpu_torch.io import AudioDecoder

    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(prefix="ga_examples_") as tmp:
        for name in EXAMPLE_ARGS:
            dirs = {k: os.path.join(tmp, f"{name}_{k}") for k in ("cpu", "card", "again", "f32")}
            for d in dirs.values():
                os.makedirs(d)
            cpu = run_example(name, "cpu", dirs["cpu"])
            card = run_example(name, dev, dirs["card"])
            again = run_example(name, dev, dirs["again"])
            got, want = card["audio"], cpu["audio"]
            if name == "pcm_delivery_opus":
                f32 = run_example(name, dev, dirs["f32"], pcm_as_f32=True)["audio"]
                f32_cpu = run_example(name, "cpu", dirs["f32"], pcm_as_f32=True)["audio"]
                packed = tcontext.pack_int16_plain(torch.from_numpy(f32)).numpy()
                r = {"pcm16_bits_equal_plain_pack": bool(np.array_equal(got, packed)),
                     "pcm16_max_lsb_vs_cpu": int(np.abs(got.astype(np.int32) - want).max()),
                     "max_abs_err": float(np.abs(f32.astype(np.float64) - f32_cpu).max()),
                     "peak": float(np.abs(f32_cpu).max()), "seconds": got.shape[0] / 2 / SR}
                ok = (r["pcm16_bits_equal_plain_pack"] and r["pcm16_max_lsb_vs_cpu"] <= 1
                      and got.dtype == np.int16)
            else:
                r = {"max_abs_err": float(np.abs(got.astype(np.float64) - want).max()),
                     "peak": float(np.abs(want).max()), "seconds": got.shape[1] / SR}
                ok = got.shape == want.shape and np.isfinite(got).all()
            if name == "timed_automation":  # past the graph rebuild at t = 2 s
                r["max_abs_err_after_rebuild"] = float(np.abs(
                    got[:, 2 * SR:].astype(np.float64) - want[:, 2 * SR:]).max())
            if name == "measured_hrtf_flac":
                with AudioDecoder(os.path.join(dirs["card"], "hrtf_scene.flac")) as dec:
                    back = dec.decode_planar(dec.frames)
                q = np.clip(np.rint(got.astype(np.float64) * (1 << 23)),
                            -(1 << 23), (1 << 23) - 1) / (1 << 23)
                r["flac_lossless"] = bool(np.array_equal(back, q.astype(np.float32)))
                ok = ok and r["flac_lossless"]
            r.update(wall_s=[card["wall_s"], again["wall_s"]], cpu_wall_s=cpu["wall_s"],
                     xrt=[r["seconds"] / card["wall_s"], r["seconds"] / again["wall_s"]],
                     graph_builds=card["graph_builds"], cpu_graph_builds=cpu["graph_builds"],
                     launches=card["launches"], repeat_equal=bool(np.array_equal(
                         got, again["audio"])), printed=card["printed"],
                     sha256=hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest())
            res[name] = r
            phase("examples", f"{name}: {json.dumps(r)}")
            if not (ok and r["max_abs_err"] < 1e-5 and r["repeat_equal"] and r["peak"] > 1e-3
                    and r["launches"]):
                raise AssertionError(f"the {name} twin on the card differs from its CPU run, "
                                     f"from itself, is silent or launched no kernel: {r}")
        world = 4
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            ranks = multichip_scene.main(world, device=dev.type)
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        want = multichip_scene.build_scene(gat.OfflineAudioContext(
            sample_rate=multichip_scene.SR, superblock=8, device="cpu"), world).render_seconds(2.0)
        got = ranks[0][0]
        r = {"ranks": world, "ranks_equal": all(np.array_equal(x[0], got) for x in ranks[1:]),
             "max_abs_err": float(np.abs(got.astype(np.float64) - want).max()),
             "peak": float(np.abs(want).max()), "sharded_stages": ranks[0][1],
             "graph_builds": ranks[0][2], "launches": {k: v for k, v in sorted(
                 ranks[0][3].items()) if v}, "wall_s": wall, "xrt": 2.0 / wall,
             "wav_written": os.path.getsize(os.path.join(tmp, "multichip_scene.wav")) > 44}
        res["multichip_scene"] = r
        phase("examples", f"multichip_scene: {json.dumps(r)}")
        if not (r["ranks_equal"] and r["max_abs_err"] < 1e-5 and r["peak"] > 1e-3
                and r["sharded_stages"] and r["launches"] and r["wav_written"]):
            raise AssertionError(f"multichip_scene on {world} ranks differs across ranks or "
                                 f"from the single-device CPU render: {r}")
    res["phase_s"] = time.perf_counter() - t_phase
    phase("examples", f"phase 17 in {res['phase_s']!r} s")
    return res


def goldens(dev):
    """Configs 4, 3, 2, 5 and 6 (modulated) at superblock 4 over 8192 frames against
    tests/goldens/*.npz, within 1e-5 max abs; returns {config: error}."""
    from graphaudio_tpu_torch.testing.configs import (config2_mix_bus, config3_eq_chain,
                                                      config4_conv_reverb, config5_spatial_scene,
                                                      config6_lfo_tremolo)

    golden_err = {}
    for n, builder in ((4, config4_conv_reverb), (3, config3_eq_chain), (2, config2_mix_bus),
                       (5, config5_spatial_scene), (6, config6_lfo_tremolo)):
        out = builder(superblock=4, device=dev).render(8192)
        golden = np.load(GOLDENS[n])["out"]
        err = float(np.abs(out.astype(np.float64) - golden).max())
        golden_err[n] = err
        phase("golden", f"config {n}, superblock 4, 8192 frames: max_abs_err={err!r} vs "
              f"{os.path.relpath(GOLDENS[n], ROOT)} (tolerance 1e-05)")
        if not (out.shape == golden.shape and err < 1e-5):
            raise AssertionError(f"config-{n} golden mismatch: {err}")
    return golden_err


def main(device="cuda", only=None):
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
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    phase("device", f"host compiler: {gxx.stdout.splitlines()[0] if gxx.returncode == 0 else gxx}")

    sys.path.insert(0, ROOT)
    import graphaudio_tpu_torch as gat  # noqa: F401  (sets the TF32 policy)
    from graphaudio_tpu_torch.core import context as tcontext
    from graphaudio_tpu_torch.core import mixing as tmixing
    from graphaudio_tpu_torch.testing.configs import config4_conv_reverb, config5_spatial_scene
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
    from graphaudio_tpu_torch.io import native as tnative

    t0 = time.perf_counter()
    codec = tnative.load()
    codec_s = time.perf_counter() - t0
    if codec is None:
        raise AssertionError("the native codec (graphaudio_tpu_torch/native/gacodec.cpp) "
                             "did not build or load")
    phase("build", f"native codec {os.path.basename(codec._name)} in {codec_s!r} s (g++)")
    # The floor under any kernel's device time as torch.profiler reads it:
    # the smallest kernel the card runs, a one-element fill.
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(one.zero_)
    phase("device", f"a one-element fill takes {floor_ms!r} ms on the device")
    S, T = 64, 64 * 128
    frames = 175 * T  # 30 s rounded down to whole superblocks (as bench.py does)
    b4 = lambda: config4_conv_reverb(superblock=S, voices=64, device=dev)  # noqa: E731
    T5 = 32 * 128
    frames5 = (30 * SR // T5) * T5  # 351 superblocks
    b5 = lambda: config5_spatial_scene(superblock=32, device=dev)  # noqa: E731

    if only:
        from graphaudio_tpu_torch.testing.configs import config3_eq_chain

        T3 = 32 * 128
        frames3 = (30 * SR // T3) * T3  # 351 superblocks
        b3 = lambda: config3_eq_chain(superblock=32, device=dev)  # noqa: E731
        golden_err = None
        if only == "k2a":
            entries = k2_checks(dev)
            runs = {"config4": render_runs(4, b4, T, frames, {"K2a": ("spectral_mac",)})}
        elif only == "p1":
            entries = [p1_checks(dev)]
            runs = {"config5": render_runs(5, b5, T5, frames5, {"P1": ("hrtf_fir",)})}
            entries[0]["launches"] = runs["config5"]["launches"]["P1"]
        elif only == "k6k8":
            entries = list(k6k8_checks(dev))
            # launches under this tree's names and the parent trees'
            runs = {"config3": render_runs(3, b3, T3, frames3, {
                "K6": ("eval_intrinsic_batch", "eval_intrinsic_blocked"),
                "K8": ("biquad_coefficients_batch", "biquad_coefficients")}, K6K8_GROUPS)}
            for e, label in zip(entries, ("K6", "K8")):
                e["launches"] = runs["config3"]["launches"][label]
        elif only == "k2bk10b":
            entries = k2_checks(dev) + [k10b_checks(dev)]
            golden_err = goldens(dev)
            # launches under this tree's wrapper names and the parent trees'
            counts = {"K2b": ("overlap_add",), "K10b": ("spatial_gains_batch", "spatial_gains")}
            runs = {"config4": render_runs(4, b4, T, frames, {"K2b": counts["K2b"]},
                                           K2BK10B_GROUPS),
                    "config5": render_runs(5, b5, T5, frames5, counts, K2BK10B_GROUPS)}
            for e, label in zip(entries[1:], ("K2b", "K10b")):
                e["launches"] = runs["config5"]["launches"][label]
            for n in (4, 5):
                runs[f"config{n}"]["golden_max_abs_err"] = golden_err[n]
        elif only == "wire6":
            entries = wire_checks(dev, 64 * T) + k11k6m_checks(dev)
            golden_err = goldens(dev)
            f32, _, _ = timed_render(b4, frames)
            runs = {"config4_wire": wire_runs(dev, b4, T, frames, f32),
                    "config6": config6_runs(dev)}
            runs["config6"]["golden_max_abs_err"] = golden_err[6]
            for e, where in zip(entries, ("render_mulaw", "render_adpcm")):
                e["launches"] = runs["config4_wire"][where]["launches"]
            for e, label in zip(entries[2:], ("K11", "K6m")):
                e["launches"] = runs["config6"]["modulated"]["launches"][label]
            entries[2]["constant_mode"]["launches"] = \
                runs["config6"]["modulated"]["launches"]["K11 constant"]
        elif only == "k11k4a":
            entries = wire_checks(dev, 64 * T, mulaw=False) + k11k6m_checks(dev)
            golden_err = goldens(dev)
            f32, _, _ = timed_render(b4, frames)
            runs = {"config4_adpcm": wire_runs(dev, b4, T, frames, f32, runs=3,
                                               methods=("render_adpcm",), profile=True),
                    "config6": config6_runs(dev, runs=3)}
            runs["config6"]["golden_max_abs_err"] = golden_err[6]
            entries[0]["launches"] = runs["config4_adpcm"]["render_adpcm"]["launches"]
            for e, label in zip(entries[1:], ("K11", "K6m")):
                e["launches"] = runs["config6"]["modulated"]["launches"][label]
            entries[1]["constant_mode"]["launches"] = \
                runs["config6"]["modulated"]["launches"]["K11 constant"]
        elif only == "k7":
            entries = [k7_checks(dev), k6x_checks(dev)]
            entries.append({"name": "K4a IMA ADPCM chunk encoder", "route": "cuda",
                            "source": "graphaudio_tpu_torch/csrc/adpcm.cu",
                            "replaces": "graphaudio_tpu/ops/wire.py:338",
                            "streamed_blocks": k4a_streamed(dev)})
            golden_err = goldens(dev)
            runs = slice16_runs(dev)
            entries[0]["launches"] = runs["config4_pitched"]["launches"]["K7"]
            entries[1]["launches"] = runs["config4_pitched"]["launches"]["K6"]
        elif only == "k4mu":
            entries = k4mu_checks(dev)
            f32, _, _ = timed_render(b4, frames)
            runs = {"config4_mulaw": wire_runs(dev, b4, T, frames, f32, runs=3,
                                               methods=("render_mulaw",), profile=True)}
            entries[0]["launches"] = runs["config4_mulaw"]["render_mulaw"]["launches"]
        elif only == "mod8b":
            entries = deferred_checks(dev)
            golden_err = goldens(dev)
            runs = prologue_item10_runs(dev, ("config3_wah", "config5_orbit"))
            entries[0]["launches"] = runs["config3_wah"]["launches"]["K8"]
            entries[1]["launches"] = runs["config5_orbit"]["launches"]["K10b"]
        elif only == "item10":
            entries = [k12_checks(dev), k13_checks(dev)]
            golden_err = goldens(dev)
            runs = prologue_item10_runs(dev, ("config5_steplinear", "config4_pingpong"))
            entries[0]["launches"] = runs["config4_pingpong"]["launches"]["K12"]
            entries[1]["launches"] = runs["config5_steplinear"]["launches"]["K13"]
            entries[1]["launches_pingpong"] = runs["config4_pingpong"]["launches"]["K13"]
        elif only == "stream":
            with tempfile.TemporaryDirectory(dir=ROOT, prefix="_stream_media_") as root:
                entries = k15_checks(dev, root)
                runs = stream_runs(dev, root)
            for e, label in zip(entries, ("K15 resample", "K15 unity")):
                e["launches"] = runs["config5_streamed"]["launches"][label]
        elif only == "pipe":
            entries = []
            golden_err = goldens(dev)
            runs = {"config3_pipe": pipe_runs(dev)}
        elif only == "hrtfpart":
            entries = k10p_checks(dev)
            golden_err = goldens(dev)
            runs = {"config5_measured": measured_runs(dev),
                    "config5": render_runs(5, b5, T5, frames5, {"P1": ("hrtf_fir",)},
                                           K10P_GROUPS)}
            if runs["config5"]["sha256"] != EARLIER_SHA256["config5/sha256"]:
                raise AssertionError(f"config 5 rendered {runs['config5']['sha256']}, not its "
                                     f"recorded {EARLIER_SHA256['config5/sha256']}")
            for e, label in zip(entries, ("K10p-in", "K10p-a", "K10p-b")):
                e["launches"] = runs["config5_measured"]["p2"]["launches"][label]
                e["launches_p8"] = runs["config5_measured"]["p8"]["launches"][label]
        elif only == "k10pa":
            entries = []
            runs = {"k10pa_us": k10pa_times(dev)}
        elif only == "k9":
            entries = [k9_checks(dev)]
            golden_err = goldens(dev)
            ref_occ = occluded_scene("cpu", OCCLUDED_VOICES).render(8 * T5)
            # launches under this tree's wrapper names and the parent trees'
            counts = {"K9": ("band_split", "onepole_lowpass"), "K9 band split": ("band_split",),
                      "K9 one-pole lowpass": ("onepole_lowpass",)}
            runs = {"occluded": render_runs("5 occluded",
                                            lambda: occluded_scene(dev, OCCLUDED_VOICES), T5,
                                            frames5, counts, K9_GROUPS, ref=ref_occ),
                    "config4": render_runs(4, b4, T, frames, {}, K9_GROUPS),
                    "config5": render_runs(5, b5, T5, frames5, {}, K9_GROUPS)}
            entries[0]["launches"] = runs["occluded"]["launches"]["K9 band split"]
            entries[0]["one_pole_mode"]["launches"] = \
                runs["occluded"]["launches"]["K9 one-pole lowpass"]
            for n in (4, 5):
                runs[f"config{n}"]["golden_max_abs_err"] = golden_err[n]
        elif only == "realtime":
            entries, rt = realtime_phase(dev)
            runs = {"realtime": rt}
        elif only == "mesh":
            entries, mesh = mesh_phase(dev)
            runs = {"mesh": mesh}
        elif only == "examples":
            entries = []
            runs = {"examples": examples_phase(dev)}
        else:  # k1k5
            entries, _ = k1k5_checks(dev)
            golden_err = goldens(dev)
            # launches under this tree's wrapper names and the parent trees'
            k1 = {"group step": ("poly_group_step", "poly_resample")}
            k5 = {"group step": ("unity_group_step", "unity_gather")}
            runs = {"config4": render_runs(4, b4, T, frames, k1, K1K5_GROUPS),
                    "config3": render_runs(3, b3, T3, frames3, k5, K1K5_GROUPS),
                    "config5": render_runs(5, b5, T5, frames5, k5, K1K5_GROUPS)}
            for e, n in zip(entries, (4, 3)):
                e["launches"] = runs[f"config{n}"]["launches"]["group step"]
            for n in (4, 3, 5):
                runs[f"config{n}"]["golden_max_abs_err"] = golden_err[n]
        print(json.dumps({"kernels": entries, **runs, "golden_max_abs_err": golden_err,
                          "build_s": build_s, "codec_build_s": codec_s,
                          "floor_device_ms": floor_ms, "card": smi}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # -- 3. kernels against their plain versions, main-path shapes ------------
    # K1 at config 4, K5 at configs 3, 2 and 5, each a whole group step
    entries, voices = k1k5_checks(dev)  # voices: config 4's K1 audio, [64, 1, 8192]

    entries += k2_checks(dev)

    k3 = k3_check("config 4: [64, 1, 8192] -> [2, 8192]", voices, 2)
    k3["name"] = "K3 lane fan-in"
    entries.append(k3)
    # Where K3's call goes on the host, beside torch.sum's.
    launch = cudabuild.launcher("ga_fan_in")
    k3_out = torch.empty(2, T, device=dev)  # kept alive while the loop launches into it
    k3_args = (voices.data_ptr(), k3_out.data_ptr(), 64, 1, 2, T, 1, 1.0,
               cudabuild.stream_of(voices))
    cudabuild.check(launch(*k3_args), "ga_fan_in")
    k3["host_us"] = {
        "fan_in_lanes": host_us(lambda: tmixing.fan_in_lanes(voices, 2)),
        "torch.sum + expand": host_us(lambda: torch.sum(voices, dim=0).expand(2, -1)),
        "ctypes launch alone": host_us(lambda: launch(*k3_args)),
        "output allocation": host_us(lambda: voices.new_empty((2, T))),
    }
    phase("kernels", f"K3 host time a call (mean of 10000, us): {json.dumps(k3['host_us'])}")
    n_pack = 175 * T
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((2, n_pack)) * 0.5).astype(np.float32)).to(dev)
    entries.append(compare(
        "K4 int16 pack", "cuda", "graphaudio_tpu_torch/csrc/pack.cu",
        "graphaudio_tpu/core/context.py:37",
        lambda: tcontext.pack_int16(audio), lambda: tcontext.pack_int16_plain(audio), 0,
        bnd=bound(nbytes(audio) + audio.numel() * 2, 3 * audio.numel())))

    entries += wire_checks(dev, 64 * T)  # config 4's launch chunk: 64 steps

    # -- 3b. the config-3, config-5 and config-6 paths' kernels ---------------------
    entries += config3_kernel_checks(dev)
    entries += k11k6m_checks(dev)
    entries += [k7_checks(dev), k6x_checks(dev)]
    for e in entries:
        if e["name"] == "K4a IMA ADPCM chunk encoder":
            e["streamed_blocks"] = k4a_streamed(dev)
    c5, k3_c5 = config5_kernel_checks(dev)
    entries += c5
    k3["config5_shape"] = {k: k3_c5[k] for k in ("name", "max_abs_err", "ms", "plain_ms",
                                                 "bound_ms", "bound_by", "library_ms",
                                                 "device_ms")}

    # -- 4. goldens ----------------------------------------------------------
    from graphaudio_tpu_torch.testing.configs import config3_eq_chain

    golden_err = goldens(dev)

    # -- 5. the config-4 path at full size -------------------------------------
    t0 = time.perf_counter()
    b4().render(T)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    phase("first", f"build graph + first superblock render: {first_s!r} s")

    # Each entry's wrapper, by the name it counts its launches on.
    wrappers = {"K1 polyphase group step": "poly_group_step", "K2a spectral MAC": "spectral_mac",
                "K2b overlap-add": "overlap_add", "K3 lane fan-in": "fan_in_lanes",
                "K4 int16 pack": "pack_int16"}
    cudabuild.launches.clear()
    f32, wall_f, bd_f = timed_render(b4, frames)
    pcm, wall_p, bd_p = timed_render(b4, frames, "render_pcm16")
    launches = {name: cudabuild.launches[w] for name, w in wrappers.items()}
    walls4 = [wall_f] + [timed_render(b4, frames)[1] for _ in range(4)]
    render4 = {"frames": frames, "f32": spread(frames, walls4)}

    rms = float(np.sqrt(np.mean(f32.astype(np.float64) ** 2)))
    seconds = frames / SR
    render4["sha256"] = hashlib.sha256(np.ascontiguousarray(f32).tobytes()).hexdigest()
    phase("render", f"f32: {f32.shape}; five runs {walls4!r} s, median "
          f"{render4['f32']['xrt_median']!r} xRT; rms {rms!r}; sha256 of the first run "
          f"{render4['sha256']}; first run breakdown {json.dumps(bd_f)}")
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
    for name in ("K1 polyphase group step", "K2b overlap-add"):
        if launches[name] != 2 * (frames // T):
            raise AssertionError(f"{name}: {launches[name]} launches in two renders of "
                                 f"{frames // T} steps, not one a step")
    host4 = statistics.median(walls4) / (frames // T) * 1e6
    profile4 = profile_steps(b4(), T, host4, groups=K2BK10B_GROUPS)
    phase("profile", f"config 4, 20 steps under torch.profiler: {json.dumps(profile4)}")
    ops4 = attribute_ops(b4(), T)
    phase("ops", f"config 4, the step's PyTorch ops by source line (device us, launches a step): "
          f"{json.dumps(ops4)}")
    render4.update(host_us_per_step_median=host4, profile=profile4, torch_ops=ops4)

    # -- 6. the config-3 path at full size -----------------------------------
    T3 = 32 * 128
    frames3 = (30 * SR // T3) * T3  # 351 superblocks
    b3 = lambda: config3_eq_chain(superblock=32, device=dev)  # noqa: E731
    wrappers3 = {"K5 unity group step": "unity_group_step",
                 "K6 param curve": "eval_intrinsic_batch",
                 "K8 RBJ coefficients": "biquad_coefficients_batch",
                 "P2 biquad cascade": "biquad_apply"}
    b3().render(T3)
    torch.cuda.synchronize()
    cudabuild.launches.clear()
    out3, wall3, bd3 = timed_render(b3, frames3)
    launches3 = {name: cudabuild.launches[w] for name, w in wrappers3.items()}
    walls3 = [wall3] + [timed_render(b3, frames3)[1] for _ in range(4)]
    rms3 = float(np.sqrt(np.mean(out3.astype(np.float64) ** 2)))
    head_err = float(np.abs(out3[:, :8192].astype(np.float64)
                            - np.load(GOLDENS[3])["out"]).max())
    render3 = spread(frames3, walls3)
    sha3 = hashlib.sha256(np.ascontiguousarray(out3).tobytes()).hexdigest()
    phase("render", f"config 3 f32: {out3.shape}; five runs {walls3!r} s, median "
          f"{render3['xrt_median']!r} xRT; rms {rms3!r}; sha256 of the first run {sha3}; "
          f"first 8192 frames vs golden "
          f"max_abs_err={head_err!r}; first run breakdown {json.dumps(bd3)}; launches {launches3}")
    if not (out3.shape == (2, frames3) and np.isfinite(out3).all() and rms3 > 0
            and head_err < 1e-5):
        raise AssertionError("config-3 render is not finite, non-silent, [2, frames] "
                             "and within 1e-5 of the golden at its start")
    for e in entries:
        if e["name"] in launches3:
            e["launches"] = launches3[e["name"]]
            if e["launches"] <= 0:
                raise AssertionError(f"{e['name']} was not launched by the config-3 path")
    # The four biquads are one pipe of delay 3: the call runs its 351 steps
    # and 3 drain rows; the source runs in the steps alone, K6, K8 and P2
    # once a row.
    rows3 = bd3["rows"]
    if rows3 != frames3 // T3 + 3:
        raise AssertionError(f"config 3 ran {rows3} rows for {frames3 // T3} steps, not 3 more")
    for name, n in (("K5 unity group step", frames3 // T3), ("K6 param curve", rows3),
                    ("K8 RBJ coefficients", rows3), ("P2 biquad cascade", rows3)):
        if launches3[name] != n:
            raise AssertionError(f"{name}: {launches3[name]} launches in {frames3 // T3} steps "
                                 f"({rows3} rows), not {n}")
    # Fused and unfused render alike, bit for bit.
    plain3, _, bd3u = timed_render(lambda: unfused(b3()), frames3)
    sha3u = hashlib.sha256(np.ascontiguousarray(plain3).tobytes()).hexdigest()
    phase("render", f"config 3 unfused: sha256 {sha3u}; rows {bd3u['rows']}")
    if sha3u != sha3 or bd3u["rows"] != frames3 // T3:
        raise AssertionError("config 3 fused and unfused differ")
    host_us3 = statistics.median(walls3) / (frames3 // T3) * 1e6
    profile3 = profile_steps(b3(), T3, host_us3, groups=K6K8_GROUPS)
    phase("profile", f"config 3, 20 steps under torch.profiler: {json.dumps(profile3)}")
    ops3 = attribute_ops(b3(), T3)
    phase("ops", f"config 3, the step's PyTorch ops by source line (device us, launches a step): "
          f"{json.dumps(ops3)}")

    # -- 7. the config-5 path at full size -----------------------------------
    wrappers5 = {"P1 HRTF FIR": "hrtf_fir", "K10b spatial gains": "spatial_gains_batch",
                 "K2a spectral MAC": "spectral_mac", "K2b overlap-add": "overlap_add",
                 "K3 lane fan-in": "fan_in_lanes", "K5 unity group step": "unity_group_step",
                 "K6 param curve": "eval_intrinsic_batch"}
    b5().render(T5)
    torch.cuda.synchronize()
    cudabuild.launches.clear()
    first5, wall5, bd5 = timed_render(b5, frames5)
    launches5 = {name: cudabuild.launches[w] for name, w in wrappers5.items()}
    walls5 = [wall5] + [timed_render(b5, frames5)[1] for _ in range(4)]
    rms5 = float(np.sqrt(np.mean(first5.astype(np.float64) ** 2)))
    head_err5 = float(np.abs(first5[:, :8192].astype(np.float64)
                             - np.load(GOLDENS[5])["out"]).max())
    render5 = spread(frames5, walls5)
    sha5 = hashlib.sha256(np.ascontiguousarray(first5).tobytes()).hexdigest()
    phase("render", f"config 5 f32: {first5.shape}; five runs {walls5!r} s, median "
          f"{render5['xrt_median']!r} xRT; rms {rms5!r}; sha256 of the first run {sha5}; "
          f"first 8192 frames vs golden "
          f"max_abs_err={head_err5!r}; first run breakdown {json.dumps(bd5)}; launches {launches5}")
    if not (first5.shape == (2, frames5) and np.isfinite(first5).all() and rms5 > 0
            and head_err5 < 1e-5):
        raise AssertionError("config-5 render is not finite, non-silent, [2, frames] "
                             "and within 1e-5 of the golden at its start")
    for name in ("P1 HRTF FIR", "K10b spatial gains", "K2a spectral MAC", "K3 lane fan-in",
                 "K5 unity group step"):
        if launches5[name] <= 0:
            raise AssertionError(f"{name} was not launched by the config-5 path")
    for name in ("K5 unity group step", "K10b spatial gains", "K2b overlap-add"):
        if launches5[name] != frames5 // T5:
            raise AssertionError(f"{name}: {launches5[name]} launches in {frames5 // T5} "
                                 "config-5 steps, not one a step")
    host_us5 = statistics.median(walls5) / (frames5 // T5) * 1e6
    profile5 = profile_steps(b5(), T5, host_us5, groups=K2BK10B_GROUPS)
    phase("profile", f"config 5, 20 steps under torch.profiler: {json.dumps(profile5)}")
    ops5 = attribute_ops(b5(), T5)
    phase("ops", f"config 5, the step's PyTorch ops by source line (device us, launches a step): "
          f"{json.dumps(ops5)}")

    # -- 8. the occluded scene -------------------------------------------------
    wrappers_occ = {"K9 band split": "band_split", "P1 HRTF FIR": "hrtf_fir",
                    "K10b spatial gains": "spatial_gains_batch"}
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
    # The full-size occluded scene: every one of the 128 voices in one
    # occluded panner stage, so the band split launches once a step.
    ref_full = occluded_scene("cpu", OCCLUDED_VOICES).render(8 * T5)
    full_occ = render_runs("5 occluded", lambda: occluded_scene(dev, OCCLUDED_VOICES), T5,
                           frames5, {name: (w,) for name, w in (*wrappers_occ.items(), (
                               "K9 one-pole lowpass", "onepole_lowpass"))},
                           K9_GROUPS, runs=5, ref=ref_full)
    launches_full = full_occ["launches"]
    if launches_full["K9 band split"] != frames5 // T5:
        raise AssertionError(f"K9 band split: {launches_full['K9 band split']} launches in "
                             f"{frames5 // T5} steps of the full-size occluded scene, not one a step")
    for name in ("P1 HRTF FIR", "K10b spatial gains"):
        if launches_full[name] <= 0:
            raise AssertionError(f"{name} was not launched by the full-size occluded scene")
    for e in entries:
        if e["name"] in ("P1 HRTF FIR", "K10b spatial gains"):
            e["launches"] = launches5[e["name"]]
        elif e["name"] == "K9 band split":
            e["launches"] = launches_full["K9 band split"]
            # the one-pole mode is not on the panner's path: 0
            e["one_pole_mode"]["launches"] = launches_full["K9 one-pole lowpass"]

    # -- 9. the wire formats on config 4 ------------------------------------------
    wire4 = wire_runs(dev, b4, T, frames, f32)

    # -- 10. config 6 at full size -----------------------------------------------------
    runs6 = config6_runs(dev)

    # -- 11. the time-varying rate: config4_pitched, config6_swept, vibrato -----------
    runs16 = slice16_runs(dev)
    for e in entries:
        if e["name"] == "K7 time-varying resample group step":
            e["launches"] = runs16["config4_pitched"]["launches"]["K7"]
        elif e["name"] == "K6 exact rows":
            e["launches"] = runs16["config4_pitched"]["launches"]["K6"]
    for e in entries:
        if e["name"] == "K4mu mu-law pack":
            e["launches"] = wire4["render_mulaw"]["launches"]
        elif e["name"] == "K4a IMA ADPCM chunk encoder":
            e["launches"] = wire4["render_adpcm"]["launches"]
        elif e["name"] == "K11 oscillator group step":
            e["launches"] = runs6["modulated"]["launches"]["K11"]
            e["constant_mode"]["launches"] = runs6["modulated"]["launches"]["K11 constant"]
        elif e["name"] == "K6m param modulation":
            e["launches"] = runs6["modulated"]["launches"]["K6m"]

    # -- 12. modulated prologue params and item 10 ----------------------------------
    entries += deferred_checks(dev) + [k12_checks(dev), k13_checks(dev)]
    runs_p10 = prologue_item10_runs(dev)
    for e in entries:
        if e["name"] == "K8 RBJ coefficients, deferred":
            e["launches"] = runs_p10["config3_wah"]["launches"]["K8"]
        elif e["name"] == "K10b spatial gains, deferred":
            e["launches"] = runs_p10["config5_orbit"]["launches"]["K10b"]
        elif e["name"] == "K12 delay":
            e["launches"] = runs_p10["config4_pingpong"]["launches"]["K12"]
        elif e["name"] == "K13 stereo pan":
            e["launches"] = runs_p10["config5_steplinear"]["launches"]["K13"]
            e["launches_pingpong"] = runs_p10["config4_pingpong"]["launches"]["K13"]

    # -- 13. the streamed scene (audio IO) --------------------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_stream_media_") as root:
        k15 = k15_checks(dev, root)
        runs_stream = stream_runs(dev, root)
    for e, label in zip(k15, ("K15 resample", "K15 unity")):
        e["launches"] = runs_stream["config5_streamed"]["launches"][label]
    entries += k15

    # -- 14. a measured HRIR set past 128 taps (the partitioned filter) ----------------
    k10p = k10p_checks(dev)
    runs_measured = measured_runs(dev)
    for e, label in zip(k10p, ("K10p-in", "K10p-a", "K10p-b")):
        e["launches"] = runs_measured["p2"]["launches"][label]
        e["launches_p8"] = runs_measured["p8"]["launches"][label]
    entries += k10p

    # -- 15. the realtime context at superblock 2, and checkpoint resume --------------
    k2a_rt, runs_rt = realtime_phase(dev)
    for e in entries:
        if e["name"] == "K2a spectral MAC":
            e["shapes"].append({k: k2a_rt[0][k] for k in ("name", "max_abs_err", "ms", "plain_ms",
                                                          "bound_ms", "bound_by", "device_ms",
                                                          "shape")})

    # -- 16. multi-device rendering: K14 and the mesh renders ------------------------
    k14, runs_mesh = mesh_phase(dev)
    entries += k14

    # -- 17. the examples' twins ---------------------------------------------------------
    runs_examples = examples_phase(dev)

    render = {
        "config4": dict(render4, pcm16_wall_s=wall_p, pcm16_xrt=seconds / wall_p,
                        first_render_s=first_s, golden_max_abs_err=golden_err[4]),
        "config3": {"frames": frames3, "f32": render3, "host_us_per_step_median": host_us3,
                    "sha256": sha3, "sha256_unfused": sha3u, "rows": rows3,
                    "golden_max_abs_err": golden_err[3], "head_vs_golden": head_err,
                    "launches": launches3, "profile": profile3, "torch_ops": ops3},
        "config5": {"frames": frames5, "f32": render5, "host_us_per_step_median": host_us5,
                    "sha256": sha5,
                    "golden_max_abs_err": golden_err[5], "head_vs_golden": head_err5,
                    "launches": launches5, "profile": profile5, "torch_ops": ops5},
        "occluded": {"max_abs_err_vs_cpu": err_occ, "launches": launches_occ},
        "occluded_full": full_occ,
        "config4_wire": wire4,
        "config6": dict(runs6, golden_max_abs_err=golden_err[6]),
        **runs16,
        **runs_p10,
        "config5_streamed": runs_stream["config5_streamed"],
        "config5_beside_streamed": runs_stream["config5"],
        "config5_measured": runs_measured,
        "realtime": runs_rt,
        "mesh": runs_mesh,
        "examples": runs_examples,
        "config2_golden_max_abs_err": golden_err[2],
        "build_s": build_s, "codec_build_s": codec_s, "floor_device_ms": floor_ms,
        "card": smi}
    check_earlier_hashes(render)
    print(json.dumps({"kernels": entries, "render": render}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    modes = {
        "k2a": "the K2 checks at their three shapes and three 30 s config-4 renders",
        "p1": "the P1 checks and three 30 s config-5 renders",
        "k6k8": "the K6 and K8 checks through their one-entry names and three 30 s "
                "config-3 renders",
        "k1k5": "the K1 and K5 group-step checks through the public process_*_group "
                "names, the goldens and three 30 s renders each of configs 4, 3 and 5",
        "k2bk10b": "the K2 checks at four shapes (one a true-stereo IR), the K10b checks "
                   "at config 5 and with two panner groups, the goldens and three 30 s "
                   "renders each of configs 4 and 5",
        "k9": "the K9 band split and one-pole checks, the goldens and three 30 s renders "
              "each of the full-size occluded config 5 and of configs 4 and 5",
        "wire6": "the K4mu, K4a, K11 and K6m checks, the goldens, five 30 s render_mulaw "
                 "and render_adpcm of config 4 and five 30 s renders each of config 6 "
                 "modulated and not",
        "k11k4a": "the K4a (also at spb 32769), K11 (also at superblocks 1, 8, 33 "
                  "and 128) and K6m checks, the goldens, three 30 s render_adpcm of "
                  "config 4 (one more profiled) and three 30 s renders each of config 6 "
                  "modulated and not",
        "k4mu": "the K4mu checks (config 4's launch chunk and last chunk, a ragged T, "
                "mono, three channels and a misaligned base, each warm and cold) and three "
                "30 s render_mulaw of config 4 (one more profiled)",
        "k7": "the K7, K6 exact-row and K4a streamed-path checks, the goldens and three "
              "renders each of config4_pitched and config6_swept (30 s) and of the "
              "vibrato (64 superblocks)",
        "mod8b": "the deferred K8 and K10b checks, the goldens and five 30 s renders each "
                 "of config3_wah and config5_orbit",
        "item10": "the K12 and K13 checks, the goldens and five 30 s renders each of "
                  "config5_steplinear and config4_pingpong",
        "pipe": "the goldens and config 3 fused and unfused, five 30 s renders each, "
                "alternated, with a 100-step profile each",
        "hrtfpart": "the input pass, K10p-a and K10p-b checks (config5_measured's step "
                    "at P = 2 and 8, moving beside their library calls and still, K10p-a "
                    "warm and cold; S = 1 and 4 at P = 8, one voice, stereo, the occluded "
                    "route, P = 3, still and run directions), the goldens, five 30 s "
                    "renders each of config5_measured at P = 2 and P = 8 and three of "
                    "config 5",
        "k10pa": "K10p-a alone, warm and cold, at config5_measured's fourth step (moving "
                 "and still, P = 2 and 8) and five seeded cases, at each block length the "
                 "tree may pick (runs on the tree that first had K10p too)",
        "realtime": "the realtime phase: configs 4 and 5 at full width in a "
                    "RealtimeAudioContext at superblock 2, 64 steps bit for bit their unfused "
                    "offline renders and within 1e-5 of their CPU renders, then pipelined; K2a "
                    "at the step's shape; config 5 live for 10 s on the null output device, "
                    "twice, in a fresh process; "
                    "checkpoint resume of config 5 and of config 3 fused",
        "mesh": "phase 16: K14a and K14b against their plain versions at every rank's "
                "slice (part = 2 and 4) and summed against the unsliced MAC; config 4 and "
                "config5_part_hrir at full width on a 2x2 mesh of four ranks on the card, "
                "8 superblocks, equal across ranks and within 1e-5 of the single-card and CPU "
                "renders; ShardedVoiceScene against its numpy mirror",
        "examples": "phase 17: every twin of graphaudio_tpu_torch/examples on the card, "
                    "twice, held to its CPU run within 1e-5 (pcm16 bit for bit the plain pack "
                    "of the card's f32, the FLAC round trip lossless), and multichip_scene on "
                    "four ranks on the card, the ranks equal",
        "stream": "the K15 checks (whole calls: config5_streamed's two stream nodes over "
                  "351 steps, S = 1 and 64, mono, rates 0.5 and 3.0, a stream that runs "
                  "out), five 30 s renders each of config5_streamed and config 5, K15's "
                  "time in the render, the call's peak device memory and the feeds' "
                  "staging costs",
    }
    for mode, what in modes.items():
        ap.add_argument(f"--{mode}", dest="only", action="store_const", const=mode,
                        help=f"only the build, {what}, with their profiles (to alternate two "
                             "trees in one call)")
    ap.add_argument("--live-child", metavar="PATH",
                    help="only phase 15's two live runs of config 5, in this process, their "
                         "results written to PATH as JSON (phase 15 starts this in a fresh "
                         "process)")
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.live_child:
        sys.exit(live_child(args.live_child, args.device))
    sys.exit(main(only=args.only))
