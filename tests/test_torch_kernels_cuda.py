"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips
elsewhere; this file imports neither jax nor graphaudio_tpu, so it runs on
a machine without them:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda
"""

from collections import Counter

import numpy as np
import pytest
import torch

import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.core.context import pack_int16, pack_int16_plain
from graphaudio_tpu_torch.core.graph import PARAM_TABLE, to_device
from graphaudio_tpu_torch.core.mixing import fan_in_lanes, fan_in_lanes_plain
from graphaudio_tpu_torch.nodes import spatial as tsp
from graphaudio_tpu_torch.ops import biquad as tbq
from graphaudio_tpu_torch.ops import convolve as tconv
from graphaudio_tpu_torch.ops import hrtf as th
from graphaudio_tpu_torch.ops import onepole as top
from graphaudio_tpu_torch.ops import oscillator as tosc
from graphaudio_tpu_torch.ops import param_eval as tpe
from graphaudio_tpu_torch.ops import wire
from graphaudio_tpu_torch.testing import groups
from graphaudio_tpu_torch.testing import hrtf_part
from graphaudio_tpu_torch.testing import tables as ttab
from graphaudio_tpu_torch.testing.configs import (
    config2_mix_bus,
    config3_eq_chain,
    config4_conv_reverb,
    config4_pitched,
    config5_measured,
    config5_spatial_scene,
    config6_lfo_tremolo,
)
from graphaudio_tpu_torch.utils import cudabuild

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _int_view(t):
    return t.view({8: torch.int64, 4: torch.int32}[t.element_size()]) \
        if t.is_floating_point() else t


def _check_group_steps(ctx, steps):
    """The fused step of ctx's stage-0 source group (one launch) against
    its plain composition on the card, bit for bit, audio and every new
    state field, over ``steps`` steps; returns the audio's abs sum."""
    w, variant, _ = ctx._compiled._bufsrc_cfg[0]
    node = ctx._compiled.stages[0][1][0]
    c = ctx._consts
    heard = 0.0
    for st, rc in groups.group_inputs(ctx, steps):
        head = (st, c["st0/arena"], c["st0/geom"])
        if variant[0] == "poly":
            tail = (rc, w, variant[1], variant[2], (c["st0/poly_w"], c["st0/poly_b"]))
            got = type(node).process_poly_group(*head, c["st0/gtab"], *tail)
            want = type(node).poly_group_step_plain(*head, *tail)
            fields = ("x", "primed", "stop_time")
        else:
            tail = (rc, w, variant[1])
            got = type(node).process_unity_group(*head, c["st0/gtab"], *tail)
            want = type(node).unity_group_step_plain(*head, *tail)
            fields = ("pos", "stop_time")
        torch.cuda.synchronize()
        assert torch.equal(_int_view(got[1]), _int_view(want[1]))
        for f in fields:
            assert got[0][f].is_contiguous()
            assert torch.equal(_int_view(got[0][f]), _int_view(want[0][f])), f
        for f in st:
            if f not in fields:
                assert got[0][f] is st[f]
        heard += float(want[1].abs().sum())
    return heard


@pytest.mark.parametrize("case", ["config4 S=8 V=8", "edges S=4", "edges S=32", "edges S=64",
                                  "edges S=32 q=4800"])
def test_k1_poly_resample(dev, case):
    if case.startswith("config4"):
        ctx = config4_conv_reverb(superblock=8, voices=8, device=dev)
        ctx._ensure_compiled()
        steps = 12
    else:
        S = int(case.split()[1][2:])
        ctx = groups.poly_group(S, dev, buffer_rate=10 if "q=" in case else 44100)
        steps = 5
    assert _check_group_steps(ctx, steps) > 0
# (K, L, P, B, rev): the 128 grain, config 4's shape, config 5's reverb
# send, L = 1 at both grains, a ragged sub-block tile, two tiles; P = 97
# is not a multiple of the lags a group (tconv.mac_plan).
K2_SHAPES = [(2, 4, 750, 128, False), (2, 8, 94, 1024, True), (1, 4, 47, 1024, True),
             (2, 1, 750, 128, False), (2, 1, 94, 1024, True), (2, 3, 97, 128, False),
             (2, 10, 97, 512, True)]


@pytest.mark.parametrize("head", ["0", "7", "R-1"])
@pytest.mark.parametrize("K, L, P, B, rev", K2_SHAPES)
def test_k2_mac_and_overlap_add(dev, K, L, P, B, rev, head):
    g = torch.Generator().manual_seed(0)
    NB, R = B + 1, P - 1 + L
    head = R - 1 if head == "R-1" else int(head)
    X = torch.complex(torch.randn(K, L, NB, generator=g), torch.randn(K, L, NB, generator=g))
    hr = torch.randn(K, P, NB, generator=g)
    hi = torch.randn(K, P, NB, generator=g)
    ring_r = torch.randn(K, R, NB, generator=g)
    ring_i = torch.randn(K, R, NB, generator=g)
    X, hr, hi = X.to(dev), hr.to(dev), hi.to(dev)
    rr_ref, ri_ref = ring_r.to(dev), ring_i.to(dev)
    rr, ri = rr_ref.clone(), ri_ref.clone()
    rr2, ri2 = rr_ref.clone(), ri_ref.clone()
    ref = tconv.spectral_mac_plain(X, hr, hi, rr_ref, ri_ref, head, rev)
    got = tconv.spectral_mac(X, hr, hi, rr, ri, head, rev)
    again = tconv.spectral_mac(X, hr, hi, rr2, ri2, head, rev)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() < 1e-5 * max(1.0, ref.abs().max().item())
    assert torch.equal(rr, rr_ref) and torch.equal(ri, ri_ref)  # same ring writes
    assert torch.equal(got, again)  # fixed-order reduction: the same bits every run
    yf = torch.randn(K, L, 2 * B, generator=g).to(dev)
    ov = torch.randn(K, B, generator=g).to(dev)
    ov2 = ov.clone()
    y_ref = tconv.overlap_add_plain(yf, ov)
    y = tconv.overlap_add(yf, ov2)
    torch.cuda.synchronize()
    assert torch.equal(y, y_ref) and torch.equal(ov, ov2)


@pytest.mark.parametrize("K, L, B, true_stereo", [
    (1, 4, 1024, False), (2, 8, 1024, False), (2, 4, 128, False), (4, 1, 128, False),
    (4, 8, 1024, False), (4, 1, 128, True), (4, 8, 1024, True), (4, 32, 128, True)])
def test_k2b_overlap_add_combine(dev, K, L, B, true_stereo):
    """The one-pass overlap-add against its plain version, error 0, output
    and carried tails, with the true-stereo combine (K = 4) and without."""
    g = torch.Generator().manual_seed(K * 100 + L)
    yf = torch.randn(K, L, 2 * B, generator=g).to(dev)
    ov = torch.randn(K, B, generator=g).to(dev)
    ov2 = ov.clone()
    combine = ((0, 2), (1, 3)) if true_stereo else None
    cudabuild.launches.clear()
    y = tconv.overlap_add(yf, ov2, combine)
    assert cudabuild.launches["overlap_add"] == 1
    y_ref = tconv.overlap_add_plain(yf, ov, combine)
    torch.cuda.synchronize()
    assert y.shape == y_ref.shape == (2 if true_stereo else K, L * B)
    assert torch.equal(y.view(torch.int32), y_ref.view(torch.int32))
    assert torch.equal(ov.view(torch.int32), ov2.view(torch.int32))


def test_true_stereo_convolver_on_card(dev):
    """A 4-channel IR (true stereo) and a 4-channel discrete convolver on
    the card against the same graphs on the CPU, within 1e-5."""
    def scene(device, true_stereo):
        rng = np.random.default_rng(31)
        ctx = gat.OfflineAudioContext(sample_rate=48000, superblock=16, device=device)
        if not true_stereo:
            ctx.destination.set_channel_count(4)
            ctx.destination.inputs[0].set_channel_count_mode(gat.ChannelCountMode.EXPLICIT)
        xs = [(rng.standard_normal(8192) * 0.5).astype(np.float32) for _ in range(2)]
        irs = [(rng.standard_normal(3000) * np.exp(-np.arange(3000) / 900.0) * 0.3)
               .astype(np.float32) for _ in range(4)]
        src = gat.AudioBufferSourceNode(ctx)
        src.buffer = gat.PlayableAudioBuffer.from_channel_arrays(xs, 48000)
        src.loop = True
        conv = gat.ConvolverNode(ctx)
        conv.enable_true_stereo = true_stereo
        conv.buffer = gat.PlayableAudioBuffer.from_channel_arrays(irs, 48000)
        src.connect(conv).connect(ctx.destination)
        src.start(0)
        return ctx

    for true_stereo in (True, False):
        cudabuild.launches.clear()
        got = scene(dev, true_stereo).render(6 * 2048)
        assert cudabuild.launches["overlap_add"] == 6
        want = scene("cpu", true_stereo).render(6 * 2048)
        assert got.shape == want.shape == (2 if true_stereo else 4, 6 * 2048)
        assert np.abs(want).max() > 1e-3 and np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("T", [128, 4096, 8192])
@pytest.mark.parametrize("V", [1, 3, 64, 128, 130])
def test_k3_fan_in(dev, V, T):
    g = torch.Generator().manual_seed(2)
    # modes 1 (mono up-mix), 0, 2 (down-mix), 3 (discrete, both ways)
    for src_c, dst_c in [(1, 2), (2, 2), (2, 1), (4, 2), (2, 4)]:
        lanes = torch.randn(V, src_c, T, generator=g).to(dev)
        got = fan_in_lanes(lanes, dst_c)
        ref = fan_in_lanes_plain(lanes, dst_c)
        torch.cuda.synchronize()
        # 64-term f32 sums in another order: a few ulps of the largest sum
        assert (got - ref).abs().max().item() < 4e-6 * max(1.0, ref.abs().max().item())


def test_k4_pack_int16(dev):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 10000, generator=g) * 0.8
    x[0, :4] = torch.tensor([0.5 / 32767, -0.5 / 32767, 1.5, -7.0])
    x = x.to(dev)
    assert torch.equal(pack_int16(x), pack_int16_plain(x))


def test_config4_golden_on_card(dev):
    out = config4_conv_reverb(superblock=4, device=dev).render(8192)
    golden = np.load("tests/goldens/config4_conv_reverb_64.npz")["out"]
    assert np.abs(out.astype(np.float64) - golden).max() < 1e-5


@pytest.mark.parametrize("case", ["config2 S=8", "config3 S=32", "aligned S=4",
                                  "aligned S=32", "aligned S=64", "unaligned S=4",
                                  "unaligned S=32", "unaligned S=64"])
def test_k5_unity_gather(dev, case):
    label, sb = case.split()
    S = int(sb[2:])
    if label.startswith("config"):
        ctx = (config2_mix_bus if label == "config2" else config3_eq_chain)(superblock=S,
                                                                           device=dev)
        ctx._ensure_compiled()
        steps = 30 if label == "config2" else 12
    else:
        ctx = groups.unity_group(S, label == "aligned", dev)
        steps = 5
    assert _check_group_steps(ctx, steps) > 0


def _step_kernels(call, windows=5):
    """Names of the CUDA kernels of one ``call()`` under torch.profiler, per
    window: a window now and then loses a ctypes launch's event, so the
    caller reads several."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    seen = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        seen.append([e.name for e in prof.events()
                     if str(e.device_type).endswith("CUDA")])
    return seen


@pytest.mark.parametrize("config", [4, 3])
def test_group_step_is_one_launch(dev, config):
    """One process_poly_group (config 4: V=64, S=64) or process_unity_group
    (config 3: V=1, C=2, S=32) call runs exactly one CUDA kernel, the fused
    step, and no other."""
    if config == 4:
        ctx = config4_conv_reverb(superblock=64, voices=64, device=dev)
        ctx._ensure_compiled()
        name = "poly_step_kernel"
    else:
        ctx = config3_eq_chain(superblock=32, device=dev)
        ctx._ensure_compiled()
        name = "unity_step_kernel"
    w, variant, _ = ctx._compiled._bufsrc_cfg[0]
    node = ctx._compiled.stages[0][1][0]
    c = ctx._consts
    st, rc = next(groups.group_inputs(ctx, 1))
    if variant[0] == "poly":
        def call():
            return type(node).process_poly_group(
                st, c["st0/arena"], c["st0/geom"], c["st0/gtab"], rc, w, variant[1],
                variant[2], (c["st0/poly_w"], c["st0/poly_b"]))
    else:
        def call():
            return type(node).process_unity_group(st, c["st0/arena"], c["st0/geom"],
                                                  c["st0/gtab"], rc, w, aligned=variant[1])
    cudabuild.launches.clear()
    seen = _step_kernels(call)
    assert cudabuild.launches["poly_group_step" if config == 4 else "unity_group_step"] == 6
    assert all(len(k) <= 1 for k in seen), seen
    assert any(len(k) == 1 and name in k[0] for k in seen), seen


def test_group_step_checks_the_table(dev):
    """The fused unity step raises (and launches nothing) when the packed
    geometry table is not a contiguous f64[V + 1, GEOM_COLS] on the card."""
    ctx = config3_eq_chain(superblock=32, device=dev)
    ctx._ensure_compiled()
    w, variant, _ = ctx._compiled._bufsrc_cfg[0]
    node = ctx._compiled.stages[0][1][0]
    c = ctx._consts
    st, rc = next(groups.group_inputs(ctx, 1))
    gtab = c["st0/gtab"]
    cudabuild.launches.clear()
    for bad in (gtab.cpu(), gtab.float(), gtab[1:], gtab.t().contiguous().t()):
        with pytest.raises(ValueError):
            type(node).process_unity_group(st, c["st0/arena"], c["st0/geom"], bad, rc, w,
                                           aligned=variant[1])
    assert cudabuild.launches["unity_group_step"] == 0


def _param_encoding(dev, lanes=3, cap=16, seed=6):
    """Random automation of every curve type, some events exactly on
    block and sample instants, padded to ``cap``."""
    rng = np.random.default_rng(seed)
    encs = []
    for lane in range(lanes):
        t, events = 0.0, []
        for k in range(cap - 2 * lane):
            t += float(rng.choice([128 / 48000, 1 / 48000, rng.uniform(0.0005, 0.02)]))
            kind = int(rng.integers(0, 4))
            events.append((kind, t, float(rng.uniform(0.05, 2.0)), float(rng.uniform(0.001, 0.01))))
        encs.append(tpe.encode_events(0.5, events, cap))
    return {k: torch.from_numpy(np.stack([e[k] for e in encs])).to(dev) for k in encs[0]}


@pytest.mark.parametrize("npb", [128, 1])
def test_k6_param_eval(dev, npb):
    enc = _param_encoding(dev)
    for b0 in range(0, 60, 4):
        bt = torch.from_numpy(np.arange(b0, b0 + 32) * (128 / 48000)).to(dev)
        got = tpe.eval_intrinsic_blocked(enc, bt, npb, 1 / 48000)
        ref = tpe.eval_intrinsic_blocked_plain(enc, bt, npb, 1 / 48000)
        torch.cuda.synchronize()
        # Same operations and roundings; exp/pow are f64 on both sides.
        assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("ftype", tbq.FILTER_TYPES)
def test_k8_biquad_coefficients(dev, ftype):
    g = torch.Generator().manual_seed(7)
    V, T = 2, 4096
    freq = (torch.rand(V, T, generator=g) * 30000.0 - 100.0).to(dev)  # clamps too
    q = (torch.rand(V, T, generator=g) * 8.0).to(dev)
    gain = (torch.rand(V, T // 128, generator=g) * 24.0 - 12.0).to(dev)
    got = tbq.biquad_coefficients(ftype, freq, q, gain, 48000)
    ref = tbq.biquad_coefficients_plain(ftype, freq, q, gain, 48000)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        # glibc's sin/cos and f64 pow rounded once on both sides: equal up to an ulp
        assert (a - b).abs().max().item() <= 1e-6 * max(1.0, b.abs().max().item())
    assert (got[3].imag >= 0).all()  # Im(p1) >= 0


@pytest.mark.parametrize("step", [0, 5, 11])
def test_k6_batch(dev, step):
    """The batched kernel over a mixed table (capacities 1-32 padded to 32,
    a-rate and k-rate rows, phantom lanes), bit for bit."""
    S = 32
    table = to_device(tpe.pack_param_table(ttab.mixed_param_entries(0, 12 * S * ttab.BLOCK), S),
                      dev)
    bt = torch.from_numpy(ttab.block_clock(12 * S)[step * S:(step + 1) * S]).to(dev)
    cudabuild.launches.clear()
    got = tpe.eval_intrinsic_batch(table, bt, ttab.DT)
    assert cudabuild.launches["eval_intrinsic_batch"] == 1
    want = tpe.eval_intrinsic_batch_plain(table, bt, ttab.DT)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("step", [0, 5])
def test_k6_batch_row_clocks(dev, step):
    """Each row at its own clock (rows 3, 2, 1, 0, ... of a [4, S] clock
    matrix, a view of a longer clock array as a render passes it), exact
    rows included, bit for bit the plain version."""
    S = 32
    entries = [(key, enc, npb, k % 3 == 2,
                (3 - k - np.arange(int(np.prod(np.shape(enc["base"]), dtype=np.int64)))) % 4)
               for k, (key, enc, npb) in enumerate(ttab.mixed_param_entries(
                   5, 12 * S * ttab.BLOCK) + ttab.linear_param_entries(6, 12 * S * ttab.BLOCK))]
    table = to_device(tpe.pack_param_table(entries, S), dev)
    ring = torch.from_numpy(ttab.block_clock(12 * S).reshape(12, S)).to(dev)
    clocks = ring[step:step + 4]
    cudabuild.launches.clear()
    got = tpe.eval_intrinsic_batch(table, clocks, ttab.DT)
    assert cudabuild.launches["eval_intrinsic_batch"] == 1
    want = tpe.eval_intrinsic_batch_plain(table, clocks, ttab.DT)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("step", [0, 7])
def test_k8_batch_eight_types(dev, step):
    """The batched kernel over one stage of each type, sources from a-rate
    and k-rate K6 rows and constants, bit for bit."""
    S = 32
    table, stages = ttab.eight_type_stages(3, S, 8 * S * ttab.BLOCK)
    table = to_device(table, dev)
    bt = torch.from_numpy(ttab.block_clock(8 * S)[step * S:(step + 1) * S]).to(dev)
    arena = tpe.eval_intrinsic_batch(table, bt, ttab.DT)
    ktable = to_device(tbq.pack_coefficient_table(stages, S), dev)
    cudabuild.launches.clear()
    got = tbq.biquad_coefficients_batch(ktable, arena, 48000)
    assert cudabuild.launches["biquad_coefficients_batch"] == 1
    want = tbq.biquad_coefficients_batch_plain(ktable, arena, 48000)
    torch.cuda.synchronize()
    for g_stage, w_stage in zip(got, want):
        for a, b in zip(g_stage, w_stage):
            assert a.is_contiguous() and torch.equal(a, b)


def test_config3_one_k6_and_one_k8_launch_a_step(dev):
    """A step of a render call (its 10 and the pipe's 3 drain rows) makes
    one K6 and one K8 launch."""
    ctx = config3_eq_chain(superblock=32, device=dev)
    ctx.render(32 * 128)
    cudabuild.launches.clear()
    out = ctx.render(10 * 32 * 128)
    assert ctx._compiled.pipe_delay == 3
    assert cudabuild.launches["eval_intrinsic_batch"] == 10 + 3
    assert cudabuild.launches["biquad_coefficients_batch"] == 10 + 3
    assert tuple(ctx._encs[PARAM_TABLE]["times"].shape) == (8, 32)
    want = config3_eq_chain(superblock=32, device="cpu").render(11 * 32 * 128)[:, 32 * 128:]
    assert np.abs(out - want).max() < 1e-5


def test_config3_fused_is_one_p2_launch_a_step(dev):
    """Config 3's four biquads as one pipe: one P2 launch a row over the
    four lanes, the audio bit for bit the unfused render's on the card."""
    frames = 10 * 32 * 128
    unfused = config3_eq_chain(superblock=32, device=dev)
    unfused.pipeline_chains = False
    want = np.concatenate([unfused.render(3000), unfused.render(frames - 3000)], axis=1)
    ctx = config3_eq_chain(superblock=32, device=dev)
    cudabuild.launches.clear()
    got = np.concatenate([ctx.render(3000), ctx.render(frames - 3000)], axis=1)
    # 1 + 9 steps in two calls, each with three drain rows
    assert cudabuild.launches["biquad_apply"] == 10 + 2 * 3
    assert unfused._compiled.pipe_delay == 0 and ctx._compiled.pipe_delay == 3
    np.testing.assert_array_equal(got, want)


def _biquad_inputs(dev, V, C, T, seed):
    g = torch.Generator().manual_seed(seed)
    n = torch.arange(T, dtype=torch.float32)
    freq = (300.0 + 2000.0 * torch.rand(V, 1, generator=g)) * (1.0 + n / T)
    q = 0.5 + 4.0 * torch.rand(V, 1, generator=g) + n / T
    gain = torch.full((V, T // 128), 3.0)
    coeffs = tbq.biquad_coefficients_plain("peaking", freq, q, gain, 48000)
    x = torch.randn(V, C, T, generator=g) * 0.3
    w1 = torch.randn(V, C, generator=g) * 0.1
    w2 = torch.randn(V, C, generator=g) * 0.1
    return [t.to(dev) for t in (x, *coeffs, w1, w2)]


@pytest.mark.parametrize("tv", [False, True])
@pytest.mark.parametrize("T", [128, 512, 4096, 8192])
@pytest.mark.parametrize("V, C", [(1, 1), (1, 2), (3, 2), (8, 2)])
def test_p2_biquad_cascade(dev, tv, T, V, C):
    """Sizes inside one 4096-sample tile of the scan, and two tiles."""
    args = _biquad_inputs(dev, V, C, T, seed=8)
    if not tv:  # constant poles and coefficients
        args = [args[0]] + [a[:, :1].expand_as(a).contiguous() for a in args[1:6]] + args[6:]
    got = tbq.biquad_apply(*args, time_varying=tv)
    ref = tbq.biquad_apply_plain(*args, time_varying=tv)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        # f64 recurrences on both sides (chunked scan vs prefix), rounded to f32
        assert (a - b).abs().max().item() <= 1e-6 * max(1.0, b.abs().max().item())


def test_p2_probe_form(dev):
    g = torch.Generator().manual_seed(9)
    xr, xi = (torch.randn(128, 128, generator=g).to(dev) for _ in range(2))
    mag = 0.5 + 0.49 * torch.rand(1, 128, generator=g)
    ph = torch.rand(1, 128, generator=g) * 6.0
    ar, ai = (mag * torch.cos(ph)).to(dev), (mag * torch.sin(ph)).to(dev)
    got = tbq.first_order_tb(xr, xi, ar, ai)
    ref = tbq.first_order_tb_plain(xr, xi, ar, ai)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())


def _mono_voices_into_filters(device, voices=4):
    """Looped mono buffers, each into its own lowpass: the filter group's
    inputs resolve to stereo, so every voice is up-mixed."""
    rng = np.random.default_rng(13)
    ctx = gat.OfflineAudioContext(sample_rate=48000, superblock=8, device=device)
    for v in range(voices):
        src = gat.AudioBufferSourceNode(ctx)
        sig = (rng.standard_normal(4800) * 0.3).astype(np.float32)
        src.buffer = gat.PlayableAudioBuffer.from_mono_array(sig, 48000)
        src.loop = True
        flt = gat.BiQuadFilterNode(ctx, type=gat.FilterType.LOWPASS)
        flt.frequency.value = 400.0 + 700.0 * v
        src.connect(flt).connect(ctx.destination)
        src.start(0)
    return ctx


def test_mono_voices_into_filters_on_card(dev):
    """The up-mixed [V, 2, T] input reaches the cascade kernel, which takes
    no strides, as one contiguous tensor; the render matches the CPU's."""
    ctx = _mono_voices_into_filters(dev)
    cudabuild.launches.clear()
    got = ctx.render(4096)
    assert cudabuild.launches["biquad_apply"] > 0
    want = _mono_voices_into_filters("cpu").render(4096)
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < 1e-5 * max(1.0, np.abs(want).max())


def test_config3_golden_on_card(dev):
    out = config3_eq_chain(superblock=4, device=dev).render(8192)
    golden = np.load("tests/goldens/config3_biquad_eq_chain.npz")["out"]
    assert np.abs(out.astype(np.float64) - golden).max() < 1e-5


def test_config2_golden_on_card(dev):
    out = config2_mix_bus(superblock=4, device=dev).render(8192)
    golden = np.load("tests/goldens/config2_mix_bus_ramps.npz")["out"]
    assert np.abs(out.astype(np.float64) - golden).max() < 1e-5


@pytest.mark.parametrize("S", [1, 32])
@pytest.mark.parametrize("with_gain", [True, False])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("L", [1, 37, 64, 128])
def test_p1_hrtf_fir(dev, L, C, with_gain, S):
    """Bit for bit against the plain version: L = 37 is ragged against the
    tile of 8 outputs, L = 1 has no ramp, S = 1 makes the first and the last
    quantum one block."""
    g = torch.Generator().manual_seed(10)
    V = 8
    W = th.hrtf_fft_size(L) - 128
    grid = th.build_hrir_grid(48000) if L == 64 else (
        np.random.default_rng(10).standard_normal((7, 12, 2, L)).astype(np.float32) * 0.2)
    t = torch.linspace(0.0, 1.0, S)
    az = (0.3 + 5.0 * t)[None] * torch.linspace(-1.5, 1.5, V)[:, None]
    el = (-1.4 + 2.8 * t)[None] * torch.linspace(0.2, 1.0, V)[:, None]
    args = [torch.randn(V, C, S * 128, generator=g) * 0.1,
            torch.rand(V, S, generator=g) if with_gain else None, az, el,
            torch.rand(V, S, generator=g), torch.from_numpy(grid),
            torch.randn(V, 2, W, generator=g) * 0.01]
    args = [a.to(dev) if a is not None else None for a in args]
    got = th.hrtf_fir(*args)
    ref = th.hrtf_fir_plain(*args)
    torch.cuda.synchronize()
    # the same f32 operations in the same order (__f*_rn in the kernel),
    # each output's taps in ascending order in its own accumulator
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_p1_probe_rows(dev):
    g = torch.Generator().manual_seed(11)
    R, F, L = 512, 128, 64
    x = torch.randn(R, F + L - 1, generator=g).to(dev)
    h = (torch.randn(R, 2 * L, generator=g) * 0.2).to(dev)
    got = th.hrtf_fir_rows(x, h)
    ref = th.hrtf_fir_rows_plain(x, h)
    lib = torch.nn.functional.conv1d(x[None], h.reshape(R, 2, L).flip(-1).reshape(2 * R, 1, L),
                                     groups=R).reshape(R, 2 * F)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-6
    assert (got - lib).abs().max().item() <= 1e-5 * lib.abs().max().item()


@pytest.mark.parametrize("model", list(tsp.DistanceModelType))
def test_k10b_spatial_gains(dev, model):
    g = torch.Generator().manual_seed(12)
    V, S = 16, 32
    p = torch.empty(17, V, S)
    p[:3] = torch.randn(3, V, S, generator=g) * 4.0
    p[0, 3, ::2], p[1, 3, ::2], p[2, 3, ::2] = 0.5, 0.1, -0.3  # at the listener: near
    p[3:6] = torch.randn(3, V, S, generator=g)
    p[6], p[7], p[8] = 1.0, 10000.0, 1.0
    p[6, :4], p[7, :4], p[8, :4] = 2.0, 5.0, 1.5
    p[9], p[10], p[11] = 360.0, 360.0, 0.0
    p[9, 4:8], p[10, 4:8], p[11, 4:8] = 60.0, 120.0, 0.3
    p[12] = torch.rand(V, S, generator=g)
    p[13] = 0.0
    p[13, 8:12] = torch.rand(4, S, generator=g)
    p[14:17] = 0.0
    p[14:17, 10:12] = torch.rand(3, 2, S, generator=g)
    listener = {"listener_pos": torch.tensor([0.5, 0.1, -0.3]),
                "listener_right": torch.tensor([0.8, 0.0, 0.6]),
                "listener_up": torch.tensor([0.0, 1.0, 0.0]),
                "listener_ahead": torch.tensor([-0.6, 0.0, 0.8])}
    p = p.to(dev)
    listener = {k: v.to(dev) for k, v in listener.items()}
    got = tsp.spatial_gains(p, listener, model)
    ref = tsp.spatial_gains_plain(p, listener, model)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("models", [(1, 2), (0, 1)])
@pytest.mark.parametrize("step", [0, 3, 5])
def test_k10b_batch(dev, step, models):
    """The batched K10b over two stages (a-rate, k-rate and constant
    sources, two distance models, one stage occluded) against its plain
    version, bit for bit, and against the one-entry ``spatial_gains`` on
    each stage's stacked params."""
    S = 8
    k6, stages = ttab.panner_stages(4, S, 6 * S * ttab.BLOCK, models)
    k6 = to_device(k6, dev)
    bt = torch.from_numpy(ttab.block_clock(6 * S)[step * S:(step + 1) * S]).to(dev)
    arena = tpe.eval_intrinsic_batch(k6, bt, ttab.DT)
    table = to_device(tsp.pack_gains_table(stages, S), dev)
    listener = {"listener_pos": torch.tensor([0.5, 0.1, -0.3]),
                "listener_right": torch.tensor([0.8, 0.0, 0.6]),
                "listener_up": torch.tensor([0.0, 1.0, 0.0]),
                "listener_ahead": torch.tensor([-0.6, 0.0, 0.8])}
    listener = {k: v.to(dev) for k, v in listener.items()}
    cudabuild.launches.clear()
    got = tsp.spatial_gains_batch(table, arena, listener)
    assert cudabuild.launches["spatial_gains_batch"] == 1
    want = tsp.spatial_gains_batch_plain(table, arena, listener)
    torch.cuda.synchronize()
    for out, ref, (_, V, code, words) in zip(got, want, table["stages"]):
        assert out.is_contiguous() and torch.equal(out.view(torch.int32), ref.view(torch.int32))
        p = tsp._stage_sources(words, V, S, arena, table["consts"]).contiguous()
        model = {0: tsp.DistanceModelType.LINEAR, 1: tsp.DistanceModelType.INVERSE,
                 2: tsp.DistanceModelType.EXPONENTIAL}[code]
        assert torch.equal(tsp.spatial_gains(p, listener, model), out)


def test_config5_one_k2b_and_one_k10b_launch_a_step(dev):
    """Config 5 (128 voices, superblock 32): K2b and K10b launch once a
    step each, the one-entry K10b never; the render is finite and heard."""
    ctx = config5_spatial_scene(superblock=32, device=dev)
    ctx.render(32 * 128)
    cudabuild.launches.clear()
    out = ctx.render(10 * 32 * 128)
    assert cudabuild.launches["overlap_add"] == 10
    assert cudabuild.launches["spatial_gains_batch"] == 10
    assert cudabuild.launches["spatial_gains"] == 0
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3


@pytest.mark.parametrize("hz", [800.0, 8000.0])
def test_k9_onepole(dev, hz):
    g = torch.Generator().manual_seed(13)
    a = float(np.exp(-2.0 * np.pi * hz / 48000))
    x = (torch.randn(8, 2, 32 * 128, generator=g) * 0.3).to(dev)
    y0 = (torch.randn(8, 2, generator=g) * 0.1).to(dev)
    got = top.onepole_lowpass(x, a, y0)
    ref = top.onepole_lowpass_plain(x, a, y0)
    torch.cuda.synchronize()
    for a_, b_ in zip(got, ref):
        # f64 recurrence vs f32 decay matmuls
        assert (a_ - b_).abs().max().item() <= 1e-6 * max(1.0, b_.abs().max().item())


_XOVERS = tuple(float(np.exp(-2.0 * np.pi * hz / 48000)) for hz in (800.0, 8000.0))


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("S", [1, 4, 32, 64])
def test_k9_band_split(dev, S, C):
    """The band split (one launch: both crossovers and the combine) against
    its plain version within 1e-6 x max, and its direct signal bit for bit
    the plain combine of the one-pole mode's bands."""
    g = torch.Generator().manual_seed(17 + S + C)
    V = 8
    x = (torch.randn(V, C, S * 128, generator=g) * 0.3).to(dev)
    y0l, y0h = ((torch.randn(V, C, generator=g) * 0.1).to(dev) for _ in range(2))
    gains = [torch.rand(V, S, generator=g).to(dev) for _ in range(3)]
    al, ah = _XOVERS
    cudabuild.launches.clear()
    got = top.band_split(x, al, ah, y0l, y0h, *gains)
    assert cudabuild.launches["band_split"] == 1
    assert cudabuild.launches["onepole_lowpass"] == 0
    ref = top.band_split_plain(x, al, ah, y0l, y0h, *gains)
    (low, xlow), (lowmid, xhigh) = (top.onepole_lowpass(x, al, y0l),
                                    top.onepole_lowpass(x, ah, y0h))
    torch.cuda.synchronize()
    for a_, b_ in zip(got, ref):
        assert (a_ - b_).abs().max().item() <= 1e-6 * max(1.0, b_.abs().max().item())
    combined = top.band_combine_plain(x, low, lowmid, *gains)
    assert torch.equal(got[0].view(torch.int32), combined.view(torch.int32))
    assert torch.equal(got[1], xlow) and torch.equal(got[2], xhigh)


def test_occluded_render_one_band_split_a_step(dev):
    """A small occluded Kit scene (8 voices, every one occluded with
    transmission, superblock 8): the panners' band split launches once a
    step, the one-pole mode never; the render matches the CPU's within
    1e-5."""

    def scene(device):
        ctx = config5_spatial_scene(superblock=8, voices=8, device=device)
        for snd in ctx._sounds:
            snd.occlusion = 0.5
            snd.set_transmission(0.8, 0.4, 0.1)
        return ctx

    ctx = scene(dev)
    head = ctx.render(8 * 128)
    cudabuild.launches.clear()
    out = ctx.render(4 * 8 * 128)
    assert cudabuild.launches["band_split"] == 4
    assert cudabuild.launches["onepole_lowpass"] == 0
    want = scene("cpu").render(5 * 8 * 128)
    got = np.concatenate([head, out], axis=1)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got.astype(np.float64) - want).max() < 1e-5


def test_config5_golden_on_card(dev):
    out = config5_spatial_scene(superblock=4, device=dev).render(8192)
    golden = np.load("tests/goldens/config5_spatial_scene_128.npz")["out"]
    assert np.abs(out.astype(np.float64) - golden).max() < 1e-5


# ---- K4mu, K4a: the wire formats -------------------------------------------------------


def _mulaw_pool():
    """The mu-law cases' samples: the quantizer's rounding ties, clipping,
    0 and +-inf first, then every int16 level q / 32767 shuffled, then
    noise."""
    rng = np.random.default_rng(13)
    edges = np.array([0.5 / 32767, -0.5 / 32767, 1.5 / 32767, 1.5, -7.0, 0.0, np.inf, -np.inf],
                     np.float32)
    levels = np.arange(-32767, 32768, dtype=np.float32) / np.float32(32767)
    noise = (rng.standard_normal(200000) * 0.6).astype(np.float32)
    return np.concatenate([edges, rng.permutation(levels), noise])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("T", [1, 3, 7, 8, 127, 10000, 10003, 32772])
@pytest.mark.parametrize("C", [1, 2, 3, 6])
def test_k4mu_pack_mulaw(dev, C, T, offset):
    """Every instantiation of K4mu (C = 1, 2 and any C; vector loads, and
    scalar ones for a base ``offset`` floats off or T % 4 != 0), every tail
    length T mod V: bit for bit the plain version and the host encoder,
    one launch. T = 32772 at C >= 2 holds every int16 level."""
    buf = torch.from_numpy(_mulaw_pool()[:offset + C * T]).to(dev)
    x = buf[offset:offset + C * T].view(C, T)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    before = cudabuild.launches["pack_mulaw"]
    got = wire.pack_mulaw(x)
    torch.cuda.synchronize()
    assert cudabuild.launches["pack_mulaw"] == before + 1
    assert torch.equal(got, wire.pack_mulaw_plain(x))
    np.testing.assert_array_equal(got.cpu().numpy(), wire.mulaw_encode_np(x.cpu().numpy()))


@pytest.mark.parametrize("spb", [9, 89, 505])
@pytest.mark.parametrize("C", [1, 2])
def test_k4a_ima_chunk_encode(dev, C, spb):
    rng = np.random.default_rng(C * 100 + spb)
    for F in (5, 40, 3 * spb + 17, 8192):
        for carry_len in sorted({0, 1, spb - 1}):
            audio = torch.from_numpy((rng.standard_normal((C, F)) * 0.4).astype(np.float32))
            carry = torch.from_numpy(rng.integers(-30000, 30000, (C, spb - 1)).astype(np.int16))
            got = wire.ima_chunk_encode(audio.to(dev), carry.to(dev), carry_len)
            want = wire.ima_chunk_encode_plain(audio.to(dev), carry.to(dev), carry_len)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (F, carry_len)


@pytest.mark.parametrize("spb, C, F, offset, carry_lens", [
    (32769, 1, 70000, 1, (0, 3, 32768)),
    (505, 2, 524289, 0, (0, 1, 2, 3, 5, 252, 504)),
    (505, 2, 524289, 3, (1, 2, 3, 504)),
    (89, 2, 4099, 1, (0, 1, 2, 3, 44, 88)),
    (89, 2, 4099, 2, (1, 3, 88))])
def test_k4a_long_blocks_and_misaligned_chunks(dev, spb, C, F, offset, carry_lens):
    """spb 32769 (a stage over 48 KB of shared memory), and chunks whose
    rows start off 16-byte boundaries: odd F, an audio view ``offset``
    floats into its storage, carry_len values that shift every slot. The
    plain version runs on the CPU (its spb-1 sequential torch steps take
    seconds on the card at spb 32769)."""
    rng = np.random.default_rng(spb + offset)
    base = torch.from_numpy((rng.standard_normal(C * F + offset) * 0.5).astype(np.float32))
    audio = base.to(dev)[offset:].view(C, F)
    for carry_len in carry_lens:
        carry = torch.from_numpy(rng.integers(-32768, 32768, (C, spb - 1)).astype(np.int16))
        got = wire.ima_chunk_encode(audio, carry.to(dev), carry_len)
        want = wire.ima_chunk_encode_plain(base[offset:].view(C, F), carry, carry_len)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]), \
            carry_len


def test_k4a_stream_matches_host(dev):
    """Chunks of a config-4 launch's size and ragged ones, threaded by
    ImaDeviceStream on the card, equal one host pass."""
    spb = 505
    x = (np.random.default_rng(5).standard_normal((2, 3 * 8192 + 1000)) * 0.3).astype(np.float32)
    stream = wire.ImaDeviceStream(2, spb)
    parts, off = [], 0
    for size in (8192, 777, 8192, 8192 + 1000 - 777):
        blocks, nblk = stream.encode_chunk(torch.from_numpy(x[:, off:off + size]).to(dev))
        parts.append(blocks[:nblk].cpu().numpy())
        off += size
    lead = stream.pull_carry()
    q = wire.quantize_i16(x)
    whole = (q.shape[1] // spb) * spb
    np.testing.assert_array_equal(np.concatenate(parts), wire.ima_encode_np(q[:, :whole], spb))
    np.testing.assert_array_equal(lead, q[:, whole:])


def test_packed_renders_on_card(dev):
    """render_mulaw / render_adpcm of config 4 (16 voices, superblock 4)
    equal the host encoders of the card's own f32 render, bit for bit."""
    frames = 6 * 512 + 300
    f32 = config4_conv_reverb(superblock=4, voices=16, device=dev).render(frames)
    mu = config4_conv_reverb(superblock=4, voices=16, device=dev).render_mulaw(frames)
    np.testing.assert_array_equal(mu, wire.mulaw_encode_np(f32))
    stream = config4_conv_reverb(superblock=4, voices=16, device=dev).render_adpcm(frames)
    q = wire.quantize_i16(f32)
    q = np.concatenate([q, np.zeros((2, (-frames) % 505), np.int16)], axis=1)
    np.testing.assert_array_equal(stream.blocks, wire.ima_encode_np(q, 505))


# ---- K11, K6m: the sources and the modulation ----------------------------------------------


def _source_states(L, S, seed):
    """L lanes: started or not, starts and stops inside quanta, some never."""
    rng = np.random.default_rng(seed)
    dt = 128 / 48000
    start = rng.uniform(0.0, S * dt * 0.6, L)
    stop = np.where(rng.random(L) < 0.5, start + rng.uniform(0.0, S * dt, L), np.inf)
    started = (rng.random(L) < 0.85).astype(np.int32)
    phase = rng.uniform(0.0, 2 * np.pi, L)
    return [torch.from_numpy(a) for a in (started, start, stop, phase)]


@pytest.mark.parametrize("per_sample", [False, True], ids=["base values", "rows"])
@pytest.mark.parametrize("S", [4, 32, 33, 64])
@pytest.mark.parametrize("wave", list(tosc.WAVE_CODES))
def test_k11_oscillator(dev, wave, S, per_sample):
    L, T = 64, S * 128
    started, start, stop, phase = (t.to(dev) for t in _source_states(L, S, S))
    bt = torch.from_numpy((7 + np.arange(S)) * (128 / 48000)).to(dev)
    g = torch.Generator().manual_seed(S)
    if per_sample:
        f = (torch.rand(L, T, generator=g) * 20000.0).to(dev)
    else:
        f = (torch.rand(L, generator=g) * 20000.0).to(dev)[:, None].expand(L, T)
    got = tosc.oscillator_group_step(f, started, start, stop, phase, bt, 48000, wave)
    want = tosc.oscillator_group_step_plain(f, started, start, stop, phase, bt, 48000, wave)
    torch.cuda.synchronize()
    assert (got[0] - want[0]).abs().max().item() <= 1e-6
    assert torch.equal(got[1], want[1])
    assert want[0].abs().max().item() > 0.5


@pytest.mark.parametrize("per_sample", [False, True], ids=["base values", "rows"])
@pytest.mark.parametrize("S", [1, 8, 128])
@pytest.mark.parametrize("wave", list(tosc.WAVE_CODES))
def test_k11_oscillator_tile_edges(dev, wave, S, per_sample):
    """Superblocks of one quantum, one tile and sixteen tiles (the last
    block sums four passes of quanta before its tile), with starts and
    stops on tile and quantum edges and inside quanta."""
    L, T = 48, S * 128
    dt = 128 / 48000
    t0 = 5 * dt
    bt = torch.from_numpy(t0 + np.arange(S) * dt).to(dev)
    edges = [0, 1, 7, 8, 9, 16, 63, 64, 65, 120, S - 1, S]
    start = np.array([t0 + dt * min(edges[i % len(edges)], S) + (0.3 * dt if i % 3 == 1 else 0)
                      for i in range(L)])
    stop = np.array([np.inf if i % 4 == 0 else
                     start[i] + dt * edges[(i * 5) % len(edges)] + (0.55 * dt if i % 3 == 2 else 0)
                     for i in range(L)])
    started = torch.from_numpy((np.arange(L) % 7 != 3).astype(np.int32)).to(dev)
    phase = torch.from_numpy(np.random.default_rng(S).uniform(0, 2 * np.pi, L)).to(dev)
    g = torch.Generator().manual_seed(S + 1)
    if per_sample:
        f = (torch.rand(L, T, generator=g) * 20000.0).to(dev)
    else:
        f = (torch.rand(L, generator=g) * 20000.0).to(dev)[:, None].expand(L, T)
    args = (f, started, torch.from_numpy(start).to(dev), torch.from_numpy(stop).to(dev), phase,
            bt, 48000, wave)
    got = tosc.oscillator_group_step(*args)
    want = tosc.oscillator_group_step_plain(*args)
    torch.cuda.synchronize()
    assert (got[0] - want[0]).abs().max().item() <= 1e-6
    if wave in ("sine", "square"):
        assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("per_sample", [False, True], ids=["base values", "rows"])
def test_k11_constant(dev, per_sample):
    L, S = 64, 32
    T = S * 128
    started, start, stop, _ = (t.to(dev) for t in _source_states(L, S, 3))
    bt = torch.from_numpy((3 + np.arange(S)) * (128 / 48000)).to(dev)
    g = torch.Generator().manual_seed(4)
    off = torch.randn(L, T, generator=g).to(dev) if per_sample else \
        torch.randn(L, generator=g).to(dev)[:, None].expand(L, T)
    got = tosc.constant_group_step(off, started, start, stop, bt, 48000)
    want = tosc.constant_group_step_plain(off, started, start, stop, bt, 48000)
    assert torch.equal(got, want)


@pytest.mark.parametrize("base_view", [False, True])
@pytest.mark.parametrize("a_rate", [True, False], ids=["a-rate", "k-rate"])
@pytest.mark.parametrize("Cm", [1, 2])
def test_k6m_apply_modulation(dev, Cm, a_rate, base_view):
    V, S = 64, 32
    T = S * 128
    L = T if a_rate else S
    g = torch.Generator().manual_seed(Cm)
    mod = torch.randn(V, Cm, T, generator=g).to(dev)
    intr = (torch.randn(V, generator=g).to(dev)[:, None].expand(V, L) if base_view
            else torch.randn(V, L, generator=g).to(dev))
    got = tpe.apply_modulation(intr, mod, -0.75, 1.5, a_rate)
    want = tpe.apply_modulation_plain(intr, mod, -0.75, 1.5, a_rate)
    assert torch.equal(got, want)


@pytest.mark.parametrize("modulated", [True, False])
def test_config6_on_card(dev, modulated):
    """The golden (modulated; the npz is that render) or the CPU render
    (unmodulated), and K11 and K6m once a step."""
    frames = 8192
    cudabuild.launches.clear()
    out = config6_lfo_tremolo(superblock=4, modulated=modulated, device=dev).render(frames)
    steps = frames // 512
    if modulated:
        ref = np.load("tests/goldens/config6_lfo_tremolo_64.npz")["out"]
    else:
        ref = config6_lfo_tremolo(superblock=4, modulated=False, device="cpu").render(frames)
    assert np.abs(out.astype(np.float64) - ref).max() < 1e-5
    assert cudabuild.launches["oscillator_group_step"] == steps
    assert cudabuild.launches["apply_modulation"] == (steps if modulated else 0)


# ---- K7, K6's exact rows, K4a's streamed path ---------------------------------


def _check_resample_steps(ctx, steps):
    """K7 (one launch) against resample_group_step_plain on the card over
    ``steps`` steps of ctx's stage-0 group (groups.step_rates): audio
    within 1e-6, the new x, primed and stop_time bit for bit; the rates
    also as one base value a voice (a stride-0 view). Returns the audio's
    abs sum."""
    w, variant, _ = ctx._compiled._bufsrc_cfg[0]
    assert variant[0] == "resample"
    node = ctx._compiled.stages[0][1][0]
    c = ctx._consts
    heard = 0.0
    for k, (st, rc) in enumerate(groups.group_inputs(ctx, steps)):
        rates = groups.step_rates(ctx, k)
        for r in (rates, rates[:, 0].contiguous()[:, None].expand_as(rates)):
            before = cudabuild.launches["resample_group_step"]
            got = type(node).process_resample_group(st, c["st0/arena"], c["st0/geom"],
                                                    c["st0/gtab"], r, rc, w)
            assert cudabuild.launches["resample_group_step"] == before + 1
            want = type(node).resample_group_step_plain(st, c["st0/arena"], c["st0/geom"], r,
                                                        rc, w)
            torch.cuda.synchronize()
            assert float((got[1] - want[1]).abs().max()) <= 1e-6
            for f in ("x", "primed", "stop_time"):
                assert torch.equal(_int_view(got[0][f]), _int_view(want[0][f])), f
            heard += float(want[1].abs().sum())
    return heard


@pytest.mark.parametrize("case", ["pitched S=64 V=64", "V=1 S=1", "V=1 S=4", "V=1 S=64",
                                  "stereo S=32", "edges S=4", "edges S=32"])
def test_k7_resample(dev, case):
    """config4_pitched's step shapes, one voice at S = 1, 4 and 64 (a loop
    shorter than a superblock: the seam inside a step), stereo, and the
    edge-case group (one-shots ending mid-superblock, late starts, a
    finite duration)."""
    if case.startswith("pitched"):
        ctx = config4_pitched(superblock=64, voices=64, device=dev)
        ctx._ensure_compiled()
        steps = 3
    else:
        S = int(case.split("S=")[1])
        specs = groups.POLY_VOICES[1:2] if case.startswith("V=1") else groups.POLY_VOICES
        ctx = groups.resample_group(S, dev, channels=2 if case.startswith("stereo") else 1,
                                    specs=specs)
        steps = 6
    assert _check_resample_steps(ctx, steps) > 0


@pytest.mark.parametrize("S", [16, 17, 128, 513])
def test_k7_resample_superblocks(dev, S):
    """K7 at more superblocks: S = 16 and 17 (one run of 16 and a second
    run of one quantum), 128 (eight runs, 16 spans) and 513 (33 runs: two
    passes of the plan warp's run loop), over the edge-case group: one
    launch a step, the audio, x, primed and stop_time bit for bit the plain
    version, the rates as rows and as one base value a voice."""
    ctx = groups.resample_group(S, dev)
    w = ctx._compiled._bufsrc_cfg[0][0]
    node = type(ctx._compiled.stages[0][1][0])
    c = ctx._consts
    heard = 0.0
    for k, (st, rc) in enumerate(groups.group_inputs(ctx, 3 if S > 128 else 5)):
        rates = groups.step_rates(ctx, k)
        for r in (rates, rates[:, 0].contiguous()[:, None].expand_as(rates)):
            before = cudabuild.launches["resample_group_step"]
            got = node.process_resample_group(st, c["st0/arena"], c["st0/geom"], c["st0/gtab"],
                                              r, rc, w)
            assert cudabuild.launches["resample_group_step"] == before + 1
            want = node.resample_group_step_plain(st, c["st0/arena"], c["st0/geom"], r, rc, w)
            torch.cuda.synchronize()
            assert torch.equal(got[1], want[1]), k
            for f in ("x", "primed", "stop_time"):
                assert torch.equal(_int_view(got[0][f]), _int_view(want[0][f])), (k, f)
            heard += float(want[1].abs().sum())
    assert heard > 0


def test_k7_modulated_row(dev):
    """K7 on the vibrato's modulated V = 1 rows, as its ungrouped stages
    launch it (the last voice past its window's rate bound): audio, x,
    primed and stop_time bit for bit the plain version."""
    node = gat.AudioBufferSourceNode
    seen = groups.vibrato_launches(dev, 3)
    assert len(seen) == 24
    for st, arena, geom, gtab, rate, rc, w in seen:
        assert tuple(rate.shape) == (1, 32)
        got = node.process_resample_group(st, arena, geom, gtab, rate, rc, w)
        want = node.resample_group_step_plain(st, arena, geom, rate, rc, w)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        for f in ("x", "primed", "stop_time"):
            assert torch.equal(_int_view(got[0][f]), _int_view(want[0][f])), f


def test_k7_audio_bit_for_bit_at_config4_pitched(dev):
    """config4_pitched's K7 launches (V = 64, S = 64, the rates from the
    step's K6 rows) over 10 steps: the audio bit for bit the plain
    version's, and the new states."""
    from graphaudio_tpu_torch.core import graph as tgraph

    ctx = config4_pitched(superblock=64, voices=64, device=dev)
    ctx._ensure_compiled()
    ctx._ensure_params_encoded()
    w, variant, _ = ctx._compiled._bufsrc_cfg[0]
    assert variant[0] == "resample"
    node = gat.AudioBufferSourceNode
    c = ctx._consts
    arena, geom, gtab = c["st0/arena"], c["st0/geom"], c["st0/gtab"]
    table = ctx._encs[PARAM_TABLE]
    slot = table["slots"]["st0/playbackRate"]
    S = 64
    clock = ctx._block_clock(10 * S)
    st = ctx._states["st0"]
    for k in range(10):
        rc = tgraph.RenderContext(ctx._compiled.info, k * S * 128,
                                  torch.from_numpy(clock[k * S:(k + 1) * S]).to(dev))
        rows = tpe.eval_intrinsic_batch(table, rc.block_times, rc.dt)
        rate = rows.narrow(0, slot.off, slot.lanes * slot.per_lane).view(slot.lanes, S)
        got = node.process_resample_group(st, arena, geom, gtab, rate, rc, w)
        new, want = node.resample_group_step_plain(st, arena, geom, rate, rc, w)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want), k
        for f in ("x", "primed", "stop_time"):
            assert torch.equal(_int_view(got[0][f]), _int_view(new[f])), (k, f)
        st = new


def test_k7_checks_the_table(dev):
    """K7 raises (and launches nothing) unless its table is a contiguous
    f64[V + 1, RESAMPLE_COLS] on the card: the shared layout without the
    voices' rate / sample_rate column is refused."""
    from graphaudio_tpu_torch.ops.resample import resample_group_step

    ctx = groups.resample_group(4, dev)
    c = ctx._consts
    st, rc = next(groups.group_inputs(ctx, 1))
    rates = groups.step_rates(ctx, 0)
    gtab = c["st0/gtab"]
    before = cudabuild.launches["resample_group_step"]
    for bad in (gtab[:, :-1].contiguous(), gtab.cpu(), gtab.float(), gtab[1:]):
        with pytest.raises(ValueError):
            resample_group_step(st, c["st0/arena"], bad, rates, rc.block_times,
                                rc.block_end_times)
    assert cudabuild.launches["resample_group_step"] == before


def _ulps(got, want):
    """|got - want| in units of want's last place (f32)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    return np.abs(g.astype(np.float64) - w) / np.spacing(np.abs(w))


@pytest.mark.parametrize("step", [0, 9])
def test_k6_exact_rows(dev, step):
    """K6's rows of the exact kind beside ordinary rows, one launch: linear
    ramps bit for bit; the f64 exponential and setTarget curves within one
    f32 ulp (CUDA's f64 pow/exp against the CPU's)."""
    S = 32
    entries = ttab.mixed_param_entries(0, 12 * S * ttab.BLOCK)
    exact = [(f"x{k}", e[1], e[2], True) for k, e in enumerate(entries)]
    linear = ttab.linear_param_entries(1, 12 * S * ttab.BLOCK)
    lin_exact = [(f"l{k}", e[1], e[2], True) for k, e in enumerate(linear)]
    table = tpe.pack_param_table(entries + exact + lin_exact, S)
    dt = to_device(table, dev)
    bt = torch.from_numpy(ttab.block_clock(12 * S)[step * S:(step + 1) * S]).to(dev)
    got = tpe.eval_intrinsic_batch(dt, bt, 1.0 / 48000)
    want = tpe.eval_intrinsic_batch_plain(dt, bt, 1.0 / 48000)
    torch.cuda.synchronize()
    for key, *_ in entries + exact + lin_exact:
        slot = table["slots"][key]
        g = got[slot.off:slot.off + slot.lanes * slot.per_lane]
        w = want[slot.off:slot.off + slot.lanes * slot.per_lane]
        if key.startswith("x"):
            assert float(_ulps(g, w).max()) <= 1.0, key
        else:
            assert torch.equal(g, w), key


@pytest.mark.parametrize("spb, C", [(65521, 2), (131057, 1)])
def test_k4a_streamed_blocks(dev, spb, C):
    """Blocks past the stage (the streamed path) at WAV's longest stereo
    and mono block lengths: bit for bit the host encoder of the stream
    buffer (carry, then the quantized chunk, then zeros); the new carry
    too."""
    rng = np.random.default_rng(spb)
    F, carry_len = 2 * spb + 1000, 7
    x = (rng.standard_normal((C, F)) * 0.5).astype(np.float32)
    carry = rng.integers(-32768, 32768, (C, spb - 1)).astype(np.int16)
    before = cudabuild.launches["ima_chunk_encode"]
    blocks, new_carry = wire.ima_chunk_encode(torch.from_numpy(x).to(dev),
                                              torch.from_numpy(carry).to(dev), carry_len)
    torch.cuda.synchronize()
    assert cudabuild.launches["ima_chunk_encode"] == before + 1
    ncap = wire.ima_chunk_slots(F, spb)
    buf = np.zeros((C, ncap * spb + spb), np.int16)
    buf[:, :spb - 1] = carry
    buf[:, carry_len:carry_len + F] = wire.quantize_i16(x)
    np.testing.assert_array_equal(blocks.cpu().numpy(),
                                  wire.ima_encode_np(buf[:, :ncap * spb], spb))
    nblk = (carry_len + F) // spb
    np.testing.assert_array_equal(new_carry.cpu().numpy(),
                                  buf[:, nblk * spb:nblk * spb + spb - 1])


# ---- K12, K13 and the deferred K8 / K10b -------------------------------------------------


def _delay_case(dev, C, T, L, delays, w, seed, broadcast=False):
    """x, delay times and a port delay state whose JAX view is a seeded ring
    with its cursor at ``w`` (the slot cursor elsewhere)."""
    from graphaudio_tpu_torch.nodes import delay as td

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((C, T)).astype(np.float32)).to(dev)
    if broadcast:  # a mono row up-mixed to C channels as a stride-0 view
        x = x[:1].expand(C, T)
    ring = rng.standard_normal((C, L)).astype(np.float32)
    st = td.delay_state_from_jax({"ring": ring, "wpos": w}, T, dev, slot=3 * w + 1)
    max_s = float(np.float32(L / 48000))
    if delays == "L":
        dt = torch.full((T,), max_s, device=dev)
    elif delays == "zero":
        dt = torch.zeros((), device=dev).expand(T)
    elif delays == "short":
        dt = torch.full((), float(np.float32(0.1 * T / 48000)), device=dev).expand(T)
    else:
        dt = torch.from_numpy(np.minimum(np.linspace(0.0, 1.2 * max_s, T), max_s)
                              .astype(np.float32)).to(dev)
    return x, dt, st


@pytest.mark.parametrize("C,T,L,delays,w,broadcast", [
    (2, 128, 200, "L", 150, False), (1, 256, 96, "L", 40, False),
    (2, 4096, 4096, "ramp", 4095, False), (1, 8192, 48000, "ramp", 31000, False),
    (2, 8192, 48000, "short", 123, False), (2, 4096, 960, "zero", 3, False),
    (1, 128, 5, "ramp", 4, False), (2, 8192, 48000, "ramp", 47999, True),
], ids=["d=L T<L", "d=L T>L", "T=L", "ramp d>T", "d<T base value", "d=0", "T>>L",
        "broadcast input"])
def test_k12_delay(dev, C, T, L, delays, w, broadcast):
    from graphaudio_tpu_torch.nodes import delay as td

    x, dt, st = _delay_case(dev, C, T, L, delays, w, seed=T + L, broadcast=broadcast)
    assert x.is_contiguous() != broadcast
    ref = {k: v.clone() for k, v in st.items()}
    R, W = L + min(T, L), min(T, L)
    slot0 = int(st["slot"][0])
    assert st["slot"].numel() == td.slot_copies(C, T)  # one block a copy
    for step in range(3):  # chained: the cursors K12 moved on the card are read back
        cudabuild.launches.clear()
        out = td.delay_step(x, dt, st, 48000, L)
        want = td.delay_step_plain(x, dt, ref, 48000, L)
        torch.cuda.synchronize()
        assert cudabuild.launches["delay_step"] == 1
        assert torch.equal(out, want)
        assert all(torch.equal(st[k], ref[k]) for k in ("ring", "slot", "wpos"))  # in place
        view, want_view = td.delay_jax_view(st, L), td.delay_jax_view(ref, L)
        assert torch.equal(view["ring"], want_view["ring"])
        assert st["wpos"].dtype == torch.int32 and int(st["wpos"]) == (w + (step + 1) * T) % L
        # every block's copy of the slot cursor moved by W
        assert st["slot"].tolist() == [(slot0 + (step + 1) * W) % R] * st["slot"].numel()


@pytest.mark.parametrize("base_view", [False, True], ids=["pan rows", "base values"])
@pytest.mark.parametrize("C", [1, 2], ids=["mono law", "stereo law"])
def test_k13_stereo_pan(dev, C, base_view):
    from graphaudio_tpu_torch.nodes import panner as tp

    rng = np.random.default_rng(C)
    V, T = 5, 4096
    x = torch.from_numpy(rng.standard_normal((V, C, T)).astype(np.float32)).to(dev)
    if base_view:
        pan = torch.tensor([-1.0, -0.3, 0.0, 0.6, 1.0], device=dev)[:, None].expand(V, T)
    else:
        p = np.linspace(-1.5, 1.5, V * T).astype(np.float32).reshape(V, T)
        p[:, :3] = (-1.0, 0.0, 1.0)
        pan = torch.from_numpy(p).to(dev)
    cudabuild.launches.clear()
    got = tp.stereo_pan(x, pan)
    want = tp.stereo_pan_plain(x, pan)
    torch.cuda.synchronize()
    assert cudabuild.launches["stereo_pan"] == 1
    # one f32 ulp at the output's scale: the plain fma rounds an f64 sum
    assert float((got - want).abs().max()) <= 2.0 ** -23 * max(1.0, float(want.abs().max()))


def test_deferred_k8_and_k10b(dev):
    """The one-item K8 and K10b tables of modulated stages, at their turn
    mid-render, bit for bit their plain versions on the same arena."""
    from graphaudio_tpu_torch.testing.configs import config3_wah, config5_orbit

    for key, table, arena, rc in groups.deferred_launches(config3_wah(superblock=8, device=dev),
                                                          3)[-4:]:
        got = tbq.biquad_coefficients_batch(table, arena, rc.sample_rate)
        want = tbq.biquad_coefficients_batch_plain(table, arena, rc.sample_rate)
        for g, w in zip(got[0], want[0]):
            assert torch.equal(g, w), key
    key, table, arena, rc = groups.deferred_launches(
        config5_orbit(superblock=8, voices=16, device=dev), 3)[-1]
    for g, w in zip(tsp.spatial_gains_batch(table, arena, rc.globals),
                    tsp.spatial_gains_batch_plain(table, arena, rc.globals)):
        assert torch.equal(g, w), key


@pytest.mark.parametrize("builder, kw, launches", [
    ("config3_wah", dict(superblock=8), {"biquad_coefficients_batch": 4, "apply_modulation": 4}),
    ("config5_orbit", dict(superblock=8, voices=16), {"spatial_gains_batch": 1}),
    ("config5_steplinear", dict(superblock=8, voices=16), {"stereo_pan": 1}),
    ("config4_pingpong", dict(superblock=16, voices=8), {"delay_step": 2, "stereo_pan": 1}),
])
def test_prologue_and_item10_paths_on_card(dev, builder, kw, launches):
    """8 superblocks of each path on the card against the CPU render."""
    from graphaudio_tpu_torch.testing import configs

    build = getattr(configs, builder)
    frames = 8 * kw["superblock"] * 128
    want = build(device="cpu", **kw).render(frames)
    cudabuild.launches.clear()
    got = build(device=dev, **kw).render(frames)
    assert np.abs(want).max() > 1e-3
    assert float(np.abs(got - want).max()) < 1e-5
    for name, n in launches.items():
        assert cudabuild.launches[name] == 8 * n, name


# -- K15: the stream node's feed read -------------------------------------------

STREAM_CASES = ["config5_streamed music (S=32 C=2 rate 0.91875)",
                "config5_streamed ambience (unity, S=32 C=2)", "S=1 C=2 rate 0.91875",
                "S=64 C=2 rate 0.91875", "unity S=64 C=2", "mono S=32 rate 0.91875",
                "rate 0.5 S=32 C=2", "rate 3.0 S=32 C=2 (taps clamped at the end)",
                "run out (end of stream, S=32 C=2)"]


@pytest.fixture(scope="module")
def stream_cases(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from graphaudio_tpu_torch.testing import streams

    return streams.feed_cases(torch.device("cuda"), str(tmp_path_factory.mktemp("streams")))


@pytest.mark.parametrize("case", STREAM_CASES)
def test_k15_stream_feed(dev, stream_cases, case):
    """K15 bit for bit its plain version over whole render calls: both of
    config5_streamed's stream nodes in a 351-step call and the seeded
    calls; one launch each, counted by its mode."""
    from graphaudio_tpu_torch.ops import stream as tstr

    args = stream_cases[case]
    cudabuild.launches.clear()
    got = tstr.stream_feed_call(*args)
    want = tstr.stream_feed_call_plain(*args)
    torch.cuda.synchronize()
    mode = "unity" if args[3] is None else "resample"
    assert cudabuild.launches["stream_feed"] == cudabuild.launches[f"stream_feed/{mode}"] == 1
    assert got.is_contiguous() and got.shape == want.shape == (args[1], args[0].shape[0],
                                                               args[2] * 128)
    assert torch.equal(got, want)


def test_config5_streamed_launches_k15_once_a_call(dev, tmp_path, monkeypatch):
    """8 superblocks of config5_streamed (16 voices) in one call on the
    card: one K15 launch for each of its two stream nodes (one in each
    mode), the plain version never called, the audio within 1e-5 of the
    CPU render."""
    from graphaudio_tpu_torch.ops import stream as tstr
    from graphaudio_tpu_torch.testing.configs import config5_streamed

    kw = dict(superblock=32, voices=16, root=str(tmp_path))
    frames = 8 * 32 * 128
    want = config5_streamed(device="cpu", **kw).render(frames)
    plain = []
    real = tstr.stream_feed_call_plain
    monkeypatch.setattr(tstr, "stream_feed_call_plain", lambda *a: plain.append(a) or real(*a))
    cudabuild.launches.clear()
    got = config5_streamed(device=dev, **kw).render(frames)
    assert cudabuild.launches["stream_feed"] == 2
    assert cudabuild.launches["stream_feed/resample"] == cudabuild.launches["stream_feed/unity"] == 1
    assert not plain
    assert np.abs(want).max() > 0.1
    assert float(np.abs(got - want).max()) < 1e-5


def _bits(t):
    return torch.view_as_real(t).view(torch.int32) if t.is_complex() else t.view(torch.int32)


def _k10p_same_bits(args):
    """The input pass, K10p-a and K10p-b against their plain versions on one
    call's arguments, and the whole wrapper against the whole plain
    version: the same f32 operations in the same order (__f*_rn in the
    kernels), so bit for bit."""
    inp, mac, ola = hrtf_part.kernel_inputs(args)
    for got, want in (((th.partitioned_input(*inp),), (th.partitioned_input_plain(*inp),)),
                      (th.partitioned_mac(*mac), th.partitioned_mac_plain(*mac)),
                      (th.partitioned_ola(*ola), th.partitioned_ola_plain(*ola)),
                      (th.hrtf_fir_partitioned(*args), th.hrtf_fir_partitioned_plain(*args))):
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("case", sorted(hrtf_part.PART_CASES))
def test_k10p_kernels(dev, case):
    _k10p_same_bits(hrtf_part.seeded_case(dev, *hrtf_part.PART_CASES[case]))


@pytest.mark.parametrize("q", th.MAC_BLOCK_QUANTA)
@pytest.mark.parametrize("motion", ["moving", "runs", "static"])
def test_k10p_a_block_quanta(dev, monkeypatch, q, motion):
    """K10p-a with each block length the launcher may pick, at S = 20 (a
    short last block at every length) and P = 8: bit for bit its plain
    version, sums and next ring."""
    monkeypatch.setattr(th, "mac_block_quanta", lambda V, S, sms: q)
    mac = hrtf_part.kernel_inputs(hrtf_part.seeded_case(dev, 16, 1, 20, 8, True, motion))[1]
    got, want = th.partitioned_mac(*mac), th.partitioned_mac_plain(*mac)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("taps,P", [(None, 2), (1024, 8)])
def test_k10p_config5_measured(dev, taps, P):
    """config5_measured (128 voices, superblock 32) with every source moving:
    the kernels bit for bit on its fourth step's arguments; one input pass,
    one K10p-a and one K10p-b launch a step and no P1; 4 steps within 1e-5
    of the CPU render."""
    from unittest import mock

    def build(d):
        ctx = config5_measured(superblock=32, device=d, taps=taps)
        for v, snd in enumerate(ctx._sounds):
            a = 2 * np.pi * v / len(ctx._sounds)
            for prm, fn in ((snd._spatial_panner.position_x, np.cos),
                            (snd._spatial_panner.position_z, np.sin)):
                prm.set_value_at_time(float(5 * fn(a)), 0.0)
                prm.linear_ramp_to_value_at_time(float(5 * fn(a + np.pi / 2)), 3.0)
        return ctx

    ctx = build(dev)
    ctx._ensure_compiled()
    cudabuild.launches.clear()
    with mock.patch.object(tsp, "hrtf_fir_partitioned", wraps=tsp.hrtf_fir_partitioned) as k:
        got = ctx.render(4 * 32 * 128)
    assert k.call_count == 4
    assert (cudabuild.launches["hrtf_part_input"], cudabuild.launches["hrtf_part_mac"],
            cudabuild.launches["hrtf_part_ola"], cudabuild.launches["hrtf_fir"]) == (4, 4, 4, 0)
    args = list(k.call_args.args)
    assert tuple(args[5].shape) == (7, 24, 2, P, 129)
    _k10p_same_bits(args)
    want = build("cpu").render(4 * 32 * 128)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() < 1e-5


def test_k10p_per_node_and_context_default(dev):
    """A per-node 320-tap set (P = 3) beside panners on a 200-tap context
    default (P = 2): two panner stages, each one input pass, one K10p-a and
    one K10p-b launch a step, and the render within 1e-5 of the CPU
    render."""
    from graphaudio_tpu_torch.testing.sofa import synthetic_hrir_set

    def data(n):
        hrir, az, el = synthetic_hrir_set(length=n, seed=n)
        return {"hrir": hrir, "azimuth_deg": az, "elevation_deg": el, "sample_rate": 48000}

    def build(d):
        rng = np.random.default_rng(27)
        ctx = gat.OfflineAudioContext(superblock=4, device=d)
        ctx.set_default_hrir(data(200), length=200)
        pans = []
        for v in range(3):
            src = gat.AudioBufferSourceNode(ctx)
            src.buffer = gat.PlayableAudioBuffer.from_mono_array(
                (rng.standard_normal(48000) * 0.2).astype(np.float32), 48000)
            src.loop = True
            pan = gat.SpatialPannerNode(ctx)
            pan.position_x.set_value_at_time(2.0 - 2.0 * v, 0.0)
            pan.position_x.linear_ramp_to_value_at_time(2.0 * v - 2.0, 0.05)
            pan.position_z.value = -1.0
            src.connect(pan).connect(ctx.destination)
            src.start(0)
            pans.append(pan)
        pans[0].load_hrir(data(320), length=320)
        return ctx

    ctx = build(dev)
    ctx._ensure_compiled()
    cudabuild.launches.clear()
    got = ctx.render(8 * 512)
    assert (cudabuild.launches["hrtf_part_input"], cudabuild.launches["hrtf_part_mac"],
            cudabuild.launches["hrtf_part_ola"], cudabuild.launches["hrtf_fir"]) == (16, 16, 16, 0)
    want = build("cpu").render(8 * 512)
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < 1e-5


# ---- item 15: K14 and the launch's staging ---------------------------------------


def test_to_device_stages_through_one_pinned_copy(dev):
    """On the card, to_device's tensors are views of one copy of a pinned
    buffer, with the values and dtypes of their arrays."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.float64(2.5), "d": np.array([True, False]), "e": np.zeros((0, 3)),
                  "f": np.array([7, -8], np.int64)}}
    out = to_device(tree, dev)
    torch.cuda.synchronize()
    for got, want in ((out["a"], tree["a"]), (out["b"]["c"], tree["b"]["c"]),
                      (out["b"]["d"], tree["b"]["d"]), (out["b"]["e"], tree["b"]["e"]),
                      (out["b"]["f"], tree["b"]["f"])):
        assert got.is_cuda and got.is_contiguous() and got.data_ptr() % 64 == 0 or got.numel() == 0
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        assert got.cpu().numpy().dtype == np.asarray(want).dtype


@pytest.mark.parametrize("head", ["first", "last", "seeded"])
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("L", [1, 8])
def test_k14a_matches_plain(dev, rev, L, head):
    """K14a at every slice of part = 2 and 4, bit for bit its plain version,
    the ring writes too (config 4's grain at L = 1, the 128 grain at L = 8;
    both bin counts odd), with the ring's head at slot 0, at R - 1 and
    seeded; at L = 8 also a slice of 375 rows (``ShardedVoiceScene``'s 2 s
    IR over part = 2: many batches of rows)."""
    rng = np.random.default_rng(26 + L)
    K, NB, P = (2, 8193, 12) if L == 1 else (2, 129, 16)
    shapes = [(P, (2, 4))] + ([(750, (2,))] if L == 8 else [])

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    for P, parts in shapes:
        R = P - 1 + L
        X = torch.complex(f(K, L, NB), f(K, L, NB))
        hr, hi, ring_r, ring_i = f(K, P, NB), f(K, P, NB), f(K, R, NB), f(K, R, NB)
        h0 = {"first": 0, "last": R - 1, "seeded": int(rng.integers(R))}[head]
        for part in parts:
            pl = P // part
            for d in range(part):
                h = (hr[:, d * pl:(d + 1) * pl].contiguous(),
                     hi[:, d * pl:(d + 1) * pl].contiguous())
                rk, rp = (ring_r.clone(), ring_i.clone()), (ring_r.clone(), ring_i.clone())
                got = tconv.spectral_mac_slice(X, *h, *rk, h0, rev, d * pl)
                want = tconv.spectral_mac_slice_plain(X, *h, *rp, h0, rev, d * pl)
                assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
                assert torch.equal(rk[0], rp[0]) and torch.equal(rk[1], rp[1])


def _k14b_case(dev, V, S, motion, seed):
    """K14b's inputs but the slice: (X, hx, haz, hel, az, el) of a P = 8
    filter on the 7 x 24 grid of ``testing.hrtf_part``, and its spectra
    (sr, si). ``motion``: "moving" (a new cell every 1-2 quanta), "static"
    (one direction, the ring's too: one direction run), "runs" (1-5 quanta
    a direction) or "crossing" (a new grid cell every quantum, 0.3 rad a
    quantum against the grid's 0.26)."""
    args = hrtf_part.seeded_case(dev, V, 1, S, 8, True, "moving" if motion == "crossing"
                                 else motion, seed=seed)
    x, gain, az, el, _, sr, si, hx, haz, hel, _ = args
    if motion == "crossing":
        q = np.arange(7 + S, dtype=np.float64)[None] * 0.3 + np.arange(V)[:, None]
        both = torch.from_numpy(q.astype(np.float32)).to(dev)
        haz, az = both[:, :7].contiguous(), both[:, 7:].contiguous()
        hel = torch.full_like(haz, 0.2)
        el = torch.full_like(az, 0.2)
    X = torch.fft.rfft(th.partitioned_input_plain(x, gain), dim=-1)
    return (X, hx, haz, hel, az, el), (sr, si)


@pytest.mark.parametrize("motion", ["moving", "static", "runs", "crossing"])
@pytest.mark.parametrize("part", [1, 2, 4, 8])
def test_k14b_matches_plain(dev, part, motion):
    """K14b at every slice of a P = 8 filter, bit for bit its plain version,
    the next ring and its directions too: part = 8 is the fewest partitions
    a slice (1), part = 1 the most the kernel takes (8); S = 32 at V = 1 (a
    per-node panner), S = 5 and 7 (not a multiple of the kernel's 4 quanta
    a block) at V = 3 and 2, S = 1; still, moving, run-wise and
    cell-crossing directions."""
    for i, (V, S) in enumerate(((1, 32), (3, 5), (2, 7), (1, 1))):
        args, (sr, si) = _k14b_case(dev, V, S, motion, seed=27 + i)
        P = sr.shape[3]
        pl = P // part
        for d in range(part):
            cut = slice(d * pl, (d + 1) * pl)
            s = (sr[:, :, :, cut].contiguous(), si[:, :, :, cut].contiguous(), d * pl)
            got = th.partitioned_mac_slice(*args, *s)
            want = th.partitioned_mac_slice_plain(*args, *s)
            assert torch.equal(torch.view_as_real(got[0]), torch.view_as_real(want[0]))
            for g, w in zip(got[1:], want[1:]):
                assert torch.equal(g, w)


def test_k14b_slice_of_three_inside_a_longer_ring(dev):
    """K14b with 3 partitions a slice (a P = 6 filter over part = 2, and a
    slice of 3 that starts inside a P = 8 ring), bit for bit."""
    args, (sr, si) = _k14b_case(dev, 2, 9, "runs", seed=31)
    X, hx, haz, hel, az, el = args
    for P, p_base in ((6, 3), (8, 2)):
        a = (X, hx[:, 8 - P:].contiguous(), haz[:, 8 - P:].contiguous(),
             hel[:, 8 - P:].contiguous(), az, el)
        s = (sr[:, :, :, :3].contiguous(), si[:, :, :, :3].contiguous(), p_base)
        got = th.partitioned_mac_slice(*a, *s)
        want = th.partitioned_mac_slice_plain(*a, *s)
        for g, w in zip(got, want):
            assert torch.equal(torch.view_as_real(g) if g.is_complex() else g,
                               torch.view_as_real(w) if w.is_complex() else w)


@pytest.mark.parametrize("K, L, P, B, rev", K2_SHAPES)
def test_k2a_reads_its_head_on_the_card(dev, K, L, P, B, rev):
    """K2a with the ring's head as an int64 on the card (as a realtime
    context's captured step holds it) gives the host-int head's bits, ring
    writes too."""
    g = torch.Generator().manual_seed(1)
    NB, R = B + 1, P - 1 + L

    def f(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    X = torch.complex(f(K, L, NB), f(K, L, NB))
    hr, hi, ring_r, ring_i = f(K, P, NB), f(K, P, NB), f(K, R, NB), f(K, R, NB)
    for head in (0, 7 % R, R - 1):
        rk, rd = (ring_r.clone(), ring_i.clone()), (ring_r.clone(), ring_i.clone())
        want = tconv.spectral_mac(X, hr, hi, *rk, head, rev)
        got = tconv.spectral_mac(X, hr, hi, *rd,
                                 torch.tensor(head, dtype=torch.int64, device=dev), rev)
        assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
        assert torch.equal(rd[0], rk[0]) and torch.equal(rd[1], rk[1])


@pytest.mark.parametrize("build, voices", [(config4_conv_reverb, 8), (config5_spatial_scene, 16)],
                         ids=["config4", "config5"])
def test_realtime_step_graph_renders_the_same_bits(dev, build, voices):
    """A realtime context's steps through its CUDA graph (core/stepgraph.py),
    launched two deep as the render thread launches them, across a param
    edit that drops the graph, give the bits of the same steps run kernel
    by kernel; the graph is captured again after the edit and replays most
    steps, and the wrappers' counts plus the kernels of the replays after
    each capture are the kernel-by-kernel run's counts."""
    from graphaudio_tpu_torch.realtime import RealtimeAudioContext

    def make(**geom):
        return RealtimeAudioContext(device=dev, auto_start_thread=False, output_device="null",
                                    **geom)

    runs = []
    for graphed in (True, False):
        ctx = build(superblock=2, voices=voices, context=make)
        if not graphed:
            ctx._step_graph = None
        gain = next(n for n in ctx._nodes.values() if isinstance(n, gat.GainNode))
        cudabuild.launches.clear()
        outs, pending = [], None
        for i in range(40):
            if i == 17:
                gain.gain.value = 0.25
            nxt = ctx._render_steps_launch(1)
            if pending is not None:
                outs.append(ctx._render_steps_finish(pending))
            pending = nxt
        outs.append(ctx._render_steps_finish(pending))
        runs.append((np.concatenate(outs, axis=1), dict(cudabuild.launches), ctx._step_graph))
        ctx.dispose()
    (got, counts, sg), (want, want_counts, _) = runs
    assert np.abs(want).max() > 1e-3
    np.testing.assert_array_equal(got, want)
    assert sg.refused is None and sg.captures == 2 and sg.replays >= 30
    replayed = {k: v * (sg.replays - sg.captures) for k, v in sg.kernels.items()}
    assert dict(Counter(counts) + Counter(replayed)) == want_counts
