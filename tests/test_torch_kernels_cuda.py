"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips
elsewhere; this file imports neither jax nor graphaudio_tpu, so it runs on
a machine without them:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import graphaudio_tpu_torch as gat
from graphaudio_tpu_torch.core.context import pack_int16, pack_int16_plain
from graphaudio_tpu_torch.core.graph import RenderContext
from graphaudio_tpu_torch.core.mixing import fan_in_lanes, fan_in_lanes_plain
from graphaudio_tpu_torch.nodes import spatial as tsp
from graphaudio_tpu_torch.ops import biquad as tbq
from graphaudio_tpu_torch.ops import convolve as tconv
from graphaudio_tpu_torch.ops import hrtf as th
from graphaudio_tpu_torch.ops import onepole as top
from graphaudio_tpu_torch.ops import param_eval as tpe
from graphaudio_tpu_torch.ops import resample as tres
from graphaudio_tpu_torch.ops import unity as tun
from graphaudio_tpu_torch.testing.configs import (
    config2_mix_bus,
    config3_eq_chain,
    config4_conv_reverb,
    config5_spatial_scene,
)
from graphaudio_tpu_torch.utils import cudabuild

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_k1_poly_resample(dev):
    ctx = config4_conv_reverb(superblock=8, voices=8, device="cpu")
    ctx._ensure_compiled()
    geom = ctx._consts["st0/geom"]
    V, S, q = 8, 8, 160
    g = torch.Generator().manual_seed(1)
    args = dict(
        arena=ctx._consts["st0/arena"],
        win_start=geom["off"].long() + geom["front"].long() + 3,
        j0=torch.randint(0, q, (V,), generator=g, dtype=torch.int32),
        bidx=torch.randint(0, S, (V, S), generator=g, dtype=torch.int32),
        blk_ok=torch.rand(V, S, generator=g) > 0.2,
        jlim=torch.tensor([1e9, 500.0, 2000.0, -5.0] * 2),
        looping=torch.tensor([True, False, False, False] * 2),
        wtab=ctx._consts["st0/poly_w"], btab=ctx._consts["st0/poly_b"],
    )
    on_card = {k: v.to(dev) for k, v in args.items()}
    ref = tres.poly_resample_plain(**on_card, p=147, q=q)
    got = tres.poly_resample(**on_card, p=147, q=q)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() < 1e-6


@pytest.mark.parametrize("L, P, B, rev", [(4, 750, 128, False), (8, 94, 1024, True)])
def test_k2_mac_and_overlap_add(dev, L, P, B, rev):
    g = torch.Generator().manual_seed(0)
    K, NB = 2, B + 1
    X = torch.complex(torch.randn(K, L, NB, generator=g), torch.randn(K, L, NB, generator=g))
    hr = torch.randn(K, P, NB, generator=g)
    hi = torch.randn(K, P, NB, generator=g)
    ring_r = torch.randn(K, P - 1 + L, NB, generator=g)
    ring_i = torch.randn(K, P - 1 + L, NB, generator=g)
    X, hr, hi = X.to(dev), hr.to(dev), hi.to(dev)
    rr_ref, ri_ref = ring_r.to(dev), ring_i.to(dev)
    rr, ri = rr_ref.clone(), ri_ref.clone()
    ref = tconv.spectral_mac_plain(X, hr, hi, rr_ref, ri_ref, 7, rev)
    got = tconv.spectral_mac(X, hr, hi, rr, ri, 7, rev)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() < 1e-5 * max(1.0, ref.abs().max().item())
    assert torch.equal(rr, rr_ref) and torch.equal(ri, ri_ref)  # same ring writes
    yf = torch.randn(K, L, 2 * B, generator=g).to(dev)
    ov = torch.randn(K, B, generator=g).to(dev)
    ov2 = ov.clone()
    y_ref = tconv.overlap_add_plain(yf, ov)
    y = tconv.overlap_add(yf, ov2)
    torch.cuda.synchronize()
    assert torch.equal(y, y_ref) and torch.equal(ov, ov2)


def test_k3_fan_in(dev):
    g = torch.Generator().manual_seed(2)
    for src_c, dst_c in [(1, 2), (2, 2), (2, 1), (4, 2), (2, 4)]:
        lanes = torch.randn(64, src_c, 8192, generator=g).to(dev)
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


def _k5_args(ctx, steps, dev):
    """K5's arguments for config 2's first ``steps`` superblocks, planned
    on the CPU."""
    ctx._ensure_compiled()
    S = ctx.superblock
    consts, st = ctx._consts, ctx._states["st0"]
    w, variant, _ = ctx._compiled._bufsrc_cfg[0]
    clock = ctx._block_clock(steps * S)
    out = []
    for k in range(steps):
        rc = RenderContext(ctx._compiled.info, k * S * 128,
                           torch.from_numpy(clock[k * S:(k + 1) * S]))
        st, args = gat.AudioBufferSourceNode.unity_group_plan(
            st, consts["st0/geom"], rc, w, variant[1])
        out.append({k: v.to(dev) for k, v in args.items()})
    return consts["st0/arena"].to(dev), out


def test_k5_unity_gather(dev):
    ctx = config2_mix_bus(superblock=8, device="cpu")
    arena, steps = _k5_args(ctx, 30, dev)
    for args in steps:
        got = tun.unity_gather(arena, **args)
        ref = tun.unity_gather_plain(arena, **args)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)  # a copy: bit-exact
    g = torch.Generator().manual_seed(5)
    args = dict(steps[3])
    args["delta"] = torch.randint(0, 128, args["delta"].shape, generator=g,
                                  dtype=torch.int32).to(dev)  # unaligned voices
    assert torch.equal(tun.unity_gather(arena, **args), tun.unity_gather_plain(arena, **args))


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
        # f64 sin/cos/pow rounded once on both sides: equal up to an ulp
        assert (a - b).abs().max().item() <= 1e-6 * max(1.0, b.abs().max().item())
    assert (got[3].imag >= 0).all()  # Im(p1) >= 0


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
@pytest.mark.parametrize("T", [512, 4096])
def test_p2_biquad_cascade(dev, tv, T):
    args = _biquad_inputs(dev, 3, 2, T, seed=8)
    if not tv:  # constant poles and coefficients
        args = [args[0]] + [a[:, :1].expand_as(a).contiguous() for a in args[1:6]] + args[6:]
    got = tbq.biquad_apply(*args, time_varying=tv)
    ref = tbq.biquad_apply_plain(*args, time_varying=tv)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        # f64 recurrences on both sides (sequential vs prefix), rounded to f32
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


@pytest.mark.parametrize("L, C, with_gain", [(64, 1, True), (64, 2, False), (128, 1, True)])
def test_p1_hrtf_fir(dev, L, C, with_gain):
    g = torch.Generator().manual_seed(10)
    V, S = 8, 32
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
    for a, b in zip(got, ref):
        # the same f32 operations in the same order (__f*_rn in the kernel)
        assert (a - b).abs().max().item() <= 1e-6


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


def test_config5_golden_on_card(dev):
    out = config5_spatial_scene(superblock=4, device=dev).render(8192)
    golden = np.load("tests/goldens/config5_spatial_scene_128.npz")["out"]
    assert np.abs(out.astype(np.float64) - golden).max() < 1e-5
