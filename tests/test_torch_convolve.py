"""Port K2 (partitioned convolution) against the JAX package's three grains.

The same IR and input, made with numpy from a seed, go through
graphaudio_tpu.ops.convolve (conv_superblock at the 128 grain,
conv_superblock_big at superblock grain, conv_superblock_sub at the
sub-blocked grain) and through the port's conv_step, over 3 consecutive
steps with carried state. Tolerance 1e-5 max abs: f32 FFT (port) vs f32
matmul-DFT (JAX) rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.ops import convolve as jconv
from graphaudio_tpu_torch.ops import convolve as tconv
from graphaudio_tpu_torch.utils.from_jax import conv_state_from_jax

SR = 48000
TOL = 1e-5


def _ir(rng, seconds):
    n = int(seconds * SR)
    return (rng.standard_normal(n) * np.exp(-np.arange(n) / (0.05 * SR))).astype(np.float32)


@pytest.mark.parametrize(
    "T, grain, ir_s",
    [(512, 0, 0.1), (1024, 1024, 0.25), (2048, 1024, 0.25)],
    ids=["grain128", "superblock_grain", "sub_blocked"],
)
def test_conv_grains_match_jax(T, grain, ir_s):
    rng = np.random.default_rng(7)
    ir = _ir(rng, ir_s)
    if grain:
        hr, hi = jconv.prepare_ir_big(ir, grain)
        B = grain
        jfn = jconv.conv_superblock_big if grain == T else jconv.conv_superblock_sub
    else:
        hr, hi = jconv.prepare_ir(ir)
        B = 128
        jfn = jconv.conv_superblock
    # The port's host prep is a copy: identical spectra.
    thr, thi = (tconv.prepare_ir_big(ir, grain) if grain else tconv.prepare_ir(ir))
    np.testing.assert_array_equal(thr, hr)
    np.testing.assert_array_equal(thi, hi)

    P, bins = hr.shape
    L = T // B
    jfn = jax.jit(jfn)
    hist_r = np.zeros((P - 1, bins), np.float32)
    hist_i = np.zeros((P - 1, bins), np.float32)
    overlap = np.zeros((B,), np.float32)
    st = conv_state_from_jax(
        {"hist_r": hist_r[None], "hist_i": hist_i[None], "overlap": overlap[None]},
        L, "cpu", head=3,
    )
    th_r, th_i = torch.from_numpy(hr)[None], torch.from_numpy(hi)[None]
    head = st["head"]
    for _step in range(3):
        x = (rng.standard_normal(T) * 0.3).astype(np.float32)
        xj = x.reshape(L, 128) if grain == 0 else x
        yj, hist_r, hist_i, overlap = jfn(xj, hr, hi, hist_r, hist_i, overlap)
        yj = np.asarray(yj).reshape(T)
        yt, head = tconv.conv_step(
            torch.from_numpy(x).reshape(1, L, B), th_r, th_i, st["ring_r"],
            st["ring_i"], head, st["overlap"], rev=bool(grain),
        )
        assert np.abs(yt[0].numpy() - yj).max() < TOL
        assert np.abs(st["overlap"][0].numpy() - np.asarray(overlap)).max() < TOL
    # The ring holds the same past spectra as the JAX delay line.
    past = tconv.ring_slots(head, -(P - 1), P - 1, P - 1 + L, "cpu")
    scale = max(1.0, float(np.abs(np.asarray(hist_r)).max()))
    assert np.abs(st["ring_r"][0, past].numpy() - np.asarray(hist_r)).max() < TOL * scale
    assert np.abs(st["ring_i"][0, past].numpy() - np.asarray(hist_i)).max() < TOL * scale


def test_spectral_mac_matches_jax_correlation():
    """K2a's plain version equals graphaudio_tpu.ops.convolve.spectral_mac
    (the 128-grain correlation form) on the same delay line."""
    rng = np.random.default_rng(3)
    P, S, bins = 9, 4, 129
    seq_r = rng.standard_normal((P - 1 + S, bins)).astype(np.float32)
    seq_i = rng.standard_normal((P - 1 + S, bins)).astype(np.float32)
    hr = rng.standard_normal((P, bins)).astype(np.float32)
    hi = rng.standard_normal((P, bins)).astype(np.float32)
    ar, ai = jconv.spectral_mac(jnp.asarray(seq_r), jnp.asarray(seq_i), hr, hi)
    st = conv_state_from_jax(
        {"hist_r": seq_r[None, : P - 1], "hist_i": seq_i[None, : P - 1],
         "overlap": np.zeros((1, 128), np.float32)},
        S, "cpu", head=5,
    )
    X = torch.complex(torch.from_numpy(seq_r[P - 1:]), torch.from_numpy(seq_i[P - 1:]))[None]
    acc = tconv.spectral_mac(X, torch.from_numpy(hr)[None], torch.from_numpy(hi)[None],
                             st["ring_r"], st["ring_i"], st["head"], rev=False)
    assert np.abs(acc.real[0].numpy() - np.asarray(ar)).max() < 1e-4
    assert np.abs(acc.imag[0].numpy() - np.asarray(ai)).max() < 1e-4


def _emulate_mac_kernel(X, hr, hi, ring_r, ring_i, head, rev):
    """numpy emulation of csrc/conv.cu conv_mac_kernel's loop structure, in
    f32: the plan of tconv.mac_plan, each thread's column vector (all bins at
    once here), its lag group, its LT-wide sliding window, the walk over the
    ring before and after the wrap point, then X, then zeros, and the
    fixed-order reduction (a block's groups, then the cluster's blocks).
    Updates the rings in place like the kernel; returns acc complex64."""
    K, L, NB = X.shape
    P, R = hr.shape[1], ring_r.shape[1]
    lt, clusters, groups, lags = tconv.mac_plan(K, L, P, NB)
    past = P - 1
    first = head + L if head + L < R else head + L - R
    wrap = R - first
    f32 = np.float32
    Xr, Xi = X.real.astype(f32), X.imag.astype(f32)
    acc = np.zeros((K, L, NB), np.complex64)
    for k in range(K):
        def seq_at(s):
            if s >= R:
                return np.zeros(NB, f32), np.zeros(NB, f32)
            if s >= past:
                return Xr[k, s - past], Xi[k, s - past]
            slot = first + s if s < wrap else first + s - R
            return ring_r[k, slot], ring_i[k, slot]

        for l0 in range(0, L, lt):
            blocks = []
            for rank in range(clusters):
                parts = []
                for gy in range(groups):
                    j0 = min(P, (rank * groups + gy) * lags)
                    j1 = min(P, j0 + lags)
                    ar = [np.zeros(NB, f32) for _ in range(lt)]
                    ai = [np.zeros(NB, f32) for _ in range(lt)]
                    if j0 < j1:
                        w = [seq_at(l0 + j0 + i) for i in range(lt - 1)] + [None]
                        hrow = [j0 if rev else P - 1 - j0]

                        def step(vr, vi):
                            w[lt - 1] = (vr, vi)
                            h_r, h_i = hr[k, hrow[0]], hi[k, hrow[0]]
                            hrow[0] += 1 if rev else -1
                            for i in range(lt):
                                ar[i] = ar[i] + (w[i][0] * h_r - w[i][1] * h_i)
                                ai[i] = ai[i] + (w[i][0] * h_i + w[i][1] * h_r)
                            w[:-1] = w[1:]

                        s1, s2 = l0 + j0 + lt - 1, l0 + j1 + lt - 1
                        a, e = s1, min(s2, past, wrap)
                        for t in range(max(0, e - a)):
                            step(ring_r[k, first + a + t], ring_i[k, first + a + t])
                        a, e = max(s1, wrap), min(s2, past)
                        for t in range(max(0, e - a)):
                            step(ring_r[k, first + a - R + t], ring_i[k, first + a - R + t])
                        a, e = max(s1, past), min(s2, R)
                        for t in range(max(0, e - a)):
                            step(Xr[k, a - past + t], Xi[k, a - past + t])
                        for _ in range(max(s1, R), s2):
                            step(np.zeros(NB, f32), np.zeros(NB, f32))
                    parts.append((ar, ai))
                # the block's groups in order
                br, bi = parts[0]
                for pr, pi in parts[1:]:
                    br = [u + v for u, v in zip(br, pr)]
                    bi = [u + v for u, v in zip(bi, pi)]
                blocks.append((br, bi))
            # the cluster's blocks in rank order
            tr, ti = blocks[0]
            for pr, pi in blocks[1:]:
                tr = [u + v for u, v in zip(tr, pr)]
                ti = [u + v for u, v in zip(ti, pi)]
            for i in range(lt):
                if l0 + i < L:
                    acc[k, l0 + i] = tr[i] + 1j * ti[i]
    for l in range(L):
        slot = head + l if head + l < R else head + l - R
        ring_r[:, slot], ring_i[:, slot] = Xr[:, l], Xi[:, l]
    return acc


# (K, L, P, bins, head, rev): heads 0 and R-1; past slots straddling the
# ring's end; L = 1; ragged sub-block tiles (L = 3, L = 10); P not divisible
# by the lags a group; empty trailing groups; both H orders.
MAC_CASES = {
    "head0": (2, 4, 23, 5, 0, False),
    "head_R-1": (2, 4, 23, 5, 25, True),
    "straddle_L3": (2, 3, 23, 5, 10, False),
    "L1": (2, 1, 23, 5, 7, True),
    "two_tiles_P97": (2, 10, 97, 7, 50, True),
    "config4_like": (1, 8, 94, 3, 60, False),
}


@pytest.mark.parametrize("case", sorted(MAC_CASES))
def test_mac_kernel_plan_emulation(case):
    """The kernel's index plan, emulated in numpy, against the plain version
    and the JAX correlation (graphaudio_tpu.ops.convolve.spectral_mac)."""
    K, L, P, NB, head, rev = MAC_CASES[case]
    R = P - 1 + L
    rng = np.random.default_rng(11)
    X = (rng.standard_normal((K, L, NB)) + 1j * rng.standard_normal((K, L, NB))).astype(np.complex64)
    hr, hi, ring_r, ring_i = (rng.standard_normal(s).astype(np.float32)
                              for s in ((K, P, NB), (K, P, NB), (K, R, NB), (K, R, NB)))
    lt, clusters, groups, lags = tconv.mac_plan(K, L, P, NB)
    assert clusters * groups * lags >= P and lt >= min(L, 8)
    # the delay line oldest first, for JAX: past sub-blocks, then this step's
    past = [(head - (P - 1) + s) % R for s in range(P - 1)]
    seq_r = np.concatenate([ring_r[:, past], X.real], axis=1)
    seq_i = np.concatenate([ring_i[:, past], X.imag], axis=1)

    em_r, em_i = ring_r.copy(), ring_i.copy()
    got = _emulate_mac_kernel(X, hr, hi, em_r, em_i, head, rev)
    t_r, t_i = torch.from_numpy(ring_r.copy()), torch.from_numpy(ring_i.copy())
    want = tconv.spectral_mac_plain(torch.from_numpy(X), torch.from_numpy(hr), torch.from_numpy(hi),
                                    t_r, t_i, head, rev).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() < 1e-5 * scale
    assert np.array_equal(em_r, t_r.numpy()) and np.array_equal(em_i, t_i.numpy())
    for k in range(K):
        lag_r, lag_i = (h[k, ::-1] if rev else h[k] for h in (hr, hi))  # lag order
        jr, ji = jconv.spectral_mac(jnp.asarray(seq_r[k]), jnp.asarray(seq_i[k]),
                                    np.ascontiguousarray(lag_r), np.ascontiguousarray(lag_i))
        assert np.abs(got[k].real - np.asarray(jr)).max() < 1e-5 * scale
        assert np.abs(got[k].imag - np.asarray(ji)).max() < 1e-5 * scale


def _four_channel_ir_ctx(mod, superblock, true_stereo, seed=31, **ctx_kw):
    """A stereo source through a ConvolverNode with a 4-channel IR into the
    destination: with ``true_stereo`` the 2-in/2-out matrix (outL = L*ir0 +
    R*ir2, outR = L*ir1 + R*ir3), else 4 discrete channels (the destination
    set to 4 channels, Explicit)."""
    rng = np.random.default_rng(seed)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=superblock, **ctx_kw)
    if not true_stereo:
        ctx.destination.set_channel_count(4)
        ctx.destination.inputs[0].set_channel_count_mode(mod.ChannelCountMode.EXPLICIT)
    n = 6 * superblock * 128
    xs = [(rng.standard_normal(n) * 0.5).astype(np.float32) for _ in range(2)]
    irs = [(rng.standard_normal(1800) * np.exp(-np.arange(1800) / 600.0) * 0.3)
           .astype(np.float32) for _ in range(4)]
    src = mod.AudioBufferSourceNode(ctx)
    src.buffer = mod.PlayableAudioBuffer.from_channel_arrays(xs, SR)
    src.loop = True
    conv = mod.ConvolverNode(ctx)
    conv.enable_true_stereo = true_stereo
    conv.buffer = mod.PlayableAudioBuffer.from_channel_arrays(irs, SR)
    src.connect(conv).connect(ctx.destination)
    src.start(0)
    return ctx


@pytest.mark.parametrize("true_stereo", [True, False], ids=["true_stereo", "discrete4"])
@pytest.mark.parametrize("superblock", [4, 16], ids=["grain128", "grain1024"])
def test_four_channel_ir_node_matches_jax(superblock, true_stereo):
    """A 4-channel IR ConvolverNode in the port and in the JAX package on
    the same seeded input, at the 128 grain (superblock 4) and at grain
    1024 (superblock 16, two sub-blocks a step), over a render that ends
    mid-superblock: within 1e-5 max abs. Without ``enable_true_stereo`` the
    output is 4 discrete channels."""
    frames = 3 * superblock * 128 + 300
    want = _four_channel_ir_ctx(ga, superblock, true_stereo).render(frames)
    tctx = _four_channel_ir_ctx(gat, superblock, true_stereo, device="cpu")
    got = np.concatenate([tctx.render(700), tctx.render(frames - 700)], axis=1)
    assert got.shape == want.shape == (2 if true_stereo else 4, frames)
    assert np.abs(want).max() > 1e-3  # not comparing silence
    assert np.abs(got - want).max() < TOL


def _old_overlap_add_then_stack(y_full, overlap, true_stereo):
    """The composition K2b's combine replaces: the overlap-add, then the
    true-stereo stack of sums the convolver issued after it."""
    K, L, B2 = y_full.shape
    B = B2 // 2
    tails = torch.cat([overlap[:, None], y_full[:, :-1, B:]], dim=1)
    y = (y_full[:, :, :B] + tails).reshape(K, L * B)
    overlap.copy_(y_full[:, -1, B:])
    return torch.stack([y[0] + y[2], y[1] + y[3]]) if true_stereo else y


OLA_CASES = [(1, 1, False), (1, 8, False), (2, 1, False), (2, 8, False), (4, 1, False),
             (4, 8, False), (4, 1, True), (4, 8, True)]


def _ola_inputs(K, L, B, seed):
    rng = np.random.default_rng(seed)
    y_full = torch.from_numpy(rng.standard_normal((K, L, 2 * B)).astype(np.float32))
    overlap = torch.from_numpy(rng.standard_normal((K, B)).astype(np.float32))
    return y_full, overlap


@pytest.mark.parametrize("K, L, true_stereo", OLA_CASES)
def test_overlap_add_combine_is_the_old_composition(K, L, true_stereo):
    """overlap_add_plain with the combine equals, bit for bit, the
    overlap-add followed by the stack of sums, output and carried tail."""
    B = 128 if L == 8 else 1024
    y_full, ov_old = _ola_inputs(K, L, B, 40 + K + L)
    ov_new = ov_old.clone()
    want = _old_overlap_add_then_stack(y_full, ov_old, true_stereo)
    got = tconv.overlap_add(y_full, ov_new, ((0, 2), (1, 3)) if true_stereo else None)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(ov_new, ov_old)


def _walk_ola_kernel(y_full, overlap, comb, threads=128):
    """csrc/conv.cu conv_ola_kernel in numpy f32, thread by thread in blocks
    of ``threads``: thread i is (output c, sub-block l, float4 group g), g
    fastest; it adds each instance's head and tail (the carried overlap at
    l = 0, which that thread then replaces from row L-1's tail) and sums
    the map's instances in order."""
    K, L, B2 = y_full.shape
    G = B2 // 8
    C = comb.shape[1]
    yf = y_full.reshape(K, L, 2 * G, 4)
    ov = overlap.reshape(K, G, 4)
    y = np.full((C * L * G, 4), np.nan, np.float32)
    n = C * L * G
    for blk in range(-(-n // threads)):
        for i in range(blk * threads, min(n, (blk + 1) * threads)):
            g, r = i % G, i // G
            l, c = r % L, r // L

            def part(k):
                tail = yf[k, l - 1, G + g] if l else ov[k, g].copy()
                if l == 0:
                    ov[k, g] = yf[k, L - 1, G + g]
                return yf[k, l, g] + tail

            v = part(comb[0, c])
            if comb[1, c] >= 0:
                v = v + part(comb[1, c])
            y[i] = v
    return y.reshape(C, L * G * 4)


@pytest.mark.parametrize("K, L, true_stereo", [(1, 4, False), (2, 8, False), (4, 2, True),
                                               (4, 1, True)])
def test_overlap_add_kernel_walk(K, L, true_stereo):
    """The kernel's thread plan and combine map (``_ola_map``), walked in
    numpy, bit for bit against the plain version, output and new tails."""
    B = 128
    y_full, ov = _ola_inputs(K, L, B, 50 + K * L)
    combine = ((0, 2), (1, 3)) if true_stereo else None
    comb = tconv._ola_map(combine, K)
    ov_walk = ov.numpy().copy()
    got = _walk_ola_kernel(y_full.numpy(), ov_walk, comb)
    want = tconv.overlap_add_plain(y_full, ov, combine)
    assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))
    assert np.array_equal(ov_walk, ov.numpy())


def test_overlap_add_rejects_a_bad_combine():
    for bad in (((0, 1),), ((0, 2), (1, 2)), ((0, 1, 2), (3,))):
        with pytest.raises(ValueError):
            tconv._ola_map(bad, 4)
