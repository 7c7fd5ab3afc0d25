"""The step's batched K6 and K8 tables, on the CPU.

``ops/param_eval.pack_param_table`` packs every automated param of an
encoding into one K6 table (one row per (param, lane), events padded to the
batch's capacity); ``ops/biquad.pack_coefficient_table`` packs every biquad
stage into one K8 table (eight words per (stage, lane), the type as data).
Here, on numpy inputs from seeds:

* the batched plain K6 over a mixed table (a-rate and k-rate rows,
  capacities 1 to 32, grouped lanes with phantom pads, all four event
  types, events on block starts and sample instants) equals
  ``eval_intrinsic_blocked_plain`` run per param bit for bit, and the JAX
  ``eval_intrinsic_blocked`` within test_torch_param_eval.py's tolerance;
* the batched plain K8 over the eight types as data equals the per-stage
  ``biquad_coefficients_plain`` bit for bit, and the JAX
  ``rbj_coefficients_dyn`` within 1e-6 x max, its poles through the
  polynomial they define and in JAX's order (Im(p1) >= 0);
* a numpy walk of each table in its kernel's order (csrc/param_eval.cu:
  a block per (row, tile of 256 samples); csrc/biquad.cu: a block per
  (row, quantum)), decoding the words the kernels read, reproduces the
  plain outputs bit for bit;
* a config-3 context makes one K6 and one K8 call a step, and picks up
  events, values and filter types changed between renders.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.ops import biquad as jbq
from graphaudio_tpu.ops import param_eval as jpe
from graphaudio_tpu_torch.core import graph as tgraph
from graphaudio_tpu_torch.nodes import biquad as tnb
from graphaudio_tpu_torch.ops import biquad as tbq
from graphaudio_tpu_torch.ops import param_eval as tpe
from graphaudio_tpu_torch.ops import xla_rounding
from graphaudio_tpu_torch.testing import tables as ttab
from graphaudio_tpu_torch.testing.configs import config3_eq_chain

SR = 48000
DT = 1.0 / SR
BLOCK = 128 / SR
S = 4
REL = 2.5e-7  # test_torch_param_eval.py's tolerance: two ulp of O(1) values

F32 = np.float32


_clock = ttab.block_clock


def _mixed_entries(seed=0):
    return ttab.mixed_param_entries(seed, t_end=12 * S * BLOCK)


def _tensors(tree):
    return tgraph.to_device(tree, "cpu")


def _slot_view(arena, slot):
    return arena[slot.off:slot.off + slot.lanes * slot.per_lane].view(*slot.shape, slot.per_lane)


_jax_eval = jax.jit(jpe.eval_intrinsic_blocked, static_argnums=(2, 3))


@pytest.mark.parametrize("step", [0, 3, 7, 11])
def test_k6_batch_matches_per_param_and_jax(step):
    entries = _mixed_entries()
    table = tpe.pack_param_table(entries, S)
    assert table["times"].shape == (1 + 4 + 1 + 2 + 8 + 1 + 4, 32)
    bt = _clock(12 * S)[step * S:(step + 1) * S]
    arena = tpe.eval_intrinsic_batch(_tensors(table), torch.from_numpy(bt), DT)
    assert arena.shape == (table["size"],) and arena.dtype == torch.float32
    covered = np.zeros(table["size"], bool)
    for key, enc, npb in entries:
        slot = table["slots"][key]
        covered[slot.off:slot.off + slot.lanes * slot.per_lane] = True
        got = _slot_view(arena, slot)
        want = tpe.eval_intrinsic_blocked_plain(_tensors(enc), torch.from_numpy(bt), npb, DT)
        assert torch.equal(got, want), key
        lanes = enc["base"].reshape(-1).shape[0]
        flat = got.reshape(lanes, -1).numpy()
        for lane in range(lanes):
            lane_enc = {k: np.asarray(v).reshape(lanes, *np.shape(v)[np.ndim(enc["base"]):])[lane]
                        for k, v in enc.items()}
            jw = np.asarray(_jax_eval(lane_enc, bt, npb, DT))
            np.testing.assert_allclose(flat[lane], jw, rtol=REL, atol=REL)
    assert covered.all()  # the slots tile the arena


def test_k6_padding_changes_nothing():
    """Each param alone (its own capacity) and in the mixed batch (padded
    to 32): the same bits."""
    entries = _mixed_entries(seed=5)
    bt = torch.from_numpy(_clock(3 * S)[2 * S:])
    mixed = tpe.pack_param_table(entries, S)
    arena = tpe.eval_intrinsic_batch(_tensors(mixed), bt, DT)
    for key, enc, npb in entries:
        alone = tpe.pack_param_table([(key, enc, npb)], S)
        assert alone["times"].shape[1] == enc["times"].shape[-1]
        own = tpe.eval_intrinsic_batch(_tensors(alone), bt, DT)
        assert torch.equal(_slot_view(arena, mixed["slots"][key]),
                           _slot_view(own, alone["slots"][key]))


def test_k6_empty_table():
    table = tpe.pack_param_table([], S)
    assert table["size"] == 0 and table["times"].shape == (0, 0)
    out = tpe.eval_intrinsic_batch(_tensors(table), torch.from_numpy(_clock(S)), DT)
    assert out.shape == (0,)


# ---- the numpy walk of the K6 table (csrc/param_eval.cu) --------------------

_SPLIT = 134217729.0


def _fma64(a, b, c):
    """fl64(a*b + c) rounded once, as the kernel's ``fma`` (Dekker's exact
    product, Knuth's exact sum; numpy f64)."""
    def split(x):
        t = _SPLIT * x
        hi = t - (t - x)
        return hi, x - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _fmaf(a, b, c):
    """fl32(a*b + c) as the plain version rounds it (the f32 product is exact
    in f64)."""
    return F32(a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64))


def _walk_k6(table, clocks, dt, threads=256):
    """csrc/param_eval.cu, block by block: block (r, y) decodes row r's
    (npb, offset, kind, clock) words and n, and its threads j = y*256 + tid
    < S*npb each read their block time from row ``clock`` of ``clocks``
    (f64[C, S]; f64[S] is one clock), count the staged times at or before
    their f64 absolute time and evaluate the curve with the kernel's f32/f64
    operations."""
    times, tcs, values, types, boundary = (np.asarray(table[k]) for k in
                                           ("times", "tcs", "values", "types", "boundary"))
    n_all, base, rows = (np.asarray(table[k]) for k in ("n", "base", "rows"))
    clocks = np.atleast_2d(clocks)
    R, cap = times.shape
    S_ = clocks.shape[1]
    out = np.full(table["size"], np.nan, F32)
    max_len = S_ * max(int(r[0]) for r in rows)
    for r in range(R):
        npb, off = int(rows[r, 0]), int(rows[r, 1])
        bt = clocks[int(rows[r, 3])]
        length = S_ * npb
        for y in range(-(-max_len // threads)):
            if y * threads >= length:
                continue
            j = y * threads + np.arange(threads)
            j = j[j < length]
            s, i = j // npb, j % npb
            bts = bt[s]
            fi = i.astype(np.float64)
            io = F32(fi * dt)
            t = _fma64(fi, np.full_like(fi, dt), bts)
            n = int(n_all[r])
            idx = np.minimum((t[:, None] >= times[r][None, :]).sum(1), n)
            prev, nxt = np.maximum(idx - 1, 0), np.minimum(idx, cap - 1)
            has_prev, has_next = idx > 0, idx < n

            def rel(k):
                return F32(np.clip(times[r][k] - bts, -3.0e38, 3.0e38))

            t0r, t1r = rel(prev), rel(nxt)
            v0, v1 = values[r][prev], values[r][nxt]
            denom = t1r - t0r
            safe = np.where(denom == 0, F32(1), denom)
            u = np.clip((io - t0r) / safe, F32(0), F32(1))
            lin = _fmaf(v1 - v0, u, v0)
            with np.errstate(all="ignore"):
                ok = (v0 > 0) & (v1 > 0)
                expv = v0 * F32(np.power((v1 / v0).astype(np.float64), u.astype(np.float64)))
                b = boundary[r][np.minimum(idx, cap)]
                elapsed = io - t0r
                tc = np.maximum(F32(tcs[r][prev]), F32(0.001))
                decay = _fmaf(b - v0, F32(np.exp((-elapsed / tc).astype(np.float64))), v0)
            yn, yp = types[r][nxt], types[r][prev]
            val = np.where(has_next & (yn == 1), lin,
                           np.where(has_next & (yn == 2), np.where(ok, expv, lin),
                                    np.where(yp == 3, np.where(elapsed <= 0, b, decay), v0)))
            val = np.where(has_prev & (n > 0), val, base[r])
            out[off + j] = val
    return out


@pytest.mark.parametrize("step", [0, 5, 11])
def test_k6_table_walk(step):
    table = tpe.pack_param_table(_mixed_entries(seed=2), S)
    bt = _clock(12 * S)[step * S:(step + 1) * S]
    want = tpe.eval_intrinsic_batch(_tensors(table), torch.from_numpy(bt), DT).numpy()
    got = _walk_k6(table, bt, DT)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("step", [0, 7])
def test_k6_table_walk_at_row_clocks(step):
    """A chained graph's table: each entry's lanes at clocks 3, 2, 1, 0, ...
    of a [4, S] clock matrix (the last D + 1 steps, the live one last)."""
    entries = [(key, enc, npb, False, (3 - k - np.arange(int(np.prod(np.shape(enc["base"]),
                                                                     dtype=np.int64)))) % 4)
               for k, (key, enc, npb) in enumerate(_mixed_entries(seed=6))]
    table = tpe.pack_param_table(entries, S)
    assert sorted(set(table["rows"][:, 3].tolist())) == [0, 1, 2, 3]
    clocks = _clock(12 * S)[step * S:(step + 4) * S].reshape(4, S)
    want = tpe.eval_intrinsic_batch(_tensors(table), torch.from_numpy(clocks), DT).numpy()
    got = _walk_k6(table, clocks, DT)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# ---- K8 over the eight types as data -----------------------------------------


def _signal(arena, slot, per_sample):
    """A slot's values as the node's ParamSignal gives them: per_sample()
    f32[V, T] or per_block() f32[V, S]."""
    V = slot.lanes
    if slot.off < 0:
        vals = torch.from_numpy(slot.base).reshape(V, 1)
        return vals.expand(V, S * 128 if per_sample else S)
    sig = tgraph.ParamSignal(_slot_view(arena, slot).reshape(V, -1), slot.npb == 128)
    return sig.per_sample() if per_sample else sig.per_block()


@functools.lru_cache(maxsize=None)
def _k8_run(step=2):
    table, stages = ttab.eight_type_stages(3, S, t_end=8 * S * BLOCK)
    bt = torch.from_numpy(_clock(8 * S)[step * S:(step + 1) * S])
    arena = tpe.eval_intrinsic_batch(_tensors(table), bt, DT)
    ktable = tbq.pack_coefficient_table(stages, S)
    return stages, arena, ktable, tbq.biquad_coefficients_batch(_tensors(ktable), arena, SR)


_jax_dyn = jax.jit(jbq.rbj_coefficients_dyn, static_argnums=(4,))


def _jax_poles(a1, a2):
    a1c, a2c = a1.astype(jnp.complex64), a2.astype(jnp.complex64)
    disc = jnp.sqrt(a1c * a1c - 4.0 * a2c)
    return 0.5 * (-a1c + disc), 0.5 * (-a1c - disc)


_jax_poles = jax.jit(_jax_poles)


@pytest.mark.parametrize("k", range(8), ids=tbq.FILTER_TYPES)
def test_k8_batch_matches_per_stage_and_jax(k):
    stages, arena, ktable, out = _k8_run()
    ftype, slots = stages[k]
    assert ktable["rows"].shape == (sum(s["frequency"].lanes for _, s in stages), 8)
    f = _signal(arena, slots["frequency"], True)
    q = _signal(arena, slots["Q"], True)
    g = _signal(arena, slots["gain"], False)
    want = tbq.biquad_coefficients_plain(ftype, f, q, g, SR)
    for a, b in zip(out[k], want):
        assert a.is_contiguous() and torch.equal(a, b)
    # The JAX package's type-as-data coefficients and its pole split.
    onehot = np.eye(8, dtype=F32)[k]
    fc = np.clip(f.numpy(), 1.0, SR / 2.0).astype(F32)
    qc = np.maximum(q.numpy(), F32(0.001))
    gc = np.repeat(g.numpy(), 128, axis=-1)
    jb0, jb1, jb2, ja1, ja2 = _jax_dyn(onehot, fc, qc, gc, SR)
    for a, w in zip(out[k][:3], (jb0, jb1, jb2)):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= 1e-6 * max(1.0, np.abs(w).max())
    # The poles through the polynomial they define (1 + a1 z^-1 + a2 z^-2):
    # near a double root (frequency clamped at Nyquist) the split turns a
    # one-ulp difference of a1, a2 (XLA's f32 cos against the correctly
    # rounded one) into a larger one of the poles themselves.
    p1, p2 = (t.numpy().astype(np.complex128) for t in out[k][3:])
    for got, w in ((-(p1 + p2), ja1), (p1 * p2, ja2)):
        w = np.asarray(w)
        assert np.abs(got.imag).max() <= 1e-6 and \
            np.abs(got.real - w).max() <= 1e-6 * max(1.0, np.abs(w).max())
    jp1, _ = _jax_poles(ja1, ja2)
    assert (out[k][3].imag >= 0).all() and (np.asarray(jp1).imag >= 0).all()


def _walk_k8(rows, arena, consts, T, n_b, n_p):
    """csrc/biquad.cu, block by block: block (r, s) decodes row r's words,
    thread i reads sample s*128 + i of each source (mode = word & 3, offset
    = word >> 2), A from the quantum's gain once, sin and cos of w0 as glibc
    computes them (``xla_rounding.sincosf``, the kernel's
    ``glibc_sincosf``), and the coefficients and poles in numpy f32 with the
    kernel's operation order."""
    b = np.full((n_b, T), np.nan, F32)
    p = np.full((n_p, T), np.nan, np.complex64)
    i = np.arange(128)

    def source(word, s, ii):
        mode, off = word & 3, word >> 2
        if mode == tbq.SRC_CONST:
            return np.full(np.shape(ii), consts[off], F32)
        return arena[off + s * 128 + ii] if mode == tbq.SRC_ARATE else \
            np.full(np.shape(ii), arena[off + s], F32)

    for r, w in enumerate(rows.astype(np.int64)):
        typ, V = int(w[0]), int(w[6])
        for s in range(T // 128):
            A = F32(np.power(10.0, np.float64(source(w[3], s, 0) * F32(0.025))))
            f = np.minimum(np.maximum(source(w[1], s, i), F32(1)), F32(SR / 2))
            q = np.maximum(source(w[2], s, i), F32(0.001))
            w0 = f * tbq._w0_scale(SR)
            sinw, cosw = (t.numpy() for t in xla_rounding.sincosf(torch.from_numpy(w0)))
            alpha = sinw / (F32(2) * q)
            one = F32(1)
            if typ <= 4:
                a0, a1, a2 = one + alpha, F32(-2) * cosw, one - alpha
                b0, b1, b2 = {
                    0: lambda: ((one - cosw) * F32(0.5), one - cosw, (one - cosw) * F32(0.5)),
                    1: lambda: ((one + cosw) * F32(0.5), -(one + cosw), (one + cosw) * F32(0.5)),
                    2: lambda: (alpha, np.zeros_like(alpha), -alpha),
                    3: lambda: (np.ones_like(alpha), a1, np.ones_like(alpha)),
                    4: lambda: (one - alpha, a1, one + alpha),
                }[typ]()
            elif typ == 5:
                aA, adA = alpha * A, alpha / A
                b0, b1, b2 = one + aA, F32(-2) * cosw, one - aA
                a0, a1, a2 = one + adA, b1, one - adA
            else:
                beta = np.sqrt(A) / q
                ap1, am1 = A + one, A - one
                am1c, ap1c, bs = am1 * cosw, ap1 * cosw, beta * sinw
                if typ == 6:
                    b0, b1, b2 = A * ((ap1 - am1c) + bs), (F32(2) * A) * (am1 - ap1c), \
                        A * ((ap1 - am1c) - bs)
                    a0, a1, a2 = (ap1 + am1c) + bs, F32(-2) * (am1 + ap1c), (ap1 + am1c) - bs
                else:
                    b0, b1, b2 = A * ((ap1 + am1c) + bs), (F32(-2) * A) * (am1 + ap1c), \
                        A * ((ap1 + am1c) - bs)
                    a0, a1, a2 = (ap1 - am1c) + bs, F32(2) * (am1 - ap1c), (ap1 - am1c) - bs
            inv = one / a0
            t = slice(s * 128, s * 128 + 128)
            b[w[4], t], b[w[4] + V, t], b[w[4] + 2 * V, t] = b0 * inv, b1 * inv, b2 * inv
            na1, na2 = a1 * inv, a2 * inv
            d = _fmaf(na1, na1, -(F32(4) * na2))
            sq = np.sqrt(np.abs(d))
            real = d >= 0
            half = F32(0.5)
            p1 = np.where(real, half * (-na1 + sq), half * -na1) + 1j * np.where(real, 0, half * sq)
            p2 = np.where(real, half * (-na1 - sq), half * -na1) + 1j * np.where(real, 0, -(half * sq))
            p[w[5], t], p[w[5] + V, t] = p1.astype(np.complex64), p2.astype(np.complex64)
    return b, p


def test_k8_table_walk():
    stages, arena, ktable, out = _k8_run(step=5)
    b, p = _walk_k8(ktable["rows"], arena.numpy(), ktable["consts"], ktable["frames"],
                    ktable["n_b"], ktable["n_p"])
    for (brow, prow, V), got in zip(ktable["stages"], out):
        want = (b[brow:brow + V], b[brow + V:brow + 2 * V], b[brow + 2 * V:brow + 3 * V],
                p[prow:prow + V], p[prow + V:prow + 2 * V])
        for g, w in zip(got, want):
            g = torch.view_as_real(g).numpy() if g.is_complex() else g.numpy()
            w = w.view(F32).reshape(g.shape) if w.dtype == np.complex64 else w
            assert np.array_equal(g.view(np.int32), w.view(np.int32))


# ---- the step prologue ---------------------------------------------------------


def test_config3_step_makes_one_k6_and_one_k8_call():
    """A step (a row of the render call: config 3's four biquads are one
    pipe, so a call runs its steps and three drain rows) makes one K6 and
    one K8 call, K8's one stage with a type a lane, K6's rows each at its
    lane's clock."""
    ctx = config3_eq_chain(superblock=S, device="cpu")
    steps = 6
    with mock.patch.object(tgraph, "eval_intrinsic_batch", wraps=tgraph.eval_intrinsic_batch) as k6, \
            mock.patch.object(tgraph, "eval_intrinsic_blocked",
                              wraps=tgraph.eval_intrinsic_blocked) as single, \
            mock.patch.object(tnb, "biquad_coefficients_batch",
                              wraps=tnb.biquad_coefficients_batch) as k8:
        out = ctx.render(steps * S * 128)
    D = ctx._compiled.pipe_delay
    assert D == 3
    assert k6.call_count == steps + D and k8.call_count == steps + D
    assert tuple(k6.call_args.args[1].shape) == (D + 1, S)  # the clock matrix
    # The per-encoding path is left only for params without events.
    assert all(c.args[0]["times"].shape[-1] == 0 for c in single.call_args_list)
    table = ctx._encs[tgraph.PARAM_TABLE]
    assert tuple(table["times"].shape) == (8, 32)  # frequency and Q of four biquads
    assert table["rows"][:, 3].tolist() == [3, 2, 1, 0] * 2  # lane i at level i
    assert len(k8.call_args.args[0]["stages"]) == 1
    assert [int(c) for c in k8.call_args.args[0]["rows"][:, 0]] == [0, 5, 5, 1]
    golden = np.load("tests/goldens/config3_biquad_eq_chain.npz")["out"]
    assert np.abs(out - golden[:, :out.shape[1]]).max() < 1e-5


def _filtered(mod, **kw):
    """A looped stereo buffer -> peaking biquad -> gain -> out."""
    rng = np.random.default_rng(21)
    ctx = mod.OfflineAudioContext(sample_rate=SR, superblock=S, **kw)
    sig = (rng.standard_normal(SR // 5) * 0.3).astype(np.float32)
    src = mod.AudioBufferSourceNode(ctx)
    src.buffer = mod.PlayableAudioBuffer.from_stereo_arrays(sig, sig[::-1].copy(), SR)
    src.loop = True
    flt = mod.BiQuadFilterNode(ctx, type=mod.FilterType.PEAKING)
    flt.gain.value = 6.0
    flt.frequency.set_value_at_time(300.0, 0.0)
    flt.frequency.linear_ramp_to_value_at_time(900.0, 0.02)
    gain = mod.GainNode(ctx)
    gain.gain.value = 0.5
    src.connect(flt).connect(gain).connect(ctx.destination)
    src.start(0)
    return ctx, flt, gain


def _more_events(flt):
    """Events after the first 3 steps (0.032 s): the curves up to then do
    not change."""
    flt.frequency.set_value_at_time(900.0, 0.04)
    flt.frequency.linear_ramp_to_value_at_time(4000.0, 0.05)
    flt.frequency.exponential_ramp_to_value_at_time(600.0, 0.07)
    flt.frequency.set_target_at_time(2000.0, 0.075, 0.004)
    flt.q.set_value_at_time(0.7, 0.04)
    flt.q.linear_ramp_to_value_at_time(5.0, 0.06)
    flt.gain.set_value_at_time(-9.0, 0.045)


def test_events_added_between_renders_are_picked_up():
    """Events added after a render (frequency outgrows its capacity, Q and
    the gain get their first events) reach the tables: the render equals
    one of a context that had them from the start, bit for bit."""
    late, flt, _ = _filtered(gat, device="cpu")
    first = late.render(3 * S * 128)
    cap0 = late._encs[tgraph.PARAM_TABLE]["times"].shape[1]
    _more_events(flt)
    second = late.render(5 * S * 128)
    assert late._encs[tgraph.PARAM_TABLE]["times"].shape[1] > cap0
    early, flt_e, _ = _filtered(gat, device="cpu")
    _more_events(flt_e)
    want = early.render(8 * S * 128)
    np.testing.assert_array_equal(np.concatenate([first, second], axis=1), want)
    still, _, _ = _filtered(gat, device="cpu")
    assert np.abs(still.render(8 * S * 128)[:, 3 * S * 128:] - second).max() > 1e-2


def test_constant_value_change_between_renders():
    """A param without events is a constant of the K8 table (the filter's
    gain) or a broadcast view (the gain node's): new values set between
    renders reach both, as in the JAX package."""
    outs = []
    for mod, kw in ((ga, {}), (gat, {"device": "cpu"})):
        ctx, flt, gain = _filtered(mod, **kw)
        first = ctx.render(2 * S * 128)
        flt.gain.value = -12.0
        gain.gain.value = 0.25
        outs.append(np.concatenate([first, ctx.render(3 * S * 128)], axis=1))
        if mod is gat:
            consts = ctx._encs[tgraph.PROLOGUE]["0"]["table"]["consts"]
            assert float(consts[-1]) == -12.0
    want, got = outs
    assert np.abs(got - want).max() < 1e-5 * max(1.0, np.abs(want).max())
    unchanged = _filtered(gat, device="cpu")[0].render(5 * S * 128)
    assert np.abs(unchanged[:, 2 * S * 128:] - got[:, 2 * S * 128:]).max() > 1e-2


def test_type_change_between_renders_matches_jax():
    """A filter type set between renders rebuilds the K8 table: the port
    follows the JAX package across the switch."""
    outs = []
    for mod, kw in ((ga, {}), (gat, {"device": "cpu"})):
        ctx, flt, _ = _filtered(mod, **kw)
        first = ctx.render(2 * S * 128)
        flt.type = mod.FilterType.HIGHSHELF
        outs.append(np.concatenate([first, ctx.render(3 * S * 128)], axis=1))
        if mod is gat:
            rows = ctx._encs[tgraph.PROLOGUE]["0"]["table"]["rows"]
            assert int(rows[0, 0]) == tbq.FILTER_TYPES.index("highshelf")
    want, got = outs
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() < 1e-5 * max(1.0, np.abs(want).max())
