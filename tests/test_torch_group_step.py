"""CPU emulation of the fused voice-group steps K1 (csrc/poly_resample.cu)
and K5 (csrc/unity.cu) against their plain composition.

Each kernel computes a whole group step in one launch: block (span, c, v)
recomputes voice v's plan in f64 in its prologue (every thread the voice's
scalars, thread s quantum s's placement and gates, the active quanta
counted by warp ballots), then writes kSpan quanta of channel c, kPer
consecutive samples a thread; block (0, 0, v) writes the voice's new
state. The numpy walk below follows the kernels block by block with their
op order and torch's rounding rules (rint for torch.round, torch.remainder
as fmod plus the divisor when the signs differ, floor division, truncating
casts; no fused multiply-add), K1's phase r stepped along a thread's
outputs and its taps summed as ((w0*a0 + w1*a1) + w2*a2) + w3*a3. It reads
the packed geometry table the card reads, and must equal the plain
composition (``poly_group_step_plain``, ``unity_group_step_plain``) bit for
bit: audio and every new state field, at superblocks 4, 32 and 64, over
the edge-case groups of graphaudio_tpu_torch/testing/groups.py.
"""

import numpy as np
import pytest
import torch

from graphaudio_tpu_torch.ops.voice_group import GEOM_FIELDS
from graphaudio_tpu_torch.testing import groups

THREADS, SPAN, WARP = 256, 8, 32
PER = SPAN * 128 // THREADS
COL = {name: i for i, name in enumerate(GEOM_FIELDS)}
STEPS = 5


def remainder(a, b):
    """torch.remainder on f64: fmod, plus the divisor when the signs differ."""
    m = np.fmod(a, b)
    return np.where((m != 0) & ((m < 0) != (b < 0)), m + b, m)


def ballot_count(act):
    """The kernels' exclusive count of active quanta: chunks of THREADS
    quanta, a ballot per warp, the warp totals before it, a carry between
    chunks. Returns (before[S], total)."""
    S = act.shape[0]
    before = np.zeros(S, np.int64)
    carry = 0
    for s0 in range(0, S, THREADS):
        chunk = np.zeros(THREADS, np.int64)
        n = min(THREADS, S - s0)
        chunk[:n] = act[s0:s0 + n]
        lanes = chunk.reshape(-1, WARP)
        warp_tot = lanes.sum(axis=1)
        in_warp = np.cumsum(lanes, axis=1) - lanes  # popc(mask & lanes below)
        prev_warps = np.cumsum(warp_tot) - warp_tot
        before[s0:s0 + n] = (carry + prev_warps[:, None] + in_warp).reshape(-1)[:n]
        carry += int(warp_tot.sum())
    return before, carry


def voice_scalars(st, g, v, bt, bet):
    """The prologue's shared part: the active quanta and duration end."""
    f64 = np.float64
    act = (st["started"][v] > 0) & (bet > st["start_time"][v]) & (bt < st["stop_time"][v])
    rate, length = g[v, COL["rate"]], g[v, COL["length"]]
    dur = st["duration"][v]
    de = (np.trunc(f64(st["offset"][v]) * rate) + np.trunc(dur * rate)
          if np.isfinite(dur) else length)
    return act, np.minimum(de, length)


def emulate_poly(st, gtab, bt, bet, arena, wtab, btab):
    """K1, block by block. Returns (x, primed, stop_time, out)."""
    V = gtab.shape[0] - 1
    S = bt.shape[0]
    C, _ = arena.shape
    k = gtab[V]
    p, q, pinv, w = (int(k[i]) for i in range(4))
    inv_q, blk_pq, c127, inv_p = k[4], k[5], k[6], k[7]
    out = np.full((V, C, S * 128), np.nan, np.float32)
    x_new = np.full(V, np.nan)
    stop_new = np.full(V, np.nan)
    primed_new = np.full(V, -1, np.int32)
    for v in range(V):
        for c in range(C):
            for span in range((S + SPAN - 1) // SPAN):
                g = gtab
                act, de = voice_scalars(st, g, v, bt, bet)
                lsf, lef, llen = g[v, COL["lsf"]], g[v, COL["lef"]], g[v, COL["llen"]]
                looping, loop_flag = g[v, COL["looping"]] != 0, g[v, COL["loop_flag"]] != 0
                region_len = int(g[v, COL["region_len"]])
                base = int(g[v, COL["off"]]) + int(g[v, COL["front"]])
                llen1 = max(llen, 1.0)
                p0 = st["pos"][v]
                x0 = st["x"][v] if st["primed"][v] > 0 else p0 + 1.0
                x0 = np.rint(x0 * q) * inv_q
                qmod = remainder(x0 - lsf, llen1)
                e0 = (lsf + llen) + qmod if (looping and x0 >= lsf) else x0
                ef = np.floor(e0)
                A0 = int(ef)
                r0 = int(np.rint((e0 - ef) * q))
                A0 += r0 == q
                r0 = 0 if r0 == q else r0
                j0 = (r0 * pinv) % q
                m0 = (j0 * p - r0) // q
                start = min(max(A0 - m0 - 1, -(p + 8)), region_len - w)
                win_start = base + start
                de_i, lef_i = int(de), int(lef)
                end_bound = min(lef_i, de_i) if loop_flag else de_i
                x0q = np.rint(x0 * q)
                num = (np.float64(end_bound) - 2.0) * q - x0q
                jlim = np.float32(np.floor((num + np.float64(p - 1)) * inv_p))
                # thread s: placement and gates
                before, n_act = ballot_count(act)
                bidx = np.clip(before, 0, S - 1)
                x_b = x0 + bidx.astype(np.float64) * blk_pq
                consumed_b = (p0 + 4.0) + np.floor((x_b - p0) - 1.0)
                blk_valid = looping | (consumed_b < de)
                consumed_after = (p0 + 4.0) + np.floor(((x_b + c127) - p0) - 1.0)
                cleared = act & (not looping) & (consumed_after >= de)
                first_ok = looping | ((bidx * 128).astype(np.float32) < jlim)
                starved = act & (~(blk_valid & first_ok) | cleared)
                ok = act & blk_valid & ~cleared
                if span == 0 and c == 0:
                    fs = np.min(np.where(starved, bet, np.inf))
                    nx = x0 + (np.float64(n_act) * np.float64(128 * p)) * inv_q
                    if looping and nx >= lef:
                        nx = lsf + remainder(nx - lef, llen1)
                    x_new[v] = np.rint(nx * q) * inv_q
                    stop_new[v] = min(st["stop_time"][v], fs)
                    primed_new[v] = 1 if n_act > 0 else st["primed"][v]
                # outputs: thread t owns PER consecutive samples of one
                # quantum (the block's threads as one vector)
                t = np.arange(THREADS)
                s = span * SPAN + t * PER // 128
                live = s < S
                s = np.minimum(s, S - 1)
                i0 = t * PER % 128
                jpos0 = bidx[s] * 128 + i0
                n, r = np.divmod(j0 + jpos0, q)
                y = np.zeros((THREADS, PER), np.float32)
                for u in range(PER):
                    valid = live & ok[s] & (looping | ((jpos0 + u).astype(np.float32) < jlim))
                    at = np.where(valid, win_start + n * p + btab[r], 0)
                    a = [arena[c, at + tap] for tap in range(4)]
                    wr = wtab[r]
                    val = ((wr[:, 0] * a[0] + wr[:, 1] * a[1]) + wr[:, 2] * a[2]) + wr[:, 3] * a[3]
                    y[:, u] = np.where(valid, val, np.float32(0))
                    r = r + 1
                    n = np.where(r == q, n + 1, n)
                    r = np.where(r == q, 0, r)
                o = span * SPAN * 128
                out[v, c, o:o + int(live.sum()) * PER] = y[live].reshape(-1)
    return x_new, primed_new, stop_new, out


def emulate_unity(st, gtab, bt, bet, arena):
    """K5, block by block. Returns (pos, stop_time, out)."""
    V = gtab.shape[0] - 1
    S = bt.shape[0]
    C, W = arena.shape
    w, aligned = int(gtab[V, 0]), gtab[V, 1] != 0
    nrows = W // 128
    out = np.full((V, C, S * 128), np.nan, np.float32)
    pos_new = np.full(V, np.nan)
    stop_new = np.full(V, np.nan)
    i32 = np.int32
    for v in range(V):
        for c in range(C):
            for span in range((S + SPAN - 1) // SPAN):
                g = gtab
                act, de = voice_scalars(st, g, v, bt, bet)
                lsf, lef, llen = g[v, COL["lsf"]], g[v, COL["lef"]], g[v, COL["llen"]]
                looping, loop_flag = g[v, COL["looping"]] != 0, g[v, COL["loop_flag"]] != 0
                region_len = i32(g[v, COL["region_len"]])
                base = i32(g[v, COL["off"]]) + i32(g[v, COL["front"]])
                llen1 = max(llen, 1.0)
                p0 = st["pos"][v]
                qmod = remainder(p0 - lsf, llen1)
                e0 = i32((lsf + llen) + qmod if (looping and p0 >= lsf) else p0)
                e0c = max(e0, 0)
                if aligned:
                    hi = ((region_len - w) // 128) * 128
                    row0, delta = (base + min(e0c, hi)) // 128, 0
                else:
                    abs_start = base + min(e0c, region_len - w)
                    row0 = abs_start // 128
                    delta = abs_start - row0 * 128
                de_i, lef_i = i32(de), i32(lef)
                end_bound = min(lef_i, de_i) if loop_flag else de_i
                before, n_act = ballot_count(act)
                pos_b = p0 + 128.0 * before.astype(np.float64)
                delta_b = (pos_b - p0).astype(i32)
                bidx = np.clip(delta_b // 128, 0, S - 1)
                g0 = i32(p0) + delta_b
                any_valid = looping | (g0 < end_bound)
                pos_after = pos_b + 128.0
                cleared = act & (~any_valid if looping else ((pos_after >= de) | ~any_valid))
                ok = act & ~cleared
                if span == 0 and c == 0:
                    fs = np.min(np.where(cleared, bet, np.inf))
                    npos = p0 + 128.0 * np.float64(n_act)
                    if looping and npos >= lef:
                        npos = lsf + remainder(npos - lef, llen1)
                    pos_new[v] = npos
                    stop_new[v] = min(st["stop_time"][v], fs)
                t = np.arange(THREADS)
                s = span * SPAN + t * PER // 128
                live = s < S
                s = np.minimum(s, S - 1)
                i0 = t * PER % 128
                lo = np.clip(int(row0) + bidx[s].astype(np.int64), 0, nrows - 1)
                hi_row = np.minimum(lo + 1, nrows - 1)
                y = np.zeros((THREADS, PER), np.float32)
                for u in range(PER):
                    i = i0 + u
                    valid = live & ok[s] & (looping | (g0[s].astype(np.int64) + i < end_bound))
                    j = int(delta) + i
                    at = np.where(j < 128, lo * 128 + j, hi_row * 128 + j - 128)
                    y[:, u] = np.where(valid, arena[c, np.where(valid, at, 0)], np.float32(0))
                o = span * SPAN * 128
                out[v, c, o:o + int(live.sum()) * PER] = y[live].reshape(-1)
    return pos_new, stop_new, out


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view({8: np.int64, 4: np.int32}[a.itemsize]) if a.dtype.kind == "f" else a


def _check(got, want, what):
    assert np.array_equal(bits(got), bits(want)), what


def _walk(ctx, steps=STEPS):
    """(numpy states, rc, plain new states, plain out) per step."""
    w, variant, _ = ctx._compiled._bufsrc_cfg[0]
    node = ctx._compiled.stages[0][1][0]
    c = ctx._consts
    for st, rc in groups.group_inputs(ctx, steps):
        if variant[0] == "poly":
            new, out = type(node).process_poly_group(
                st, c["st0/arena"], c["st0/geom"], c["st0/gtab"], rc, w, variant[1],
                variant[2], (c["st0/poly_w"], c["st0/poly_b"]))
        else:
            new, out = type(node).process_unity_group(
                st, c["st0/arena"], c["st0/geom"], c["st0/gtab"], rc, w, aligned=variant[1])
        yield ({k: v.numpy() for k, v in st.items()}, rc.block_times.numpy(),
               rc.block_end_times.numpy(), {k: v.numpy() for k, v in new.items()}, out.numpy())


@pytest.mark.parametrize("superblock", [4, 32, 64])
def test_k1_emulation_matches_plain(superblock):
    ctx = groups.poly_group(superblock, "cpu")
    assert ctx._compiled._bufsrc_cfg[0][1] == ("poly", 147, 160)
    assert ctx._compiled.stage_pad[0] == (len(groups.POLY_VOICES), 8)  # one phantom lane
    c = ctx._consts
    arena, gtab = c["st0/arena"].numpy(), c["st0/gtab"].numpy()
    wtab, btab = c["st0/poly_w"].numpy(), c["st0/poly_b"].numpy()
    primed0 = heard = 0
    for k, (st, bt, bet, new, out) in enumerate(_walk(ctx)):
        x, primed, stop, got = emulate_poly(st, gtab, bt, bet, arena, wtab, btab)
        _check(got, out, f"audio, step {k}")
        _check(x, new["x"], f"x, step {k}")
        _check(primed, new["primed"], f"primed, step {k}")
        _check(stop, new["stop_time"], f"stop_time, step {k}")
        primed0 += int((st["primed"] == 0).sum())
        heard += float(np.abs(out).sum())
    assert primed0 > 0 and heard > 0
    # Both one-shot buffers ran out (the starved gate) and the duration
    # ended mid-superblock (the clear); with the stopped voice, four stops.
    # The late voice and the phantom lane never started.
    assert np.isfinite(stop).sum() == 4
    assert (primed == 0).sum() == 2


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("superblock", [4, 32, 64])
def test_k5_emulation_matches_plain(superblock, aligned):
    ctx = groups.unity_group(superblock, aligned, "cpu")
    specs = groups.UNITY_ALIGNED if aligned else groups.UNITY_UNALIGNED
    assert ctx._compiled._bufsrc_cfg[0][1] == ("unity", aligned)
    assert ctx._compiled.stage_pad[0] == (len(specs), 8)
    c = ctx._consts
    arena, gtab = c["st0/arena"].numpy(), c["st0/gtab"].numpy()
    heard = 0
    for k, (st, bt, bet, new, out) in enumerate(_walk(ctx)):
        pos, stop, got = emulate_unity(st, gtab, bt, bet, arena)
        _check(got, out, f"audio, step {k}")
        _check(pos, new["pos"], f"pos, step {k}")
        _check(stop, new["stop_time"], f"stop_time, step {k}")
        heard += float(np.abs(out).sum())
    assert heard > 0
    # two buffer ends, a duration, two stop() calls
    assert np.isfinite(stop).sum() == 5


def test_group_table_packs_the_geometry():
    ctx = groups.poly_group(4, "cpu")
    geom, gtab = ctx._consts["st0/geom"], ctx._consts["st0/gtab"].numpy()
    V = gtab.shape[0] - 1
    for name in GEOM_FIELDS:
        np.testing.assert_array_equal(gtab[:V, COL[name]],
                                      geom[name].numpy().astype(np.float64), err_msg=name)
    w = ctx._compiled._bufsrc_cfg[0][0]
    np.testing.assert_array_equal(gtab[V, :8], [147, 160, pow(147, -1, 160), w, 1.0 / 160,
                                                128 * 147 / 160, 127.0 * 147 / 160, 1.0 / 147])


def test_cpu_group_step_is_the_plain_composition():
    ctx = groups.unity_group(4, True, "cpu")
    st, rc = next(groups.group_inputs(ctx, 1))
    node = ctx._compiled.stages[0][1][0]
    w = ctx._compiled._bufsrc_cfg[0][0]
    # On a CPU tensor the plain composition runs; it reads geom, not the table.
    a = type(node).process_unity_group(st, ctx._consts["st0/arena"], ctx._consts["st0/geom"],
                                       ctx._consts["st0/gtab"], rc, w, aligned=True)
    b = type(node).unity_group_step_plain(st, ctx._consts["st0/arena"],
                                          ctx._consts["st0/geom"], rc, w, True)
    assert torch.equal(a[1], b[1])
