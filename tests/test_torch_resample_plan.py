"""CPU walk of K7 (csrc/resample.cu) against its plain version.

K7 computes a time-varying-rate voice group's whole step in one launch.
Block (span, c, v) plans voice v's quanta up to its span in one warp (warp
1 computes the voice's scalars meanwhile): the quanta's clocks and rates
staged at entry; a lane a quantum for the rates and advances; lane r
summing run r of 16 in order and the runs' carries a shuffle chain in run
order (passes of 32 runs); lanes 0-7 taking the span's quanta (anchors,
bands, gates), lane 0 asking the L2 for the span's tap range. Warp w
then writes quantum w of
the span, lane i its outputs i, i + 32, i + 64, i + 96, each sub-chunk's
f64 anchor computed by one lane. Block (0, 0, v) plans every quantum, and
its warps 1-7 take the new state's sums while warp 0 plans the span:
first_stop by warp mins over every quantum's gates (a thread a quantum),
the new x from runs of 32 (lane q of warp 1 continues run q's first 16
from their run sum), combined in order. The voice's rate / sample_rate
comes from the packed table's own column, divided on the host.

The numpy walk below follows those steps block by block in the kernel's
op order (f64 fmas correctly rounded, f32 fmas as the plain version rounds
them, torch's rounding rules) and must equal
``resample_group_step_plain`` bit for bit: audio, x, primed and
stop_time, at superblocks 1, 4, 16, 17, 32, 33, 64 and 513 (two passes of
the plan's run loop), with the playbackRate as rows and as one base value
a voice (a stride-0 view), over the edge-case group of
graphaudio_tpu_torch/testing/groups.py. Every tap the walk reads lies in
the range its block prefetches into L2 (the span's quanta from floor(ub) -
1 to floor(ub + 127 rate) + 3); so does every tap the plain version reads:
with the arena outside a span's ranges turned to NaN, the plain version's
audio of that span does not change.
"""

import numpy as np
import pytest
import torch

from graphaudio_tpu_torch.ops import xla_rounding
from graphaudio_tpu_torch.ops.resample import cr_weights_fma
from graphaudio_tpu_torch.ops.voice_group import GEOM_COLS, GEOM_FIELDS, RESAMPLE_COLS
from graphaudio_tpu_torch.testing import groups

SPAN, RUN, SUM_RUN, WARP, HOP = 8, 16, 32, 32, 64
PREFETCH_MAX = 16384  # a quantum's tap range the kernel asks the L2 for, at most
COL = {name: i for i, name in enumerate(GEOM_FIELDS)}
RATIO = GEOM_COLS
W_, CAP, TILE, N_TILES = 0, 1, 2, 3  # the constants row


def remainder(a, b):
    """torch.remainder on f64: fmod, plus the divisor when the signs differ."""
    m = np.fmod(a, b)
    return m + b if (m != 0 and ((m < 0) != (b < 0))) else m


def fma64(a, b, c):
    """The card's f64 ``fma``, correctly rounded."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64))  # noqa: E731
    a, b, c = np.broadcast_arrays(a, b, c)
    return xla_rounding.fma64(t(a), t(b), t(c)).numpy()


def fma32(a, b, c):
    """``fmaf`` as the plain version rounds it (xla_rounding.fma)."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    a, b, c = np.broadcast_arrays(a, b, c)
    return xla_rounding.fma(t(a), t(b), t(c)).numpy()


def voice_plan(st, gtab, v):
    """Warp 0's scalars of voice v, the plain version's op order; the
    divide taken from the table's own column."""
    g, k = gtab[v], gtab[-1]
    f64 = np.float64
    rate, length, lsf, lef, llen = (g[COL[n]] for n in ("rate", "length", "lsf", "lef", "llen"))
    looping, loop_flag = g[COL["looping"]] != 0, g[COL["loop_flag"]] != 0
    dur = f64(st["duration"][v])
    de = (np.trunc(f64(st["offset"][v]) * rate) + np.trunc(dur * rate)
          if np.isfinite(dur) else length)
    de = np.minimum(de, length)
    llen1 = max(llen, f64(1.0))
    p0 = f64(st["pos"][v])
    x0 = f64(st["x"][v]) if st["primed"][v] > 0 else p0 + 1.0
    e0 = (lsf + llen) + remainder(x0 - lsf, llen1) if (looping and x0 >= lsf) else x0
    start = min(max(int(np.floor(e0)) - 1, 0), int(g[COL["region_len"]]) - int(k[W_]))
    de_i, lef_i = int(de), int(lef)
    shift = int(np.rint(x0 - e0)) + start
    end_bound = min(lef_i, de_i) if loop_flag else de_i
    # an output plays while its int32 base <= lim (base + shift + 2 <= end_bound - 1)
    lim = 2**31 - 1 if looping else int(np.clip(end_bound - 3 - shift, -2**31, 2**31 - 1))
    return dict(
        x0=x0, p0=p0, p4=p0 + 4.0, de=de, lsf=lsf, lef=lef, llen1=llen1, looping=looping,
        e0s=e0 - f64(start), win0=int(g[COL["off"]]) + int(g[COL["front"]]) + start,
        shift=shift, end_bound=end_bound, lim=lim,
        ratio=g[RATIO], cap=k[CAP], tile=int(k[TILE]), n_tiles=int(k[N_TILES]),
        started=st["started"][v] > 0, start_time=f64(st["start_time"][v]),
        stop_time=f64(st["stop_time"][v]), primed=int(st["primed"][v]))


def advances(p, rates_v, bt, bet):
    """A lane a quantum: (act, rb, adv) of every quantum."""
    act = p["started"] & (bet > p["start_time"]) & (bt < p["stop_time"])
    rb = p["ratio"] * rates_v.astype(np.float64)
    rb = np.where(rb > p["cap"], p["cap"], rb)
    return act, rb, np.where(act, 128.0 * rb, 0.0)


def run_sums(adv):
    """XLA's cumsum as the plan warp takes it: lane r sums run r of 16 in
    order; lane r's carry adds the runs before it, one shuffle at a time in
    run order, onto the carry of the passes (32 runs) before. Returns
    (pre, carry): the inclusive sums within runs, each run's carry."""
    P = adv.shape[0]
    nruns = -(-P // RUN)
    runs = np.zeros((nruns, RUN))
    runs.reshape(-1)[:P] = adv
    has = (np.arange(nruns * RUN) < P).reshape(nruns, RUN)
    acc = runs[:, 0].copy()
    pre = [acc.copy()]
    for j in range(1, RUN):
        acc = np.where(has[:, j], acc + runs[:, j], acc)
        pre.append(acc.copy())
    pre = np.stack(pre, axis=1).reshape(-1)[:P]
    carry_s = np.zeros(nruns)
    carry = 0.0
    for r0 in range(0, nruns, WARP):
        n = min(WARP, nruns - r0)
        lanes = np.arange(WARP)
        tot = np.zeros(WARP)
        tot[:n] = acc[r0:r0 + n]
        cr = np.full(WARP, carry)
        for j in range(n - 1):
            cr = np.where(lanes > j, cr + tot[j], cr)
        carry_s[r0:r0 + n] = cr[:n]
        carry = cr[31] + tot[31]
    return pre, carry_s


def plan_quanta(p, s, act, rb, adv, pre, carry):
    """Quanta s's anchors and gates (the kernel's plan_quantum)."""
    du = (pre[s] + carry[s // RUN]) - adv[s]
    ub = p["e0s"] + du
    xd = p["x0"] + du
    consumed_b = p["p4"] + np.floor((xd - p["p0"]) - 1.0)
    blk_valid = p["looping"] | (consumed_b < p["de"])
    consumed_after = p["p4"] + np.floor((fma64(127.0, rb[s], xd) - p["p0"]) - 1.0)
    cleared = act[s] & ~p["looping"] & (consumed_after >= p["de"])
    a_int = np.floor(ub)
    a_frac = (ub - a_int).astype(np.float32)
    base0 = a_int.astype(np.int64) + np.floor(a_frac).astype(np.int64)
    any_valid = blk_valid & (p["looping"] | (base0 + p["shift"] + 2 <= p["end_bound"] - 1))
    return dict(ub=ub, xd=xd, a_int=a_int, ok=act[s] & blk_valid & ~cleared,
                starved=act[s] & (~any_valid | cleared), cleared=cleared)


def span_range(q, rb_s):
    """The window samples [lo, hi) the span's taps can touch, which the
    plan warp's lane 0 asks the L2 for: floor(ub) - 1 to floor(ub + 127
    rate) + 3 of each quantum that plays, the last + 1 for the f32
    offsets' rounding."""
    last = np.floor(fma64(127.0, rb_s, q["ub"]))
    keep = (q["ok"] & np.isfinite(q["ub"]) & np.isfinite(last)
            & (last - q["a_int"] <= PREFETCH_MAX))
    if not keep.any():
        return None
    return int((q["a_int"][keep] - 1).min()), int((last[keep] + 4).max())


def span_audio(p, q, rb_s, arena_c):
    """Warp w's 128 outputs of the span's quantum w, lane i its outputs
    i + 32u, each the sum of its four weighted taps in order; returns (y
    f32[n, 128], the window samples read)."""
    i = np.arange(128)
    ub, rb = q["ub"][:, None], rb_s[:, None]
    anchor = fma64((i >> 4).astype(np.float64), 16.0 * rb, ub)
    a_int = np.floor(anchor)
    a_frac = (anchor - a_int).astype(np.float32)
    local = fma32((i & 15).astype(np.float32), rb.astype(np.float32), a_frac)
    bl = np.floor(local)
    frac = local - bl
    base_l = a_int.astype(np.int32) + bl.astype(np.int32)  # int32, as the plain version's
    valid = q["ok"][:, None] & (base_l <= p["lim"])
    m_b = np.clip((q["a_int"].astype(np.int64) - 1) // HOP, 0, p["n_tiles"] - 1)
    row = base_l - (m_b * HOP).astype(np.int32)[:, None]
    wk = [w.numpy() for w in cr_weights_fma(torch.from_numpy(frac))]
    term, read = [], []
    for k in range(4):
        # a tap outside its tile, or of an output that does not play,
        # weighs +0 and reads +0
        inb = valid & ((row + k - 1).astype(np.uint32) < np.uint32(p["tile"]))
        at = np.where(inb, p["win0"] + base_l + k - 1, 0)
        zero = np.float32(0.0)
        term.append(np.where(inb, wk[k], zero) * np.where(inb, arena_c[at], zero))
        read.append((base_l + k - 1)[inb])
    return ((term[0] + term[1]) + term[2]) + term[3], np.concatenate(read)


def walk_k7(st, gtab, rates, arena, bt, bet):
    """K7 block by block. rates: f32[V, S] rows, or f32[V] base values.
    Returns (x, primed, stop_time, out f32[V, C, S*128], ranges, stats):
    ranges[(span, c, v)] = (win0, lo, hi) of each block whose taps count."""
    V, S = gtab.shape[0] - 1, bt.shape[0]
    C = arena.shape[0]
    out = np.zeros((V, C, S * 128), np.float32)
    x, primed, stop = np.zeros(V), np.zeros(V, np.int32), np.zeros(V)
    ranges, stats = {}, dict(late=0, ends_mid_span=0, seams=0)
    for v in range(V):
        p = voice_plan(st, gtab, v)
        rv = rates[v] if rates.ndim == 2 else np.full(S, rates[v], np.float32)
        act, rb, adv = advances(p, rv, bt, bet)
        for span in range(-(-S // SPAN)):
            s = np.arange(span * SPAN, min(S, (span + 1) * SPAN))
            for c in range(C):
                head = span == 0 and c == 0
                P = S if head else min(S, (span + 1) * SPAN)
                pre, carry = run_sums(adv[:P])
                q = plan_quanta(p, s, act, rb, adv, pre, carry)
                rng = span_range(q, rb[s])
                y, read = span_audio(p, q, rb[s], arena[c])
                out[v, c, s[0] * 128:(s[-1] + 1) * 128] = y.reshape(-1)
                if read.size:
                    assert rng is not None and rng[0] <= read.min() and read.max() < rng[1], \
                        (span, c, v, rng, read.min(), read.max())
                if rng is not None:
                    ranges[(span, c, v)] = (p["win0"], *rng)
                if head:
                    x[v], primed[v], stop[v] = write_state(p, act, rb, adv, pre, carry, bet)
            stats["late"] += bool((~act[s]).any() and act[s].any() and act[s][-1])
            stats["ends_mid_span"] += bool(q["ok"].any() and (q["cleared"] | ~q["ok"])[-1]
                                           and not p["looping"])
            if p["looping"] and q["ok"].any():  # the loop's seam inside the span
                lap = np.floor((q["xd"][q["ok"]] - p["lsf"]) / p["llen1"])
                end = q["xd"][q["ok"]] + 127.0 * rb[s][q["ok"]]
                stats["seams"] += bool((np.floor((end - p["lsf"]) / p["llen1"]) > lap).any())
    return x, primed, stop, out, ranges, stats


def write_state(p, act, rb, adv, pre, carry, bet):
    """Block (0, 0, v)'s state: first_stop by warp mins over every
    quantum's gates (warps 1-7, a thread a quantum), then their min; the
    new x from warp 1's lane q, which continues run q of 32 from the run
    sum of its first 16, the runs' sums combined in order."""
    S = adv.shape[0]
    q = plan_quanta(p, np.arange(S), act, rb, adv, pre, carry)
    gated = np.where(q["starved"], bet, np.inf)
    mins = [gated[t::224].min(initial=np.inf) for t in range(224)]
    first_stop = min(min(mins[w * 32:(w + 1) * 32]) for w in range(7))
    sums = []
    for s0 in range(0, S, SUM_RUN):
        s1 = min(S, s0 + SUM_RUN)
        mid = min(s1, s0 + RUN)
        acc = pre[mid - 1]
        for s in range(mid, s1):
            acc = acc + adv[s]
        sums.append(acc)
    total = sums[0]
    for t in sums[1:]:
        total = total + t
    new_x = p["x0"] + total
    if p["looping"] and new_x >= p["lef"]:
        new_x = p["lsf"] + remainder(new_x - p["lef"], p["llen1"])
    stop = p["stop_time"] if np.isnan(p["stop_time"]) else min(p["stop_time"], first_stop)
    return new_x, (1 if act.any() else p["primed"]), stop


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({8: np.int64, 4: np.int32}[a.itemsize]) if a.dtype.kind == "f" else a


# superblock: steps walked (the walk's stats hold a late start, a one-shot
# that ends mid-span and a loop seam at every superblock from 4; 513 is two
# passes of the plan warp's run loop)
STEPS = {1: 6, 4: 6, 16: 3, 17: 3, 32: 3, 33: 3, 64: 3, 513: 1}


@pytest.mark.parametrize("superblock", list(STEPS))
def test_k7_walk_matches_plain(superblock):
    ctx = groups.resample_group(superblock, "cpu")
    w, variant, _ = ctx._compiled._bufsrc_cfg[0]
    assert variant == ("resample", 2)
    node = type(ctx._compiled.stages[0][1][0])
    c = ctx._consts
    arena, geom, gtab = c["st0/arena"], c["st0/geom"], c["st0/gtab"].numpy()
    V = gtab.shape[0] - 1
    assert gtab.shape[1] == RESAMPLE_COLS
    np.testing.assert_array_equal(gtab[:V, RATIO], gtab[:V, COL["rate"]] / np.float64(48000))
    stats = dict(late=0, ends_mid_span=0, seams=0)
    heard = 0.0
    for k, (st, rc) in enumerate(groups.group_inputs(ctx, STEPS[superblock])):
        rows = groups.step_rates(ctx, k)
        sn = {f: t.numpy() for f, t in st.items()}
        bt, bet = rc.block_times.numpy(), rc.block_end_times.numpy()
        base = rows[:, 0].contiguous()
        for rate_pb, rates in ((rows, rows.numpy()),
                               (base[:, None].expand_as(rows), base.numpy())):
            new, want = node.resample_group_step_plain(st, arena, geom, rate_pb, rc, w)
            x, primed, stop, got, ranges, seen = walk_k7(sn, gtab, rates, arena.numpy(), bt, bet)
            where = f"superblock {superblock}, step {k}, {'rows' if rates.ndim == 2 else 'base'}"
            np.testing.assert_array_equal(_bits(got), _bits(want.numpy()), err_msg=where)
            np.testing.assert_array_equal(_bits(x), _bits(new["x"].numpy()), err_msg=where)
            np.testing.assert_array_equal(primed, new["primed"].numpy(), err_msg=where)
            np.testing.assert_array_equal(_bits(stop), _bits(new["stop_time"].numpy()),
                                          err_msg=where)
            heard += float(np.abs(got).sum())
            for key in stats:
                stats[key] += seen[key]
            if k == STEPS[superblock] // 2 and rates.ndim == 2:
                _check_plain_reads_in_ranges(node, st, arena, geom, rows, rc, w, ranges, want)
    assert heard > 0
    if superblock >= 4:  # a span of one quantum has no middle
        assert all(stats.values()), stats


def _check_plain_reads_in_ranges(node, st, arena, geom, rates, rc, w, ranges, want):
    """Per span (at most six of them): the arena NaN outside the span's
    blocks' ranges leaves the plain version's audio of the span as it was."""
    S = rc.block_times.shape[0]
    n_span = -(-S // SPAN)
    spans = range(n_span) if n_span <= 6 else (0, 1, n_span // 2, n_span - 2, n_span - 1)
    C = arena.shape[0]
    for span in spans:
        poisoned = torch.full_like(arena, float("nan"))
        for (sp, c, v), (win0, lo, hi) in ranges.items():
            if sp == span:
                a, b = max(0, win0 + lo), min(arena.shape[1], win0 + hi)
                poisoned[c, a:b] = arena[c, a:b]
        _, got = node.resample_group_step_plain(st, poisoned, geom, rates, rc, w)
        cut = slice(span * SPAN * 128, min(S, (span + 1) * SPAN) * 128)
        assert C == got.shape[1]
        np.testing.assert_array_equal(_bits(got[:, :, cut].numpy()),
                                      _bits(want[:, :, cut].numpy()), err_msg=f"span {span}")
