"""AudioParam automation encoding and evaluation.

``encode_events`` is the host-side encoder of the JAX package, copied: a
sorted event list becomes fixed-shape numpy arrays (times f64, values f32,
boundary values precomputed). ``pack_param_table`` packs every automated
param of a graph's encoding into one table, once per encoding, and
``eval_intrinsic_batch`` evaluates all of it for one superblock into one
f32 arena; it is K6: one launch of csrc/param_eval.cu on CUDA tensors,
``eval_intrinsic_batch_plain`` on CPU tensors. ``eval_intrinsic_blocked``
evaluates one encoding (a one-entry batch on the card). All follow the
JAX function (graphaudio_tpu/ops/param_eval.py:175-336): the event index
from an f64 ABSOLUTE-time ``>=`` compare, the curve math in f32 on event
times relative to each block start, all four curve types. A param flagged
``exact_eval`` (playbackRate, delay time, oscillator frequency: values
that a consumer integrates) takes the exact branches, as rows of their
own kind in the same table: at k-rate the whole curve in f64 at the block
start times (``eval_intrinsic``, rounded once to f32), at a-rate its
linear ramps in f64 (the exponential ramps and setTarget keep the f32
path, as in the reference).

Times are float64 (the reference uses doubles for its clock); values float32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.ops import xla_rounding
from graphaudio_tpu_torch.utils import cudabuild

# Event type codes (parity: AudioParam.cs:369-375).
EVT_SET_VALUE = 0
EVT_LINEAR_RAMP = 1
EVT_EXPONENTIAL_RAMP = 2
EVT_SET_TARGET = 3

_INF = np.float64(np.inf)


def encode_events(base_value, events, capacity):
    """Encode a sorted host-side event list into fixed-shape arrays.

    Args:
      base_value: the param's current base value (reference ``_value``),
        used when no events apply.
      events: sequence of (type, time, value, time_constant) tuples sorted by
        time (the host AudioParam maintains sort order on insert, mirroring
        AudioParam.AddEvent:333-352).
      capacity: static padded event capacity (>= len(events)).

    Returns a dict of numpy arrays:
      times f64[capacity] (padded +inf), values f32, tcs f64,
      types i32, boundary f32[capacity+1], n i32 scalar, base f32 scalar.
    """
    n = len(events)
    if n > capacity:
        raise ValueError(f"event count {n} exceeds capacity {capacity}")
    times = np.full((capacity,), _INF, dtype=np.float64)
    values = np.zeros((capacity,), dtype=np.float32)
    tcs = np.full((capacity,), 1.0, dtype=np.float64)
    types = np.zeros((capacity,), dtype=np.int32)
    boundary = np.full((capacity + 1,), np.float32(base_value), dtype=np.float32)

    b = np.float32(base_value)
    for i, (etype, etime, evalue, etc) in enumerate(events):
        times[i] = etime
        values[i] = evalue
        tcs[i] = etc
        types[i] = etype
        boundary[i] = b
        if etype != EVT_SET_TARGET:
            b = np.float32(evalue)
    boundary[n:] = b

    return {
        "times": times,
        "values": values,
        "tcs": tcs,
        "types": types,
        "boundary": boundary,
        "n": np.int32(n),
        "base": np.float32(base_value),
    }




def _lanes(enc):
    """The encoding's fields with the lane dims flattened: [L, cap] event
    arrays, [L, cap+1] boundary, [L] count and base."""
    cap = enc["times"].shape[-1]
    return (
        enc["times"].reshape(-1, cap), enc["values"].reshape(-1, cap),
        enc["tcs"].reshape(-1, cap), enc["types"].reshape(-1, cap),
        enc["boundary"].reshape(-1, cap + 1), enc["n"].reshape(-1),
        enc["base"].reshape(-1),
    )


def eval_intrinsic(enc, t):
    """The intrinsic param curve at arbitrary f64 times, all in f64 and
    rounded once to f32: the JAX package's ``eval_intrinsic``
    (graphaudio_tpu/ops/param_eval.py:85-172), with the multiply-adds
    XLA contracts (the linear ramp, the setTarget decay) as single fmas.
    ``enc`` holds tensors, any leading lane dims; t f64[T]. Returns
    f32[..., T]. The step's k-rate exact rows are this curve at the block
    start times (K6 evaluates them on the card)."""
    times, values, tcs, types, boundary, n, base = _lanes(enc)
    L, cap = times.shape
    T = t.shape[0]
    lead = enc["base"].shape
    f64 = torch.float64
    if cap == 0:
        return base[:, None].expand(L, T).reshape(*lead, T)
    # idx = number of events with event.time <= t (AudioParam.cs:181)
    idx = torch.minimum((t[None, :, None] >= times[:, None, :]).sum(-1), n[:, None].long())
    prev = torch.clamp(idx - 1, min=0)
    nxt = torch.clamp(idx, max=cap - 1)
    has_prev = idx > 0
    has_next = idx < n[:, None]
    next_type = torch.where(has_next, torch.gather(types, 1, nxt), -1)
    prev_type = torch.gather(types, 1, prev)
    t0 = torch.gather(times, 1, prev)
    t1 = torch.gather(times, 1, nxt)
    v0 = torch.gather(values, 1, prev).to(f64)
    v1 = torch.gather(values, 1, nxt).to(f64)
    one = torch.ones((), dtype=f64, device=t.device)
    zero = torch.zeros((), dtype=f64, device=t.device)
    # Linear interpolation (AudioParam.cs:219-225): u clamped to [0, 1];
    # the +inf padding sanitized as the reference does.
    t0s = torch.where(torch.isfinite(t0), t0, zero)
    t1s = torch.where(torch.isfinite(t1), t1, t0s + 1.0)
    denom = t1s - t0s
    safe_denom = torch.where(denom == 0.0, one, denom)
    u = torch.clamp((t - t0s) / safe_denom, 0.0, 1.0)
    lin = xla_rounding.fma64(v1 - v0, u, v0)
    # Exponential interpolation (AudioParam.cs:227-237); linear when either
    # endpoint is <= 0.
    exp_ok = (v0 > 0.0) & (v1 > 0.0)
    safe_v0 = torch.where(exp_ok, v0, one)
    safe_v1 = torch.where(exp_ok, v1, one)
    exp_val = torch.where(exp_ok, safe_v0 * torch.pow(safe_v1 / safe_v0, u), lin)
    # SetTarget decay from the boundary value (AudioParam.cs:239-247).
    bl = torch.gather(boundary, 1, idx).to(f64)
    elapsed = t - t0s
    tc = torch.clamp(torch.gather(tcs, 1, prev), min=0.001)
    decay = xla_rounding.fma64(bl - v0, torch.exp(-torch.clamp(elapsed, min=0.0) / tc), v0)
    settarget_val = torch.where(elapsed <= 0.0, bl, decay)
    val = torch.where(
        has_next & (next_type == EVT_LINEAR_RAMP),
        lin,
        torch.where(
            has_next & (next_type == EVT_EXPONENTIAL_RAMP),
            exp_val,
            torch.where(prev_type == EVT_SET_TARGET, settarget_val, v0),
        ),
    )
    val = torch.where(has_prev & (n[:, None] > 0), val, base[:, None].to(f64))
    return val.float().reshape(*lead, T)


def eval_intrinsic_blocked_plain(enc, block_times, n_per_block, sample_dt, exact=False):
    """Plain torch K6 (events present). Returns f32[..., S * n_per_block].
    ``exact``: the reference's exact branches (graphaudio_tpu/ops/
    param_eval.py:213-222, :287-306), at k-rate ``eval_intrinsic`` at the
    block times, at a-rate the linear ramps in f64."""
    if exact and n_per_block == 1:
        return eval_intrinsic(enc, block_times)
    times, values, tcs, types, boundary, n, base = _lanes(enc)
    L, cap = times.shape
    S = block_times.shape[0]
    dev = block_times.device
    f64 = torch.float64
    # Per-block f64 -> f32 relative event times (+inf padding -> large
    # finite so the f32 arithmetic below stays NaN-free).
    rel = torch.clamp(times[:, None, :] - block_times[None, :, None],
                      -3.0e38, 3.0e38).float()  # [L, S, cap]
    i = torch.arange(n_per_block, dtype=f64, device=dev)
    io = (i * sample_dt).float()  # [n]
    # idx = number of events with event.time <= t, compared in f64
    # ABSOLUTE time (AudioParam.cs:181): t = blockTime + i*deltaTime, which
    # XLA fuses into one fma (an event on a sample instant hinges on it).
    ts = xla_rounding.fma64(i[None, :], torch.full_like(i, sample_dt)[None, :],
                            block_times[:, None])  # [S, n]
    ge = ts[None, :, :, None] >= times[:, None, None, :]  # [L, S, n, cap]
    idx = torch.minimum(ge.sum(-1).to(torch.int32), n[:, None, None])
    prev = torch.clamp(idx - 1, min=0).long()
    nxt = torch.clamp(idx, max=cap - 1).long()
    has_prev = idx > 0
    has_next = idx < n[:, None, None]

    def pick(table, at):  # table [L, cap] or [L, S, cap] -> [L, S, n]
        if table.dim() == 2:
            table = table[:, None, :].expand(L, S, table.shape[-1])
        return torch.gather(table, 2, at)

    t0r, t1r = pick(rel, prev), pick(rel, nxt)
    v0, v1 = pick(values, prev), pick(values, nxt)
    next_type, prev_type = pick(types, nxt), pick(types, prev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    # Linear interpolation (AudioParam.cs:219-225): u clamped to [0,1].
    denom = t1r - t0r
    safe_denom = torch.where(denom == 0.0, one, denom)
    u = torch.clamp((io - t0r) / safe_denom, 0.0, 1.0)
    lin = xla_rounding.fma(v1 - v0, u, v0)
    if exact:
        # The ramp in f64 absolute time, rounded once (AudioParam.cs:219-225
        # does all of it in doubles); the exponential fallback below takes
        # this value too, as in the reference.
        times_f = torch.where(torch.isfinite(times), times, torch.zeros((), dtype=f64,
                                                                        device=dev))
        t0a, t1a = pick(times_f, prev), pick(times_f, nxt)
        v0a, v1a = v0.to(f64), v1.to(f64)
        den = t1a - t0a
        den = torch.where(den == 0.0, torch.ones((), dtype=f64, device=dev), den)
        # Here XLA leaves blockTime + i*deltaTime uncontracted: a rounded
        # product, then a rounded sum.
        ts_u = block_times[:, None] + i[None, :] * sample_dt
        u64 = torch.clamp((ts_u[None] - t0a) / den, 0.0, 1.0)
        lin = xla_rounding.fma64(v1a - v0a, u64, v0a).float()
    # Exponential interpolation (AudioParam.cs:227-237); linear when either
    # endpoint is <= 0.
    exp_ok = (v0 > 0.0) & (v1 > 0.0)
    safe_v0 = torch.where(exp_ok, v0, one)
    safe_v1 = torch.where(exp_ok, v1, one)
    exp_val = torch.where(exp_ok, safe_v0 * xla_rounding.pow(safe_v1 / safe_v0, u), lin)
    # SetTarget decay from the boundary value (AudioParam.cs:239-247).
    bl = pick(boundary, torch.clamp(idx, max=cap).long())
    elapsed = io - t0r
    tc = torch.clamp(pick(tcs.float(), prev), min=0.001)
    decay = xla_rounding.fma(bl - v0, xla_rounding.exp(-torch.clamp(elapsed, min=0.0) / tc), v0)
    settarget_val = torch.where(elapsed <= 0.0, bl, decay)

    val = torch.where(
        has_next & (next_type == EVT_LINEAR_RAMP),
        lin,
        torch.where(
            has_next & (next_type == EVT_EXPONENTIAL_RAMP),
            exp_val,
            torch.where(prev_type == EVT_SET_TARGET, settarget_val, v0),
        ),
    )
    b = base[:, None, None]
    val = torch.where(has_prev & (n[:, None, None] > 0), val, b)
    return val.reshape(*enc["base"].shape, S * n_per_block)


# ---- K6: the batched step table ---------------------------------------------


#: Words of a K6 table row: npb, arena offset, kind (1 = exact), clock (the
#: row of the step's clock matrix it is evaluated at).
ROW_WORDS = 4


@dataclass(frozen=True, eq=False)
class ParamSlot:
    """Where one param's values for a step lie. A param with events owns
    ``lanes`` consecutive rows of the step's K6 arena from ``off``, each
    ``per_lane`` = S * ``npb`` floats; a param without events (capacity 0)
    owns none (``off`` = -1) and is its per-lane ``base`` value."""

    off: int
    npb: int
    per_lane: int
    shape: Tuple[int, ...]  # lead (lane) dims of the encoding
    base: np.ndarray  # f32[lanes]

    @property
    def lanes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


def pack_param_table(entries, superblock: int, reserved=()):
    """The K6 table of one encoding: every (key, enc, npb), (key, enc,
    npb, exact) or (key, enc, npb, exact, clock) in ``entries`` (numpy
    encodings with capacity > 0; exact False and clock 0 when left out;
    ``clock`` one int for all lanes or one a lane) becomes one row per
    lane, its event
    fields padded to the batch's largest capacity as ``encode_events`` pads
    them (times +inf, values 0, tcs 1, types 0, ``boundary`` repeating its
    last value), which changes no output: padded times are never counted and
    the index never passes a row's own ``n``. Each (key, npb, lane shape)
    in ``reserved`` gets arena rows after all of those and no table row:
    K6 never writes them. They hold a modulated param that a prologue
    batch reads (K8's or K10b's), which K6m writes at its stage's turn in
    the step (``apply_modulation(..., out=)``).

    Returns a dict of numpy arrays, ``times`` f64[R, cap], ``tcs`` f64,
    ``values`` f32, ``types`` i32, ``boundary`` f32[R, cap+1], ``n`` i32[R],
    ``base`` f32[R], ``rows`` i32[R, 4] (``npb``, arena offset, the kind:
    1 for the exact branch, else 0, and the clock: the row of the step's
    clock matrix that the row is evaluated at), and three
    host fields: ``size``, the arena's length in floats, ``slots``, the
    ``ParamSlot`` of each key, and ``reserved``, the ``ParamSlot`` of each
    reserved key.
    """
    cap = max((e[1]["times"].shape[-1] for e in entries), default=0)
    fields = {"times": [], "tcs": [], "values": [], "types": [], "boundary": [],
              "n": [], "base": [], "rows": []}
    slots = {}
    off = 0
    for key, enc, npb, *extra in entries:
        exact = bool(extra and extra[0])
        times, values, tcs, types, boundary, n, base = _lanes(enc)
        L, c = times.shape
        clock = np.broadcast_to(np.asarray(extra[1] if len(extra) > 1 else 0), (L,))
        pad = ((0, 0), (0, cap - c))
        fields["times"].append(np.pad(times, pad, constant_values=_INF))
        fields["tcs"].append(np.pad(tcs, pad, constant_values=1.0))
        fields["values"].append(np.pad(values, pad))
        fields["types"].append(np.pad(types, pad))
        fields["boundary"].append(np.pad(boundary, pad, mode="edge"))
        fields["n"].append(n)
        fields["base"].append(base)
        per_lane = superblock * npb
        fields["rows"].append(np.stack(
            [np.full(L, npb), off + per_lane * np.arange(L), np.full(L, int(exact)), clock],
            axis=1))
        slots[key] = ParamSlot(off, npb, per_lane, tuple(np.shape(enc["base"])),
                               np.asarray(base, np.float32))
        off += L * per_lane
    held = {}
    for key, npb, shape in reserved:
        lanes = int(np.prod(shape, dtype=np.int64))
        held[key] = ParamSlot(off, npb, superblock * npb, tuple(shape),
                              np.zeros(lanes, np.float32))
        off += lanes * superblock * npb
    if off >= 2 ** 31:
        raise ValueError(f"the K6 arena of {off} floats needs 64-bit offsets")
    dtypes = {"times": np.float64, "tcs": np.float64, "values": np.float32,
              "types": np.int32, "boundary": np.float32, "n": np.int32,
              "base": np.float32, "rows": np.int32}
    widths = {"n": (), "base": (), "rows": (ROW_WORDS,), "boundary": (cap + 1,)}
    table = {
        k: (np.concatenate(v).astype(dtypes[k]) if v
            else np.zeros((0, *widths.get(k, (cap,))), dtypes[k]))
        for k, v in fields.items()
    }
    table["size"] = off
    table["slots"] = slots
    table["reserved"] = held
    return table


def constant_slot(enc, npb: int, superblock: int) -> ParamSlot:
    """The slot of a param without events (capacity 0): its base values."""
    base = np.asarray(enc["base"], np.float32)
    return ParamSlot(-1, npb, superblock * npb, base.shape, base.reshape(-1))


# Where a batched prologue kernel (K8, K10b) reads a param: a source word
# ``off << 2 | mode`` per lane. SRC_ARATE: the lane's a-rate row of the K6
# arena from ``off`` (sample t at off + t); SRC_KRATE: its k-rate row
# (quantum s at off + s); SRC_CONST: ``consts[off]``, the lane's base value
# of a param without events.
SRC_ARATE, SRC_KRATE, SRC_CONST = 0, 1, 2


def source_words(slot: ParamSlot, consts: list):
    """One source word per lane of a ``ParamSlot``; a constant slot's base
    values are appended to ``consts``."""
    if slot.off < 0:
        first = len(consts)
        consts.extend(slot.base.tolist())
        return [((first + v) << 2) | SRC_CONST for v in range(slot.lanes)]
    mode = SRC_ARATE if slot.npb == FRAMES_PER_BLOCK else SRC_KRATE
    return [((slot.off + v * slot.per_lane) << 2) | mode for v in range(slot.lanes)]


def _table_fields(table):
    return (table["times"], table["values"], table["tcs"], table["types"],
            table["boundary"], table["n"], table["base"], table["rows"])


def _clock_matrix(clocks):
    """A step's clocks as f64[C, S]: one row of block times ([S]) is [1, S]."""
    return clocks if clocks.dim() == 2 else clocks[None]


def eval_intrinsic_batch_plain(table, clocks, sample_dt):
    """Plain torch K6 over a ``pack_param_table`` table (tensors): each
    row's curve at the block times of its clock (row ``clock`` of
    ``clocks`` f64[C, S]; f64[S] is one clock), ``eval_intrinsic_blocked_plain``
    over the rows of each (``npb``, kind, clock), written at the row's
    arena offset. Returns f32[size]."""
    times, values, tcs, types, boundary, n, base, rows = _table_fields(table)
    clocks = _clock_matrix(clocks)
    S = clocks.shape[1]
    out = torch.empty(table["size"], dtype=torch.float32, device=clocks.device)
    rows_h = rows.cpu()
    for npb, kind, clock in torch.unique(rows_h[:, [0, 2, 3]], dim=0).tolist():
        sel = torch.nonzero((rows_h[:, 0] == npb) & (rows_h[:, 2] == kind)
                            & (rows_h[:, 3] == clock)).flatten()
        sub = {"times": times[sel], "values": values[sel], "tcs": tcs[sel],
               "types": types[sel], "boundary": boundary[sel], "n": n[sel], "base": base[sel]}
        vals = eval_intrinsic_blocked_plain(sub, clocks[clock], npb, sample_dt, exact=bool(kind))
        at = rows_h[sel, 1].long()[:, None] + torch.arange(S * npb)
        out[at.flatten().to(out.device)] = vals.flatten()
    return out


def _launch_k6(times, values, tcs, types, boundary, n, base, rows, clocks,
               max_len, sample_dt, out):
    """csrc/param_eval.cu over R rows of ``cap`` events at the clocks
    f64[C, S] (no checks)."""
    R, cap = times.shape
    status = cudabuild.launcher("ga_param_eval_batch")(
        times.data_ptr(), values.data_ptr(), tcs.data_ptr(), types.data_ptr(),
        boundary.data_ptr(), n.data_ptr(), base.data_ptr(), rows.data_ptr(),
        clocks.data_ptr(), R, cap, clocks.shape[-1], max_len, float(sample_dt),
        out.data_ptr(), cudabuild.stream_of(clocks),
    )
    cudabuild.check(status, "ga_param_eval_batch")
    cudabuild.launches["eval_intrinsic_batch"] += 1


def _require_table(times, values, tcs, types, boundary, n, base, rows, clocks):
    R, cap = times.shape
    req = cudabuild.require
    req(clocks, "clocks", torch.float64, ndim=2)
    req(times, "times", torch.float64, shape=(R, cap))
    req(values, "values", torch.float32, shape=(R, cap))
    req(tcs, "tcs", torch.float64, shape=(R, cap))
    req(types, "types", torch.int32, shape=(R, cap))
    req(boundary, "boundary", torch.float32, shape=(R, cap + 1))
    req(n, "n", torch.int32, shape=(R,))
    req(base, "base", torch.float32, shape=(R,))
    req(rows, "rows", torch.int32, shape=(R, ROW_WORDS))


def eval_intrinsic_batch(table, clocks, sample_dt):
    """K6: every row of a ``pack_param_table`` table for one superblock, in
    one launch, each row at its own clock (a row of ``clocks`` f64[C, S],
    a contiguous view; f64[S] is one clock); see
    ``eval_intrinsic_batch_plain``. CPU tensors take the plain version;
    CUDA tensors launch csrc/param_eval.cu. Returns the arena f32[size]; a
    param's values are its slot's rows."""
    if clocks.device.type == "cpu":
        return eval_intrinsic_batch_plain(table, clocks, sample_dt)
    clocks = _clock_matrix(clocks)
    fields = _table_fields(table)
    _require_table(*fields, clocks)
    out = torch.empty(table["size"], dtype=torch.float32, device=clocks.device)
    max_len = clocks.shape[1] * max((s.npb for s in table["slots"].values()), default=0)
    if max_len:
        _launch_k6(*fields, clocks, max_len, sample_dt, out)
    return out


@functools.lru_cache(maxsize=64)
def _uniform_rows(L: int, npb: int, S: int, exact: bool, device: torch.device):
    """The ``rows`` of L lanes of one param: (npb, l * S * npb, kind, clock
    0), on the card once per shape."""
    return torch.tensor([[npb, lane * S * npb, int(exact), 0] for lane in range(L)],
                        dtype=torch.int32, device=device)


def eval_intrinsic_blocked(enc, block_times, n_per_block, sample_dt,
                           exact: bool = False):
    """Intrinsic (pre-modulation) param values for one superblock.

    ``enc`` holds tensors; leading lane dims of ``enc["base"]`` (a group's
    stacked lanes) carry through. ``block_times`` is f64[S].
    Returns f32[..., S * n_per_block]. On CUDA tensors a one-entry K6 batch
    on the encoding's own fields (rows of the exact kind with ``exact``).
    """
    base = enc["base"]
    S = block_times.shape[0]
    cap = enc["times"].shape[-1]
    if cap == 0:
        # Statically event-free (capacity 0): the base value everywhere —
        # one broadcast view, no per-sample work.
        return base.unsqueeze(-1).expand(*base.shape, S * n_per_block)
    if block_times.device.type == "cpu":
        return eval_intrinsic_blocked_plain(enc, block_times, n_per_block, sample_dt, exact)
    times, values, tcs, types, boundary, n, base_l = _lanes(enc)
    rows = _uniform_rows(times.shape[0], n_per_block, S, bool(exact), block_times.device)
    clocks = block_times[None]
    _require_table(times, values, tcs, types, boundary, n, base_l, rows, clocks)
    out = torch.empty((times.shape[0], S * n_per_block), dtype=torch.float32,
                      device=block_times.device)
    _launch_k6(times, values, tcs, types, boundary, n, base_l, rows, clocks,
               S * n_per_block, sample_dt, out)
    return out.reshape(*base.shape, S * n_per_block)


# ---- K6m: modulation ---------------------------------------------------------


def apply_modulation_plain(intr, mod, min_value, max_value, a_rate: bool):
    """Plain torch K6m, the JAX package's ``apply_modulation``
    (graphaudio_tpu/ops/param_eval.py:339) as graph.py applies it:
    ``clamp(intr + mono(mod), min, max)``. intr: f32[V, L] (L = T a-rate,
    S k-rate; any strides); mod: f32[V, Cm, T]. The mono signal is channel
    0, or the channels summed in order times fl32(1/sqrt(Cm)) as
    ``adapt_channels(x, 1)`` does, whose multiply XLA contracts with the
    add into one fma. A k-rate param reads the modulation at sample 0 of
    each quantum."""
    Cm = mod.shape[1]
    acc = mod[:, 0]
    for c in range(1, Cm):
        acc = acc + mod[:, c]
    if not a_rate:
        acc = acc[:, ::FRAMES_PER_BLOCK]
    if Cm == 1:
        x = intr + acc
    else:
        scale = torch.tensor(np.float32(1.0 / np.sqrt(Cm)), device=mod.device)
        x = xla_rounding.fma(acc, scale, intr)
    return torch.clamp(x, float(np.float32(min_value)), float(np.float32(max_value)))


def apply_modulation(intr, mod, min_value, max_value, a_rate: bool, out=None):
    """K6m: a param's values with its modulation added and clamped; the
    contract of ``apply_modulation_plain``, bit for bit. ``intr`` may be
    the broadcast view of one base value per lane (stride 0 along time):
    the kernel reads the base values, nothing is copied. ``out``, a
    contiguous f32[V, L] (a param's reserved rows of the step's K6 arena),
    takes the result in place of a new tensor and is returned. CPU tensors
    take the plain version; CUDA tensors launch csrc/param_eval.cu."""
    if mod.device.type == "cpu":
        res = apply_modulation_plain(intr, mod, min_value, max_value, a_rate)
        return res if out is None else out.copy_(res)
    cudabuild.require(mod, "mod", torch.float32, ndim=3)
    V, Cm, T = mod.shape
    L = T if a_rate else T // FRAMES_PER_BLOCK
    if intr.shape != (V, L):
        raise ValueError(f"intr must be [{V}, {L}], got {tuple(intr.shape)}")
    if intr.stride(-1) == 0 and intr.select(-1, 0).is_contiguous():
        src, rows = intr.select(-1, 0), 0
    else:
        src, rows = intr, 1
    cudabuild.require(src, "intr", torch.float32)
    if out is None:
        out = torch.empty((V, L), dtype=torch.float32, device=mod.device)
    cudabuild.require(out, "out", torch.float32, shape=(V, L))
    scale = float(np.float32(1.0 / np.sqrt(Cm)))
    status = cudabuild.launcher("ga_apply_modulation")(
        src.data_ptr(), rows, mod.data_ptr(), V, Cm, T, L,
        FRAMES_PER_BLOCK if a_rate else 1, scale, float(np.float32(min_value)),
        float(np.float32(max_value)), out.data_ptr(), cudabuild.stream_of(mod))
    cudabuild.check(status, "ga_apply_modulation")
    cudabuild.launches["apply_modulation"] += 1
    return out
