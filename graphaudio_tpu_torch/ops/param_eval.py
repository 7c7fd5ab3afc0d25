"""AudioParam automation encoding and evaluation.

``encode_events`` is the host-side encoder of the JAX package, copied: a
sorted event list becomes fixed-shape numpy arrays (times f64, values f32,
boundary values precomputed). ``eval_intrinsic_blocked`` evaluates the
encoded curve for one superblock; it is K6: csrc/param_eval.cu on a CUDA
tensor, ``eval_intrinsic_blocked_plain`` on a CPU tensor. Both follow the
JAX function (graphaudio_tpu/ops/param_eval.py:175-336, its non-exact
branch): the event index from an f64 ABSOLUTE-time ``>=`` compare, the curve
math in f32 on event times relative to each block start, all four curve
types. The ``exact=True`` branches (f64 k-rate curves and f64 a-rate linear
ramps, used only by playbackRate, delay time and oscillator frequency)
raise and name the ROADMAP items that port them.

Times are float64 (the reference uses doubles for its clock); values float32.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.ops import xla_rounding
from graphaudio_tpu_torch.utils import cudabuild

# Event type codes (parity: AudioParam.cs:369-375).
EVT_SET_VALUE = 0
EVT_LINEAR_RAMP = 1
EVT_EXPONENTIAL_RAMP = 2
EVT_SET_TARGET = 3

_INF = np.float64(np.inf)

_EXACT_TODO = (
    "exact (f64) automation curves are not ported yet: they serve "
    "playbackRate, delay time and oscillator frequency (ROADMAP.md module "
    "items 7, 8 and 10)"
)


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


def eval_intrinsic_blocked_plain(enc, block_times, n_per_block, sample_dt):
    """Plain torch K6 (events present). Returns f32[..., S * n_per_block]."""
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


def eval_intrinsic_blocked(enc, block_times, n_per_block, sample_dt,
                           exact: bool = False):
    """Intrinsic (pre-modulation) param values for one superblock.

    ``enc`` holds tensors; leading lane dims of ``enc["base"]`` (a group's
    stacked lanes) carry through. ``block_times`` is f64[S].
    Returns f32[..., S * n_per_block].
    """
    base = enc["base"]
    S = block_times.shape[0]
    cap = enc["times"].shape[-1]
    if cap == 0:
        # Statically event-free (capacity 0): the base value everywhere —
        # one broadcast view, no per-sample work.
        return base.unsqueeze(-1).expand(*base.shape, S * n_per_block)
    if exact:
        raise NotImplementedError(_EXACT_TODO)
    if block_times.device.type == "cpu":
        return eval_intrinsic_blocked_plain(enc, block_times, n_per_block, sample_dt)
    times, values, tcs, types, boundary, n, base_l = _lanes(enc)
    L = times.shape[0]
    req = cudabuild.require
    req(block_times, "block_times", torch.float64, shape=(S,))
    req(times, "times", torch.float64, shape=(L, cap))
    req(values, "values", torch.float32, shape=(L, cap))
    req(tcs, "tcs", torch.float64, shape=(L, cap))
    req(types, "types", torch.int32, shape=(L, cap))
    req(boundary, "boundary", torch.float32, shape=(L, cap + 1))
    req(n, "n", torch.int32, shape=(L,))
    req(base_l, "base", torch.float32, shape=(L,))
    out = torch.empty((L, S * n_per_block), dtype=torch.float32,
                      device=block_times.device)
    status = cudabuild.load().ga_param_eval(
        times.data_ptr(), values.data_ptr(), tcs.data_ptr(), types.data_ptr(),
        boundary.data_ptr(), n.data_ptr(), base_l.data_ptr(),
        block_times.data_ptr(), L, cap, S, n_per_block, float(sample_dt),
        out.data_ptr(), cudabuild.stream_of(block_times),
    )
    cudabuild.check(status, "ga_param_eval")
    cudabuild.launches["eval_intrinsic_blocked"] += 1
    return out.reshape(*base.shape, S * n_per_block)
