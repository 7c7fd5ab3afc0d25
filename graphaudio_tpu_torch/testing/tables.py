"""Synthetic K6, K8 and K10b tables for the kernel checks (numpy, from a seed).

``mixed_param_entries`` is a K6 table's input that mixes what the step's
table can hold: a-rate and k-rate rows, capacities 1 to 32, single params
and groups with phantom pad lanes, all four event types, events on block
starts and sample instants. ``eight_type_stages`` is a K8 table's input:
one biquad stage of each filter type, 1 to 4 lanes, its frequency, Q and
gain read from a-rate rows, k-rate rows or constants, frequency past both
clamps and Q below its floor. ``panner_stages`` is a K10b table's input:
two spatial-panner stages under two distance models, each of the 17
params read from an a-rate row, a k-rate row or a constant, one stage
occluded with transmission.
"""

from __future__ import annotations

import numpy as np

from graphaudio_tpu_torch.ops import param_eval as tpe
from graphaudio_tpu_torch.ops.biquad import FILTER_TYPES

SR = 48000
DT = 1.0 / SR
BLOCK = 128 / SR


def block_clock(n_blocks):
    """The reference's accumulated block clock (core/context.py)."""
    return np.add.accumulate(np.full(n_blocks, BLOCK) * (np.arange(n_blocks) > 0))


def _events(rng, n, t_end, lo, hi, types=4):
    """n sorted events cycling through the first ``types`` of the four
    types; a third on block starts, a third on sample instants, the rest
    anywhere."""
    out = []
    for k in range(n):
        where = k % 3
        if where == 0:
            t = float(rng.integers(0, int(t_end / BLOCK))) * BLOCK
        elif where == 1:
            t = float(rng.integers(0, int(t_end * SR))) * DT
        else:
            t = float(rng.uniform(0.0, t_end))
        value = float(rng.uniform(lo, hi)) * (1 if rng.random() > 0.1 else -1)
        out.append(((k + int(rng.integers(0, 4))) % types, t, value,
                    float(rng.uniform(0.0005, 0.02))))
    out.sort(key=lambda e: e[1])
    return out


def param_encoding(rng, real, padded, cap, t_end, lo=0.05, hi=2.0, types=4):
    """A param's numpy encoding: one lane (``real`` None, no lane dims) or
    ``real`` lanes padded to ``padded`` with copies of lane 0 (phantom pad
    lanes, as ``CompiledGraph.encode_params`` stacks a group)."""
    lanes = 1 if real is None else real
    per = []
    for lane in range(lanes):
        n = [cap, max(cap - 3, 1), 1, cap // 2][lane % 4]
        base = float(rng.uniform(lo, hi))
        per.append(tpe.encode_events(base, _events(rng, n, t_end, lo, hi, types), cap))
    if real is None:
        return per[0]
    per += [per[0]] * (padded - real)
    return {k: np.stack([e[k] for e in per]) for k in per[0]}


def mixed_param_entries(seed, t_end):
    """(key, enc, npb) of a mixed K6 table, 21 rows: capacities 1, 4, 16
    and 32, a-rate and k-rate, single params and padded groups; events up
    to ``t_end`` seconds."""
    rng = np.random.default_rng(seed)
    spec = [("st1/single32", None, 1, 32, 128), ("st2/group16", 3, 4, 16, 128),
            ("st3/k1", None, 1, 1, 1), ("st4/group_k4", 2, 2, 4, 1),
            ("st5/group32", 5, 8, 32, 128), ("st6/a4", None, 1, 4, 128),
            ("st7/k32", 4, 4, 32, 1)]
    return [(key, param_encoding(rng, real, padded, cap, t_end), npb)
            for key, real, padded, cap, npb in spec]


def linear_param_entries(seed, t_end):
    """(key, enc, npb) of set values and linear ramps alone (the curves an
    exact row evaluates in f64 at a-rate), a-rate and k-rate, a single
    param and a padded group."""
    rng = np.random.default_rng(seed)
    spec = [("lin/a16", None, 1, 16, 128), ("lin/group_a8", 3, 4, 8, 128),
            ("lin/group_k8", 3, 4, 8, 1)]
    return [(key, param_encoding(rng, real, padded, cap, t_end, types=2), npb)
            for key, real, padded, cap, npb in spec]


def eight_type_stages(seed, superblock, t_end):
    """A K6 table (``pack_param_table``) and the (filter type, slots) of
    eight biquad stages, one of each type, for ``pack_coefficient_table``."""
    rng = np.random.default_rng(seed)
    lanes = [1, 2, 4, 1, 2, 4, 3, 1]
    # (frequency, Q, gain) source kinds per stage: "a" a-rate row, "k"
    # k-rate row, "c" constant (capacity 0)
    kinds = [("a", "a", "c"), ("a", "k", "k"), ("k", "a", "c"), ("a", "c", "a"),
             ("c", "a", "k"), ("a", "a", "k"), ("a", "c", "c"), ("a", "k", "a")]
    ranges = {"frequency": (-100.0, 30000.0), "Q": (0.0002, 9.0), "gain": (-24.0, 24.0)}
    entries, consts = [], {}
    for k, (V, kind) in enumerate(zip(lanes, kinds)):
        for name, kd in zip(("frequency", "Q", "gain"), kind):
            key = f"st{k}/{name}"
            lo, hi = ranges[name]
            if kd == "c":
                base = rng.uniform(max(lo, 0.01), hi, V).astype(np.float32)
                consts[key] = tpe.constant_slot({"base": base}, 128, superblock)
            else:
                # a group's lanes, the last a phantom copy of lane 0
                enc = param_encoding(rng, max(V - 1, 1), V, 16, t_end, lo, hi)
                entries.append((key, enc, 128 if kd == "a" else 1))
    table = tpe.pack_param_table(entries, superblock)
    stages = []
    for k, ftype in enumerate(FILTER_TYPES):
        slots = {n: table["slots"].get(f"st{k}/{n}") or consts[f"st{k}/{n}"]
                 for n in ("frequency", "Q", "gain")}
        stages.append((ftype, slots))
    return table, stages


#: (lo, hi) of each panner param's draws, in GAIN_PARAMS order
_PANNER_RANGES = ((-6.0, 6.0),) * 3 + ((-1.0, 1.0),) * 3 + (
    (0.5, 3.0), (4.0, 20.0), (0.5, 2.0), (30.0, 360.0), (60.0, 360.0), (0.0, 1.0),
    (0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0))


def panner_stages(seed, superblock, t_end, models=(1, 2)):
    """A K6 table (``pack_param_table``) and the (distance model code,
    slots) of two panner stages for ``nodes.spatial.pack_gains_table``:
    stage 0 with 4 lanes (the last a phantom copy of lane 0) and no
    occlusion, stage 1 with 2 lanes, occluded with transmission. Each
    param's source is an a-rate row ("a"), a k-rate row ("k") or a
    constant ("c"); positions ramp, a cone narrows."""
    from graphaudio_tpu_torch.nodes.spatial import GAIN_PARAMS

    rng = np.random.default_rng(seed)
    kinds = ("kkk" "ccc" "ckc" "acc" "a" "c" "ccc",
             "kak" "kcc" "cca" "ckk" "c" "k" "ckc")
    lanes = (4, 2)
    entries, consts = [], {}
    for k, (V, kind) in enumerate(zip(lanes, kinds)):
        for name, kd, (lo, hi) in zip(GAIN_PARAMS, kind, _PANNER_RANGES):
            key = f"st{k}/{name}"
            if name == "occlusion" and k == 0:
                lo = hi = 0.0
            if kd == "c":
                base = rng.uniform(lo, hi, V).astype(np.float32)
                if name.startswith("cone") and name != "coneOuterGain":
                    base[::2] = 360.0  # half the lanes without a cone
                consts[key] = tpe.constant_slot({"base": base}, 1, superblock)
            else:
                enc = param_encoding(rng, max(V - 1, 1), V, 8, t_end, max(lo, 0.01), max(hi, 0.01))
                entries.append((key, enc, 128 if kd == "a" else 1))
    table = tpe.pack_param_table(entries, superblock)
    stages = []
    for k, code in enumerate(models):
        slots = {n: table["slots"].get(f"st{k}/{n}") or consts[f"st{k}/{n}"] for n in GAIN_PARAMS}
        stages.append((code, slots))
    return table, stages
