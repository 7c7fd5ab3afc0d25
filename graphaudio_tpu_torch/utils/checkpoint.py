"""Checkpoint / resume: serialize the full engine state.

The port of graphaudio_tpu/utils/checkpoint.py, with its manifest, format
tag and scratch exclusions. The reference keeps all state (playback
positions, filter states, convolver delay lines, automation event lists)
in-memory only (SURVEY.md §5). Here the engine state is a dict of tensors
(and a few host ints, such as the convolver's ring head) per stage, so
checkpointing is serialization: the state leaves (moved to numpy), the
block clock, and every param's base value + event timeline. Restoring into
a context with the same graph topology resumes rendering bit-exactly where
it left off; the leaves go back to that context's device.

Format: a single .npz with a JSON manifest (no pickle — safe to load). Leaf
paths are written as the JAX package writes them (``['st3']['phase']``); the
two packages' stage states differ in layout, so a file loads only into the
package that saved it.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _is_scratch(path_str: str) -> bool:
    """Leaves excluded from checkpoints: pipeline-fusion working storage
    (register banks + block-time ring — within-render-call scratch whose
    cross-call content is never read; see core/graph.py) and
    config-DERIVED leaves (the biquad's ``__type_sel__`` one-hot), which
    the loader re-derives from the restored graph config at build time.
    Excluding them keeps files smaller and lets these layouts change
    without invalidating existing checkpoints."""
    return (
        "__pipe_bt__" in path_str
        or ".pipe'" in path_str
        or "__type_sel__" in path_str
    )


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict in sorted key order, paths in the JAX
    package's key-string form."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], f"{prefix}[{k!r}]")


def _host(leaf) -> np.ndarray:
    return leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _flatten_states(states):
    arrays = {}
    manifest = []
    i = 0
    for path_str, leaf in _leaves(states):
        if _is_scratch(path_str):
            continue
        arrays[f"leaf_{i}"] = _host(leaf)
        manifest.append(path_str)
        i += 1
    return arrays, manifest


def _rebuild(tree, new, prefix=""):
    """``tree`` with each leaf replaced by ``new[path]``."""
    if not isinstance(tree, dict):
        return new[prefix]
    return {k: _rebuild(v, new, f"{prefix}[{k!r}]") for k, v in tree.items()}


def save_context_state(context, path) -> None:
    """Write a resumable checkpoint of the context's render state."""
    context._ensure_compiled()
    arrays, leaf_paths = _flatten_states(context._states)

    # Nodes are identified by CREATION ORDINAL within the context (ids are
    # process-global monotonic, so sorting by id is creation order) plus the
    # node type: stable across identically-constructed fresh contexts, which
    # raw node_ids are NOT.
    params = []
    for ordinal, node in enumerate(
        sorted(context._nodes.values(), key=lambda n: n.node_id)
    ):
        for name, p in getattr(node, "params", {}).items():
            params.append(
                {
                    "node": ordinal,
                    "type": type(node).__name__,
                    "name": name,
                    "value": float(p.value),
                    # Sticky flags: kernel-variant selection keys on whether
                    # the param EVER had events (static vs time-varying
                    # biquad) and on touched (unity vs resample playback),
                    # so the compiled layout depends on them even when the
                    # event list is currently empty.
                    "had_events": bool(p._had_events),
                    "touched": bool(p._touched),
                    "events": [
                        {"time": e[0], "type": e[2], "value": e[3], "tc": e[4]}
                        for e in p._events
                    ],
                }
            )

    manifest = {
        "format": "graphaudio-tpu-checkpoint-v1",
        "sample_rate": context.sample_rate,
        "superblock": context.superblock,
        "current_frame": context._current_frame,
        "current_time": context._current_time,
        "leaf_paths": leaf_paths,
        "params": params,
        # A render call that isn't a whole number of superblocks leaves
        # already-rendered frames in the host-side carry; dropping them on
        # resume would skip audio (the device clock is already past them).
        "has_carry": context._carry is not None,
    }
    if context._carry is not None:
        arrays["__carry__"] = np.asarray(context._carry)
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_context_state(context, path) -> None:
    """Restore a checkpoint into a context with the same graph topology."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        if manifest.get("format") != "graphaudio-tpu-checkpoint-v1":
            raise ValueError(
                f"not a graphaudio-tpu checkpoint (format tag: "
                f"{manifest.get('format')!r})"
            )
        leaves = [z[f"leaf_{i}"] for i in range(len(manifest["leaf_paths"]))]
        carry = z["__carry__"] if manifest.get("has_carry") else None
    if manifest["sample_rate"] != context.sample_rate:
        raise ValueError(
            f"checkpoint sample rate {manifest['sample_rate']} != context "
            f"{context.sample_rate}"
        )
    if manifest["superblock"] != context.superblock:
        raise ValueError(
            f"checkpoint superblock {manifest['superblock']} != context "
            f"{context.superblock} (state shapes depend on it)"
        )

    context._drain_commands()
    # Restore params BEFORE compiling: kernel-variant selection (e.g. the
    # biquad's static blocked-matmul vs time-varying scan, and therefore
    # chain-fusion grouping) keys on whether params carry events, so the
    # graph must compile against the CHECKPOINT's automation state or the
    # state layouts below won't line up.
    by_key = {}
    for p in manifest["params"]:
        if "node" in p:
            by_key[(p["node"], p["type"], p["name"])] = p
        else:  # older checkpoints keyed by raw node_id (same-context only)
            by_key[p["node_id"], p["name"]] = p
    for ordinal, node in enumerate(
        sorted(context._nodes.values(), key=lambda n: n.node_id)
    ):
        for name, p in getattr(node, "params", {}).items():
            saved = by_key.get(
                (ordinal, type(node).__name__, name)
            ) or by_key.get((node.node_id, name))
            if saved is None:
                continue
            p._value = saved["value"]
            p._events = [
                (e["time"], i, e["type"], e["value"], e["tc"])
                for i, e in enumerate(saved["events"])
            ]
            p._seq = len(p._events)
            p._version += 1
            had = bool(saved.get("had_events", saved["events"]))
            if had and not p._had_events:
                # Flip through the same notify path as the first scheduled
                # event so variant-dependent kernels recompile.
                p._had_events = True
                if p.notify_first_event and p._owner is not None:
                    p._owner._config_changed()
            if bool(saved.get("touched", saved["events"])):
                # Same for the touched flag (unity-vs-resample playback
                # variants key on it); _mark_touched notifies the owner.
                p._mark_touched()
    context._invalidate_topology()
    context._ensure_compiled()
    # Match leaves BY PATH (not position): pipe scratch is excluded from
    # checkpoints and ignored in files that carried it, so within-call
    # working storage can change layout without invalidating checkpoints.
    # (A pipelined graph still stacks its lane STATES, so a file saved
    # with pipeline_chains=True needs a True context to load — mismatches
    # fail below with the missing/extra leaf named.) Requiring each path's
    # shape and dtype to match keeps restored arrays from landing in the
    # wrong state slots silently.
    saved_by_path = {
        p: a
        for p, a in zip(manifest["leaf_paths"], leaves)
        if not _is_scratch(p)
    }
    new_leaves = {}
    for cur_path, cur in _leaves(context._states):
        if _is_scratch(cur_path):
            new_leaves[cur_path] = cur  # fresh scratch; never read cross-call
            continue
        cur_arr = _host(cur)
        saved = saved_by_path.pop(cur_path, None)
        if saved is None:
            raise ValueError(
                f"checkpoint has no state leaf {cur_path!r} that the current "
                f"graph expects (different topology?)"
            )
        if np.shape(saved) != cur_arr.shape or saved.dtype != cur_arr.dtype:
            raise ValueError(
                f"checkpoint leaf {cur_path!r} is {np.shape(saved)}/"
                f"{saved.dtype}; current graph expects "
                f"{cur_arr.shape}/{cur_arr.dtype} — same topology but "
                f"incompatible kernel state layouts (checkpoint saved by an "
                f"older build?)"
            )
        if isinstance(cur, torch.Tensor):
            new_leaves[cur_path] = torch.from_numpy(saved.copy()).to(context.device)
        else:  # a host scalar (the convolver's ring head)
            new_leaves[cur_path] = type(cur)(saved.item())
    if saved_by_path:
        extra = sorted(saved_by_path)[:4]
        raise ValueError(
            f"checkpoint contains {len(saved_by_path)} state leaves the "
            f"current graph does not (e.g. {extra}) — different topology?"
        )
    context._states = _rebuild(context._states, new_leaves)
    if "__globals__" in context._states:
        # The listener rides in the state; keep the host copy, from which a
        # rebuild takes it, in step.
        context._listener = {k: _host(v) for k, v in context._states["__globals__"].items()}
    context._carry = carry
    context._current_frame = int(manifest["current_frame"])
    # Older checkpoints predate the accumulated clock; the frame-derived
    # value differs only at the ~1e-13 level.
    context._current_time = float(
        manifest.get("current_time",
                     context._current_frame / context.sample_rate)
    )
    context._encs = None  # force re-encode from restored event lists
