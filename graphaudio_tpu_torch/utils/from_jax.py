"""Carry a JAX-package render over into the port, mid-render.

Numpy in, tensors out: no ``jax`` import. The caller fetches the JAX
context's compiled constants and per-stage render state to the host
(``jax.device_get``) and hands them over as numpy dicts; these functions
turn them into the port's layout, so both packages compute the same thing
from the same point of a render.

Both packages schedule stages the same way, so stage keys ("st<i>") and
group lane order agree, and most states have the same layout in both: the
sources (the buffer sources' positions; the oscillator's f64 ``phase`` and
every scheduled source's ``started`` / ``start_time`` / ``stop_time``),
the biquads and spatial panners (``ola``, ``xlow``, ``xhigh``, and past
128 taps the partitioned filter's ring ``hx`` with its directions ``haz``
/ ``hel``, and the partition spectra ``hrtf_sr`` / ``hrtf_si`` among the
constants), the
decoder stream nodes (``x0``, ``rate``: f64, rewritten by each call's
feed staging; each package's node keeps its own decoder queue, so a
hand-off needs both nodes at the same point of the same file), and
the ``__globals__`` entry (the listener transform, f32[3] each). What
differs are two rings: the convolver's delay line (the JAX package keeps
the P-1 past spectra oldest first, ``hist_r`` / ``hist_i`` [K, P-1,
bins]; the port keeps a ring of P-1+L slots with a head,
``conv_state_from_jax``) and the delay's (the JAX package keeps L slots
and a write cursor; the port keeps L + min(T, L) slots and a slot cursor
beside it, ``nodes.delay.delay_state_from_jax``). A graph with pipes
(fused chains) carries each pipe's register bank (``st<i>.pipe``) and the
ring of the last D block clocks (``__pipe_bt__``) in the same layout in
both, so a fused JAX render hands over to a fused port render; an unfused
one to an unfused one (``pipeline_chains=False`` on both).

A port context sharded over a mesh (``set_mesh``) takes the JAX package's
WHOLE arrays (its sharded arrays fetched to the host are whole) and each
rank keeps its share of them exactly as its own graph build does
(``CompiledGraph.shard_state``, ``shard_consts``): its lanes of a
voice-sharded group's states and geometry (the packed geometry table packed
again from them), its slice of a part-sharded stage's partition spectra.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.graph import to_device
from graphaudio_tpu_torch.nodes.delay import DelayNode, delay_state_from_jax
from graphaudio_tpu_torch.ops.voice_group import pack_group_table


def conv_state_from_jax(st: dict, sub_blocks: int, device, head: int = 0) -> dict:
    """JAX convolver state {hist_r, hist_i, overlap} -> the port's
    {ring_r, ring_i, overlap, head}. ``sub_blocks`` is L (sub-blocks per
    step); past sub-block m (-(P-1) <= m < 0) goes to ring slot
    (head + m) mod R, R = P-1+L."""
    hist_r = np.asarray(st["hist_r"], np.float32)
    hist_i = np.asarray(st["hist_i"], np.float32)
    K, P1, bins = hist_r.shape
    R = P1 + sub_blocks
    slots = (head - P1 + np.arange(P1)) % R
    ring_r = np.zeros((K, R, bins), np.float32)
    ring_i = np.zeros((K, R, bins), np.float32)
    ring_r[:, slots] = hist_r
    ring_i[:, slots] = hist_i
    return {
        "ring_r": torch.from_numpy(ring_r).to(device),
        "ring_i": torch.from_numpy(ring_i).to(device),
        "overlap": torch.from_numpy(np.asarray(st["overlap"], np.float32).copy()).to(device),
        "head": head % R,
    }


def states_from_jax(ctx, jax_states: dict) -> dict:
    """The port's state dict for ``ctx``'s graph from the JAX package's
    host-fetched states of the same graph."""
    ctx._ensure_compiled()
    out = {"__globals__": to_device(
        {k: np.asarray(v, np.float32) for k, v in jax_states["__globals__"].items()}, ctx.device)}
    for sp in ctx._compiled.plan:
        key = sp["key"]
        st = ctx._compiled.shard_state(key, jax_states[key])
        if "hist_r" in st:
            out[key] = conv_state_from_jax(st, sp["rep"].sub_blocks(), ctx.device)
        elif isinstance(sp["rep"], DelayNode):
            out[key] = delay_state_from_jax(st, ctx.superblock * FRAMES_PER_BLOCK, ctx.device)
        else:
            out[key] = to_device({k: np.asarray(v) for k, v in st.items()}, ctx.device)
        if sp["kind"] == "pipe":  # the register bank, same layout in both
            out[key + ".pipe"] = to_device(
                {k: np.asarray(v) for k, v in jax_states[key + ".pipe"].items()}, ctx.device)
    if ctx._compiled.pipe_delay:  # the clock ring, latest first in both
        out["__pipe_bt__"] = torch.from_numpy(
            np.asarray(jax_states["__pipe_bt__"], np.float64).copy()).to(ctx.device)
    return out


def consts_from_jax(ctx, jax_consts: dict) -> dict:
    """The port's stage constants with the JAX package's arena, geometry and
    IR spectra (same layout in both packages); port-only constants (the
    polyphase tap tables) are kept, and a source group's packed geometry
    table is packed again from the JAX geometry. Under a mesh each rank
    keeps its share, as its own build does (``shard_consts``)."""
    ctx._ensure_compiled()
    compiled = ctx._compiled
    whole = dict(compiled.global_consts)
    for name, v in jax_consts.items():
        if name not in whole:
            raise KeyError(f"JAX constant {name!r} has no counterpart in the port's graph")
        if isinstance(v, dict):
            geom = {k: np.asarray(x) for k, x in v.items()}
            whole[name] = geom
            key = name[:-len("/geom")] if name.endswith("/geom") else None
            if f"{key}/gtab" in whole:
                w, variant, _ = compiled._bufsrc_cfg[int(key[2:])]
                whole[f"{key}/gtab"] = pack_group_table(geom, w, variant, ctx.superblock,
                                                        ctx.sample_rate)
        else:
            whole[name] = np.asarray(v)
    return to_device(compiled.shard_consts(whole), ctx.device)


def load_render_state(ctx, jax_states: dict, jax_consts: dict,
                      current_frame: int, current_time: float) -> None:
    """Continue a JAX render in the port: install the converted states and
    constants, the JAX context's clock (frame counter and accumulated f64
    time) and its listener into ``ctx``, whose graph must be built the same
    way."""
    states = states_from_jax(ctx, jax_states)
    consts = consts_from_jax(ctx, jax_consts)
    ctx._listener = {k: np.asarray(v, np.float32).copy()
                     for k, v in jax_states["__globals__"].items()}
    ctx._states = states
    ctx._consts = consts
    ctx._current_frame = int(current_frame)
    ctx._current_time = float(current_time)
