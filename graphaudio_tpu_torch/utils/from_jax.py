"""Carry a JAX-package render over into the port, mid-render.

Numpy in, tensors out: no ``jax`` import. The caller fetches the JAX
context's compiled constants and per-stage render state to the host
(``jax.device_get``) and hands them over as numpy dicts; these functions
turn them into the port's layout, so both packages compute the same thing
from the same point of a render.

Both packages schedule stages the same way, so stage keys ("st<i>") and
group lane order agree, and most states have the same layout in both: the
sources, biquads and spatial panners (``ola``, ``xlow``, ``xhigh``), and
the ``__globals__`` entry (the listener transform, f32[3] each). What
differs is the convolver's delay line: the JAX package keeps the P-1 past
spectra oldest first (``hist_r`` / ``hist_i`` [K, P-1, bins]); the port
keeps a ring of P-1+L slots with a head (``conv_state_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.graph import to_device


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
        st = jax_states[key]
        if "hist_r" in st:
            out[key] = conv_state_from_jax(st, sp["rep"].sub_blocks(), ctx.device)
        else:
            out[key] = to_device({k: np.asarray(v) for k, v in st.items()}, ctx.device)
    return out


def consts_from_jax(ctx, jax_consts: dict) -> dict:
    """The port's stage constants with the JAX package's arena, geometry and
    IR spectra (same layout in both packages); port-only constants (the
    polyphase tap tables) are kept."""
    ctx._ensure_compiled()
    out = dict(ctx._consts)
    for name, v in jax_consts.items():
        if name not in out:
            raise KeyError(f"JAX constant {name!r} has no counterpart in the port's graph")
        if isinstance(v, dict):
            out[name] = to_device({k: np.asarray(x) for k, x in v.items()}, ctx.device)
        else:
            out[name] = torch.from_numpy(np.asarray(v).copy()).to(ctx.device)
    return out


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
