"""Graph compiler: host node graph -> one step function over a superblock.

The port of graphaudio_tpu/core/graph.py. The host graph is topologically
sorted once, channel counts are resolved statically, same-key nodes are
batched into group stages (lanes padded to a power of two), and the routing
is snapshotted into a plan. ``make_step_fn`` turns the plan into

    step(states, encs, consts, block_times, frame0) -> (new_states, out f32[C, T])

that evaluates every stage for one superblock of S render quanta
(T = S*128 frames), and ``make_render_fn`` runs it as a plain Python loop
over superblocks (the JAX package's ``lax.scan``). PyTorch runs eagerly, so
there is no compiled program: the step issues the stage kernels directly.

Left out so far (see ROADMAP.md): chain fusion into pipelined stages
(``_fuse_chains``), mesh sharding (``_compute_sharding`` / ``shard_map``),
modulated params, and the time-varying-rate buffer-source variant.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.mixing import (
    adapt_channels,
    fan_in_lanes,
    resolve_channel_count,
)
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.ops.param_eval import eval_intrinsic_blocked
from graphaudio_tpu_torch.ops.resample import poly_taps


@dataclass(frozen=True)
class StaticRenderInfo:
    """Render geometry handed to node kernels."""

    sample_rate: int
    superblock: int  # S: quanta per step

    @property
    def frames(self) -> int:  # T
        return self.superblock * FRAMES_PER_BLOCK


class RenderContext:
    """Per-step context: the clocks of one superblock.

    ``block_times`` (f64[S], on the render device) is the reference's
    ACCUMULATED block clock, computed on the host with its exact rounding
    sequence (context.py); block end times add fl(128/sr) to it
    (AudioBufferSourceNode.cs:134).
    """

    def __init__(self, info: StaticRenderInfo, frame0: int, block_times):
        self.info = info
        self.sample_rate = info.sample_rate
        self.superblock = info.superblock
        self.frames = info.frames
        self.frame0 = frame0  # absolute frame index of sample 0 (host int)
        # fl(1/sr): the reference's per-sample deltaTime (AudioParam.cs:116).
        self.dt = 1.0 / float(info.sample_rate)
        self.block_times = block_times
        self.block_end_times = block_times + float(FRAMES_PER_BLOCK) / float(info.sample_rate)
        # Per-stage constants (e.g. convolver IR spectra), set by the step.
        self.stage_consts = {}
        # Context-level globals (the listener transform), f32[3] tensors.
        self.globals = None


class ParamSignal:
    """Computed values of one AudioParam for a superblock, f32[..., T]
    (a-rate) or f32[..., S] (k-rate). ``per_sample()`` yields f32[..., T];
    ``per_block()`` yields f32[..., S], the value a k-rate consumer sees for
    each 128-frame quantum (reference ``GetValues()[0]``)."""

    def __init__(self, values, is_a_rate: bool):
        self._values = values
        self._a_rate = is_a_rate

    def per_sample(self):
        if self._a_rate:
            return self._values
        return torch.repeat_interleave(self._values, FRAMES_PER_BLOCK, dim=-1)

    def per_block(self):
        if self._a_rate:
            return self._values[..., ::FRAMES_PER_BLOCK]
        return self._values


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _is_buffer_source(node) -> bool:
    """Buffer sources batch over a packed sample arena (duck-typed to avoid an
    import cycle with the nodes package)."""
    return hasattr(node, "process_poly_group") and hasattr(node, "_buffer")


def to_device(tree, device):
    """numpy arrays / scalars in a (nested) dict -> tensors on ``device``,
    dtypes kept; Python ints (host-side scalars such as a ring head) stay."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree)).to(device)
    return tree


class CompiledGraph:
    """Static schedule for a graph topology.

    Holds the topo order, resolved per-port channel counts, param encoding
    capacities, the stage plan and the stage constants. Immutable; rebuilt
    when the topology changes.
    """

    def __init__(self, context):
        self.context = context
        self.info = StaticRenderInfo(context.sample_rate, context.superblock)
        self.destination = context.destination
        self.topo: List = []
        self.input_channels: Dict[Tuple[int, int], int] = {}
        self.output_channels: Dict[Tuple[int, int], int] = {}
        self.param_capacity: Dict[Tuple[int, str], int] = {}
        self._build()

    # -- topology -------------------------------------------------------------

    def _build(self) -> None:
        dest = self.destination
        # Iterative DFS from the destination through input connections and
        # param modulation sources (reference GetAllNodes,
        # AudioContextBase.cs:191-218); a GREY revisit is a cycle.
        WHITE, GREY, BLACK = 0, 1, 2
        color: Dict[int, int] = {}
        topo: List = []

        def upstream(node):
            ups = []
            for inp in node.inputs:
                for out in inp.connected_outputs:
                    ups.append(out.owner)
            for param in node.params.values():
                for out in param._mod_outputs:
                    ups.append(out.owner)
            return ups

        stack = [(dest, False)]
        while stack:
            node, expanded = stack.pop()
            c = color.get(node.node_id, WHITE)
            if expanded:
                color[node.node_id] = BLACK
                topo.append(node)
                continue
            if c == BLACK:
                continue
            if c == GREY:
                raise RuntimeError(
                    f"Audio graph cycle detected at node {node.name} "
                    f"(ID: {node.node_id})"
                )
            color[node.node_id] = GREY
            stack.append((node, True))
            for up in upstream(node):
                uc = color.get(up.node_id, WHITE)
                if uc == GREY:
                    raise RuntimeError(
                        f"Audio graph cycle detected at node {up.name} "
                        f"(ID: {up.node_id})"
                    )
                if uc == WHITE:
                    stack.append((up, False))
        self.topo = topo

        # Static channel resolution in topo order (AudioNodeInput.cs:140-168).
        node_in_counts = {}
        for node in topo:
            in_counts = []
            for inp in node.inputs:
                src_counts = [
                    self.output_channels[(o.owner.node_id, o.index)]
                    for o in inp.connected_outputs
                ]
                c = resolve_channel_count(
                    inp.channel_count_mode.value, inp.channel_count, src_counts
                )
                self.input_channels[(node.node_id, inp.index)] = c
                in_counts.append(c)
            node_in_counts[node.node_id] = tuple(in_counts)
            for i, c in enumerate(node.output_channel_counts(in_counts)):
                self.output_channels[(node.node_id, i)] = c

        # ---- stage scheduling with voice batching --------------------------
        # Ready nodes sharing a group_key run as one batched stage.
        emitted = set()
        stages = []
        remaining = [n for n in topo if n is not dest]

        def upstream_ids(node):
            return {up.node_id for up in upstream(node)}

        while remaining:
            ready = [n for n in remaining if upstream_ids(n) <= emitted]
            if not ready:  # cannot happen on a DAG, but fail loudly
                raise RuntimeError("stage scheduling stalled (cycle?)")
            by_key = {}
            singles = []
            for n in ready:
                key = n.group_key(node_in_counts[n.node_id])
                if key is None:
                    singles.append(n)
                else:
                    by_key.setdefault(key, []).append(n)
            for n in singles:
                stages.append(("single", [n], None))
            # Every keyed stage is a "group" even with one member, so its
            # layout depends only on the key and lane count.
            for key, nodes in by_key.items():
                stages.append(("group", nodes, key))
            for n in ready:
                emitted.add(n.node_id)
            remaining = [n for n in remaining if n.node_id not in emitted]
        stages.append(("dest", [dest], None))
        self.stages = stages

        # Static buffer-source kernel variants; a change forces a rebuild.
        self.bufsrc_variants = {
            n.node_id: n.kernel_variant()
            for n in topo
            if _is_buffer_source(n) and n._buffer is not None
        }

        # State layout: stage keys "st<i>"; groups stack their lanes and pad
        # to a power of two with PHANTOM lanes (fresh never-started state,
        # silent output).
        self.state_ref: Dict[int, Tuple[str, object]] = {}
        self.state_composition: Dict[str, Tuple[int, ...]] = {}
        self.stage_pad: Dict[int, Tuple[int, int]] = {}
        for si, (kind, nodes, _) in enumerate(self.stages):
            key = f"st{si}"
            self.state_composition[key] = tuple(n.node_id for n in nodes)
            if kind == "group":
                self.stage_pad[si] = (len(nodes), _next_pow2(len(nodes)))
                for lane, n in enumerate(nodes):
                    self.state_ref[n.node_id] = (key, lane)
            else:
                self.state_ref[nodes[0].node_id] = (key, None)

        # Param encoding capacities: pow2 high-water marks, 0 for params that
        # never had events (the constant fast path).
        for node in topo:
            for name, p in node.params.items():
                c = p.event_count()
                self.param_capacity[(node.node_id, name)] = _next_pow2(c) if c else 0
        for kind, nodes, _ in self.stages:
            if kind == "group":
                self._share_group_capacity(nodes)

        # ---- buffer-source arenas ------------------------------------------
        # One packed arena per buffer-source stage, width padded to a pow2
        # bucket, plus stacked per-voice geometry (and the polyphase taps).
        self.consts: Dict[str, object] = {}
        self._bufsrc_cfg: Dict[int, Tuple[int, tuple, int]] = {}
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind != "group" or not _is_buffer_source(nodes[0]):
                continue
            rep = nodes[0]
            variant = rep.kernel_variant()  # shared: it's in the group key
            rep.require_ported(variant)
            if variant[0] == "poly":
                w, front = type(rep).poly_window(self.info.superblock, *variant[1:])
            else:  # unity
                w, front = type(rep).unity_window(self.info.superblock), 0
            built = [n.build_region(w, front) for n in nodes]
            regions = [b[0] for b in built]
            geoms = [b[1] for b in built]
            if variant[0] == "unity":
                # 128-align each voice's arena offset so the aligned
                # variant's row fetch holds; harmless padding otherwise.
                regions = [
                    np.pad(r, ((0, 0), (0, (-r.shape[1]) % FRAMES_PER_BLOCK)))
                    for r in regions
                ]
            widths = [r.shape[1] for r in regions]
            offs = list(np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32))
            arena = np.concatenate(regions, axis=1)
            # Size the arena as if phantom lanes had regions too, so the
            # padded width is the same for every voice count in a bucket.
            real, padded = self.stage_pad[si]
            virtual_w = arena.shape[1] + (padded - real) * widths[0]
            arena_w = _next_pow2(max(virtual_w, w + 8, FRAMES_PER_BLOCK))
            if arena.shape[1] < arena_w:
                arena = np.pad(arena, ((0, 0), (0, arena_w - arena.shape[1])))
            # Phantom lanes duplicate lane 0's geometry: reads are valid
            # data, outputs are silenced by their never-started state.
            geoms = geoms + [geoms[0]] * (padded - real)
            offs = offs + [offs[0]] * (padded - real)
            stacked = {k: np.stack([g[k] for g in geoms]) for k in geoms[0]}
            stacked["off"] = np.asarray(offs, np.int32)
            self.consts[f"st{si}/arena"] = arena
            self.consts[f"st{si}/geom"] = stacked
            if variant[0] == "poly":
                wtab, btab = poly_taps(*variant[1:])
                self.consts[f"st{si}/poly_w"] = wtab
                self.consts[f"st{si}/poly_b"] = btab
            self._bufsrc_cfg[si] = (w, variant, arena_w)

        # ---- stage consts (convolver IR spectra, a panner group's HRIR grid) --
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind == "dest":
                continue
            sc = getattr(nodes[0], "stage_consts", None)
            if sc is None:
                continue
            for name, arr in sc().items():
                self.consts[f"st{si}/{name}"] = arr

        self._build_plan()

    # -- execution plan ---------------------------------------------------------
    #
    # The step never reads live node objects' connection lists: routing is
    # snapshotted here as plain data, producers addressed as (stage, port,
    # lane).

    def _build_plan(self) -> None:
        stage_of = {}
        lane_of = {}
        stage_real = {}
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind == "group":
                stage_real[si] = len(nodes)
            for lane, n in enumerate(nodes):
                stage_of[n.node_id] = si
                lane_of[n.node_id] = lane if kind == "group" else None

        def producer(o):
            return (
                stage_of[o.owner.node_id],
                o.index,
                lane_of[o.owner.node_id],
                self.output_channels[(o.owner.node_id, o.index)],
            )

        def producers(connected_outputs):
            prods = tuple(producer(o) for o in connected_outputs)
            # "Every lane of one group" collapses to one ("ALL", si, port, c)
            # marker: the fan-in sums the PADDED tensor (phantoms are silent).
            by_src: Dict[Tuple[int, int], list] = {}
            for p in prods:
                if p[2] is not None:
                    by_src.setdefault((p[0], p[1]), []).append(p)
            out = []
            consumed = set()
            for (psi, pport), ps in by_src.items():
                lanes = sorted(p[2] for p in ps)
                if lanes == list(range(stage_real.get(psi, -1))):
                    out.append(("ALL", psi, pport, ps[0][3]))
                    consumed.update(ps)
            for p in prods:
                if p not in consumed:
                    out.append(p)
            return tuple(out)

        def chain_or_lanes(nodes, getter, pad):
            """Group per-lane routing: a pure 1:1 chain from one equally
            padded group is ("CHAIN", src_si, src_port, c); otherwise
            explicit per-lane producers, phantom lanes silent."""
            per_lane = [tuple(producer(o) for o in getter(n)) for n in nodes]
            first = per_lane[0]
            if (
                len(first) == 1
                and first[0][2] is not None
                and all(
                    len(pl) == 1 and pl[0][:2] == first[0][:2] and pl[0][2] == v
                    for v, pl in enumerate(per_lane)
                )
            ):
                src_si = first[0][0]
                src_pad = self.stage_pad.get(src_si, (0, -1))[1]
                if src_pad == pad and stage_real.get(src_si) == len(nodes):
                    return ("CHAIN", src_si, first[0][1], first[0][3])
            return tuple(producers(getter(n)) for n in nodes) + (
                ((),) * (pad - len(nodes))
            )

        plan = []
        for si, (kind, nodes, gkey) in enumerate(self.stages):
            rep = nodes[0]
            if kind == "group":
                pad = self.stage_pad[si][1]
                inputs = tuple(
                    (
                        self.input_channels[(rep.node_id, i)],
                        chain_or_lanes(
                            nodes, lambda n, i=i: n.inputs[i].connected_outputs, pad
                        ),
                    )
                    for i in range(len(rep.inputs))
                )
            else:
                inputs = tuple(
                    (
                        self.input_channels[(rep.node_id, inp.index)],
                        producers(inp.connected_outputs),
                    )
                    for inp in rep.inputs
                )
            for n in nodes:
                if n._params_modulated():
                    raise NotImplementedError(
                        "modulated AudioParams are not ported yet "
                        "(ROADMAP.md module item 8)"
                    )
            params = tuple(
                (name, p.automation_rate == AutomationRate.A_RATE, p.exact_eval)
                for name, p in rep.params.items()
            )
            out_counts = tuple(
                self.output_channels.get((rep.node_id, i))
                for i in range(len(rep.outputs))
            )
            plan.append(
                {
                    "kind": kind,
                    "si": si,
                    "key": f"st{si}",
                    "rep": rep,
                    "n_lanes": self.stage_pad[si][1] if kind == "group" else 1,
                    "group_key": gkey,
                    "inputs": inputs,
                    "params": params,
                    "out_counts": out_counts,
                    "bufsrc": self._bufsrc_cfg.get(si),
                }
            )
        self.plan = plan

    def signature(self):
        """Structural identity of the step function: two CompiledGraphs with
        equal signatures compute the same function of (states, encs,
        consts, clocks). Group stages key on their batching key; singles on
        node identity + config version. (The JAX package keys its compiled-
        program cache on it; PyTorch runs eagerly, so the port rebuilds its
        step function on every graph build and keeps this as the graph's
        identity for callers and tests.)"""
        sig = [("hdr", self.info.sample_rate, self.info.superblock)]
        for sp in self.plan:
            if sp["kind"] == "group":
                ident = ("G", sp["group_key"], sp["n_lanes"], sp["bufsrc"])
            elif sp["kind"] == "dest":
                ident = ("D",)
            else:
                ident = ("N", sp["rep"].static_fingerprint())
            sig.append((ident, sp["inputs"], sp["params"], sp["out_counts"]))
        return tuple(sig)

    def static_config_stale(self) -> bool:
        """True when a buffer source's compiled kernel variant no longer
        matches its current param values."""
        for nid, compiled in self.bufsrc_variants.items():
            node = self.context._nodes.get(nid)
            if node is not None and node.kernel_variant() != compiled:
                return True
        return False

    # -- state ------------------------------------------------------------------

    def _init_node_state(self, node) -> dict:
        st = node.init_state(self.info)
        overrides = getattr(node, "_state_overrides", None)
        if overrides:
            st = dict(st)
            for k, v in overrides.items():
                if k in st:
                    st[k] = np.asarray(v, dtype=np.asarray(st[k]).dtype)
        return st

    def init_states(self) -> Dict:
        """Initial states as numpy dicts (the context moves them to its
        device): groups stack their lanes [V, ...]."""
        states = {}
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind == "group":
                members = [self._init_node_state(n) for n in nodes]
                real, padded = self.stage_pad[si]
                members += [nodes[0].init_state(self.info) for _ in range(padded - real)]
                states[f"st{si}"] = {
                    k: np.stack([np.asarray(m[k]) for m in members])
                    for k in members[0]
                }
            else:
                states[f"st{si}"] = self._init_node_state(nodes[0])
        # Context-level globals (listener transform) travel in the state, so
        # they are data, not rebuild triggers.
        states["__globals__"] = self.context.global_state()
        return states

    def _share_group_capacity(self, nodes) -> None:
        """Unify event capacities across a group's lanes, per param name
        (high-water mark; names never automated stay at capacity 0)."""
        names = list(nodes[0].params)
        ever = {
            nm: (
                any(n.params[nm].event_count() > 0 for n in nodes)
                or any(self.param_capacity[(n.node_id, nm)] > 0 for n in nodes)
            )
            for nm in names
        }
        cap = max(
            (self.param_capacity[(n.node_id, nm)]
             for n in nodes for nm in names if ever[nm]),
            default=0,
        )
        for n in nodes:
            for nm in names:
                self.param_capacity[(n.node_id, nm)] = cap if ever[nm] else 0

    def encode_params(self) -> Dict[str, dict]:
        """Encode all params' event lists (numpy); bumps capacities when
        outgrown. Group encodings stack into one [V, ...] entry per param."""
        for node in self.topo:
            for name, p in node.params.items():
                key = (node.node_id, name)
                if p.event_count() > self.param_capacity[key]:
                    self.param_capacity[key] = _next_pow2(p.event_count())
        for kind, nodes, _ in self.stages:
            if kind == "group":
                self._share_group_capacity(nodes)
        encs = {}
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind == "group":
                real, padded = self.stage_pad[si]
                for name in nodes[0].params:
                    per = [
                        n.params[name].encode(self.param_capacity[(n.node_id, name)])
                        for n in nodes
                    ]
                    per += [per[0]] * (padded - real)
                    encs[f"st{si}/{name}"] = {
                        k: np.stack([e[k] for e in per]) for k in per[0]
                    }
            else:
                n = nodes[0]
                for name, p in n.params.items():
                    encs[f"st{si}/{name}"] = p.encode(
                        self.param_capacity[(n.node_id, name)]
                    )
        return encs

    # -- the step function ---------------------------------------------------

    def make_step_fn(self):
        """Build the step function from the snapshotted plan. It captures
        only the plan and each stage representative's kernel methods, never
        live connection lists. Returns (step, destination channel count)."""
        info = self.info
        plan = self.plan
        dest_channels = self.input_channels[(self.destination.node_id, 0)]

        def step(states, encs, consts, block_times, frame0):
            rc = RenderContext(info, frame0, block_times)
            rc.globals = states["__globals__"]
            out_table: Dict[Tuple[int, int], object] = {}
            new_states = {"__globals__": rc.globals}
            dest_out = None

            def mixed_signal(prods, dst_c):
                """Sum producer outputs into one [dst_c, T] block — the
                reference's fan-in summing junction (AudioNodeInput.cs:100-138).
                Lane sums of a group tensor go through K3 (fan_in_lanes)."""
                lanes: Dict[Tuple[int, int], list] = {}
                parts = []
                for p in prods:
                    if p[0] == "ALL":
                        parts.append(fan_in_lanes(out_table[(p[1], p[2])], dst_c))
                        continue
                    psi, pport, plane, _c = p
                    if plane is None:
                        parts.append(adapt_channels(out_table[(psi, pport)], dst_c))
                    else:
                        lanes.setdefault((psi, pport), []).append(plane)
                for (psi, pport), vs in lanes.items():
                    tensor = out_table[(psi, pport)]
                    if len(vs) == 1:
                        parts.append(adapt_channels(tensor[vs[0]], dst_c))
                    else:
                        sel = tensor if len(vs) == tensor.shape[0] else tensor[vs]
                        parts.append(fan_in_lanes(sel.contiguous(), dst_c))
                if not parts:
                    return torch.zeros((dst_c, rc.frames), dtype=torch.float32,
                                       device=block_times.device)
                acc = parts[0]
                for p in parts[1:]:
                    acc = acc + p
                return acc

            def eval_params(sp, key):
                params = {}
                for name, a_rate, exact in sp["params"]:
                    vals = eval_intrinsic_blocked(
                        encs[f"{key}/{name}"], block_times,
                        FRAMES_PER_BLOCK if a_rate else 1, rc.dt, exact=exact,
                    )
                    params[name] = ParamSignal(vals, a_rate)
                return params

            def run_process(sp, key, inputs, params):
                prefix = key + "/"
                rc.stage_consts = {
                    n[len(prefix):]: v for n, v in consts.items() if n.startswith(prefix)
                }
                result = sp["rep"].process(states[key], inputs, params, rc)
                rc.stage_consts = {}
                return result

            def run_single(sp):
                si, key = sp["si"], sp["key"]
                params = eval_params(sp, key)
                inputs = [mixed_signal(prods, c) for c, prods in sp["inputs"]]
                st, outs = run_process(sp, key, inputs, params)
                new_states[key] = st
                for i, o in enumerate(outs):
                    out_table[(si, i)] = o

            def stacked_inputs(sp, inp_idx):
                """Contiguous [V, C, T] inputs for a group (the kernels take
                no strides): CHAIN is the identity fast path; otherwise
                per-lane mixing, phantom pad lanes silent."""
                dst_c, routing = sp["inputs"][inp_idx]
                if routing and routing[0] == "CHAIN":
                    t = out_table[(routing[1], routing[2])]
                    if routing[3] != dst_c:
                        # all lanes at once: channels lead in adapt_channels,
                        # whose mono up-mix is a stride-0 view
                        t = adapt_channels(t.transpose(0, 1), dst_c).transpose(0, 1).contiguous()
                    return t
                return torch.stack([mixed_signal(pl, dst_c) for pl in routing])

            def run_group(sp):
                si, key, rep = sp["si"], sp["key"], sp["rep"]
                if sp["bufsrc"] is not None:
                    # The unity and polyphase source groups consume no
                    # params (playbackRate is baked into the variant).
                    w, variant, _ = sp["bufsrc"]
                    arena, geom = consts[f"{key}/arena"], consts[f"{key}/geom"]
                    if variant[0] == "poly":
                        sts, out = type(rep).process_poly_group(
                            states[key], arena, geom, rc, w, variant[1], variant[2],
                            (consts[f"{key}/poly_w"], consts[f"{key}/poly_b"]),
                        )
                    else:
                        sts, out = type(rep).process_unity_group(
                            states[key], arena, geom, rc, w, aligned=variant[1])
                    outs = [out]
                else:
                    params = eval_params(sp, key)
                    inputs = [stacked_inputs(sp, i) for i in range(len(sp["inputs"]))]
                    sts, outs = run_process(sp, key, inputs, params)
                new_states[key] = sts
                for i, o in enumerate(outs):  # o: [V, C, T]
                    out_table[(si, i)] = o

            for sp in plan:
                if sp["kind"] == "single":
                    run_single(sp)
                elif sp["kind"] == "group":
                    run_group(sp)
                else:  # destination: passthrough sink (AudioDestinationNode.cs:42-64)
                    dst_c, prods = sp["inputs"][0]
                    dest_out = mixed_signal(prods, dst_c)
                    new_states[sp["key"]] = states[sp["key"]]
            return new_states, dest_out

        return step, dest_channels

    def make_render_fn(self):
        """Multi-superblock renderer: the step in a Python loop over
        superblocks. ``render(states, encs, consts, block_times f64[n, S],
        frame0s)`` returns (states, out f32[C, n*T])."""
        step, dest_channels = self.make_step_fn()

        def render(states, encs, consts, block_times, frame0s):
            outs = []
            for j, frame0 in enumerate(frame0s):
                states, out = step(states, encs, consts, block_times[j], int(frame0))
                outs.append(out)
            return states, torch.cat(outs, dim=1)

        return render, dest_channels
