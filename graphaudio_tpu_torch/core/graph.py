"""Graph compiler: host node graph -> one step function over a superblock.

The port of graphaudio_tpu/core/graph.py. The host graph is topologically
sorted once, channel counts are resolved statically, same-key nodes are
batched into group stages (lanes padded to a power of two), and the routing
is snapshotted into a plan. ``make_step_fn`` turns the plan into

    step(states, encs, consts, clocks, frame0) -> (new_states, out f32[C, T])

that evaluates every stage for one superblock of S render quanta
(T = S*128 frames), and ``make_render_fn`` runs it as a plain Python loop
over superblocks (the JAX package's ``lax.scan``). PyTorch runs eagerly, so
there is no compiled program: the step issues the stage kernels directly.
Work that depends on params alone is batched at the top of the step, where
XLA would fuse it: one K6 launch evaluates every automated param into one
arena (``encode_params`` packs its table once per encoding), and each batch
function of the stages' ``prologue_request``s (K8 for the biquads, K10b
for the spatial panners) runs once for all of its stages.

A modulated param (an AudioNode output connected to it) gets its
modulation added and clamped by K6m (``apply_modulation``) once a step,
after its intrinsic values; a group routes its lanes' modulators like
per-lane audio inputs, the 1:1 per-voice LFO -> param chain as CHAIN.
A stage whose prologue request reads a modulated param cannot join the
batch at the top of the step, which runs before its modulators: K6m
writes that param into rows of the K6 arena reserved for it (K6 never
writes them), and the stage's own one-item batch (``DEFERRED``) runs at
its turn, reading them as it reads any arena row.

With ``pipeline_chains`` on (the offline context's default), a head-to-tail
run of same-key one-lane group stages becomes one "pipe" stage
(``_fuse_chains``): lane i processes the superblock of i steps ago, fed by
lane i-1's output of the previous step from a carried register bank, so
the K stages run as one batched launch a step (config 3's four biquads: one
P2 launch). Every stage runs at a LEVEL, the steps between the live clock
and the audio it processes; its param rows in the K6 table carry the clock
of that step (a row of the step's clock matrix), and the destination lags
by the pipe delay D. A render call runs D rows more than it delivers and a
stage at level L commits its state only in rows L <= r < n + L, so the
audio equals the unfused graph's, bit for bit.

Under a device mesh (``context.set_mesh``, a ``torch.distributed``
``DeviceMesh`` with dims ``("voice", "part")``; parallel/), every rank
builds the same graph and runs the same steps on its own device, SPMD, and
receives the whole destination output (the JAX package's ``shard_map`` with
``out_specs`` ``P()``). ``_compute_sharding`` decides per stage, as the JAX
package does: a group whose padded lane count divides by the ``voice``
size keeps only its rank's lanes (states, param encodings and the K6
table's rows built from them, source geometry and its packed table), its
whole-group fan-ins completing with one ``all_reduce`` over ``voice``
after K3; a single whose node supports partition sharding (the convolver's
IR, a long per-node HRIR) keeps only its rank's slice of its partition
spectra, sliced on the node's ``const_part_axes``, and completes its MAC
(K14) with one ``all_reduce`` over ``part``. Everything else, pipes
included, is computed identically on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.mesh import axis_group, axis_index, axis_size
from graphaudio_tpu_torch.core.mixing import (
    adapt_channels,
    fan_in_lanes,
    resolve_channel_count,
)
from graphaudio_tpu_torch.core.params import AutomationRate
from graphaudio_tpu_torch.ops.param_eval import (
    apply_modulation,
    constant_slot,
    eval_intrinsic_batch,
    eval_intrinsic_blocked,
    pack_param_table,
)
from graphaudio_tpu_torch.ops.resample import poly_taps
from graphaudio_tpu_torch.ops.voice_group import pack_group_table


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
        self._block_end_times = None
        # Per-stage constants (e.g. convolver IR spectra), set by the step.
        self.stage_consts = {}
        # Context-level globals (the listener transform), f32[3] tensors.
        self.globals = None
        # The running stage's result from the step's prologue, if it asked.
        self.prologue_result = None
        # The call's host-staged feeds (stream nodes), set by the step:
        # {str(node_id): the call's read f32[n_steps, C, T] on the render
        # device, "__base__": the call's first frame (host int)}, or None.
        self.feeds = None
        # The running stage's partition slice under a ``part`` mesh: (this
        # rank's index along ``part``, the dimension's process group), or
        # None; its stage consts hold that slice's rows.
        self.part = None

    @property
    def block_end_times(self):
        """fl(block time + fl(128/sr)), f64[S], computed at the first use
        (a stage at a pipe's level seldom needs it)."""
        if self._block_end_times is None:
            self._block_end_times = self.block_times + float(FRAMES_PER_BLOCK) / float(
                self.sample_rate)
        return self._block_end_times


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


#: keys of the step's batched tables in an encoding (``encode_params``)
PARAM_TABLE = "__param_table__"
PROLOGUE = "__prologue__"
DEFERRED = "__deferred__"


def _evaluates_params(sp) -> bool:
    """Stages whose params the step evaluates (the unity and polyphase
    buffer-source groups bake theirs into the kernel variant; the
    time-varying one reads its playbackRate; the destination has none)."""
    return sp["kind"] != "dest" and (sp["bufsrc"] is None or sp["bufsrc"][1][0] == "resample")


def _deferred_params(sp) -> List[str]:
    """The params of a stage that its prologue request reads and that are
    modulated: they hold the stage's request back from the prologue."""
    return [name for name, _, _, modspec in sp["params"]
            if modspec is not None and name in sp["rep"].prologue_params]


def level_span(sp) -> Tuple[int, int]:
    """The lowest and highest level a stage's lanes run at: a pipe's lane i
    runs at its level + i, any other stage's lanes at its level."""
    lo = sp["level"]
    return lo, lo + (sp["n_lanes"] - 1 if sp["kind"] == "pipe" else 0)


def active(span, row, n_main) -> bool:
    """Whether some lane of levels ``span`` is active in call row ``row``
    of a call delivering ``n_main`` steps: a lane at level l processes the
    superblock of ``row - l``, one of the call's iff 0 <= row - l < n_main.
    ``row`` None: every stage (a graph without pipes)."""
    return row is None or span[0] <= row < n_main + span[1]


def one_gather_routes(plan):
    """The per-lane routes of a plan's group stages (inputs and modulation)
    of two lanes or more that the step serves with one gather instead of a
    mix a lane and a stack: id(routing) -> (sources, lanes), the sources
    (stage, port, grouped, channels) and each lane's (source, lane), or None
    for a pad lane. Two kinds of route qualify:

    * every lane reads exactly one lane of one group output, as when a
      group is fed by part of a larger one (so no CHAIN): one source;
    * every lane reads one lane of a group output, the whole output of a
      single stage or nothing, with lanes of both of the first two kinds,
      as when streamed sounds' gains join the voices' gain group
      (config5_streamed): the sources joined, with a silent row for the
      pad lanes.

    A one-lane route keeps the mix: there the gather is one launch more (on
    an H100, 2.5 us a step more for config3_wah's four one-lane biquad
    stages). So do lanes that read single stages only: each is a view, and
    the stack is one launch (the vibrato's eight)."""
    gathers = {}
    for sp in plan:
        if sp["kind"] != "group":
            continue
        routes = [r for _, r in sp["inputs"]] + [m[2] for *_, m in sp["params"] if m]
        for routing in routes:
            if not routing or routing[0] == "CHAIN" or len(routing) < 2:
                continue
            if any(len(pl) > 1 or (pl and pl[0][0] == "ALL") for pl in routing):
                continue
            firsts = [pl[0] if pl else None for pl in routing]
            grouped = {p[2] is not None for p in firsts if p is not None}
            one_group = (grouped == {True} and None not in firsts
                         and len({p[:2] for p in firsts}) == 1)
            if not (one_group or grouped == {True, False}):
                continue
            sources = {}
            for p in firsts:
                if p is not None:
                    sources.setdefault(p[:2], (*p[:2], p[2] is not None, p[3]))
            order = list(sources)
            lanes = [None if p is None else (order.index(p[:2]), p[2] or 0) for p in firsts]
            gathers[id(routing)] = (list(sources.values()), lanes)
    return gathers


def _is_buffer_source(node) -> bool:
    """Buffer sources batch over a packed sample arena (duck-typed to avoid an
    import cycle with the nodes package)."""
    return hasattr(node, "process_poly_group") and hasattr(node, "_buffer")


#: Byte alignment of each array in ``to_device``'s staging buffer.
_STAGE_ALIGN = 64


def to_device(tree, device):
    """numpy arrays / scalars in a (nested) dict -> tensors on ``device``,
    values and dtypes kept; Python ints (host-side scalars such as a ring
    head) stay. For a CUDA device the arrays are packed into one pinned
    host buffer, each on a 64-byte boundary, copied up by one non-blocking
    copy, and returned as views of its device copy: no call here waits for
    the device (a pageable copy a leaf would synchronize once each)."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (np.ndarray, np.generic)):
            leaves.append(np.array(t))  # a copy: the result never aliases the caller's
            return _Leaf(len(leaves) - 1)
        return t

    skeleton = walk(tree)
    device = torch.device(device)
    if device.type != "cuda":
        tensors = [torch.from_numpy(a).to(device) for a in leaves]
    else:
        offs, total = [], 0
        for a in leaves:
            offs.append(total)
            total += -(-a.nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
        host = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
        flat = host.numpy()
        for a, off in zip(leaves, offs):
            flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = host.to(device, non_blocking=True)
        tensors = [dev[off:off + a.nbytes].view(torch.from_numpy(a.reshape(-1)[:0]).dtype)
                   .reshape(a.shape) for a, off in zip(leaves, offs)]

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        return tensors[t.index] if isinstance(t, _Leaf) else t

    return fill(skeleton)


class _Leaf:
    """An array's place in ``to_device``'s list of leaves."""

    __slots__ = ("index",)

    def __init__(self, index):
        self.index = index


class CompiledGraph:
    """Static schedule for a graph topology.

    Holds the topo order, resolved per-port channel counts, param encoding
    capacities, the stage plan and the stage constants. Immutable; rebuilt
    when the topology changes.
    """

    def __init__(self, context):
        self.context = context
        self.mesh = getattr(context, "mesh", None)
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
        # The nodes a launch asks each call: host-streamed data to stage
        # (``prepare_feed``) and sources whose ended-event it may fire.
        self.feed_nodes = [n for n in topo if hasattr(n, "prepare_feed")]
        self.notify_nodes = [n for n in topo if getattr(n, "wants_notify", False)]

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
        self._in_counts = node_in_counts

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
        self._fuse_chains()

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
            if kind in ("group", "pipe"):
                # Pipe lanes are pipeline stages, not voices: no phantom
                # padding (a phantom lane would change the delay).
                self.stage_pad[si] = (len(nodes), _next_pow2(len(nodes)) if kind == "group"
                                      else len(nodes))
                for lane, n in enumerate(nodes):
                    self.state_ref[n.node_id] = (key, lane)
            else:
                self.state_ref[nodes[0].node_id] = (key, None)
            if kind == "pipe":
                # The register bank migrates by composition like a group.
                self.state_composition[key + ".pipe"] = ("pipe",) + tuple(
                    n.node_id for n in nodes)
        if self.pipe_delay:
            self.state_composition["__pipe_bt__"] = ("bt", self.pipe_delay,
                                                     self.info.superblock)

        # Param encoding capacities: pow2 high-water marks, 0 for params that
        # never had events (the constant fast path).
        for node in topo:
            for name, p in node.params.items():
                c = p.event_count()
                self.param_capacity[(node.node_id, name)] = _next_pow2(c) if c else 0
        for kind, nodes, _ in self.stages:
            if kind in ("group", "pipe"):
                self._share_group_capacity(nodes)

        # ---- buffer-source arenas ------------------------------------------
        # One packed arena per buffer-source stage, width padded to a pow2
        # bucket, plus stacked per-voice geometry (also packed as one table)
        # and the polyphase taps.
        self.consts: Dict[str, object] = {}
        self._bufsrc_cfg: Dict[int, Tuple[int, tuple, int]] = {}
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind != "group" or not _is_buffer_source(nodes[0]):
                continue
            rep = nodes[0]
            variant = rep.kernel_variant()  # shared: it's in the group key
            if variant[0] == "poly":
                w, front = type(rep).poly_window(self.info.superblock, *variant[1:])
            elif variant[0] == "unity":
                w, front = type(rep).unity_window(self.info.superblock), 0
            else:  # resample: the window of the group's largest rate bound
                bound = max(n.rate_bound() for n in nodes)
                w, front = type(rep).resample_window(self.info.superblock, bound), 0
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
            # The same geometry packed for the card's one-launch group step.
            self.consts[f"st{si}/gtab"] = pack_group_table(
                stacked, w, variant, self.info.superblock, self.info.sample_rate)
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
            for name, arr in sc(self.mesh).items():
                self.consts[f"st{si}/{name}"] = arr

        self._build_plan()
        self._compute_sharding()
        # The whole constants, and this rank's (the same without a mesh).
        self.global_consts = self.consts
        self.consts = self.shard_consts(self.global_consts)

    # -- chain fusion -----------------------------------------------------------

    def _fuse_chains(self) -> None:
        """Fuse head-to-tail runs of same-key one-lane group stages into
        pipelined "pipe" stages (the JAX package's ``_fuse_chains``,
        graphaudio_tpu/core/graph.py:408-567): lane i of a K-lane pipe
        processes the superblock of i steps ago, lane 0 the live input and
        lane i lane i-1's output of the previous step from a carried
        register bank [K-1, C, T]. Every stage then runs at a LEVEL, the
        steps between the live clock and the audio it processes; the
        destination's level is the pipe delay D. Fusion is refused where a
        stage's inputs come from more than one level (a direct source tap
        beside a chained path), and where D would be 0 or above 64."""
        self.pipe_delay = 0
        self.stage_level = {}
        if not self.context.pipeline_chains:
            return
        stages = self.stages

        def fusable(entry):
            kind, nodes, key = entry
            if kind != "group" or len(nodes) != 1 or key is None:
                return False
            n = nodes[0]
            # A modulated param would need its modulator's output at the
            # lane's level, which the register bank does not carry.
            return (len(n.inputs) == 1 and len(n.outputs) == 1
                    and not _is_buffer_source(n) and not n._params_modulated())

        def links_to(a, b):
            """True when a's one output feeds exactly b's one input."""
            out = a.outputs[0]
            return (
                len(out.connections) == 1
                and not out.param_connections
                and out.connections[0] is b.inputs[0]
                and len(b.inputs[0].connected_outputs) == 1
                and self.output_channels[(a.node_id, 0)] == self.output_channels[(b.node_id, 0)]
                and self.input_channels[(b.node_id, 0)] == self.output_channels[(a.node_id, 0)]
            )

        stage_idx_of = {n.node_id: si for si, (_, nodes, _) in enumerate(stages) for n in nodes}

        def chain_key_of(si):
            """A node's ``chain_key`` where it has one (the biquad's leaves
            its type out), else its group key."""
            n = stages[si][1][0]
            fn = getattr(n, "chain_key", None)
            return stages[si][2] if fn is None else fn([self.input_channels[(n.node_id, 0)]])

        used, chains = set(), []
        for si, entry in enumerate(stages):
            if si in used or not fusable(entry):
                continue
            run, cur = [si], entry[1][0]
            while True:
                out = cur.outputs[0]
                if len(out.connections) != 1 or out.param_connections:
                    break
                nxt = out.connections[0].owner
                nsi = stage_idx_of.get(nxt.node_id)
                if (nsi is None or nsi in used or not fusable(stages[nsi])
                        or chain_key_of(nsi) != chain_key_of(run[0])
                        or not links_to(cur, nxt)):
                    break
                run.append(nsi)
                cur = nxt
            if len(run) >= 2:
                chains.append(run)
                used.update(run)
        if not chains:
            return

        head_of = {run[0]: run for run in chains}
        member = {si for run in chains for si in run[1:]}
        new_stages = []
        for si, entry in enumerate(stages):
            if si in member:
                continue
            if si in head_of:
                new_stages.append(("pipe", [stages[j][1][0] for j in head_of[si]], entry[2]))
            else:
                new_stages.append(entry)

        # Levels: a stage runs at the level of its producers' outputs (a
        # pipe's output leaves at its last lane's level); mixed levels refuse.
        out_level, level = {}, {}
        for si, (kind, nodes, _) in enumerate(new_stages):
            prods = set()
            for n in ([nodes[0]] if kind == "pipe" else nodes):
                for inp in n.inputs:
                    prods.update(o.owner.node_id for o in inp.connected_outputs)
                for p in n.params.values():
                    prods.update(o.owner.node_id for o in p._mod_outputs)
            in_levels = {out_level[nid] for nid in prods}
            if len(in_levels) > 1:
                return
            lvl = in_levels.pop() if in_levels else 0
            level[si] = lvl
            for n in nodes:
                out_level[n.node_id] = lvl + (len(nodes) - 1 if kind == "pipe" else 0)
        delay = level[len(new_stages) - 1]  # the destination's
        if delay <= 0 or delay > 64:
            return
        self.stages = new_stages
        self.stage_level = level
        self.pipe_delay = delay

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
            if kind in ("group", "pipe"):
                stage_real[si] = len(nodes)
            for lane, n in enumerate(nodes):
                stage_of[n.node_id] = si
                lane_of[n.node_id] = lane if kind in ("group", "pipe") else None

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
            # (name, a_rate, exact, modspec): modspec is None without
            # modulation, else (min, max, routing). A group's lanes agree on
            # WHICH params are modulated (the mod signature is in the group
            # key) and route their modulators like audio inputs, the 1:1
            # per-voice LFO -> param chain as CHAIN.
            params = tuple(
                (
                    name,
                    p.automation_rate == AutomationRate.A_RATE,
                    p.exact_eval,
                    (
                        float(p.min_value),
                        float(p.max_value),
                        chain_or_lanes(
                            nodes, lambda n, name=name: n.params[name]._mod_outputs,
                            self.stage_pad[si][1],
                        ) if kind == "group" else producers(p._mod_outputs),
                    ) if p._mod_outputs else None,
                )
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
                    "n_lanes": self.stage_pad[si][1] if kind in ("group", "pipe") else 1,
                    "level": self.stage_level.get(si, 0),
                    "group_key": gkey,
                    # A pipe's members may differ where the chain key leaves
                    # them out (the biquad's type): each lane's own key.
                    "lane_keys": (tuple(n.group_key(self._in_counts[n.node_id]) for n in nodes)
                                  if kind == "pipe" else None),
                    "inputs": inputs,
                    "params": params,
                    "out_counts": out_counts,
                    "bufsrc": self._bufsrc_cfg.get(si),
                }
            )
        self.plan = plan

    # -- mesh sharding -----------------------------------------------------------

    def _compute_sharding(self) -> None:
        """Decide per stage whether its lanes shard over the mesh's
        ``voice`` dimension (the JAX package's ``_compute_sharding``,
        graphaudio_tpu/core/graph.py:767-842).

        Candidates: groups whose padded lane count divides by the ``voice``
        size. Demotions, to a fixpoint (a demoted stage is computed whole on
        every rank): any lane-indexed read of a group's output (it would
        need the other ranks' lanes), per-lane input or modulation routing
        (the plan names global lanes), and CHAIN endpoints sharded unlike
        each other. Whole-group (ALL) fan-ins of a sharded stage complete
        with an all_reduce over ``voice``. ``part_sharded``: the singles
        whose node supports partition sharding under a ``part`` size > 1
        (``supports_part_sharding``)."""
        self.sharded_stages = set()
        self.part_sharded = set()
        self.voice_size = self.part_size = 1
        self.voice_index = self.part_index = 0
        self.voice_group = self.part_group = None
        if self.mesh is None:
            self.render_sharded = False
            return
        self.voice_size = axis_size(self.mesh, "voice")
        self.part_size = axis_size(self.mesh, "part")
        if self.part_size > 1:
            for sp in self.plan:
                if sp["kind"] == "single" and getattr(
                        sp["rep"], "supports_part_sharding", lambda m: False)(self.mesh):
                    self.part_sharded.add(sp["si"])
        n = self.voice_size
        cand = {sp["si"] for sp in self.plan
                if sp["kind"] == "group" and sp["n_lanes"] % n == 0}
        changed = True
        while changed:
            changed = False

            def demote(si):
                nonlocal changed
                if si in cand:
                    cand.discard(si)
                    changed = True

            def scan_prods(prods):
                for p in prods:
                    if p[0] != "ALL" and p[2] is not None:
                        demote(p[0])

            for sp in self.plan:
                if sp["kind"] == "group":
                    routings = [r for _c, r in sp["inputs"]]
                    routings.extend(p[3][2] for p in sp["params"] if p[3] is not None)
                    for routing in routings:
                        if routing and routing[0] == "CHAIN":
                            src = routing[1]
                            if (sp["si"] in cand) != (src in cand):
                                demote(sp["si"])
                                demote(src)
                        else:
                            if any(pl for pl in routing):
                                demote(sp["si"])
                            for pl in routing:
                                scan_prods(pl)
                else:
                    for _c, prods in sp["inputs"]:
                        scan_prods(prods)
                    for p in sp["params"]:
                        if p[3] is not None:
                            scan_prods(p[3][2])
        self.sharded_stages = cand if n > 1 else set()
        # Part-sharded singles run sharded even where no voice group
        # shards: part_sharded never names a distribution that did not run.
        self.render_sharded = bool(self.sharded_stages or self.part_sharded)
        if self.sharded_stages:
            self.voice_index = axis_index(self.mesh, "voice")
            self.voice_group = axis_group(self.mesh, "voice")
        if self.part_sharded:
            self.part_index = axis_index(self.mesh, "part")
            self.part_group = axis_group(self.mesh, "part")

    def lane_range(self, key: str):
        """The global lanes [lo, hi) that this rank holds of stage ``key``
        ("st<i>"), or None for a stage held whole."""
        si = int(key[2:]) if key.startswith("st") and key[2:].isdigit() else None
        if si not in getattr(self, "sharded_stages", ()):
            return None
        n = self.stage_pad[si][1] // self.voice_size
        return self.voice_index * n, (self.voice_index + 1) * n

    def local_lane(self, key: str, lane):
        """A stage's global lane as this rank's index into its state, or
        None where another rank holds it (lane None: a single, itself)."""
        rng = self.lane_range(key)
        if rng is None or lane is None:
            return lane
        return lane - rng[0] if rng[0] <= lane < rng[1] else None

    def shard_state(self, key: str, st):
        """This rank's part of stage ``key``'s whole numpy state: its lanes
        of a voice-sharded group, the whole of any other stage's."""
        rng = self.lane_range(key)
        if rng is None or not isinstance(st, dict):
            return st
        return {k: np.asarray(v)[rng[0]:rng[1]] for k, v in st.items()}

    def shard_consts(self, consts: dict) -> dict:
        """This rank's constants from the whole ones (numpy): a sharded
        source group's geometry cut to its lanes and its packed table packed
        again from them; a part-sharded stage's partition spectra cut to
        its slice on the node's ``const_part_axes`` (a const the node does
        not declare raises: it is neither known to be replicated nor known
        to be cut); the rest whole. Returns ``consts`` itself without a
        sharded stage."""
        if not self.render_sharded:
            return consts
        out = dict(consts)
        for si in self.sharded_stages:
            key = f"st{si}"
            if f"{key}/geom" not in consts:
                continue
            lo, hi = self.lane_range(key)
            geom = {k: np.asarray(v)[lo:hi] for k, v in consts[f"{key}/geom"].items()}
            out[f"{key}/geom"] = geom
            w, variant, _ = self._bufsrc_cfg[si]
            out[f"{key}/gtab"] = pack_group_table(geom, w, variant, self.info.superblock,
                                                  self.info.sample_rate)
        rep_of = {sp["si"]: sp["rep"] for sp in self.plan}
        for name, arr in consts.items():
            si = int(name.split("/", 1)[0][2:])
            if si not in self.part_sharded:
                continue
            local = name.split("/", 1)[1]
            axes = getattr(rep_of[si], "const_part_axes", {})
            if local not in axes:
                raise ValueError(f"stage const {name!r} of a part-sharded stage has no "
                                 "partition axis in its node's const_part_axes")
            ax = axes[local]
            n = np.shape(arr)[ax]
            if n % self.part_size:
                raise ValueError(f"stage const {name!r}: {n} partitions do not split over "
                                 f"part = {self.part_size}")
            m = n // self.part_size
            out[name] = np.take(arr, np.arange(self.part_index * m, (self.part_index + 1) * m),
                                axis=ax)
        return out

    def signature(self):
        """Structural identity of the step function: two CompiledGraphs with
        equal signatures compute the same function of (states, encs,
        consts, clocks). Group stages key on their batching key; singles on
        node identity + config version. (The JAX package keys its compiled-
        program cache on it; PyTorch runs eagerly, so the port rebuilds its
        step function on every graph build and keeps this as the graph's
        identity for callers and tests.)"""
        sig = [("hdr", self.info.sample_rate, self.info.superblock, self.pipe_delay)]
        if self.mesh is not None:
            sig.append(("mesh", self.voice_size, self.part_size,
                        tuple(sorted(self.sharded_stages)), tuple(sorted(self.part_sharded))))
        for sp in self.plan:
            if sp["kind"] == "group":
                ident = ("G", sp["group_key"], sp["n_lanes"], sp["bufsrc"])
            elif sp["kind"] == "pipe":
                # each lane's key: two pipes with one head but different
                # member types compute different functions
                ident = ("P", sp["lane_keys"], sp["n_lanes"], sp["level"])
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
            if kind in ("group", "pipe"):
                members = [self._init_node_state(n) for n in nodes]
                real, padded = self.stage_pad[si]
                members += [nodes[0].init_state(self.info) for _ in range(padded - real)]
                states[f"st{si}"] = {
                    k: np.stack([np.asarray(m[k]) for m in members])
                    for k in members[0]
                }
            else:
                states[f"st{si}"] = self._init_node_state(nodes[0])
            if kind == "pipe":
                # The audio in flight between lanes, silent at the start.
                c = self.output_channels[(nodes[0].node_id, 0)]
                states[f"st{si}.pipe"] = {
                    "reg": np.zeros((len(nodes) - 1, c, self.info.frames), np.float32)}
        if self.pipe_delay:
            # The block clocks of the last D steps, the latest first (the
            # JAX package's ring; a level-l stage runs at row l - 1's).
            states["__pipe_bt__"] = np.zeros((self.pipe_delay, self.info.superblock),
                                             np.float64)
        # Context-level globals (listener transform) travel in the state, so
        # they are data, not rebuild triggers.
        states["__globals__"] = self.context.global_state()
        return {k: self.shard_state(k, v) for k, v in states.items()}

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
            if kind in ("group", "pipe"):
                self._share_group_capacity(nodes)
        encs = {}
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind in ("group", "pipe"):
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
        # A sharded group keeps its lanes' encodings; the step's tables are
        # packed from them (so the K6 table holds this rank's rows).
        for si in self.sharded_stages:
            for name in self.stages[si][1][0].params:
                key = f"st{si}/{name}"
                encs[key] = self.shard_state(f"st{si}", encs[key])
        self._pack_prologue(encs)
        return encs

    def _pack_prologue(self, encs) -> None:
        """Add the step's batched tables to ``encs``: the K6 table of every
        evaluated param with events (``PARAM_TABLE``), and per batch
        function of the stages' prologue requests its table, the stage keys
        it serves and the function (``PROLOGUE``). A stage with a modulated
        prologue param gets reserved K6 arena rows for each such param and
        a one-item table of its own, run at its turn (``DEFERRED``: stage
        key -> function and table)."""
        S, D = self.info.superblock, self.pipe_delay
        entries, reserved = [], []
        for sp in self.plan:
            if not _evaluates_params(sp):
                continue
            deferred = _deferred_params(sp)
            # Each row's clock: row D - l of the step's clock matrix for a
            # lane at level l (a pipe's lane i runs at its level + i).
            clock = D - sp["level"] - (np.arange(sp["n_lanes"]) if sp["kind"] == "pipe" else 0)
            for name, a_rate, exact, _ in sp["params"]:
                key = f"{sp['key']}/{name}"
                npb = FRAMES_PER_BLOCK if a_rate else 1
                if encs[key]["times"].shape[-1]:
                    entries.append((key, encs[key], npb, exact, clock))
                if name in deferred:
                    reserved.append((key, npb, np.shape(encs[key]["base"])))
        table = pack_param_table(entries, S, reserved)
        batches, deferred_tables = {}, {}
        for sp in self.plan:
            if not _evaluates_params(sp):
                continue
            slots = {}
            for name, a_rate, exact, _ in sp["params"]:
                key = f"{sp['key']}/{name}"
                slot = table["reserved"].get(key, table["slots"].get(key))
                if slot is None and not encs[key]["times"].shape[-1]:
                    slot = constant_slot(encs[key], FRAMES_PER_BLOCK if a_rate else 1, S)
                slots[name] = slot
            lanes = self.stages[sp["si"]][1] if sp["kind"] == "pipe" else None
            req = sp["rep"].prologue_request(slots, lanes)
            if req is None:
                continue
            if _deferred_params(sp):
                deferred_tables[sp["key"]] = {"run": req.run, "table": req.pack([req.item], S)}
            else:
                batch = batches.setdefault(req.run, (req.pack, [], [], []))
                batch[1].append(sp["key"])
                batch[2].append(req.item)
                batch[3].append(level_span(sp))
        encs[PARAM_TABLE] = table
        # "levels": the lowest and highest level of the stages a batch
        # serves; the step skips it in a row outside the span of rows in
        # which one of them is active.
        encs[PROLOGUE] = {
            str(i): {"run": run, "keys": tuple(keys), "table": pack(items, S),
                     "levels": (min(lo for lo, _ in spans), max(hi for _, hi in spans))}
            for i, (run, (pack, keys, items, spans)) in enumerate(batches.items())
        }
        encs[DEFERRED] = deferred_tables

    # -- the step function ---------------------------------------------------

    def make_step_fn(self):
        """Build the step function from the snapshotted plan. It captures
        only the plan and each stage representative's kernel methods, never
        live connection lists. Returns (step, destination channel count).

        ``step(states, encs, consts, clocks, frame0, row=None, n_main=None,
        feeds=None)``:
        ``clocks`` f64[D+1, S] are the block clocks of the last D+1 steps,
        the live one last (D = ``pipe_delay``; a stage at level l runs at
        row D - l, the superblock that began at ``frame0 - l * T``).
        ``row`` and ``n_main`` place the step in its render call for a
        graph with pipes: a stage none of whose lanes is active in the row
        (``active``) is skipped and keeps its state (its output would feed
        only stages as idle), and a pipe commits only its active lanes'.
        ``feeds`` are the call's staged feeds, handed to every stage's
        context (``RenderContext.feeds``); a stream node is a source at
        level 0, so it runs in the call's rows 0 to n_main - 1 only and
        the drain rows read no feed.
        Returns (new states, destination audio f32[C, T], or None in a
        row where the destination is idle)."""
        info = self.info
        plan = self.plan
        D = self.pipe_delay
        T = info.frames
        dest_channels = self.input_channels[(self.destination.node_id, 0)]

        # (name, a-rate, exact, modspec, encoding key) of each stage's
        # params, but the unmodulated ones that only its prologue request
        # reads
        stage_params = {
            sp["key"]: [(name, a_rate, exact, modspec, f"{sp['key']}/{name}")
                        for name, a_rate, exact, modspec in sp["params"]
                        if modspec is not None or name not in sp["rep"].prologue_params]
            for sp in plan
        }
        spans = {sp["key"]: level_span(sp) for sp in plan}

        gathers = one_gather_routes(plan)
        lane_index = {}
        # The fan-in of a voice-sharded stage completes over ``voice``; a
        # part-sharded stage runs its slice of the partitions.
        fan_group = {si: self.voice_group for si in self.sharded_stages}
        part_of = {si: (self.part_index, self.part_group) for si in self.part_sharded}

        def step(states, encs, consts, clocks, frame0, row=None, n_main=None, feeds=None):
            by_level = {}

            def rc_for(level):
                """The context of a stage at ``level``: the superblock that
                began ``level`` steps before the live one."""
                rc = by_level.get(level)
                if rc is None:
                    rc = by_level[level] = RenderContext(info, frame0 - level * T,
                                                         clocks[D - level])
                    rc.globals = states["__globals__"]
                    rc.feeds = feeds
                return rc

            live = rc_for(0)
            out_table: Dict[Tuple[int, int], object] = {}
            new_states = {"__globals__": live.globals}
            dest_out = None

            # Prologue: one K6 launch evaluates every automated param of the
            # step into one arena, each row at its stage's clock, then each
            # batch function of the stages' requests (K8 for the biquads,
            # K10b for the panners) runs once, unless none of the stages it
            # serves is active in this row; a deferred request runs at its
            # stage's turn (run_process).
            table = encs[PARAM_TABLE]
            slots, reserved = table["slots"], table["reserved"]
            deferred = encs[DEFERRED]
            arena = eval_intrinsic_batch(table, clocks, live.dt) if table["size"] else None
            prologue = {}
            for batch in encs[PROLOGUE].values():
                if active(batch["levels"], row, n_main):
                    prologue.update(zip(batch["keys"], batch["run"](batch["table"], arena, live)))

            def mixed_signal(prods, dst_c):
                """Sum producer outputs into one [dst_c, T] block — the
                reference's fan-in summing junction (AudioNodeInput.cs:100-138).
                Lane sums of a group tensor go through K3 (fan_in_lanes)."""
                lanes: Dict[Tuple[int, int], list] = {}
                parts = []
                for p in prods:
                    if p[0] == "ALL":
                        lanes_out = out_table[(p[1], p[2])]
                        parts.append(fan_in_lanes(lanes_out, dst_c, fan_group.get(p[1])))
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
                    return torch.zeros((dst_c, T), dtype=torch.float32, device=clocks.device)
                acc = parts[0]
                for p in parts[1:]:
                    acc = acc + p
                return acc

            def gathered(routing, dst_c):
                """A ``one_gather_routes`` route's lanes, f32[V, dst_c, T],
                by one gather (each element mixed as ``mixed_signal`` mixes
                it), or None for another route or a down-mix of more than
                two channels. One source without pad lanes is gathered,
                then re-channelled; several, or pad lanes, are re-channelled
                and joined by one ``cat`` (a silent row for the pads)
                first."""
                g = gathers.get(id(routing))
                if g is None:
                    return None
                sources, lanes = g
                if not all(c in (1, dst_c) or (c, dst_c) == (2, 1) for *_, c in sources):
                    return None
                tables = [out_table[(psi, pport)] if grouped else out_table[(psi, pport)][None]
                          for psi, pport, grouped, _ in sources]
                pad = None in lanes
                join = pad or len(tables) > 1
                if join:
                    tables = [adapt_channels(t.transpose(0, 1), dst_c).transpose(0, 1)
                              for t in tables]
                    if pad:
                        tables.append(torch.zeros((1, dst_c, T), dtype=torch.float32,
                                                  device=clocks.device))
                table = torch.cat(tables) if len(tables) > 1 else tables[0]
                idx = lane_index.get((id(routing), table.device))
                if idx is None:
                    offs = np.cumsum([0] + [t.shape[0] for t in tables])
                    idx = lane_index[(id(routing), table.device)] = torch.tensor(
                        [offs[-2] if lane is None else offs[lane[0]] + lane[1]
                         for lane in lanes], device=table.device)
                t = table.index_select(0, idx)
                return t if join else adapt_channels(t.transpose(0, 1), dst_c).transpose(0, 1)

            def modulation(sp, routing):
                """A modulated param's modulation input, f32[V, Cm, T]: a
                CHAIN route's producer group output as it is, else each
                lane's mixed mono sum (a stage's one lane: [1, 1, T])."""
                if sp["kind"] != "group":
                    return mixed_signal(routing, 1)[None]
                if routing and routing[0] == "CHAIN":
                    return out_table[(routing[1], routing[2])]
                g = gathered(routing, 1)
                if g is not None:
                    return g
                return torch.stack([mixed_signal(pl, 1) for pl in routing])

            def eval_params(sp, key, rc):
                """Each param's values: its rows of the arena, or (no
                events) its base value as a broadcast view; a modulated
                param then goes through K6m (apply_modulation), once a
                step, into its reserved arena rows where the stage's
                prologue request reads it."""
                params = {}
                for name, a_rate, exact, modspec, pkey in stage_params[key]:
                    slot = slots.get(pkey)
                    if slot is None:
                        vals = eval_intrinsic_blocked(
                            encs[pkey], rc.block_times, FRAMES_PER_BLOCK if a_rate else 1,
                            rc.dt, exact=exact,
                        )
                    else:
                        vals = arena.narrow(0, slot.off, slot.lanes * slot.per_lane).view(
                            *slot.shape, slot.per_lane)
                    if modspec is not None:
                        lo, hi, routing = modspec
                        mod = modulation(sp, routing)
                        held = reserved.get(pkey)
                        dst = None if held is None else arena.narrow(
                            0, held.off, held.lanes * held.per_lane).view(mod.shape[0], -1)
                        vals = apply_modulation(vals.reshape(mod.shape[0], -1), mod, lo, hi,
                                                a_rate, out=dst).reshape(vals.shape)
                    params[name] = ParamSignal(vals, a_rate)
                return params

            def run_process(sp, key, inputs, params, rc):
                prefix = key + "/"
                rc.stage_consts = {
                    n[len(prefix):]: v for n, v in consts.items() if n.startswith(prefix)
                }
                # A deferred request runs now: K6m has written its rows.
                d = deferred.get(key)
                rc.prologue_result = (d["run"](d["table"], arena, rc)[0] if d is not None
                                      else prologue.get(key))
                rc.part = part_of.get(sp["si"])
                result = sp["rep"].process(states[key], inputs, params, rc)
                rc.stage_consts = {}
                rc.prologue_result = None
                rc.part = None
                return result

            def run_single(sp):
                si, key = sp["si"], sp["key"]
                rc = rc_for(sp["level"])
                params = eval_params(sp, key, rc)
                inputs = [mixed_signal(prods, c) for c, prods in sp["inputs"]]
                st, outs = run_process(sp, key, inputs, params, rc)
                new_states[key] = st
                for i, o in enumerate(outs):
                    out_table[(si, i)] = o

            def stacked_inputs(sp, inp_idx):
                """Contiguous [V, C, T] inputs for a group (the kernels take
                no strides): CHAIN is the identity fast path; one lane of
                one group a lane is one gather; otherwise per-lane mixing,
                phantom pad lanes silent."""
                dst_c, routing = sp["inputs"][inp_idx]
                if routing and routing[0] == "CHAIN":
                    t = out_table[(routing[1], routing[2])]
                    if routing[3] != dst_c:
                        # all lanes at once: channels lead in adapt_channels,
                        # whose mono up-mix is a stride-0 view
                        t = adapt_channels(t.transpose(0, 1), dst_c).transpose(0, 1).contiguous()
                    return t
                g = gathered(routing, dst_c)
                if g is not None:
                    return g.contiguous()
                return torch.stack([mixed_signal(pl, dst_c) for pl in routing])

            def run_group(sp):
                si, key, rep = sp["si"], sp["key"], sp["rep"]
                rc = rc_for(sp["level"])
                if sp["bufsrc"] is not None:
                    # The unity and polyphase source groups consume no
                    # params (playbackRate is baked into the variant); the
                    # time-varying one takes its k-rate playbackRate rows
                    # from the K6 arena, or the lanes' base values.
                    w, variant, _ = sp["bufsrc"]
                    arena_, geom = consts[f"{key}/arena"], consts[f"{key}/geom"]
                    gtab = consts[f"{key}/gtab"]
                    if variant[0] == "resample":
                        rate = eval_params(sp, key, rc)["playbackRate"].per_block()
                        sts, out = type(rep).process_resample_group(
                            states[key], arena_, geom, gtab, rate, rc, w)
                    elif variant[0] == "poly":
                        sts, out = type(rep).process_poly_group(
                            states[key], arena_, geom, gtab, rc, w, variant[1], variant[2],
                            (consts[f"{key}/poly_w"], consts[f"{key}/poly_b"]),
                        )
                    else:
                        sts, out = type(rep).process_unity_group(
                            states[key], arena_, geom, gtab, rc, w, aligned=variant[1])
                    outs = [out]
                else:
                    params = eval_params(sp, key, rc)
                    inputs = [stacked_inputs(sp, i) for i in range(len(sp["inputs"]))]
                    sts, outs = run_process(sp, key, inputs, params, rc)
                new_states[key] = sts
                for i, o in enumerate(outs):  # o: [V, C, T]
                    out_table[(si, i)] = o

            def run_pipe(sp):
                """A fused chain: one launch of the stage's kernel over its K
                lanes, lane 0 on the live input, lane i on lane i-1's
                output of the previous step (the register bank), each
                lane's params from its own clock's arena rows."""
                si, key = sp["si"], sp["key"]
                base, K = sp["level"], sp["n_lanes"]
                rc = rc_for(base)
                params = eval_params(sp, key, rc)
                dst_c, routing = sp["inputs"][0]
                # Lane 0's producers were skipped in a row where it idles.
                fresh = (mixed_signal(routing, dst_c) if active((base, base), row, n_main)
                         else torch.zeros((dst_c, T), dtype=torch.float32, device=clocks.device))
                lane_in = torch.cat([fresh[None], states[key + ".pipe"]["reg"]])
                sts, outs = run_process(sp, key, [lane_in], params, rc)
                # Lane i is active in rows base + i <= row < n_main + base + i.
                lo = 0 if row is None else max(0, row - n_main - base + 1)
                hi = K if row is None else min(K, row - base + 1)
                if (lo, hi) != (0, K):
                    old = states[key]
                    sts = {k: v if v is old[k] else torch.cat([old[k][:lo], v[lo:hi], old[k][hi:]])
                           for k, v in sts.items()}
                new_states[key] = sts
                # What an idle lane writes to the bank is read only by a lane
                # idle in the next row.
                new_states[key + ".pipe"] = {"reg": outs[0][:-1]}
                for i, o in enumerate(outs):
                    out_table[(si, i)] = o

            for sp in plan:
                key = sp["key"]
                if not active(spans[key], row, n_main):
                    new_states[key] = states[key]
                    if sp["kind"] == "pipe":
                        new_states[key + ".pipe"] = states[key + ".pipe"]
                elif sp["kind"] == "single":
                    run_single(sp)
                elif sp["kind"] == "group":
                    run_group(sp)
                elif sp["kind"] == "pipe":
                    run_pipe(sp)
                else:  # destination: passthrough sink (AudioDestinationNode.cs:42-64)
                    dst_c, prods = sp["inputs"][0]
                    dest_out = mixed_signal(prods, dst_c)
                    new_states[key] = states[key]
            if D:
                new_states["__pipe_bt__"] = states["__pipe_bt__"]
            return new_states, dest_out

        return step, dest_channels

    def make_render_fn(self):
        """Multi-superblock renderer: the step in a Python loop over
        superblocks. ``render(states, encs, consts, block_times f64[n, S],
        frame0s, first_row=0, n_main=None, feeds=None)`` runs n rows of a render call
        from its row ``first_row`` and returns (states, out f32[C, m*T]),
        the audio of its m rows at or past the pipe delay D (all n without
        pipes). A call that delivers ``n_main`` steps runs n_main + D rows,
        its clocks continuing past its end; the rows before D refill the
        pipes, the last D drain them. Each row's clock matrix is a view of
        the launch's clocks behind the carried ring of the last D
        (``__pipe_bt__``), which the launch leaves holding its own last D."""
        step, dest_channels = self.make_step_fn()
        D = self.pipe_delay

        def render(states, encs, consts, block_times, frame0s, first_row=0, n_main=None,
                   feeds=None):
            if D:
                clocks = torch.cat([states["__pipe_bt__"].flip(0), block_times])
            else:
                clocks = block_times
            outs = []
            for j, frame0 in enumerate(frame0s):
                row = first_row + j if D else None
                states, out = step(states, encs, consts, clocks[j:j + D + 1], int(frame0),
                                   row, n_main, feeds)
                if out is not None:
                    outs.append(out)
            if D:
                states["__pipe_bt__"] = clocks[-D:].flip(0)
            if not outs:
                return states, torch.zeros((dest_channels, 0), dtype=torch.float32,
                                           device=block_times.device)
            return states, torch.cat(outs, dim=1)

        return render, dest_channels
