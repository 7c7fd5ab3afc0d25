"""Audio contexts: block clock, command queue, graph build, rendering.

The port of graphaudio_tpu/core/context.py. ``AudioContextBase`` mirrors
GraphAudio.Core/AudioContextBase.cs: the block clock, the destination node,
the command queue (``post`` / ``execute_or_post`` / ``post_at``).
``OfflineAudioContext`` mirrors GraphAudio.Core/OfflineAudioContext.cs:
synchronous rendering of N frames with a partial-superblock carry.

The device is explicit: ``device="cuda"`` by default, and a context asked for
CUDA where there is none raises — nothing falls back to the CPU. State lives
on that device as dicts of tensors between calls; graph edits apply at
render boundaries.

``pack_int16`` is K4, the interleaved int16 PCM pack of ``render_pcm16``;
``render_mulaw`` and ``render_adpcm`` pack with K4mu and K4a (ops/wire.py).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import (
    DEFAULT_SAMPLE_RATE,
    DEFAULT_SUPERBLOCK,
    FRAMES_PER_BLOCK,
)
from graphaudio_tpu_torch.core.graph import CompiledGraph, StaticRenderInfo, to_device
from graphaudio_tpu_torch.ops import wire
from graphaudio_tpu_torch.ops.hrtf import N_AZIMUTH, N_ELEVATION, load_hrir_grid
from graphaudio_tpu_torch.ops.wire import ImaDeviceStream, pack_mulaw
from graphaudio_tpu_torch.utils import cudabuild
from graphaudio_tpu_torch.utils.profiling import RenderStats


# ---- K4: int16 PCM pack ------------------------------------------------------


def pack_int16_plain(outs):
    """Plain torch K4: f32[C, T] -> int16[T*C] interleaved,
    round_half_even(clip(x, -1, 1) * 32767) (the JAX package's _pack_int16)."""
    pcm = torch.round(torch.clamp(outs, -1.0, 1.0) * 32767.0)
    return pcm.to(torch.int16).T.reshape(-1)


def pack_int16(outs):
    """K4: [C, T] f32 audio -> flat interleaved int16 PCM. Quantization
    error is <= 0.5/32767 of full scale. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if outs.device.type == "cpu":
        return pack_int16_plain(outs)
    cudabuild.require(outs, "outs", torch.float32, ndim=2)
    C, T = outs.shape
    out = torch.empty((T * C,), dtype=torch.int16, device=outs.device)
    status = cudabuild.launcher("ga_pack_int16")(outs.data_ptr(), out.data_ptr(), C, T,
                                                 cudabuild.stream_of(outs))
    cudabuild.check(status, "ga_pack_int16")
    cudabuild.launches["pack_int16"] += 1
    return out


def resolve_device(device) -> torch.device:
    """The render device; CUDA must exist when asked for (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to render on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def parse_chunk_schedule(override) -> List[int]:
    """Steps per launch: an int, an iterable of ints, a "5,34"-style string
    (the last entry repeats), or None for the GA_RENDER_CHUNK env var
    (default 64). Raises ValueError on anything else, bools and dicts
    included."""
    src = "chunk_schedule" if override is not None else "GA_RENDER_CHUNK"
    if override is None:
        raw = os.environ.get("GA_RENDER_CHUNK", "64")
    elif isinstance(override, (bool, dict)):
        raise ValueError(
            f"chunk_schedule must be an int, a comma-separated string, or an "
            f"iterable of positive integers; got {override!r}"
        )
    elif isinstance(override, int):
        raw = str(override)
    elif isinstance(override, str):
        raw = override
    else:
        try:
            items = list(override)
        except TypeError:
            raise ValueError(
                f"chunk_schedule must be an int, a comma-separated string, or "
                f"an iterable of positive integers; got {override!r}"
            ) from None
        if not all(isinstance(c, int) and not isinstance(c, bool) for c in items):
            raise ValueError(f"chunk_schedule entries must be ints, got {items!r}")
        raw = ",".join(str(c) for c in items)
    try:
        sched = [int(c.strip()) for c in raw.split(",")]
    except ValueError:
        raise ValueError(
            f"{src} must be a comma-separated list of positive integers "
            f"(e.g. '5,34'), got {raw!r}"
        ) from None
    if any(c <= 0 for c in sched):
        raise ValueError(f"{src} entries must be positive, got {sched}")
    return sched


def _same_structure(a, b) -> bool:
    """Same keys, shapes and dtypes (host ints compare by type)."""
    if set(a) != set(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if isinstance(x, torch.Tensor) and (x.shape != y.shape or x.dtype != y.dtype):
            return False
    return True


class AudioContextBase:
    def __init__(
        self,
        sample_rate: int = DEFAULT_SAMPLE_RATE,
        superblock: int = DEFAULT_SUPERBLOCK,
        pipeline_chains: bool = False,
        device="cuda",
    ):
        """``pipeline_chains`` fuses head-to-tail chains of same-type nodes
        into one pipelined stage (core/graph.py ``_fuse_chains``), as the
        reference does: a render call then runs the pipe delay's D steps
        more than it delivers, and its audio equals the unfused render's,
        bit for bit."""
        if sample_rate <= 0:
            raise ValueError("sample_rate must be positive")
        if superblock <= 0:
            raise ValueError("superblock must be positive")
        self.device = resolve_device(device)
        self.sample_rate = int(sample_rate)
        self.superblock = int(superblock)
        self.pipeline_chains = bool(pipeline_chains)
        self._nodes: Dict[int, object] = {}
        self._pending: deque = deque()
        self._timed: List = []  # (time, seq, command) — see post_at
        self._timed_seq = 0
        self._topology_version = 0
        self._compiled: Optional[CompiledGraph] = None
        self._compiled_version = -1
        self._render_fn = None
        self._dest_channels = None
        self._states = None
        self._consts = None
        self._encs = None
        self._param_versions: Dict = {}
        self._current_frame = 0  # host-side absolute frame counter
        # The reference's clock ACCUMULATES (`_currentTime = blockTime +
        # increment`, AudioContextBase.cs:77-78); replicating the exact
        # rounding sequence keeps event boundaries sample-exact.
        self._current_time = 0.0
        self._carry: Optional[np.ndarray] = None  # [C, n] leftover rendered frames
        # Steps enqueued per launch before their audio is copied to the host
        # (see parse_chunk_schedule); None defers to GA_RENDER_CHUNK.
        self.chunk_schedule = None
        self.stats = RenderStats()
        self._disposed = False
        self._disposing_callbacks: List[Callable] = []

        # Listener transform for spatialization. Right-handed basis with
        # ahead = -forward (parity: SteamAudioContext.SetListener, :136-164).
        self._listener = {
            "listener_pos": np.zeros(3, np.float32),
            "listener_right": np.array([1, 0, 0], np.float32),
            "listener_up": np.array([0, 1, 0], np.float32),
            "listener_ahead": np.array([0, 0, 1], np.float32),
        }
        # Context-level default HRIR set (parity: SteamAudioContext.cs:82-106);
        # None = the analytic spherical-head model.
        self._default_hrir = None
        self._default_hrir_uid = 0

        from graphaudio_tpu_torch.nodes.destination import AudioDestinationNode

        self.destination = AudioDestinationNode(self)

    # -- spatialization globals -------------------------------------------------

    def set_default_hrir(self, source, n_azimuth=None, n_elevation=None,
                         length=None) -> None:
        """Install a measured HRIR set as the DEFAULT of every
        SpatialPannerNode without a per-node override (parity: the
        reference's per-context HRTF, SteamAudioContext.cs:82-106).

        ``source``: SOFA path, .npz path, or dict with ``hrir`` /
        ``azimuth_deg`` / ``elevation_deg`` / ``sample_rate`` (see
        ops/hrtf.load_hrir_grid). None reverts to the analytic model.
        """
        if source is None:
            grid = None
        else:
            grid = load_hrir_grid(
                source, self.sample_rate,
                n_azimuth=n_azimuth or N_AZIMUTH,
                n_elevation=n_elevation or N_ELEVATION,
                length=length,
            )

        def do(ctx):
            ctx._default_hrir = grid
            ctx._default_hrir_uid += 1
            # The grid is a stage constant of every panner group keyed on
            # the context default: rebuild.
            ctx._invalidate_topology()

        self.execute_or_post(do)

    def set_listener(self, position, forward, up) -> None:
        """Set the listener transform (parity: SteamAudioContext.SetListener).

        ``ahead = -forward`` mirrors the reference's phonon-convention basis.
        The listener is device data in the render state
        (``states["__globals__"]``): moving it rebuilds nothing.
        """
        position = np.asarray(position, np.float32)
        forward = np.asarray(forward, np.float64)
        up = np.asarray(up, np.float64)
        f = forward / max(np.linalg.norm(forward), 1e-9)
        u = up / max(np.linalg.norm(up), 1e-9)
        right = np.cross(f, u)
        right /= max(np.linalg.norm(right), 1e-9)
        true_up = np.cross(right, f)
        listener = {
            "listener_pos": position,
            "listener_right": right.astype(np.float32),
            "listener_up": true_up.astype(np.float32),
            "listener_ahead": (-f).astype(np.float32),
        }

        def do(ctx):
            # Through the command queue, as in the JAX package: a realtime
            # render rebinds ctx._states between steps.
            ctx._listener = listener
            if ctx._states is not None and "__globals__" in ctx._states:
                ctx._states["__globals__"] = to_device(listener, ctx.device)

        self.execute_or_post(do)

    def global_state(self) -> dict:
        return dict(self._listener)

    # -- clock (parity: AudioContextBase.cs:28,64-79,220-223) -----------------

    @property
    def current_time(self) -> float:
        """Current render time in seconds (accumulated double)."""
        return self._current_time

    @property
    def current_block(self) -> int:
        return self._current_frame // FRAMES_PER_BLOCK

    def frames_to_seconds(self, frames: int) -> float:
        return frames / self.sample_rate

    def seconds_to_frames(self, seconds: float) -> int:
        return int(seconds * self.sample_rate)

    # -- node registry ----------------------------------------------------------

    def _register_node(self, node) -> None:
        self._nodes[node.node_id] = node

    def _unregister_node(self, node) -> None:
        self._nodes.pop(node.node_id, None)
        self._invalidate_topology()

    def _invalidate_topology(self) -> None:
        self._topology_version += 1

    def get_all_nodes(self) -> List:
        """All nodes reachable from the destination (AudioContextBase.cs:191-218)."""
        seen = set()
        result = []
        stack = [self.destination]
        while stack:
            node = stack.pop()
            if node.node_id in seen:
                continue
            seen.add(node.node_id)
            result.append(node)
            for inp in node.inputs:
                for out in inp.connected_outputs:
                    if out.owner.node_id not in seen:
                        stack.append(out.owner)
            for param in node.params.values():
                for out in param._mod_outputs:
                    if out.owner.node_id not in seen:
                        stack.append(out.owner)
        return result

    # -- command queue (parity: AudioContextBase.cs:266-305) ------------------

    def post(self, command: Callable) -> None:
        """Enqueue a command to run at the next render boundary."""
        if self._disposed:
            raise RuntimeError("context is disposed")
        self._pending.append(command)

    def execute_or_post(self, command: Callable) -> None:
        """Execute immediately (an offline context is never mid-render when
        host code runs)."""
        if self._disposed:
            raise RuntimeError("context is disposed")
        command(self)

    def post_at(self, time: float, command: Callable) -> None:
        """Enqueue a command to run when the block clock reaches ``time``:
        it lands at the first not-yet-rendered superblock boundary whose
        block time is >= ``time`` (``render`` splits the call there).
        Frames already rendered, including a host carry, are never affected."""
        if self._disposed:
            raise RuntimeError("context is disposed")
        self._timed.append((float(time), self._timed_seq, command))
        self._timed_seq += 1

    def _drain_due_timed(self) -> None:
        """Move timed commands due at the current block clock into the
        pending queue, in (time, post-order) order."""
        if not self._timed:
            return
        snap, self._timed = self._timed, []
        due = []
        keep = []
        for e in snap:
            (due if e[0] <= self._current_time else keep).append(e)
        self._timed.extend(keep)
        due.sort(key=lambda e: (e[0], e[1]))
        for _, _, cmd in due:
            self._pending.append(cmd)

    def _timed_steps_until_next(self, max_steps: int) -> Optional[int]:
        """Steps from the current clock until the first pending timed
        command's landing boundary, or None if none lands within
        ``max_steps``; replicates the accumulated clock bit for bit."""
        if not self._timed:
            return None
        t_next = min(e[0] for e in self._timed)
        if self._current_time >= t_next:
            return 0
        times = self._block_clock(max_steps * self.superblock)
        for j in range(1, max_steps):
            if times[j * self.superblock] >= t_next:
                return j
        return None

    def _segment_cap(self, n_steps: int) -> int:
        """Steps the next render segment may run before a timed command
        must land."""
        k = self._timed_steps_until_next(n_steps)
        if k == 0:
            self._drain_due_timed()
            k = self._timed_steps_until_next(n_steps)
        return k if k else n_steps

    def _drain_commands(self) -> None:
        self._drain_due_timed()
        while self._pending:
            cmd = self._pending.popleft()
            try:
                cmd(self)
            except Exception:
                # Parity: the reference swallows command exceptions during
                # drain (AudioContextBase.cs:276-283).
                pass

    def _block_clock(self, n_blocks: int) -> np.ndarray:
        """Start times of the next ``n_blocks`` blocks: t[k+1] = fl(t[k] +
        fl(128/sr)) (AudioContextBase.cs:77-78); np.add.accumulate folds
        left to right with intermediate rounding, bit for bit."""
        inc = np.full(n_blocks, np.float64(FRAMES_PER_BLOCK) / self.sample_rate)
        inc[0] = self._current_time
        return np.add.accumulate(inc)

    # -- graph build & state management ------------------------------------------

    @property
    def static_info(self) -> StaticRenderInfo:
        return StaticRenderInfo(self.sample_rate, self.superblock)

    def _ensure_compiled(self) -> None:
        if self._compiled is not None and self._compiled_version == self._topology_version:
            return
        old_states = self._states
        old_comp = self._compiled.state_composition if self._compiled else {}
        old_ref = self._compiled.state_ref if self._compiled else {}
        self._compiled = CompiledGraph(self)
        self._compiled_version = self._topology_version
        self._render_fn, self._dest_channels = self._compiled.make_render_fn()
        self.stats.record_graph_build()
        self._consts = to_device(self._compiled.consts, self.device)
        new_states = to_device(self._compiled.init_states(), self.device)
        # Keep a stage's running state when its member composition and
        # layout are unchanged; otherwise each surviving member's state
        # migrates on its own (lane by lane for groups), so running voices
        # keep their playback and filter state across a regroup (parity:
        # graphaudio_tpu/core/context.py _ensure_compiled). The globals
        # always come fresh from the context.
        if old_states:
            new_comp = self._compiled.state_composition
            for key, st in new_states.items():
                if key == "__globals__":
                    continue
                old = old_states.get(key)
                if isinstance(st, torch.Tensor):
                    # The pipes' clock ring: kept whole or started afresh.
                    if (isinstance(old, torch.Tensor) and old_comp.get(key) == new_comp.get(key)
                            and old.shape == st.shape):
                        new_states[key] = old
                elif (
                    old is not None
                    and old_comp.get(key) == new_comp.get(key)
                    and _same_structure(old, st)
                ):
                    new_states[key] = old
                else:
                    # A pipe's register bank has no members: it restarts
                    # silent (nothing a later call delivers reads it).
                    self._migrate_members(key, st, old_states, old_ref)
        self._states = new_states
        # Config-derived leaves (the biquad's type selector) must reflect the
        # node's CURRENT config, not the one a kept state was built with.
        for nid in self._compiled.state_ref:
            node = self._nodes.get(nid)
            cfg = getattr(node, "config_state", None)
            if cfg is not None:
                self.update_node_state(node, **cfg())
        self._encs = None  # re-encode against (possibly) new capacities
        self._param_versions = {}

    def _migrate_members(self, key, st, old_states, old_ref) -> None:
        """Copy into the fresh stage state ``st`` (in place) the previous
        state of each member that ran before in a layout of the same keys,
        shapes and dtypes."""
        for nid, (k, lane) in self._compiled.state_ref.items():
            src = old_ref.get(nid)
            if k != key or src is None or src[0] not in old_states:
                continue
            old = old_states[src[0]]
            if src[1] is not None:
                old = {n: v[src[1]] for n, v in old.items()}
            dst = st if lane is None else {n: v[lane] for n, v in st.items()}
            if not _same_structure(old, dst):
                continue
            for n, v in old.items():
                if lane is None:
                    st[n] = v
                else:
                    st[n][lane] = v

    def _ensure_params_encoded(self) -> None:
        dirty = self._encs is None or any(
            self._param_versions.get((node.node_id, name)) != p.version
            for node in self._compiled.topo
            for name, p in node.params.items()
        )
        if dirty:
            self._encs = to_device(self._compiled.encode_params(), self.device)
            for node in self._compiled.topo:
                for name, p in node.params.items():
                    self._param_versions[(node.node_id, name)] = p.version

    def update_node_state(self, node, **updates) -> None:
        """Replace leaves of a node's state (host command helper). Updates
        are also recorded on the node so they survive graph rebuilds — a
        source may be scheduled before it is connected."""
        if not hasattr(node, "_state_overrides"):
            node._state_overrides = {}
        node._state_overrides.update(updates)
        if self._states is None or self._compiled is None:
            return
        ref = self._compiled.state_ref.get(node.node_id)
        if ref is None or ref[0] not in self._states:
            return
        key, lane = ref
        st = dict(self._states[key])
        for k, v in updates.items():
            if k not in st:
                continue
            arr = st[k].clone()
            val = torch.as_tensor(np.asarray(v), dtype=arr.dtype)
            if lane is None:
                arr.copy_(val.expand_as(arr))
            else:
                arr[lane] = val
            st[k] = arr
        self._states[key] = st

    def peek_node_state(self, node) -> Optional[dict]:
        """Host (numpy) view of a node's current state."""
        if self._states is None or self._compiled is None:
            return None
        ref = self._compiled.state_ref.get(node.node_id)
        if ref is None or ref[0] not in self._states:
            return None
        entry = self._states[ref[0]]

        def host(v):
            if not isinstance(v, torch.Tensor):
                return v
            v = v.cpu().numpy()
            return v if ref[1] is None else v[ref[1]]

        return {k: host(v) for k, v in entry.items()}

    # -- rendering ------------------------------------------------------------

    def _render_steps(self, n_steps: int, pack=None, keep=None):
        """Render ``n_steps`` superblocks; returns f32[channels, n_steps*S*128].

        With ``pack``, a function of one launch's f32 device audio [C, F]
        (``pack_int16``, ``pack_mulaw``, ``ImaDeviceStream.pack``), every
        launch is packed on the device and the call returns (the packed
        launches joined along axis 0, None). With ``keep`` too, only the
        first ``keep`` frames are packed (``keep`` lies in the last
        superblock) and the rest comes back unpacked: (packed, f32[C, n]).

        Drains pending commands first (parity: DrainCommands at block start,
        AudioContextBase.cs:272), then enqueues the steps in launches of
        ``chunk_schedule`` steps; each launch's audio is copied to the host
        asynchronously, and the call waits once at the end.
        """
        if self._disposed:
            raise RuntimeError("context is disposed")
        t0 = time.perf_counter()
        self._drain_commands()
        self._ensure_compiled()
        if self._compiled.static_config_stale():
            self._invalidate_topology()
            self._ensure_compiled()
        self._ensure_params_encoded()
        sched = parse_chunk_schedule(self.chunk_schedule)
        if self.chunk_schedule is not None and not isinstance(
            self.chunk_schedule, (int, str)
        ):
            self.chunk_schedule = ",".join(map(str, sched))  # materialize iterables

        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        cuda = self.device.type == "cuda"
        # A graph with pipes runs D rows more than it delivers (the first D
        # refill the pipes, the last D drain them); the clock continues
        # past the call's end for the drain rows, which go with the last
        # launch.
        D = self._compiled.pipe_delay
        rows = n_steps + D
        bt_host = self._block_clock(rows * self.superblock).reshape(rows, self.superblock)
        block_times = torch.from_numpy(bt_host).to(self.device)
        t_feed = time.perf_counter()
        feeds, held = self._stage_feeds(n_steps, cuda)
        t_enq = time.perf_counter()
        prep_s = t_enq - t0

        pending = []
        tail = None
        launched = 0
        delivered = 0  # frames of audio the launches so far returned
        chunk_i = 0
        while launched < n_steps:
            this = min(sched[min(chunk_i, len(sched) - 1)], n_steps - launched)
            chunk_i += 1
            last = launched + this == n_steps
            end = rows if last else launched + this
            frame0s = [self._current_frame + frames_per_step * r for r in range(launched, end)]
            self._states, out = self._render_fn(
                self._states, self._encs, self._consts,
                block_times[launched:end], frame0s, launched, n_steps, feeds,
            )
            launched += this
            if keep is not None and last:
                cut = keep - delivered
                tail = out[:, cut:].contiguous()
                tail = tail.to("cpu", non_blocking=True) if cuda else tail
                out = out[:, :cut].contiguous()
            delivered += out.shape[1]
            if out.shape[1] == 0:  # a launch of refill rows only
                continue
            if pack is not None:
                out = pack(out)
            # Async device-to-host copy (into pinned memory) so the device
            # keeps working while the host enqueues the next launch.
            pending.append(out.to("cpu", non_blocking=True) if cuda else out)
        t_sync = time.perf_counter()
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        del held  # the feeds' pinned host copies: every launch has run
        parts = [p.numpy() for p in pending]
        axis = 1 if pack is None else 0
        out_np = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)
        if tail is not None:
            tail = tail.numpy()
        t_notify = time.perf_counter()

        self._current_frame += n_steps * frames_per_step
        self._current_time = float(
            bt_host[n_steps - 1, -1] + np.float64(FRAMES_PER_BLOCK) / self.sample_rate
        )
        self._notify_sources()
        t_end = time.perf_counter()
        self.stats.record(
            frames=n_steps * frames_per_step,
            quanta=n_steps * self.superblock,
            steps=n_steps,
            breakdown={
                "prep_s": prep_s,
                "feed_s": t_enq - t_feed,  # prepare_feed, the copies' and reads' issue
                "enqueue_s": t_sync - t_enq,
                "sync_s": t_notify - t_sync,
                "notify_s": t_end - t_notify,
                "n_launches": chunk_i,
                "rows": rows,  # steps run: n_steps and the pipes' D
            },
        )
        return out_np if pack is None else (out_np, tail)

    def _stage_feeds(self, n_steps: int, cuda: bool):
        """Host-streamed data (decoder-fed stream nodes), staged once a
        render call (the analogue of the reference's decoder-thread buffer
        queue, AudioDecoderStreamNode.cs:47-87; parity:
        graphaudio_tpu/core/context.py:623-633): each node's
        ``prepare_feed`` of the call's frames, copied to the render device
        and read at once for all ``n_steps`` steps by the node's
        ``read_feed`` (one K15 launch on the card, on the current stream,
        right after the copy; the feed is freed once read), and
        ``__base__``, the call's first frame, against which a step finds its
        row. On the card each feed goes through pinned memory with a
        non-blocking copy. Returns ({str(node_id): f32[n_steps, C, T],
        "__base__": frame} or None, the pinned host tensors, which the
        caller keeps until its launches have run)."""
        feeds, held = {}, []
        S = self.superblock
        for node in self._compiled.topo:
            if not hasattr(node, "prepare_feed"):
                continue
            host = torch.from_numpy(node.prepare_feed(n_steps * S * FRAMES_PER_BLOCK))
            if cuda:
                host = host.pin_memory()
                held.append(host)
            feed = host.to(self.device, non_blocking=True)
            feeds[str(node.node_id)] = node.read_feed(feed, n_steps, S)
        if not feeds:
            return None, held
        feeds["__base__"] = self._current_frame
        return feeds, held

    def _notify_sources(self) -> None:
        """Fire ended-events / self-disposal on scheduled sources that can
        end; all their stop times come to the host in one copy per stage."""
        end_time = self.current_time
        wanted = []
        fetch = {}
        for node in self._compiled.topo:
            if not getattr(node, "wants_notify", False) or not node.may_notify():
                continue
            ref = self._compiled.state_ref.get(node.node_id)
            if ref is None or ref[0] not in self._states:
                continue
            entry = self._states[ref[0]]
            if "stop_time" not in entry:
                continue
            wanted.append((node, ref))
            fetch.setdefault(ref[0], entry["stop_time"])
        if not wanted:
            return
        host = {k: v.cpu().numpy() for k, v in fetch.items()}
        for node, (key, lane) in wanted:
            st = host[key] if lane is None else host[key][lane]
            node.notify_rendered({"stop_time": st}, end_time)

    # -- lifecycle ------------------------------------------------------------

    def on_disposing(self, callback: Callable) -> None:
        """Parity: AudioContextBase.Disposing event (:241)."""
        self._disposing_callbacks.append(callback)

    def dispose(self) -> None:
        if self._disposed:
            return
        for cb in self._disposing_callbacks:
            try:
                cb()
            except Exception:
                pass  # parity: disposing handlers never block disposal
        self.destination.dispose()
        self._disposed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.dispose()
        return False

    # -- block-level APIs (parity: AudioContextBase.cs:52-186) -----------------

    def process_block(self) -> np.ndarray:
        """Render exactly one 128-frame quantum -> f32[channels, 128]
        (parity: ProcessBlock, AudioContextBase.cs:52-81)."""
        return self.render(FRAMES_PER_BLOCK)

    def process_block_interleaved(self) -> np.ndarray:
        """One quantum, interleaved f32[128*channels]
        (parity: ProcessBlockInterleaved, AudioContextBase.cs:88-161)."""
        return self.render_interleaved(FRAMES_PER_BLOCK)

    def process_blocks(self, block_count: int) -> np.ndarray:
        """Render ``block_count`` quanta -> f32[channels, block_count*128]
        (parity: ProcessBlocks, AudioContextBase.cs:166-186)."""
        return self.render(block_count * FRAMES_PER_BLOCK)

    def render_interleaved(self, frame_count: int) -> np.ndarray:
        """Render and interleave -> f32[frame_count*channels]."""
        return np.ascontiguousarray(self.render(frame_count).T).reshape(-1)

    def render(self, frame_count: int) -> np.ndarray:
        """Render ``frame_count`` frames; returns f32[channels, frame_count].
        Frames rendered past ``frame_count`` (superblock granularity) are
        carried on the host and served first by the next call
        (OfflineAudioContext.cs:55-101)."""
        if frame_count < 0:
            raise ValueError("frame_count must be non-negative")
        if frame_count == 0:
            ch = self._carry.shape[0] if self._carry is not None else 2
            return np.zeros((ch, 0), dtype=np.float32)

        chunks = []
        got = 0
        if self._carry is not None and self._carry.shape[1] > 0:
            take = min(frame_count, self._carry.shape[1])
            chunks.append(self._carry[:, :take])
            self._carry = self._carry[:, take:] if take < self._carry.shape[1] else None
            got += take

        remaining = frame_count - got
        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        while remaining > 0:
            n_steps = self._segment_cap(-(-remaining // frames_per_step))
            out = self._render_steps(n_steps)
            if out.shape[1] > remaining:
                self._carry = out[:, remaining:].copy()
                out = out[:, :remaining]
            chunks.append(out)
            remaining -= out.shape[1]

        if len(chunks) == 1:
            return np.ascontiguousarray(chunks[0])
        # Channel counts can differ between carried audio and a rebuilt
        # graph; pad to the widest (only after topology edits).
        width = max(c.shape[0] for c in chunks)
        padded = []
        for c in chunks:
            if c.shape[0] < width:
                c = np.vstack([c, np.zeros((width - c.shape[0], c.shape[1]), np.float32)])
            padded.append(c)
        return np.concatenate(padded, axis=1)

    def render_pcm16(self, frame_count: int) -> np.ndarray:
        """Render ``frame_count`` frames as interleaved int16 PCM.

        The quantization ``round(clip(x, -1, 1) * 32767)`` and the interleave
        run on the device (K4), so 2 bytes per sample come back to the host.
        Frames carried from an f32 render quantize on the host with the same
        formula; leftover frames of a pcm16 render are carried back
        dequantized (v / 32767), which re-quantizes bit-identically.
        Returns int16[frame_count * channels].
        """
        return self._render_flat(
            frame_count, pack_int16,
            lambda part: np.ascontiguousarray(wire.quantize_i16(part).T).reshape(-1),
            np.int16(0),
            decode=lambda frames: frames.T.astype(np.float32) / np.float32(32767.0))

    # -- compressed wire formats ------------------------------------------------
    #
    # Standard lossy delivery formats encoded on the device: G.711 mu-law (1
    # byte a sample) and IMA ADPCM (about 4.06 bits a sample). The f32 and
    # pcm16 paths remain the accuracy-bearing surfaces.

    def render_mulaw(self, frame_count: int) -> np.ndarray:
        """Render ``frame_count`` frames as interleaved G.711 mu-law bytes.

        The companding of the int16-quantized signal runs on the device
        (K4mu, ops.wire.pack_mulaw), decodable by any G.711 decoder (as a
        WAV with ops.wire.mulaw_wav_bytes) or ops.wire.mulaw_decode_np.
        Frames carried in from an earlier render encode on the host with the
        same formula; frames over-rendered past ``frame_count`` come back
        unpacked and carry as exact float32, so later calls continue
        bit-identically to an all-f32 session.
        """
        return self._render_flat(frame_count, pack_mulaw, wire.mulaw_encode_np, np.uint8(0xFF))

    def _render_flat(self, frame_count, pack, encode, silence, decode=None) -> np.ndarray:
        """Render ``frame_count`` frames as one flat interleaved format.

        ``pack`` packs each launch on the device; ``encode`` (f32 [C, n] ->
        flat interleaved) encodes frames carried in from an earlier render
        on the host. Frames rendered past ``frame_count`` are packed too and
        carried back through ``decode`` (packed [n, C] -> f32 [C, n]) where
        it is given, else they come back unpacked and carry as they are.
        Segments rendered before a mid-call change of the channel count are
        padded to the widest count with ``silence``, whose type is the
        format's.
        """
        if frame_count < 0:
            raise ValueError("frame_count must be non-negative")
        if frame_count == 0:
            return np.zeros(0, dtype=silence.dtype)

        chunks = []  # (flat interleaved samples, channel count)
        got = 0
        if self._carry is not None and self._carry.shape[1] > 0:
            take = min(frame_count, self._carry.shape[1])
            part = self._carry[:, :take]
            self._carry = self._carry[:, take:] if take < self._carry.shape[1] else None
            chunks.append((encode(part), part.shape[0]))
            got += take

        remaining = frame_count - got
        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        while remaining > 0:
            n_steps = self._segment_cap(-(-remaining // frames_per_step))
            over = n_steps * frames_per_step > remaining
            out, tail = self._render_steps(
                n_steps, pack=pack, keep=remaining if over and decode is None else None)
            ch = max(self._dest_channels or 0, 1)
            total = out.shape[0] // ch
            if total > remaining:
                frames = out.reshape(total, ch)
                tail = decode(frames[remaining:])
                out = np.ascontiguousarray(frames[:remaining]).reshape(-1)
                total = remaining
            if tail is not None:
                self._carry = np.ascontiguousarray(tail)
            chunks.append((out, ch))
            remaining -= total

        if len(chunks) == 1:
            return chunks[0][0]
        width = max(c for _, c in chunks)
        if all(c == width for _, c in chunks):
            return np.concatenate([f for f, _ in chunks])
        # A timed topology edit changed the channel count mid-call: pad every
        # segment to the widest count (silent extra channels).
        padded = []
        for flat, c in chunks:
            if c == width:
                padded.append(flat)
                continue
            frames = flat.reshape(-1, c)
            wide = np.full((frames.shape[0], width), silence, dtype=silence.dtype)
            wide[:, :c] = frames
            padded.append(wide.reshape(-1))
        return np.concatenate(padded)

    def render_adpcm(self, frame_count: int, samples_per_block: int = None):
        """Render ``frame_count`` frames as a standard IMA ADPCM stream.

        Returns an ``ops.wire.AdpcmStream`` of WAV tag-0x11 blocks (about
        4.06 bits a sample at the default 505-sample block). Blocks encode
        on the device (K4a), with the block-boundary carry threaded across
        launch chunks so the call yields one contiguous stream
        (``stream.write_wav(path)``). Frames over-rendered past
        ``frame_count`` come back unpacked and carry as exact float32. An
        ADPCM stream has a fixed channel layout: a timed command that
        changes the destination channel count mid-call raises.
        """
        if frame_count < 0:
            raise ValueError("frame_count must be non-negative")
        spb = wire._validate_spb(
            samples_per_block if samples_per_block is not None
            else wire.DEFAULT_SAMPLES_PER_BLOCK
        )
        # The stream's channel layout is fixed up front: drain + build now.
        self._drain_commands()
        self._ensure_compiled()
        ch = max(self._dest_channels or 0, 1)
        stream = ImaDeviceStream(ch, spb)
        block_parts: List[np.ndarray] = []

        def host_blocks(q: np.ndarray) -> None:
            """Host-encode int16 [ch, n]: its whole blocks; the remainder
            seeds the stream's carry."""
            whole = (q.shape[1] // spb) * spb
            if whole:
                block_parts.append(wire.ima_encode_np(q[:, :whole], spb))
            stream.set_carry(q[:, whole:])

        got = 0
        if self._carry is not None and self._carry.shape[1] > 0:
            take = min(frame_count, self._carry.shape[1])
            part = self._carry[:, :take]
            self._carry = self._carry[:, take:] if take < self._carry.shape[1] else None
            if part.shape[0] != ch:  # topology edited since the carry
                fixed = np.zeros((ch, part.shape[1]), np.float32)
                fixed[: min(ch, part.shape[0])] = part[: min(ch, part.shape[0])]
                part = fixed
            host_blocks(wire.quantize_i16(part))
            got += take

        remaining = frame_count - got
        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        while remaining > 0:
            n_steps = self._segment_cap(-(-remaining // frames_per_step))
            seg = n_steps * frames_per_step
            # Frames past frame_count come back unpacked and carry as exact
            # float32; the ones before them pack on the device.
            blocks, tail = self._render_steps(
                n_steps, pack=stream.pack, keep=remaining if seg > remaining else None)
            if blocks.size:
                block_parts.append(blocks)
            if tail is not None:
                self._carry = np.ascontiguousarray(tail)
            remaining -= min(seg, remaining)
        if stream.carry_len:
            # Flush: the last partial block, zero-padded, on the host.
            rem = stream.pull_carry()
            padded = np.concatenate([rem, np.zeros((ch, spb - rem.shape[1]), np.int16)], axis=1)
            block_parts.append(wire.ima_encode_np(padded, spb))

        blocks_all = (
            np.concatenate(block_parts, axis=0) if block_parts
            else np.zeros((0, stream.block_align), np.uint8)
        )
        return wire.AdpcmStream(blocks=blocks_all, channels=ch, samples_per_block=spb,
                                sample_rate=self.sample_rate, frames=frame_count)


class OfflineAudioContext(AudioContextBase):
    """Non-realtime renderer (parity: GraphAudio.Core/OfflineAudioContext.cs:8).

    ``render(frame_count)`` pulls exactly ``frame_count`` frames through the
    graph. ``device`` defaults to "cuda" and raises where CUDA is absent.
    ``pipeline_chains`` defaults on, as in the reference (see
    ``AudioContextBase``)."""

    def __init__(
        self,
        sample_rate: int = DEFAULT_SAMPLE_RATE,
        superblock: int = DEFAULT_SUPERBLOCK,
        pipeline_chains: bool = True,
        device="cuda",
    ):
        super().__init__(sample_rate=sample_rate, superblock=superblock,
                         pipeline_chains=pipeline_chains, device=device)

    def render_seconds(self, seconds: float) -> np.ndarray:
        return self.render(int(round(seconds * self.sample_rate)))
