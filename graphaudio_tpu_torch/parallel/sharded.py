"""The device mesh and the sharded voice-bank renderer.

The port of graphaudio_tpu/parallel/sharded.py. ``make_mesh`` factors the
ranks of the initialized process group into a ``("voice", "part")``
``torch.distributed.device_mesh.DeviceMesh`` the way the JAX package
factors its devices. ``ShardedVoiceScene`` is the JAX package's
``shard_map``-ped voice scene as an ``nn.Module`` that every rank runs:
voice synthesis over the rank's voices, a local mix (K3), one
``all_reduce`` over ``voice``, then the partition-sharded spectral MAC of a
shared reverb (K14a over the rank's IR partitions) completed by one
``all_reduce`` over ``part`` (AudioNodeInput.cs:100-138 and
PartitionedConvolver.cs:154-223, distributed). The transforms are
``torch.fft``'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.mesh import AXES, axis_group, axis_index, axis_size
from graphaudio_tpu_torch.core.mixing import fan_in_lanes
from graphaudio_tpu_torch.ops.convolve import NUM_BINS, conv_step, prepare_ir


def factor_mesh(n: int, voice_axis: int = 0, part_axis: int = 0):
    """(voice, part) sizes for ``n`` ranks, as the JAX package's
    ``make_mesh`` factors ``n`` devices: with no sizes given the largest
    divisor <= sqrt(n) becomes ``part`` (8 -> 4x2, 16 -> 4x4; a prime n
    -> all voices); one size given, the other is n over it. Raises
    ValueError when the sizes do not multiply to n."""
    if voice_axis <= 0 and part_axis <= 0:
        part_axis = 1
        for cand in range(2, int(np.sqrt(n)) + 1):
            if n % cand == 0:
                part_axis = cand
        voice_axis = n // part_axis
    elif voice_axis <= 0:
        voice_axis = n // part_axis
    elif part_axis <= 0:
        part_axis = n // voice_axis
    if voice_axis * part_axis != n:
        raise ValueError(f"{voice_axis}x{part_axis} != {n} devices")
    return voice_axis, part_axis


def make_mesh(ranks=None, voice_axis: int = 0, part_axis: int = 0, device_type=None):
    """A ``DeviceMesh`` of ``ranks`` (default: every rank of the process
    group) with dims ``("voice", "part")`` (``factor_mesh``'s sizes), rank
    ``ranks[v * part + p]`` at (v, p). ``device_type`` defaults to "cuda"
    where CUDA is available, else "cpu"; each rank selects its card before
    the call (``torch.cuda.set_device``). Every rank of the group calls it
    (the mesh's groups are made collectively). Raises RuntimeError without
    an initialized process group."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group "
                           "(init_process_group with the backend of your choice)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    v, p = factor_mesh(len(ranks), voice_axis, part_axis)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(v, p)
    return DeviceMesh(device_type, grid, mesh_dim_names=AXES)


def _mesh_device(mesh, device):
    if device is not None:
        return torch.device(device)
    if mesh.device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh, but torch.cuda.is_available() is False")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class ShardedVoiceScene(torch.nn.Module):
    """A voice bank and a shared convolution reverb rendered over a mesh.

    Args:
      mesh: a ``DeviceMesh`` with a ``voice`` dim (and optionally ``part``).
      arenas: f32[V, L] per-voice mono material (looped).
      ir: f32[ir_len] the shared reverb's impulse response.
      gains, pans: f32[V] per-voice mix controls.
      sample_rate, superblock: the render geometry.
      device: the rank's render device (default: its card on a CUDA mesh,
        the CPU on a CPU mesh).

    V must divide by the ``voice`` size; the IR's partition count is padded
    with zero partitions to a multiple of the ``part`` size. Each rank holds
    its voices (rows [v0, v0 + V / voice)) and its partitions (rows [p0,
    p0 + P / part) of the 128-grain spectra, in lag order) and renders the
    whole output.
    """

    def __init__(self, mesh, arenas, ir, gains, pans, sample_rate: int = 48000,
                 superblock: int = 8, master_gain: float = 0.5, normalize_ir: bool = True,
                 device=None):
        super().__init__()
        self.mesh = mesh
        self.sample_rate = sample_rate
        self.superblock = superblock
        self.frames = superblock * FRAMES_PER_BLOCK
        self.master_gain = float(np.float32(master_gain))
        dev = _mesh_device(mesh, device)

        arenas = np.asarray(arenas, np.float32)
        self.V, self.L = arenas.shape
        nv, npart = axis_size(mesh, "voice"), axis_size(mesh, "part")
        if self.V % nv:
            raise ValueError(f"voices {self.V} not divisible by voice axis {nv}")
        hr, hi = prepare_ir(np.asarray(ir, np.float32), normalize=normalize_ir)
        pad = (-hr.shape[0]) % npart
        if pad:
            z = np.zeros((pad, NUM_BINS), np.float32)
            hr, hi = np.concatenate([hr, z]), np.concatenate([hi, z])
        self.P = hr.shape[0]
        self.p_local = self.P // npart
        self.p0 = axis_index(mesh, "part") * self.p_local
        vl = self.V // nv
        v0 = axis_index(mesh, "voice") * vl
        self.voice_group = axis_group(mesh, "voice")
        self.part_group = axis_group(mesh, "part")

        def buf(name, a, dtype=torch.float32):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype))

        buf("arenas", arenas[v0:v0 + vl])
        buf("gains", np.asarray(gains, np.float32)[v0:v0 + vl])
        buf("pans", np.asarray(pans, np.float32)[v0:v0 + vl])
        rows = slice(self.p0, self.p0 + self.p_local)
        # Both channels convolve with the one IR: K14a takes [K, P_local, bins].
        buf("Hr", np.stack([hr[rows]] * 2))
        buf("Hi", np.stack([hi[rows]] * 2))

    def init_state(self):
        """The rank's state: its voices' f64 positions, the replicated
        delay line (a ring of P-1+S spectra a channel and its head, the
        port's convolver layout) and the carried overlap."""
        dev = self.arenas.device
        R = self.P - 1 + self.superblock
        return {
            "pos": torch.zeros(self.arenas.shape[0], dtype=torch.float64, device=dev),
            "ring_r": torch.zeros((2, R, NUM_BINS), dtype=torch.float32, device=dev),
            "ring_i": torch.zeros((2, R, NUM_BINS), dtype=torch.float32, device=dev),
            "head": 0,
            "overlap": torch.zeros((2, FRAMES_PER_BLOCK), dtype=torch.float32, device=dev),
        }

    def render_step(self, state, frame0=0):
        """One superblock: returns (new_state, f32[2, T]), the whole output
        on every rank. The ring and overlap are updated in place."""
        del frame0
        S, T, L = self.superblock, self.frames, self.L
        dev = self.arenas.device
        # ---- voice synthesis, local mix, then the bus fan-in across ranks ----
        idx = torch.remainder(state["pos"][:, None]
                              + torch.arange(T, dtype=torch.float64, device=dev), L)
        s = torch.gather(self.arenas, 1, idx.to(torch.int64)) * self.gains[:, None]
        x = (self.pans + 1.0) * 0.5
        half_pi = float(np.float32(math.pi / 2))
        voiced = torch.stack([s * torch.cos(x * half_pi)[:, None],
                              s * torch.sin(x * half_pi)[:, None]], dim=1)  # [Vl, 2, T]
        mix = fan_in_lanes(voiced.contiguous(), 2, self.voice_group)

        # ---- the partition-sharded spectral convolution (K14a, 128 grain) ----
        wet, head = conv_step(mix.reshape(2, S, FRAMES_PER_BLOCK), self.Hr, self.Hi,
                              state["ring_r"], state["ring_i"], state["head"], state["overlap"],
                              rev=False, part=(self.p0, self.part_group))
        new_state = dict(state, pos=torch.remainder(state["pos"] + T, L), head=head)
        return new_state, wet * self.master_gain

    def forward(self, state, frame0=0):
        return self.render_step(state, frame0)
