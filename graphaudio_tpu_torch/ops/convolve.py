"""Uniformly partitioned FFT convolution (K2).

The reference's PartitionedConvolver (GraphAudio.Core/PartitionedConvolver.cs)
splits the impulse response into partitions, pre-transforms each, keeps a
frequency-domain delay line of past input spectra and per block computes

    acc[b] = sum_p delay[t-p][b] * H[p][b]          (complex MAC, :154-223)

then an inverse FFT and overlap-add (:140-151).

The JAX package runs this at three grains (ops/convolve.py conv_superblock,
conv_superblock_big, conv_superblock_sub); they are one computation at
grain B with L sub-blocks per step, and ``conv_step`` is that computation:

  1. forward real FFTs of the L input sub-blocks (torch.fft.rfft / cuFFT);
  2. ``spectral_mac``: the complex MAC of P partitions against the delay
     line, which is a ring of R = P-1+L slots with a head index (the new
     spectra are written into it in the same pass) — K2's first kernel;
  3. inverse real FFTs (torch.fft.irfft, 1/N scaled like the JAX RealDft /
     BigRealDft inverse);
  4. ``overlap_add`` of heads and carried tails, with the instances'
     combine (the convolver's true-stereo matrix) — K2's second kernel.

Spectra order: ``prepare_ir`` rows are in lag order (row p multiplies the
sub-block p steps ago); ``prepare_ir_big`` rows are reversed (newest-input
row last). ``rev`` tells the MAC which. Host-side IR preparation is numpy,
copied from the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu_torch.core.mixing import all_reduce_sum
from graphaudio_tpu_torch.utils import cudabuild

FFT_SIZE = 2 * FRAMES_PER_BLOCK  # 256 (PartitionedConvolver.cs:40)
NUM_BINS = FFT_SIZE // 2 + 1  # 129 (:41)

# Equal-power normalization constants (:93-101).
GAIN_CALIBRATION_DB = -58.0
MIN_POWER = 0.000125


def normalization_scale(ir: np.ndarray) -> float:
    """Parity: PartitionedConvolver.CalculateNormalizationScale (:93-102)."""
    ir = np.asarray(ir, dtype=np.float32)
    sum_sq = float(np.sum(ir.astype(np.float64) ** 2))
    power = np.float32(np.sqrt(sum_sq / ir.shape[0])) if ir.shape[0] else np.float32(0)
    if not np.isfinite(power) or power < MIN_POWER:
        power = np.float32(MIN_POWER)
    return float((1.0 / power) * np.float32(10.0 ** (GAIN_CALIBRATION_DB * 0.05)))


def prepare_ir(ir: np.ndarray, normalize: bool = True):
    """Partition + pre-transform an impulse response channel at 128 grain.

    Returns (Hr, Hi): f32[P, 129] partition spectra in lag order, from a
    float64 FFT rounded to float32 (the reference's FftFlat double transform
    of float data, :65-91).
    """
    ir = np.asarray(ir, dtype=np.float32)
    scale = np.float32(normalization_scale(ir)) if normalize else np.float32(1.0)
    n_partitions = max(1, -(-ir.shape[0] // FRAMES_PER_BLOCK))
    hr = np.zeros((n_partitions, NUM_BINS), dtype=np.float32)
    hi = np.zeros((n_partitions, NUM_BINS), dtype=np.float32)
    for p in range(n_partitions):
        seg = ir[p * FRAMES_PER_BLOCK : (p + 1) * FRAMES_PER_BLOCK]
        padded = np.zeros(FFT_SIZE, dtype=np.float64)
        padded[: seg.shape[0]] = (seg * scale).astype(np.float32)
        spec = np.fft.rfft(padded)
        hr[p] = spec.real.astype(np.float32)
        hi[p] = spec.imag.astype(np.float32)
    return hr, hi


def prepare_ir_big(ir: np.ndarray, block: int, normalize: bool = True):
    """Partition + pre-transform an IR channel at ``block``-sample grain.

    Returns (Hr, Hi): f32[P, block+1] spectra of 2*block-point transforms,
    PARTITION-REVERSED (newest-input partition last). Same -58 dB
    normalization as the 128-grain path (:93-102)."""
    ir = np.asarray(ir, dtype=np.float32)
    scale = np.float32(normalization_scale(ir)) if normalize else np.float32(1.0)
    n_part = max(1, -(-ir.shape[0] // block))
    hr = np.zeros((n_part, block + 1), dtype=np.float32)
    hi = np.zeros((n_part, block + 1), dtype=np.float32)
    for p in range(n_part):
        seg = ir[p * block : (p + 1) * block]
        padded = np.zeros(2 * block, dtype=np.float64)
        padded[: seg.shape[0]] = (seg * scale).astype(np.float32)
        spec = np.fft.rfft(padded)
        # reversed: row k multiplies the spectrum of input block (now-(P-1-k))
        hr[n_part - 1 - p] = spec.real.astype(np.float32)
        hi[n_part - 1 - p] = spec.imag.astype(np.float32)
    return hr, hi


def ring_slots(head: int, first: int, count: int, R: int, device):
    """Ring slots of sub-blocks first..first+count-1 relative to ``head``
    (sub-block m lives in slot (head + m) mod R)."""
    return (head + first + torch.arange(count, device=device)) % R


# ---- K2a: spectral MAC ---------------------------------------------------


def spectral_mac_plain(X, hr, hi, ring_r, ring_i, head: int, rev: bool):
    """Plain torch K2a. X complex64[K, L, NB] (this step's spectra);
    hr, hi f32[K, P, NB]; ring_r, ring_i f32[K, R, NB] with R = P-1+L,
    updated in place (this step's spectra written at slots head..head+L-1).
    Returns acc complex64[K, L, NB]."""
    K, L, NB = X.shape
    P = hr.shape[1]
    R = ring_r.shape[1]
    Xr, Xi = X.real, X.imag
    past = ring_slots(head, -(P - 1), P - 1, R, X.device)
    seq_r = torch.cat([ring_r[:, past], Xr], dim=1)  # [K, P-1+L, NB], oldest first
    seq_i = torch.cat([ring_i[:, past], Xi], dim=1)
    # window position p of output l holds sub-block l+p-(P-1), i.e. lag P-1-p
    win_r = seq_r.unfold(1, P, 1)  # [K, L, NB, P]
    win_i = seq_i.unfold(1, P, 1)
    kr = hr if rev else hr.flip(1)
    ki = hi if rev else hi.flip(1)
    kr = kr.transpose(1, 2)[:, None]  # [K, 1, NB, P]
    ki = ki.transpose(1, 2)[:, None]
    acc_r = (win_r * kr - win_i * ki).sum(-1)
    acc_i = (win_r * ki + win_i * kr).sum(-1)
    new = ring_slots(head, 0, L, R, X.device)
    ring_r[:, new] = Xr
    ring_i[:, new] = Xi
    return torch.complex(acc_r, acc_i)


# K2a's launch plan (csrc/conv.cu): a warp is 32 columns (k, bin) of one
# lag group; a group aims at MAC_LAGS lags, so its window preload and its
# share of the reduction stay small beside its loads.
MAC_LAGS = 6
MAC_MIN_BLOCKS = 256  # about two blocks on each of the H100's 132 SMs
MAC_MAX_CLUSTER = 8  # the portable thread-block cluster size
MAC_MAX_GROUPS = 16  # lag groups (warps) in a block


@functools.cache
def mac_plan(K: int, L: int, P: int, NB: int):
    """K2a's launch plan for K channels, L sub-blocks, P lags and NB bins:
    (lt, clusters, groups, lags). A thread owns a tile of ``lt`` sub-blocks
    (L rounded up to a power of two, at most 8) for one group of ``lags``
    lags; a block holds ``groups`` lag groups of 32 columns, and
    ``clusters`` blocks of one cluster split the lags of the same columns,
    doubling until the grid has MAC_MIN_BLOCKS blocks or the groups would
    fall below MAC_LAGS lags."""
    lt = min(8, 1 << (L - 1).bit_length())
    base = -(-K * NB // 32) * -(-L // lt)
    wanted = -(-P // MAC_LAGS)
    clusters = 1
    while (clusters < MAC_MAX_CLUSTER and base * clusters < MAC_MIN_BLOCKS
           and 2 * clusters <= wanted):
        clusters *= 2
    groups = min(MAC_MAX_GROUPS, -(-wanted // clusters))
    return lt, clusters, groups, -(-P // (clusters * groups))


def spectral_mac(X, hr, hi, ring_r, ring_i, head, rev: bool):
    """K2a: the partitioned complex MAC (see spectral_mac_plain for shapes).

    CPU tensors take the plain version; CUDA tensors launch the kernel with
    the plan of ``mac_plan``. ``head`` is a host int, or on the card an
    int64 scalar tensor in [0, R) that the kernel reads there (a realtime
    context's captured step, core/stepgraph.py).
    """
    if X.device.type == "cpu":
        return spectral_mac_plain(X, hr, hi, ring_r, ring_i, head, rev)
    K, L, NB = X.shape
    P = hr.shape[1]
    R = P - 1 + L
    req = cudabuild.require
    req(X, "X", torch.complex64, shape=(K, L, NB))
    req(hr, "hr", torch.float32, shape=(K, P, NB))
    req(hi, "hi", torch.float32, shape=(K, P, NB))
    req(ring_r, "ring_r", torch.float32, shape=(K, R, NB))
    req(ring_i, "ring_i", torch.float32, shape=(K, R, NB))
    if isinstance(head, torch.Tensor):
        req(head, "head", torch.int64, shape=())
        head, head_dev = 0, head.data_ptr()
    else:
        head, head_dev = int(head) % R, None
    acc = torch.empty((K, L, NB), dtype=torch.complex64, device=X.device)
    status = cudabuild.launcher("ga_conv_mac")(
        X.data_ptr(), hr.data_ptr(), hi.data_ptr(), ring_r.data_ptr(),
        ring_i.data_ptr(), acc.data_ptr(), K, L, P, NB, R, head, head_dev,
        int(bool(rev)), *mac_plan(K, L, P, NB), cudabuild.stream_of(X),
    )
    cudabuild.check(status, "ga_conv_mac")
    cudabuild.launches["spectral_mac"] += 1
    return acc


# ---- K14a: the MAC over one rank's slice of the partitions -------------------
#
# graphaudio_tpu/ops/convolve.py conv_superblock_big_sharded (:236-265) and
# the part-sharded MAC of graphaudio_tpu/parallel/sharded.py (:170-180):
# under a mesh whose ``part`` dimension has n ranks the (zero-padded) P
# partitions split into n slices of P / n; each rank MACs its slice against
# the replicated delay line and an all_reduce over ``part`` completes the
# sum (the caller's).


def _slice_lags(P: int, p0: int, rows: int, rev: bool):
    """The lag of each local row: global row p0 + j multiplies the
    sub-block p0 + j steps ago in lag order, P-1-(p0+j) steps ago when the
    rows are reversed (``prepare_ir_big``)."""
    return [P - 1 - (p0 + j) if rev else p0 + j for j in range(rows)]


def spectral_mac_slice_plain(X, hr, hi, ring_r, ring_i, head: int, rev: bool, p0: int):
    """Plain K14a: K2a's MAC over the partitions [p0, p0 + P_local) of a
    P-partition IR, at their global lags.

    X complex64[K, L, NB] this step's spectra; hr, hi f32[K, P_local, NB]
    the rank's rows of the (padded) spectra, in lag order or reversed as
    ``rev`` says; ring_r, ring_i f32[K, R, NB] the whole delay line, R =
    P-1+L (so P is global), updated in place as K2a updates it. Output
    sub-block l takes, for local rows j = 0, 1, .. in turn, acc = acc +
    (D(l-lag) re * h re - D(l-lag) im * h im) and the same for the
    imaginary part, D(m) this step's spectrum m for m >= 0 and ring slot
    (head + m) mod R for m < 0. Returns the partial acc complex64[K, L,
    NB]: summed over every rank's slice it is K2a's."""
    K, L, NB = X.shape
    Pl = hr.shape[1]
    R = ring_r.shape[1]
    P = R - L + 1
    if not (0 <= p0 and p0 + Pl <= P):
        raise ValueError(f"rows [{p0}, {p0 + Pl}) are not partitions of P = {P}")
    past = ring_slots(head, -(P - 1), P - 1, R, X.device)
    seq_r = torch.cat([ring_r[:, past], X.real], dim=1)  # [K, R, NB]: D(s - (P-1))
    seq_i = torch.cat([ring_i[:, past], X.imag], dim=1)
    acc_r = torch.zeros((K, L, NB), dtype=torch.float32, device=X.device)
    acc_i = torch.zeros_like(acc_r)
    for j, lag in enumerate(_slice_lags(P, p0, Pl, rev)):
        s0 = P - 1 - lag
        xr, xi = seq_r[:, s0:s0 + L], seq_i[:, s0:s0 + L]
        h_r, h_i = hr[:, j:j + 1], hi[:, j:j + 1]
        acc_r = acc_r + (xr * h_r - xi * h_i)
        acc_i = acc_i + (xr * h_i + xi * h_r)
    new = ring_slots(head, 0, L, R, X.device)
    ring_r[:, new] = X.real
    ring_i[:, new] = X.imag
    return torch.complex(acc_r, acc_i)


def spectral_mac_slice(X, hr, hi, ring_r, ring_i, head: int, rev: bool, p0: int):
    """K14a: csrc/conv.cu ``ga_conv_mac_slice`` on CUDA tensors (a thread an
    output (k, l, bin), its local rows in order, their loads issued in
    batches of 8 rows ahead of the multiply-adds, this step's spectra
    written into the ring in the same launch), ``spectral_mac_slice_plain``
    (arguments and result as there) on CPU tensors."""
    if X.device.type == "cpu":
        return spectral_mac_slice_plain(X, hr, hi, ring_r, ring_i, head, rev, p0)
    K, L, NB = X.shape
    Pl = hr.shape[1]
    R = ring_r.shape[1]
    req = cudabuild.require
    req(X, "X", torch.complex64, shape=(K, L, NB))
    req(hr, "hr", torch.float32, shape=(K, Pl, NB))
    req(hi, "hi", torch.float32, shape=(K, Pl, NB))
    req(ring_r, "ring_r", torch.float32, shape=(K, R, NB))
    req(ring_i, "ring_i", torch.float32, shape=(K, R, NB))
    acc = torch.empty((K, L, NB), dtype=torch.complex64, device=X.device)
    status = cudabuild.launcher("ga_conv_mac_slice")(
        X.data_ptr(), hr.data_ptr(), hi.data_ptr(), ring_r.data_ptr(), ring_i.data_ptr(),
        acc.data_ptr(), K, L, Pl, NB, R, int(head) % R, int(bool(rev)), int(p0),
        cudabuild.stream_of(X))
    cudabuild.check(status, "ga_conv_mac_slice")
    cudabuild.launches["spectral_mac_slice"] += 1
    return acc


# ---- K2b: overlap-add -------------------------------------------------------


def overlap_add_plain(y_full, overlap, combine=None):
    """Plain torch K2b. y_full f32[K, L, 2B] inverse transforms; overlap
    f32[K, B] carried tail, replaced in place by the last tail. Returns y
    f32[K, L*B], or with ``combine`` (a tuple of one tuple of 1 or 2
    instances per output channel, each instance in exactly one) f32[C, L*B] whose row c
    is the sum of its instances' rows in tuple order: the true-stereo
    matrix ((0, 2), (1, 3)) gives ``y[0] + y[2], y[1] + y[3]``."""
    K, L, B2 = y_full.shape
    B = B2 // 2
    heads = y_full[:, :, :B]
    tails = torch.cat([overlap[:, None], y_full[:, :-1, B:]], dim=1)
    y = (heads + tails).reshape(K, L * B)
    overlap.copy_(y_full[:, -1, B:])
    if combine is None:
        return y
    return torch.stack([y[ks[0]] if len(ks) == 1 else y[ks[0]] + y[ks[1]] for ks in combine])


@functools.cache
def _ola_map(combine, K: int) -> np.ndarray:
    """K2b's combine map as the kernel takes it: int32[2, C], each output's
    first instance and its second or -1 (the identity when ``combine`` is
    None). Cached, so the host buffer outlives every launch that reads
    it."""
    combine = tuple((k,) for k in range(K)) if combine is None else combine
    if sorted(k for ks in combine for k in ks) != list(range(K)) or not all(
            1 <= len(ks) <= 2 for ks in combine):
        raise ValueError(f"combine must use each of {K} instances once, 1 or 2 an output: "
                         f"{combine!r}")
    return np.array([[ks[0] for ks in combine], [ks[-1] if len(ks) == 2 else -1 for ks in combine]],
                    np.int32)


def overlap_add(y_full, overlap, combine=None):
    """K2b: overlap-add of one step's inverse transforms, with the
    instances' combine (see overlap_add_plain). CPU tensors take the plain
    version; CUDA tensors launch the kernel, one thread per (output, sub-
    block, 4 samples)."""
    if y_full.device.type == "cpu":
        return overlap_add_plain(y_full, overlap, combine)
    K, L, B2 = y_full.shape
    B = B2 // 2
    cudabuild.require(y_full, "y_full", torch.float32, shape=(K, L, 2 * B))
    cudabuild.require(overlap, "overlap", torch.float32, shape=(K, B))
    comb = _ola_map(combine, K)
    C = comb.shape[1]
    y = torch.empty((C, L * B), dtype=torch.float32, device=y_full.device)
    status = cudabuild.launcher("ga_conv_ola")(
        y_full.data_ptr(), overlap.data_ptr(), y.data_ptr(), K, C, L, B, comb.ctypes.data,
        cudabuild.stream_of(y_full))
    cudabuild.check(status, "ga_conv_ola")
    cudabuild.launches["overlap_add"] += 1
    return y


def conv_step(x, hr, hi, ring_r, ring_i, head: int, overlap, rev: bool, combine=None,
              part=None):
    """Convolve one step of K channels: x f32[K, L, B] (L sub-blocks of B
    frames) against partition spectra hr, hi f32[K, P, B+1], the
    instances' outputs combined as ``overlap_add_plain``'s ``combine``
    says (None: one output per instance).

    The ring (f32[K, P-1+L, B+1]) and ``overlap`` (f32[K, B]) are updated in
    place — the delay line is the largest state of the render, and the
    in-place ring replaces the JAX package's copy of the whole line per
    step. With ``part`` = (p0, group) the partitions are split over ranks:
    hr, hi hold this rank's rows [p0, p0 + P_local), the ring the whole
    (replicated) delay line; K14a MACs the slice and one all_reduce over
    ``group`` (the mesh's ``part`` line) completes the sums before the
    inverse transform and K2b, which every rank runs on the whole sums.
    Returns (y f32[C, L*B], new head).
    """
    K, L, B = x.shape
    X = torch.fft.rfft(x, n=2 * B, dim=-1)  # complex64 [K, L, B+1]
    if part is None:
        acc = spectral_mac(X, hr, hi, ring_r, ring_i, head, rev)
    else:
        p0, group = part
        acc = all_reduce_sum(spectral_mac_slice(X, hr, hi, ring_r, ring_i, head, rev, p0), group)
    y_full = torch.fft.irfft(acc, n=2 * B, dim=-1)  # [K, L, 2B], 1/(2B) scaled
    y = overlap_add(y_full.contiguous(), overlap, combine)
    return y, (head + L) % ring_r.shape[1]
