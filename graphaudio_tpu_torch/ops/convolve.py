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
  4. ``overlap_add`` of heads and carried tails — K2's second kernel.

Spectra order: ``prepare_ir`` rows are in lag order (row p multiplies the
sub-block p steps ago); ``prepare_ir_big`` rows are reversed (newest-input
row last). ``rev`` tells the MAC which. Host-side IR preparation is numpy,
copied from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaudio_tpu_torch.core.constants import FRAMES_PER_BLOCK
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


def spectral_mac(X, hr, hi, ring_r, ring_i, head: int, rev: bool):
    """K2a: the partitioned complex MAC (see spectral_mac_plain for shapes).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
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
    acc = torch.empty((K, L, NB), dtype=torch.complex64, device=X.device)
    lib = cudabuild.load()
    status = lib.ga_conv_mac(
        X.data_ptr(), hr.data_ptr(), hi.data_ptr(), ring_r.data_ptr(),
        ring_i.data_ptr(), acc.data_ptr(), K, L, P, NB, R, int(head) % R,
        int(bool(rev)), cudabuild.stream_of(X),
    )
    cudabuild.check(status, "ga_conv_mac")
    cudabuild.launches["spectral_mac"] += 1
    return acc


# ---- K2b: overlap-add ------------------------------------------------------


def overlap_add_plain(y_full, overlap):
    """Plain torch K2b. y_full f32[K, L, 2B] inverse transforms; overlap
    f32[K, B] carried tail, replaced in place by the last tail.
    Returns y f32[K, L*B]."""
    K, L, B2 = y_full.shape
    B = B2 // 2
    heads = y_full[:, :, :B]
    tails = torch.cat([overlap[:, None], y_full[:, :-1, B:]], dim=1)
    y = (heads + tails).reshape(K, L * B)
    overlap.copy_(y_full[:, -1, B:])
    return y


def overlap_add(y_full, overlap):
    """K2b: overlap-add of one step's inverse transforms (see
    overlap_add_plain). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if y_full.device.type == "cpu":
        return overlap_add_plain(y_full, overlap)
    K, L, B2 = y_full.shape
    B = B2 // 2
    cudabuild.require(y_full, "y_full", torch.float32, shape=(K, L, 2 * B))
    cudabuild.require(overlap, "overlap", torch.float32, shape=(K, B))
    y = torch.empty((K, L * B), dtype=torch.float32, device=y_full.device)
    lib = cudabuild.load()
    status = lib.ga_conv_ola(y_full.data_ptr(), overlap.data_ptr(), y.data_ptr(),
                             K, L, B, cudabuild.stream_of(y_full))
    cudabuild.check(status, "ga_conv_ola")
    cudabuild.launches["overlap_add"] += 1
    return y


def conv_step(x, hr, hi, ring_r, ring_i, head: int, overlap, rev: bool):
    """Convolve one step of K channels: x f32[K, L, B] (L sub-blocks of B
    frames) against partition spectra hr, hi f32[K, P, B+1].

    The ring (f32[K, P-1+L, B+1]) and ``overlap`` (f32[K, B]) are updated in
    place — the delay line is the largest state of the render, and the
    in-place ring replaces the JAX package's copy of the whole line per
    step. Returns (y f32[K, L*B], new head).
    """
    K, L, B = x.shape
    X = torch.fft.rfft(x, n=2 * B, dim=-1)  # complex64 [K, L, B+1]
    acc = spectral_mac(X, hr, hi, ring_r, ring_i, head, rev)
    y_full = torch.fft.irfft(acc, n=2 * B, dim=-1)  # [K, L, 2B], 1/(2B) scaled
    y = overlap_add(y_full.contiguous(), overlap)
    return y, (head + L) % ring_r.shape[1]
