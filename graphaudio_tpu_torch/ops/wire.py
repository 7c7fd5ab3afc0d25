"""Compressed wire formats: G.711 mu-law and IMA ADPCM, packed on the device.

The port of graphaudio_tpu/ops/wire.py. ``OfflineAudioContext.render_mulaw``
and ``render_adpcm`` quantize the rendered audio on the device so fewer
bytes come back to the host:

- mu-law: 8 bits a sample, memoryless (K4mu, ``pack_mulaw``);
- IMA ADPCM (WAV tag 0x11): about 4.06 bits a sample at the default
  505-sample block (K4a, ``ima_chunk_encode``, threaded across launch
  chunks by ``ImaDeviceStream``).

Both produce the standard bitstreams (ITU-T G.711; IMA/DVI ADPCM in the WAV
block layout). The host codecs below are the JAX package's numpy encoders
and decoders, copied: they encode the edges of a stream (carried frames, the
final flush) and are the bit-exactness oracle of both kernels.

On CPU tensors the wrappers take the plain torch versions; on CUDA tensors
they launch csrc/pack.cu (K4mu) and csrc/adpcm.cu (K4a).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from graphaudio_tpu_torch.utils import cudabuild

# IMA/DVI ADPCM tables (from the IMA ADPCM specification).
IMA_STEP_TABLE = np.array(
    [
        7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
        41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
        190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
        724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
        2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
        6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
        16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
    ],
    dtype=np.int32,
)
# Index adjustment by 3-bit magnitude (sign bit does not affect it).
IMA_INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)

DEFAULT_SAMPLES_PER_BLOCK = 505  # 256 bytes/channel/block -> 4.06 bits/sample


def quantize_i16(audio) -> np.ndarray:
    """f32 [-1,1] -> int16 with the wire quantizer round(clip(x)*32767)
    (same formula as the pcm16 path, so all wire formats agree on sample 0)."""
    x = np.asarray(audio, dtype=np.float32)
    return np.round(np.clip(x, -1.0, 1.0) * np.float32(32767.0)).astype(np.int16)


# -- G.711 mu-law --------------------------------------------------------------


def _quantize_plain(outs):
    """round_half_even(clip(x, -1, 1) * 32767) as int32, in torch."""
    return torch.round(torch.clamp(outs, -1.0, 1.0) * 32767.0).to(torch.int32)


def pack_mulaw_plain(outs):
    """Plain torch K4mu: f32 [C, T] -> interleaved mu-law uint8[T*C], the
    JAX package's ``pack_mulaw`` (graphaudio_tpu/ops/wire.py:66-82)."""
    x = _quantize_plain(outs)
    sign = (x < 0).to(torch.int32)
    mag = torch.clamp(torch.abs(x), max=32635) + 0x84
    # exponent = index of the segment holding mag (7 exact comparisons)
    exp = torch.zeros_like(mag)
    for k in range(7):
        exp = exp + (mag >= (0x100 << k)).to(torch.int32)
    mant = (mag >> (exp + 3)) & 0xF
    byte = (~((sign << 7) | (exp << 4) | mant)) & 0xFF
    return byte.to(torch.uint8).T.reshape(-1)


#: Frames of every channel one thread of K4mu encodes (csrc/pack.cu's
#: kV; 8 timed faster than 16 on the H100).
MULAW_FRAMES = 8
#: K4mu's threads a block.
MULAW_THREADS = 256
#: Shared memory K4mu's any-C instantiation may take (the 48 KB default):
#: a block stages threads x MULAW_FRAMES x C bytes.
_MULAW_MAX_SMEM = 48 * 1024
#: The most channels K4mu packs: 32 threads' stages within _MULAW_MAX_SMEM.
MULAW_MAX_CHANNELS = _MULAW_MAX_SMEM // (32 * MULAW_FRAMES)


class MulawPlan(NamedTuple):
    """K4mu's geometry, in the order ``ga_pack_mulaw`` takes it."""

    variant: int  # C for 1 and 2 (bytes interleaved in registers), 0 for any C (shared memory)
    vec: bool  # 16-byte loads: every row base is 16-byte aligned
    frames: int  # V, frames of every channel a thread
    tail: int  # first frame of the tail, T - T % V: one thread writes [tail, T)
    threads: int
    blocks: int
    smem: int  # dynamic shared bytes (the any-C instantiation)


def mulaw_pack_plan(C: int, T: int, offset: int) -> MulawPlan:
    """K4mu's geometry for f32 [C, T] whose base address is ``offset``
    bytes past a 16-byte boundary. Thread g of the grid encodes frames
    [g V, g V + V) of every channel, the thread g = T // V the frames
    [tail, T); the grid covers them in one pass (a grid-stride grid of a
    multiple of 132 blocks timed no faster). Vector loads need every
    row base (x + c T) 16-byte aligned: ``offset`` 0, and T % 4 == 0 when
    there is more than one row. Raises above ``MULAW_MAX_CHANNELS``."""
    if not 1 <= C <= MULAW_MAX_CHANNELS:
        raise ValueError(f"the card's mu-law pack takes 1 to {MULAW_MAX_CHANNELS} channels "
                         f"(its stage of {MULAW_FRAMES} frames of every channel for 32 "
                         f"threads must fit in {_MULAW_MAX_SMEM} bytes); got {C}")
    V = MULAW_FRAMES
    variant = C if C <= 2 else 0
    threads = MULAW_THREADS
    smem = 0
    if variant == 0:
        threads = min(threads, _MULAW_MAX_SMEM // (V * C) // 32 * 32)
        smem = threads * V * C
    vec = offset % 16 == 0 and (C == 1 or T % 4 == 0)
    groups = -(-T // V)
    return MulawPlan(variant, vec, V, T - T % V, threads, max(1, -(-groups // threads)), smem)


def pack_mulaw(outs):
    """K4mu: f32 [C, T] -> flat interleaved G.711 mu-law bytes uint8[T*C],
    bit for bit ``mulaw_encode_np``. CPU tensors take the plain version;
    CUDA tensors launch csrc/pack.cu with ``mulaw_pack_plan``'s geometry
    (an empty tensor launches nothing)."""
    if outs.device.type == "cpu":
        return pack_mulaw_plain(outs)
    cudabuild.require(outs, "outs", torch.float32, ndim=2)
    C, T = outs.shape
    out = torch.empty((T * C,), dtype=torch.uint8, device=outs.device)
    if out.numel() == 0:
        return out
    plan = mulaw_pack_plan(C, T, outs.data_ptr() % 16)
    status = cudabuild.launcher("ga_pack_mulaw")(outs.data_ptr(), out.data_ptr(), C, T, *plan,
                                                 cudabuild.stream_of(outs))
    cudabuild.check(status, "ga_pack_mulaw")
    cudabuild.launches["pack_mulaw"] += 1
    return out


def mulaw_encode_np(audio) -> np.ndarray:
    """Host reference mu-law encoder (planar [C, T] -> interleaved uint8)."""
    x = quantize_i16(audio).astype(np.int32)
    sign = (x < 0).astype(np.int32)
    mag = np.minimum(np.abs(x), 32635) + 0x84
    exp = np.zeros_like(mag)
    for k in range(7):
        exp += (mag >= (0x100 << k)).astype(np.int32)
    mant = (mag >> (exp + 3)) & 0xF
    byte = (~((sign << 7) | (exp << 4) | mant)) & 0xFF
    return np.ascontiguousarray(byte.astype(np.uint8).T).reshape(-1)


def mulaw_decode_np(data: np.ndarray, channels: int) -> np.ndarray:
    """Interleaved mu-law uint8 -> planar f32 [C, T] (gacodec's ulaw_expand
    formula exactly: sample/32768)."""
    u = (~np.asarray(data, dtype=np.uint8)).astype(np.int32) & 0xFF
    sign = u & 0x80
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    sample = (((mant << 3) + 0x84) << exp) - 0x84
    sample = np.where(sign != 0, -sample, sample)
    out = sample.astype(np.float32) / np.float32(32768.0)
    return np.ascontiguousarray(out.reshape(-1, channels).T)


# -- IMA ADPCM (WAV tag 0x11 block layout) -------------------------------------


def _validate_spb(samples_per_block: int) -> int:
    """WAV-IMA blocks hold 1 header sample + 2*D nibble samples per channel,
    with D (data bytes/channel) a multiple of 4 — so spb must be ≡ 1 (mod 8)."""
    spb = int(samples_per_block)
    if spb < 9 or (spb - 1) % 8 != 0:
        raise ValueError(
            "samples_per_block must be 8*k+1 with k >= 1 (WAV-IMA blocks are "
            f"1 header sample + 4-byte nibble words per channel); got {spb}"
        )
    return spb


def ima_block_align(channels: int, samples_per_block: int) -> int:
    return channels * (4 + (samples_per_block - 1) // 2)


def _initial_index_np(blocks_i32: np.ndarray) -> np.ndarray:
    """Per-block initial step index: the smallest step >= the block's mean
    |first difference|, by pure integer comparison (sum of |diff| vs
    step*(spb-1)), so host and device encoders agree bit for bit."""
    nm1 = blocks_i32.shape[-1] - 1
    sad = np.abs(np.diff(blocks_i32, axis=-1)).sum(axis=-1, dtype=np.int64)
    thresholds = IMA_STEP_TABLE.astype(np.int64) * nm1  # [89]
    idx = (sad[..., None] > thresholds).sum(axis=-1)
    return np.clip(idx, 0, 88).astype(np.int32)


def _ima_encode_step_np(pred, index, x):
    """One IMA encode step, vectorized over any leading shape. Mirrors the
    decoder's reconstruction bit-exactly (gacodec.cpp ima_step)."""
    step = IMA_STEP_TABLE[index]
    diff = x - pred
    sign = diff < 0
    adiff = np.abs(diff)
    b4 = adiff >= step
    adiff = adiff - np.where(b4, step, 0)
    vp = (step >> 3) + np.where(b4, step, 0)
    s2 = step >> 1
    b2 = adiff >= s2
    adiff = adiff - np.where(b2, s2, 0)
    vp = vp + np.where(b2, s2, 0)
    s1 = step >> 2
    b1 = adiff >= s1
    vp = vp + np.where(b1, s1, 0)
    delta = b4.astype(np.int32) * 4 + b2.astype(np.int32) * 2 + b1.astype(np.int32)
    pred = np.where(sign, pred - vp, pred + vp)
    pred = np.clip(pred, -32768, 32767)
    index = np.clip(index + IMA_INDEX_TABLE[delta], 0, 88)
    nib = delta + sign.astype(np.int32) * 8
    return pred, index, nib


def _ima_blocks_to_bytes_np(pred0, index0, nibs, channels):
    """Assemble WAV-IMA block bytes from per-block header state + nibbles.

    pred0/index0: [C, nblk]; nibs: [C, nblk, spb-1] (values 0..15).
    Layout per block: for each channel a 4-byte header (predictor int16 LE,
    step index, 0), then 4-byte nibble words round-robin per channel, low
    nibble first (gacodec.cpp adpcm_decode_block reads this exact layout).
    """
    C, nblk, nm1 = nibs.shape
    D = nm1 // 2
    u = pred0.astype(np.int32).astype(np.uint16)
    header = np.empty((nblk, C, 4), dtype=np.uint8)
    header[:, :, 0] = (u & 0xFF).T
    header[:, :, 1] = (u >> 8).T
    header[:, :, 2] = index0.astype(np.uint8).T
    header[:, :, 3] = 0
    data = (nibs[..., 0::2] | (nibs[..., 1::2] << 4)).astype(np.uint8)  # [C,nblk,D]
    words = data.reshape(C, nblk, D // 4, 4).transpose(1, 2, 0, 3)  # [nblk,D/4,C,4]
    return np.concatenate(
        [header.reshape(nblk, 4 * C), words.reshape(nblk, D * channels)], axis=1
    )


def _ima_encode_scalar_np(blocks_i32: np.ndarray) -> tuple:
    """Bit-exact scalar twin of the vectorized encode loop, for FEW lanes
    (the final flush block of a stream): plain Python ints run the 504
    steps faster than the vectorized loop's per-step numpy overhead."""
    C, nblk, spb = blocks_i32.shape
    step_tab = IMA_STEP_TABLE.tolist()
    idx_tab = IMA_INDEX_TABLE.tolist()
    pred0 = np.empty((C, nblk), np.int32)
    index0 = np.empty((C, nblk), np.int32)
    nibs = np.empty((C, nblk, spb - 1), dtype=np.int32)
    nm1 = spb - 1
    for c in range(C):
        for b in range(nblk):
            xs = blocks_i32[c, b].tolist()
            p = xs[0]
            sad = sum(abs(xs[t + 1] - xs[t]) for t in range(nm1))
            ix = 0
            for st in step_tab:
                if sad > st * nm1:
                    ix += 1
            if ix > 88:
                ix = 88
            pred0[c, b] = p
            index0[c, b] = ix
            row = nibs[c, b]
            for t in range(1, spb):
                step = step_tab[ix]
                diff = xs[t] - p
                sign = diff < 0
                adiff = -diff if sign else diff
                delta = 0
                vp = step >> 3
                if adiff >= step:
                    delta = 4
                    adiff -= step
                    vp += step
                s2 = step >> 1
                if adiff >= s2:
                    delta += 2
                    adiff -= s2
                    vp += s2
                if adiff >= step >> 2:
                    delta += 1
                    vp += step >> 2
                p = p - vp if sign else p + vp
                if p < -32768:
                    p = -32768
                elif p > 32767:
                    p = 32767
                ix += idx_tab[delta]
                if ix < 0:
                    ix = 0
                elif ix > 88:
                    ix = 88
                row[t - 1] = delta + (8 if sign else 0)
    return pred0, index0, nibs


def ima_encode_np(q: np.ndarray, samples_per_block: int) -> np.ndarray:
    """Host reference IMA encoder: int16 planar [C, N] -> block bytes
    [nblk, block_align]. N must be a multiple of samples_per_block (pad the
    final partial block with zeros first; WAV records true frames in `fact`).
    Few-lane calls (the flush block) take the bit-exact scalar path."""
    spb = _validate_spb(samples_per_block)
    q = np.asarray(q, dtype=np.int16)
    C, N = q.shape
    if N % spb:
        raise ValueError(f"sample count {N} not a multiple of block size {spb}")
    nblk = N // spb
    blocks = q.reshape(C, nblk, spb).astype(np.int32)
    if C * nblk <= 4:
        pred0, index0, nibs = _ima_encode_scalar_np(blocks)
        return _ima_blocks_to_bytes_np(pred0, index0, nibs, C)
    pred = blocks[:, :, 0].copy()
    index = _initial_index_np(blocks)
    pred0, index0 = pred.copy(), index.copy()
    nibs = np.empty((C, nblk, spb - 1), dtype=np.int32)
    for t in range(1, spb):
        pred, index, nib = _ima_encode_step_np(pred, index, blocks[:, :, t])
        nibs[:, :, t - 1] = nib
    return _ima_blocks_to_bytes_np(pred0, index0, nibs, C)


def ima_decode_np(
    blocks: np.ndarray, channels: int, samples_per_block: int, frames: int = None
) -> np.ndarray:
    """Decode WAV-IMA block bytes [nblk, block_align] (or a flat byte vector)
    -> int16 planar [C, frames]. Bit-exact vs gacodec's adpcm_decode_block."""
    spb = _validate_spb(samples_per_block)
    C = int(channels)
    ba = ima_block_align(C, spb)
    blocks = np.asarray(blocks, dtype=np.uint8).reshape(-1, ba)
    nblk = blocks.shape[0]
    D = (spb - 1) // 2
    header = blocks[:, : 4 * C].reshape(nblk, C, 4)
    pred = (
        header[:, :, 0].astype(np.uint16) | (header[:, :, 1].astype(np.uint16) << 8)
    ).astype(np.int16).astype(np.int32).T  # [C, nblk]
    index = np.minimum(header[:, :, 2].astype(np.int32), 88).T
    words = blocks[:, 4 * C:].reshape(nblk, D // 4, C, 4)
    data = words.transpose(2, 0, 1, 3).reshape(C, nblk, D)
    nibs = np.empty((C, nblk, spb - 1), dtype=np.int32)
    nibs[..., 0::2] = data & 0xF
    nibs[..., 1::2] = data >> 4
    out = np.empty((C, nblk, spb), dtype=np.int16)
    out[:, :, 0] = pred.astype(np.int16)
    for t in range(1, spb):
        nib = nibs[:, :, t - 1]
        step = IMA_STEP_TABLE[index]
        diff = (step >> 3)
        diff += np.where(nib & 1, step >> 2, 0)
        diff += np.where(nib & 2, step >> 1, 0)
        diff += np.where(nib & 4, step, 0)
        pred = np.where(nib & 8, pred - diff, pred + diff)
        pred = np.clip(pred, -32768, 32767)
        index = np.clip(index + IMA_INDEX_TABLE[nib & 7], 0, 88)
        out[:, :, t] = pred.astype(np.int16)
    out = out.reshape(C, nblk * spb)
    if frames is not None:
        out = out[:, :frames]
    return out


# -- K4a: the IMA ADPCM chunk encoder ---------------------------------------------


def ima_chunk_slots(frames: int, samples_per_block: int) -> int:
    """ncap: the block slots a chunk of ``frames`` frames always emits."""
    return (samples_per_block - 1 + frames) // samples_per_block


#: Blocks a thread block of csrc/adpcm.cu takes at most: its 512 threads
#: run a header warp a block (the launcher refuses more).
IMA_MAX_BLOCKS_PER_TB = 16
#: f32 words of K4a's stage beyond its blocks' samples (the copy's
#: alignment lead and tail, at most 3 words each). The plan below is the
#: one owner of the kernel's geometry: the launcher takes it as given.
IMA_STAGE_SLACK = 8
#: Dynamic shared memory K4a's stage may take: the 227 KB a block can use
#: on the H100, less 1 KB for the kernel's static arrays.
IMA_MAX_STAGE_BYTES = 227 * 1024 - 1024
#: The longest WAV-IMA block K4a stages: its f32 samples fit in shared
#: memory. Longer blocks take the streamed path.
IMA_MAX_SPB = ((IMA_MAX_STAGE_BYTES // 4 - IMA_STAGE_SLACK - 1) // 8) * 8 + 1
_IMA_DEFAULT_SMEM = 48 * 1024


def ima_chunk_plan(frames: int, samples_per_block: int):
    """K4a's geometry for a chunk of ``frames`` frames: (sb, thread blocks
    a channel, dynamic shared-memory bytes, streamed). A thread block
    stages ``sb`` consecutive block slots of one channel, as many as fit in
    the 48 KB default (at most ``IMA_MAX_BLOCKS_PER_TB``, at least one);
    the last thread block of each channel writes the new carry row. A block
    longer than ``IMA_MAX_SPB`` samples does not fit the stage: it takes the
    streamed path (``streamed`` True), one warp a block slot reading the
    chunk directly, so sb is 1 and no dynamic shared memory is used."""
    spb = samples_per_block
    ncap = ima_chunk_slots(frames, spb)
    if spb > IMA_MAX_SPB:
        return 1, ncap + 1, 0, True
    sb = max(1, min(IMA_MAX_BLOCKS_PER_TB,
                    (_IMA_DEFAULT_SMEM // 4 - IMA_STAGE_SLACK) // spb))
    return sb, -(-ncap // sb) + 1, (sb * spb + IMA_STAGE_SLACK) * 4, False


def ima_chunk_encode_plain(audio, carry, carry_len: int):
    """Plain torch K4a, the JAX package's ``make_ima_chunk_encoder``
    (graphaudio_tpu/ops/wire.py:338-459) with the same contract:

        (audio f32[C, F], carry int16[C, spb-1], carry_len)
          -> (blocks uint8[ncap, block_align], new_carry int16[C, spb-1])

    ``carry_len`` leading samples of ``carry`` precede the chunk's audio;
    ncap = (spb-1+F)//spb block slots are always emitted, the caller keeps
    the first (carry_len+F)//spb. The stream buffer is built as the JAX
    encoder builds it (the whole carry row first, the quantized chunk
    written over it from ``carry_len``, zeros after), so every slot and
    the whole new carry row match it, not only the kept ones."""
    C, F = audio.shape
    spb = carry.shape[1] + 1
    D = (spb - 1) // 2
    ncap = ima_chunk_slots(F, spb)
    dev = audio.device
    q = _quantize_plain(audio).to(torch.int16)
    buf = torch.zeros((C, ncap * spb + spb), dtype=torch.int16, device=dev)
    buf[:, :spb - 1] = carry
    buf[:, carry_len:carry_len + F] = q
    blocks = buf[:, :ncap * spb].reshape(C, ncap, spb).to(torch.int32)
    pred0 = blocks[:, :, 0]
    step_t = torch.from_numpy(IMA_STEP_TABLE).to(dev)
    idx_t = torch.from_numpy(IMA_INDEX_TABLE).to(dev)
    # 64-bit, as the host encoder: a long block's sum and thresholds pass 2^31
    sad = torch.abs(torch.diff(blocks, dim=2)).sum(dim=2, dtype=torch.int64)
    index0 = (sad[..., None] > step_t.long() * (spb - 1)).sum(dim=-1, dtype=torch.int32)
    index0 = torch.clamp(index0, 0, 88)
    pred, index = pred0, index0
    nibs = torch.empty((C, ncap, spb - 1), dtype=torch.int32, device=dev)
    for t in range(1, spb):
        step = step_t[index.long()]
        diff = blocks[:, :, t] - pred
        sign = diff < 0
        adiff = torch.abs(diff)
        b4 = (adiff >= step).to(torch.int32)
        adiff = adiff - b4 * step
        vp = (step >> 3) + b4 * step
        s2 = step >> 1
        b2 = (adiff >= s2).to(torch.int32)
        adiff = adiff - b2 * s2
        vp = vp + b2 * s2
        s1 = step >> 2
        b1 = (adiff >= s1).to(torch.int32)
        vp = vp + b1 * s1
        delta = b4 * 4 + b2 * 2 + b1
        pred = torch.clamp(torch.where(sign, pred - vp, pred + vp), -32768, 32767)
        index = torch.clamp(index + idx_t[delta.long()], 0, 88)
        nibs[:, :, t - 1] = delta + sign.to(torch.int32) * 8
    u = pred0 & 0xFFFF
    header = torch.stack([u & 0xFF, u >> 8, index0, torch.zeros_like(index0)], dim=-1)
    header = header.transpose(0, 1).reshape(ncap, 4 * C)
    data = nibs[..., 0::2] | (nibs[..., 1::2] << 4)  # [C, ncap, D]
    words = data.reshape(C, ncap, D // 4, 4).permute(1, 2, 0, 3).reshape(ncap, D * C)
    out = torch.cat([header, words], dim=1).to(torch.uint8)
    nblk = (carry_len + F) // spb
    new_carry = buf[:, nblk * spb:nblk * spb + spb - 1].clone()
    return out, new_carry


def ima_chunk_encode(audio, carry, carry_len: int):
    """K4a: one launch chunk of an IMA ADPCM stream; the contract of
    ``ima_chunk_encode_plain``, bit for bit. CPU tensors take the plain
    version; CUDA tensors launch csrc/adpcm.cu (one thread per (channel,
    block slot) for the sequential in-block recurrence, plus the new
    carry, in one launch; ``ima_chunk_plan`` gives its geometry and its
    path: staged, or streamed for a block too long to stage)."""
    if audio.device.type == "cpu":
        return ima_chunk_encode_plain(audio, carry, carry_len)
    cudabuild.require(audio, "audio", torch.float32, ndim=2)
    C, F = audio.shape
    cudabuild.require(carry, "carry", torch.int16, ndim=2)
    spb = _validate_spb(carry.shape[1] + 1)
    if carry.shape[0] != C or not 0 <= carry_len < spb:
        raise ValueError(f"carry must be int16[{C}, spb-1] with 0 <= carry_len < spb, got "
                         f"{tuple(carry.shape)} and carry_len={carry_len}")
    ncap = ima_chunk_slots(F, spb)
    sb, tiles, smem, streamed = ima_chunk_plan(F, spb)
    blocks = torch.empty((ncap, ima_block_align(C, spb)), dtype=torch.uint8, device=audio.device)
    new_carry = torch.empty_like(carry)
    status = cudabuild.launcher("ga_ima_chunk_encode")(
        audio.data_ptr(), carry.data_ptr(), C, F, spb, int(carry_len), ncap, sb, tiles, smem,
        int(streamed), blocks.data_ptr(), new_carry.data_ptr(), cudabuild.stream_of(audio))
    cudabuild.check(status, "ga_ima_chunk_encode")
    cudabuild.launches["ima_chunk_encode"] += 1
    return blocks, new_carry


class ImaDeviceStream:
    """Streaming IMA encoder threading block-boundary carry across device
    chunks, so one render call yields ONE contiguous standard WAV-IMA stream
    whatever the launch-chunk schedule. The carry stays on the chunks'
    device; ``carry_len`` is a host int."""

    def __init__(self, channels: int, samples_per_block: int):
        self.channels = int(channels)
        self.spb = _validate_spb(samples_per_block)
        self.block_align = ima_block_align(self.channels, self.spb)
        # Host zeros until the first chunk names the device.
        self.carry_buf = np.zeros((self.channels, self.spb - 1), np.int16)
        self.carry_len = 0

    def set_carry(self, q: np.ndarray) -> None:
        """Seed the stream with leftover host samples (int16 [C, n<spb])."""
        n = q.shape[1]
        if n >= self.spb:
            raise ValueError("carry must be shorter than one block")
        buf = np.zeros((self.channels, self.spb - 1), np.int16)
        buf[:, :n] = q
        self.carry_buf = buf
        self.carry_len = n

    def encode_chunk(self, audio):
        """f32 [C, F] (a tensor, or a numpy array taken as a CPU tensor) ->
        (uint8 block slots [ncap, block_align] on its device, kept-block
        count)."""
        if not isinstance(audio, torch.Tensor):
            audio = torch.from_numpy(np.ascontiguousarray(audio, dtype=np.float32))
        C, F = audio.shape
        if C != self.channels:
            raise RuntimeError(
                "destination channel count changed mid-stream "
                f"({self.channels} -> {C}); an ADPCM stream has a fixed "
                "channel layout — render across the topology change with "
                "separate render_adpcm calls"
            )
        carry = self.carry_buf
        if not isinstance(carry, torch.Tensor):
            carry = torch.from_numpy(carry).to(audio.device)
        blocks, self.carry_buf = ima_chunk_encode(audio, carry, self.carry_len)
        nblk = (self.carry_len + F) // self.spb
        self.carry_len = (self.carry_len + F) % self.spb
        return blocks, nblk

    def pack(self, audio):
        """``encode_chunk``'s kept block rows alone, on the device: the pack
        function a render passes to each launch, so only those rows cross
        to the host."""
        blocks, nblk = self.encode_chunk(audio)
        return blocks[:nblk]

    def pull_carry(self) -> np.ndarray:
        """Fetch the pending carry samples to the host (int16 [C,
        carry_len]) and reset the carry, to hand off to host-side encoding
        (stream flush / f32 tail)."""
        carry = self.carry_buf
        if isinstance(carry, torch.Tensor):
            carry = carry.cpu().numpy()
        buf = np.asarray(carry)[:, : self.carry_len]
        self.carry_buf = np.zeros((self.channels, self.spb - 1), np.int16)
        self.carry_len = 0
        return buf


@dataclass
class AdpcmStream:
    """A rendered IMA ADPCM stream: standard WAV tag-0x11 blocks.

    ``blocks`` is uint8 [nblk, block_align]; the final block is zero-padded
    past ``frames`` (standard WAV practice — the `fact` chunk records the
    true frame count)."""

    blocks: np.ndarray
    channels: int
    samples_per_block: int
    sample_rate: int
    frames: int

    @property
    def block_align(self) -> int:
        return ima_block_align(self.channels, self.samples_per_block)

    @property
    def nbytes(self) -> int:
        return int(self.blocks.size)

    def tobytes(self) -> bytes:
        return self.blocks.tobytes()

    def decode_int16(self) -> np.ndarray:
        """Planar int16 [C, frames] (bit-exact vs gacodec's decode)."""
        return ima_decode_np(
            self.blocks, self.channels, self.samples_per_block, self.frames
        )

    def decode(self) -> np.ndarray:
        """Planar f32 [C, frames]; int16/32768, matching gacodec exactly."""
        return self.decode_int16().astype(np.float32) / np.float32(32768.0)

    def to_wav_bytes(self) -> bytes:
        """A complete, standard WAV-IMA file (fmt tag 0x11 with
        wSamplesPerBlock extension + fact chunk + data)."""
        data = self.tobytes()
        fmt = struct.pack(
            "<HHIIHHHH",
            0x11,
            self.channels,
            self.sample_rate,
            # nAvgBytesPerSec for ADPCM: bytes per second of blocks.
            int(
                round(
                    self.sample_rate * self.block_align / self.samples_per_block
                )
            ),
            self.block_align,
            4,  # bits per (compressed) sample
            2,  # cbSize
            self.samples_per_block,
        )
        chunks = (
            b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"fact" + struct.pack("<II", 4, self.frames)
            + b"data" + struct.pack("<I", len(data)) + data
        )
        if len(data) & 1:
            chunks += b"\x00"
        return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks

    def write_wav(self, path) -> None:
        with open(path, "wb") as f:
            f.write(self.to_wav_bytes())


def mulaw_wav_bytes(data: np.ndarray, channels: int, sample_rate: int) -> bytes:
    """Wrap interleaved mu-law bytes as a standard WAV (fmt tag 7)."""
    payload = np.asarray(data, dtype=np.uint8).tobytes()
    fmt = struct.pack(
        "<HHIIHHH", 7, channels, sample_rate, sample_rate * channels,
        channels, 8, 0,
    )
    chunks = (
        b"fmt " + struct.pack("<I", len(fmt)) + fmt
        + b"fact" + struct.pack("<II", 4, len(payload) // channels)
        + b"data" + struct.pack("<I", len(payload)) + payload
    )
    if len(payload) & 1:
        chunks += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks
