"""K4a's staging, header and branch-free step (csrc/adpcm.cu), walked in numpy.

The kernel stages a thread block's span of the chunk with 1-D bulk copies
of a 16-byte-aligned superset, turns the span's words into int16 samples
in place (the quantized audio; outside the chunk the carry or zeros),
splits each block's header over a warp (partial |diff| sums, the 89
compares 32 ways), and runs the step with compares and selects: the code
from 7 thresholds known from the step size at the step's start, select
trees for vp and for the next (index, step size) among the five
candidates (index - 1, + 2, + 4, + 6, + 8, clamped) read from a padded
table that packs each clamped index with its step size. The walks below do the same and must equal the host encoder
(``ima_encode_np``, ``_initial_index_np``) and the plain chunk encoder bit
for bit.
"""

import numpy as np
import pytest
import torch

from graphaudio_tpu_torch.ops import wire

LANES = 32  # header threads (a warp) a block
STEP = wire.IMA_STEP_TABLE.astype(np.int64)
#: The kernel's padded, packed table: entry i = (step[j] << 8) | j for
#: j = clamp(i - 1, 0, 88).
_J = np.clip(np.arange(89 + 9) - 1, 0, 88)
PACKED = (STEP[_J] << 8) | _J


def header_walk(x):
    """int [B, spb] -> initial index [B]: lane ``part`` of 32 sums the
    |diff|s at t = 1 + part + 32 i (exact in any order), the lanes' sums
    add up in 64 bits, then the thresholds k = part mod 32 are counted per
    lane against the 64-bit step * (spb - 1)."""
    B, spb = x.shape
    nm1 = spb - 1
    sad = np.zeros(B, np.uint64)
    for part in range(LANES):
        t = np.arange(1 + part, spb, LANES)
        if t.size:
            d = np.abs(x[:, t] - x[:, t - 1]).astype(np.uint64)
            sad += d.sum(axis=1, dtype=np.uint64)
    s = sad.astype(np.int64)
    count = np.zeros(B, np.int64)
    for part in range(LANES):
        for k in range(part, 89, LANES):
            count += s > (PACKED[k + 1] >> 8) * nm1
    return np.minimum(count, 88)


def chain_walk(x, index):
    """The branch-free steps of [B] blocks from their header indices:
    nibbles int [B, spb-1]. The code is the number of the 7 increasing
    thresholds |diff| reaches, vp is step/8 plus the largest of them, and
    the next index and step size come from one select tree among the five
    packed candidates read at the step's start."""
    B, spb = x.shape
    pred = x[:, 0].astype(np.int64)
    index = index.astype(np.int64)
    step = PACKED[index + 1] >> 8
    nibs = np.empty((B, spb - 1), np.int64)
    sel = np.where
    for t in range(1, spb):
        cm1, c2, c4, c6, c8 = (PACKED[index + k] for k in (0, 3, 5, 7, 9))
        s1, s2 = step >> 2, step >> 1
        t3, t5, t6 = s2 + s1, step + s1, step + s2
        t7 = t6 + s1
        diff = x[:, t] - pred
        neg = diff < 0
        ad = np.abs(diff)
        p1, p2, p3, p4, p5, p6, p7 = (ad >= th for th in (s1, s2, t3, step, t5, t6, t7))
        b2 = sel(p4, p6, p2)
        b1 = sel(p4, sel(p6, p7, p5), sel(p2, p3, p1))
        top = sel(p4, sel(p6, sel(p7, t7, t6), sel(p5, t5, step)),
                  sel(p2, sel(p3, t3, s2), sel(p1, s1, 0)))
        vp = (step >> 3) + top
        pred = np.minimum(np.maximum(sel(neg, pred - vp, pred + vp), -32768), 32767)
        nxt = sel(p4, sel(b2, sel(b1, c8, c6), sel(b1, c4, c2)), cm1)
        step, index = nxt >> 8, nxt & 0xFF
        nibs[:, t - 1] = 4 * p4 + 2 * b2 + b1 + 8 * neg
    return nibs


def _hard_blocks(spb, seed):
    """Blocks that drive the index to 0 and 88 and the predictor to both
    clamps, beside noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(spb)
    rows = [
        np.zeros(spb),                                          # index to 0
        np.where(t % 2, 32767, -32768),                         # index to 88
        np.where((t // 3) % 2, 32767, -32767),                  # pred overshoots both ways
        np.concatenate([np.full(spb // 2, -32768), np.full(spb - spb // 2, 32767)]),
        np.clip(np.cumsum(rng.integers(-9000, 9000, spb)), -32768, 32767),
        rng.integers(-32768, 32768, spb),
        (np.sin(t * 0.05) * 32000).round(),
        rng.integers(-3, 4, spb),
    ]
    return np.stack(rows).astype(np.int16)


@pytest.mark.parametrize("spb", [9, 17, 89, 505])
def test_header_and_chain_match_host_encoder(spb):
    q = _hard_blocks(spb, spb)
    C, nblk = 2, q.shape[0] // 2
    x = q.astype(np.int64)
    idx = header_walk(x)
    np.testing.assert_array_equal(idx, wire._initial_index_np(x.astype(np.int32)))
    nibs = chain_walk(x, idx)
    pred0 = x[:, 0].reshape(C, nblk)
    got = wire._ima_blocks_to_bytes_np(pred0, idx.reshape(C, nblk),
                                       nibs.reshape(C, nblk, spb - 1), C)
    planar = q.reshape(C, nblk * spb)
    np.testing.assert_array_equal(got, wire.ima_encode_np(planar, spb))
    # the walk reaches the edges it is meant to
    ix = idx.copy()
    seen = set()
    for n in nibs.T:
        ix = np.clip(ix + wire.IMA_INDEX_TABLE[n & 7], 0, 88)
        seen |= set(ix.tolist())
    assert {0, 88} <= seen


def _quantize(v):
    """The wire quantizer (edge words, integers seen as floats, come out as
    garbage that the caller's select drops)."""
    with np.errstate(invalid="ignore"):
        return np.round(np.clip(v, np.float32(-1), np.float32(1))
                        * np.float32(32767)).astype(np.int64)


def kernel_walk(audio, carry, carry_len, offset):
    """numpy walk of ima_encode_kernel, thread block by thread block, the
    chunk's rows ``offset`` floats into a 16-byte-aligned buffer: the bulk
    copy's superset into the stage, cut to the tensor's own 16-byte words,
    the samples the cut leaves out read directly, the edge words, the
    header, the steps. Returns (blocks uint8 [ncap, block_align], new
    carry) and checks the geometry on the way, and that the copy reads
    nothing outside the tensor."""
    C, F = audio.shape
    spb = carry.shape[1] + 1
    ncap = wire.ima_chunk_slots(F, spb)
    sb, tiles, smem, streamed = wire.ima_chunk_plan(F, spb)
    assert not streamed
    assert 1 <= sb <= wire.IMA_MAX_BLOCKS_PER_TB and smem <= wire.IMA_MAX_STAGE_BYTES
    assert tiles == -(-ncap // sb) + 1
    bits = np.full(offset + C * F + 16, 0xDEADBEEF, np.uint32)  # word i at byte 4 i
    bits[offset:offset + C * F] = audio.ravel().view(np.uint32)
    t_lo, t_hi = (4 * offset + 15) & ~15, (4 * (offset + C * F)) & ~15
    words = smem // 4
    xs = np.empty((C, ncap, spb), np.int64)
    owned = np.zeros((C, ncap), np.int64)
    for c in range(C):
        row = offset + c * F  # word address of the row
        for tb in range(tiles - 1):
            slot0 = tb * sb
            n = min(sb, ncap - slot0)
            total = n * spb
            owned[c, slot0:slot0 + n] += 1
            a_lo = slot0 * spb - carry_len
            c_lo, c_hi = max(a_lo, 0), min(a_lo + total, F)
            stage = np.full(words, 0xDEADBEEF, np.uint32)
            lead, k_lo, k_hi = 0, c_hi, c_hi
            if c_lo < c_hi:
                lo = 4 * (row + c_lo)
                g_lo, g_hi = lo & ~15, (4 * (row + c_hi) + 15) & ~15
                b_lo, b_hi = max(g_lo, t_lo), min(g_hi, t_hi)
                m = (lo - g_lo) // 4
                d = c_lo - m - a_lo
                lead = (-d) & 3
                assert d >= -3 and (d + lead) % 4 == 0 and (g_hi - g_lo) % 16 == 0
                assert d + lead >= 0 and d + lead + (g_hi - g_lo) // 4 <= words
                if b_lo < b_hi:
                    assert 4 * offset <= b_lo and b_hi <= 4 * (offset + C * F)
                    cut = (b_lo - g_lo) // 4
                    k_lo = c_lo - m + cut
                    k_hi = k_lo + (b_hi - b_lo) // 4
                    dst = d + lead + cut
                    stage[dst:dst + (b_hi - b_lo) // 4] = bits[b_lo // 4:b_hi // 4]
            in_lo = min(c_lo - a_lo, total)
            in_hi = c_hi - a_lo if c_hi > c_lo else in_lo
            # the words turned into samples in place: quantized in the
            # chunk (the copy's, or read directly where the cut left them
            # out), the carry's or 0 outside it
            i = np.arange(total)
            j = slot0 * spb + i
            a = np.clip(a_lo + i, 0, F - 1)
            x = np.where((a_lo + i >= k_lo) & (a_lo + i < k_hi),
                         stage[lead:lead + total].view(np.float32), audio[c, a])
            edge = np.where(j < spb - 1, carry[c, np.minimum(j, spb - 2)], 0)
            xi = np.where((i >= in_lo) & (i < in_hi), _quantize(x), edge)
            xs[c, slot0:slot0 + n] = xi.reshape(n, spb)
    assert (owned == 1).all()
    flat = xs.reshape(C * ncap, spb)
    index0 = header_walk(flat)
    nibs = chain_walk(flat, index0)
    blocks = wire._ima_blocks_to_bytes_np(xs[:, :, 0], index0.reshape(C, ncap),
                                          nibs.reshape(C, ncap, spb - 1), C)
    # the carry thread block
    start = (carry_len + F) // spb * spb
    new_carry = np.empty_like(carry)
    for k in range(spb - 1):
        j = start + k
        a = j - carry_len
        new_carry[:, k] = (_quantize(audio[:, a]) if 0 <= a < F else
                           (carry[:, j] if j < spb - 1 else 0))
    return blocks, new_carry


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("spb, C, F", [(9, 2, 1001), (505, 2, 8 * 505 * 3 + 77),
                                       (505, 1, 300), (89, 2, 5)])
def test_kernel_walk_matches_plain(spb, C, F, offset):
    rng = np.random.default_rng(spb * 10 + offset)
    audio = (rng.standard_normal((C, F)) * 0.45).astype(np.float32)
    audio[0, :3] = [1.7, -1.2, 0.5 / 32767]
    for carry_len in sorted({0, 1, 3, spb // 2, spb - 1}):
        carry = rng.integers(-32768, 32768, (C, spb - 1)).astype(np.int16)
        got = kernel_walk(audio, carry, carry_len, offset)
        want = wire.ima_chunk_encode_plain(torch.from_numpy(audio), torch.from_numpy(carry),
                                           carry_len)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("spb, F", [(9, 524288), (505, 524288), (32769, 70000),
                                    (wire.IMA_MAX_SPB, 200000)])
def test_geometry(spb, F):
    """The plan at config 4's launch chunk and at long blocks: ncap not a
    multiple of the blocks a thread block, every slot owned once, the
    stage within shared memory, config 4's chunk over the card's 132 SMs,
    and the block align within WAV's 16 bits."""
    ncap = wire.ima_chunk_slots(F, spb)
    sb, tiles, smem, streamed = wire.ima_chunk_plan(F, spb)
    assert not streamed
    assert ncap % sb != 0 or sb == 1
    slots = [min(sb, ncap - t * sb) for t in range(tiles - 1)]
    assert sum(slots) == ncap and min(slots) >= 1
    assert smem == (sb * spb + wire.IMA_STAGE_SLACK) * 4 <= wire.IMA_MAX_STAGE_BYTES
    assert smem <= 48 * 1024 or sb == 1
    if (spb, F) == (505, 524288):
        assert 2 * (tiles - 1) >= 128  # both channels' thread blocks fill the SMs
    assert wire.ima_block_align(2, spb) <= 0xFFFF


#: Samples a tile of the streamed path (csrc/adpcm.cu kLongTile).
LONG_TILE = 2048


@pytest.mark.parametrize("spb, C", [(65521, 2), (131057, 1), (131065, 1),
                                    (wire.IMA_MAX_SPB + 8, 2)])
def test_long_blocks_stream(spb, C):
    """A block past the stage takes the streamed path: a thread block (one
    warp) a slot, ncap + 1 thread blocks a channel, the last writing the
    carry; every slot owned once, its tiles covering the block's spb - 1
    steps once, whole words each; no spb of the form 8k + 1 raises."""
    wire._validate_spb(spb)
    for F in (5, spb - 1, 3 * spb + 17, 524288):
        ncap = wire.ima_chunk_slots(F, spb)
        sb, tiles, smem, streamed = wire.ima_chunk_plan(F, spb)
        assert streamed and sb == 1 and smem == 0 and tiles == ncap + 1
        owned = np.zeros(ncap, np.int64)
        for tb in range(tiles - 1):
            owned[tb * sb:tb * sb + sb] += 1
        assert (owned == 1).all()
        steps = [min(LONG_TILE, spb - t0) for t0 in range(1, spb, LONG_TILE)]
        assert sum(steps) == spb - 1 and all(n % 8 == 0 for n in steps)


def streamed_walk(audio, carry, carry_len):
    """numpy walk of ima_encode_streamed_kernel: each slot's samples read
    straight from the chunk (quantized) or the carry or 0, the 64-bit
    header, the steps. Returns the block bytes [ncap, block_align]."""
    C, F = audio.shape
    spb = carry.shape[1] + 1
    ncap = wire.ima_chunk_slots(F, spb)
    i = np.arange(ncap * spb)
    a = i - carry_len
    inside = (a >= 0) & (a < F)
    edge = np.where(i < spb - 1, carry[:, np.minimum(i, spb - 2)], 0)
    xs = np.where(inside, _quantize(audio[:, np.clip(a, 0, F - 1)]), edge)
    flat = xs.reshape(C * ncap, spb)
    index0 = header_walk(flat)
    nibs = chain_walk(flat, index0)
    return wire._ima_blocks_to_bytes_np(flat[:, 0].reshape(C, ncap), index0.reshape(C, ncap),
                                        nibs.reshape(C, ncap, spb - 1), C)


def test_streamed_walk_matches_host_encoder():
    """The first streamed block length, stereo, two slots and a part (the
    carry before, zeros after), loud enough that the 64-bit header matters
    at long blocks: the walk equals the host encoder of the same stream
    buffer bit for bit."""
    spb = wire.IMA_MAX_SPB + 8
    rng = np.random.default_rng(spb)
    C, F, carry_len = 2, 2 * spb - 100, 3
    audio = (rng.standard_normal((C, F)) * 0.9).astype(np.float32)
    carry = rng.integers(-32768, 32768, (C, spb - 1)).astype(np.int16)
    got = streamed_walk(audio, carry, carry_len)
    buf = np.zeros((C, wire.ima_chunk_slots(F, spb) * spb), np.int16)
    buf[:, :spb - 1] = carry
    buf[:, carry_len:carry_len + F] = _quantize(audio)
    np.testing.assert_array_equal(got, wire.ima_encode_np(buf, spb))
