"""The port's wire formats, G.711 mu-law and IMA ADPCM, on the CPU.

* twins of the 14 tests of tests/test_wire.py on the port (contexts with
  ``device="cpu"``, so the wrappers take their plain versions);
* K4mu's and K4a's plain versions against the JAX package's jitted
  encoders, bit for bit: ``pack_mulaw``, and ``make_ima_chunk_encoder``
  with carry_len 0, 1 and spb-1, for 1 and 2 channels (every block slot
  and the whole new carry row, the slots the caller drops included);
* ``render_mulaw`` and ``render_adpcm`` of a small config-4 scene (8
  voices, superblock 4) equal the host encoders of the port's own f32
  render of the same scene bit for bit, and the JAX package's within one
  int16 LSB after decoding: the two f32 renders differ in their last bits
  (1.5e-8 at this size), so a sample on a rounding edge may quantize one
  step apart.

The gacodec round trips use graphaudio_tpu.io.native, as test_wire.py
does, and skip where that library is not built.
"""

import numpy as np
import pytest
import torch

import benchmarks.configs as bc
import graphaudio_tpu as ga
import graphaudio_tpu_torch as gat
from graphaudio_tpu.io import native
from graphaudio_tpu.io.decode import AudioDecoder
from graphaudio_tpu.ops import wire as jwire
from graphaudio_tpu_torch.ops import wire
from graphaudio_tpu_torch.testing import configs as tc

SR = 48000


def _signal(rng, channels, n):
    t = np.arange(n, dtype=np.float64) / SR
    tones = np.stack(
        [np.sin(2 * np.pi * 220.0 * (c + 1) * t) for c in range(channels)]
    )
    sig = 0.7 * tones + 0.05 * rng.standard_normal((channels, n))
    return np.clip(sig, -1.0, 1.0).astype(np.float32)


def _snr_db(ref, got):
    ref = ref.astype(np.float64)
    err = got.astype(np.float64) - ref
    return 10.0 * np.log10(np.sum(ref**2) / max(np.sum(err**2), 1e-30))


def _noise_ctx(superblock=2, channels=2, seconds=1.0, seed=7):
    """Offline context playing a broadband looped buffer (worst case for
    ADPCM adaptation, unlike a constant that compresses losslessly)."""
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    buf = gat.PlayableAudioBuffer.from_channel_arrays(
        list(_signal(rng, channels, n)), SR
    )
    ctx = gat.OfflineAudioContext(sample_rate=SR, superblock=superblock, device="cpu")
    src = gat.AudioBufferSourceNode(ctx)
    src.buffer = buf
    src.loop = True
    src.connect(ctx.destination)
    src.start(0)
    return ctx


# -- twins of tests/test_wire.py: mu-law ------------------------------------------


def test_mulaw_device_matches_host(rng):
    x = _signal(rng, 2, 4096)
    dev = wire.pack_mulaw(torch.from_numpy(x)).numpy()
    host = wire.mulaw_encode_np(x)
    np.testing.assert_array_equal(dev, host)


def test_mulaw_roundtrip_snr(rng):
    x = _signal(rng, 2, 8192)
    back = wire.mulaw_decode_np(wire.mulaw_encode_np(x), 2)
    assert back.shape == x.shape
    assert _snr_db(x, back) > 32.0  # G.711 SNDR ~38 dB on tones


def test_mulaw_wav_decodes_via_gacodec(rng, tmp_path):
    if native.load() is None:
        pytest.skip("native codec not built")
    x = _signal(rng, 2, 3000)
    data = wire.mulaw_encode_np(x)
    p = tmp_path / "m.wav"
    p.write_bytes(wire.mulaw_wav_bytes(data, 2, SR))
    with AudioDecoder(str(p)) as d:
        assert d.channels == 2 and d.sample_rate == SR
        got = d.decode_planar(3000)
    np.testing.assert_array_equal(got, wire.mulaw_decode_np(data, 2))


# -- twins of tests/test_wire.py: IMA ADPCM ---------------------------------------


def test_ima_device_matches_host_single_chunk(rng):
    spb = 505
    x = _signal(rng, 2, spb * 3)
    host = wire.ima_encode_np(wire.quantize_i16(x), spb)
    stream = wire.ImaDeviceStream(2, spb)
    blocks, nblk = stream.encode_chunk(x)
    assert nblk == 3 and stream.carry_len == 0
    np.testing.assert_array_equal(np.asarray(blocks)[:nblk], host)


def test_ima_stream_chunked_matches_one_shot(rng):
    """Carry threading: encoding in ragged chunks (none block-aligned)
    yields the identical block bytes as one host-side pass."""
    spb = 89  # small blocks so several boundaries land mid-chunk
    x = _signal(rng, 2, spb * 7)
    host = wire.ima_encode_np(wire.quantize_i16(x), spb)
    stream = wire.ImaDeviceStream(2, spb)
    parts, off = [], 0
    for size in (50, 200, 89 * 3, 17, 300):
        blocks, nblk = stream.encode_chunk(x[:, off : off + size])
        if nblk:
            parts.append(np.asarray(blocks)[:nblk])
        off += size
    blocks, nblk = stream.encode_chunk(x[:, off:])
    if nblk:
        parts.append(np.asarray(blocks)[:nblk])
    assert stream.carry_len == 0
    got = np.concatenate(parts, axis=0)
    np.testing.assert_array_equal(got, host)


def test_ima_roundtrip_snr(rng):
    spb = 505
    x = _signal(rng, 2, spb * 4)
    blocks = wire.ima_encode_np(wire.quantize_i16(x), spb)
    back = wire.ima_decode_np(blocks, 2, spb).astype(np.float32) / 32768.0
    assert back.shape == x.shape
    assert _snr_db(x, back) > 22.0  # broadband worst case


def test_ima_wav_gacodec_bitexact(rng, tmp_path):
    if native.load() is None or not ga.io.codec_capabilities()["adpcm"]:
        pytest.skip("native ADPCM decoder not available")
    spb = 505
    frames = spb * 3 + 123  # final block zero-padded, fact trims
    ctx = _noise_ctx(superblock=2)
    stream = ctx.render_adpcm(frames, samples_per_block=spb)
    assert stream.frames == frames and stream.channels == 2
    p = tmp_path / "a.wav"
    stream.write_wav(p)
    with AudioDecoder(str(p)) as d:
        assert d.frames == frames
        got = d.decode_planar(frames)
    want = stream.decode()
    np.testing.assert_array_equal(got, want)


def test_render_adpcm_matches_f32_render(rng):
    frames = 48 * 128  # 12 superblocks at superblock=4
    ref = _noise_ctx(superblock=4).render(frames)
    stream = _noise_ctx(superblock=4).render_adpcm(frames)
    got = stream.decode()
    assert got.shape == ref.shape
    assert _snr_db(ref, got) > 22.0


def test_render_mulaw_matches_f32_render(rng):
    frames = 40 * 128
    ref = _noise_ctx(superblock=4).render(frames)
    data = _noise_ctx(superblock=4).render_mulaw(frames)
    assert data.dtype == np.uint8 and data.size == frames * 2
    got = wire.mulaw_decode_np(data, 2)
    assert _snr_db(ref, got) > 32.0


def test_packed_renders_do_not_poison_the_timeline(rng):
    """Frames over-rendered past a packed call carry as exact f32: an
    adpcm+mulaw+f32 session continues bit-identically to an all-f32 one."""
    a = _noise_ctx(superblock=4)
    b = _noise_ctx(superblock=4)
    n1, n2, n3 = 700, 333, 2000  # none superblock-aligned
    a.render(n1)
    a.render(n2)
    want = a.render(n3)
    b.render_adpcm(n1)
    b.render_mulaw(n2)
    got = b.render(n3)
    np.testing.assert_array_equal(got, want)


def test_render_adpcm_partial_and_sequential_calls(rng):
    """Two back-to-back adpcm calls cover the same samples as one f32
    render of the concatenated span (each stream decodes its own range)."""
    frames1, frames2 = 1000, 1500
    ref = _noise_ctx(superblock=2).render(frames1 + frames2)
    ctx = _noise_ctx(superblock=2)
    s1 = ctx.render_adpcm(frames1)
    s2 = ctx.render_adpcm(frames2)
    got = np.concatenate([s1.decode(), s2.decode()], axis=1)
    assert got.shape == ref.shape
    assert _snr_db(ref, got) > 22.0


def test_ima_stream_channel_change_raises():
    stream = wire.ImaDeviceStream(2, 505)
    with pytest.raises(RuntimeError, match="channel count changed"):
        stream.encode_chunk(np.zeros((3, 505), np.float32))


def test_validate_spb_rejects_bad_sizes():
    for bad in (0, 1, 8, 10, 512):
        with pytest.raises(ValueError):
            wire._validate_spb(bad)
    assert wire._validate_spb(9) == 9
    assert wire._validate_spb(505) == 505


def test_render_zero_frames():
    ctx = _noise_ctx()
    assert ctx.render_mulaw(0).size == 0
    s = ctx.render_adpcm(0)
    assert s.frames == 0 and s.nbytes == 0


# -- side by side with the JAX encoders -----------------------------------------------


def test_pack_mulaw_plain_against_jax(rng):
    x = (rng.standard_normal((2, 5000)) * 0.5).astype(np.float32)
    # clipping, zero, and the quantizer's rounding ties
    x[0, :6] = [1.5, -1.5, 0.0, 0.5 / 32767, -0.5 / 32767, 1.5 / 32767]
    want = np.asarray(jwire.pack_mulaw(x))
    got = wire.pack_mulaw_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spb", [89, 505])
@pytest.mark.parametrize("C", [1, 2])
def test_ima_chunk_encode_plain_against_jax(C, spb):
    rng = np.random.default_rng(C * 1000 + spb)
    for F in (40, 3 * spb + 17):
        for carry_len in (0, 1, spb - 1):
            audio = (rng.standard_normal((C, F)) * 0.3).astype(np.float32)
            carry = rng.integers(-30000, 30000, (C, spb - 1)).astype(np.int16)
            jb, jc = jwire.make_ima_chunk_encoder(C, F, spb)(audio, carry, np.int32(carry_len))
            tb, tcarry = wire.ima_chunk_encode_plain(torch.from_numpy(audio),
                                                     torch.from_numpy(carry), carry_len)
            assert tb.shape == (wire.ima_chunk_slots(F, spb), wire.ima_block_align(C, spb))
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
            np.testing.assert_array_equal(tcarry.numpy(), np.asarray(jc))


# -- the packed renders of a config-4 scene ---------------------------------------------

FRAMES4 = 4 * 512 + 300  # 4 superblocks and a ragged tail


def _config4(builder, **kw):
    return builder(superblock=4, voices=8, **kw)


@pytest.fixture(scope="module")
def config4_f32():
    """The port's and the JAX package's f32 renders of the small config-4
    scene, and their int16 quantizations, which differ by at most one
    step (and only where the f32 renders straddle a rounding edge)."""
    port = _config4(tc.config4_conv_reverb, device="cpu").render(FRAMES4)
    ref = _config4(bc.config4_conv_reverb).render(FRAMES4)
    q, jq = wire.quantize_i16(port), wire.quantize_i16(ref)
    assert np.abs(port).max() > 1e-3
    assert np.abs(q.astype(np.int32) - jq).max() <= 1
    return port, q, jq


def test_render_mulaw_equals_host_encoding_of_f32_render(config4_f32):
    port, q, jq = config4_f32
    got = _config4(tc.config4_conv_reverb, device="cpu").render_mulaw(FRAMES4)
    np.testing.assert_array_equal(got, wire.mulaw_encode_np(port))
    want = _config4(bc.config4_conv_reverb).render_mulaw(FRAMES4)
    same = (q == jq).T.reshape(-1)  # interleaved, as the bytes
    np.testing.assert_array_equal(got[same], want[same])


def test_render_adpcm_equals_host_encoding_of_f32_render(config4_f32):
    port, q, jq = config4_f32
    spb = wire.DEFAULT_SAMPLES_PER_BLOCK
    stream = _config4(tc.config4_conv_reverb, device="cpu").render_adpcm(FRAMES4)
    padded = np.concatenate([q, np.zeros((2, (-FRAMES4) % spb), np.int16)], axis=1)
    np.testing.assert_array_equal(stream.blocks, wire.ima_encode_np(padded, spb))
    jstream = _config4(bc.config4_conv_reverb).render_adpcm(FRAMES4)
    assert jstream.blocks.shape == stream.blocks.shape
    diff = stream.decode_int16().astype(np.int32) - jstream.decode_int16()
    assert np.abs(diff).max() <= 1


@pytest.mark.parametrize("fmt", ["mulaw", "adpcm"])
def test_ragged_sequential_calls_equal_host_encoding(fmt):
    """Calls that end inside a superblock, over launches of two steps: each
    call's bytes are the host encoder of its range of the f32 render, bit
    for bit (the frames before the cut pack on the device, the ones after
    it carry as f32 into the next call and encode on the host there)."""
    spans = (700, 1500, 333, 2100)  # none superblock-aligned
    ref = _config4(tc.config4_conv_reverb, device="cpu").render(sum(spans))
    ctx = _config4(tc.config4_conv_reverb, device="cpu")
    ctx.chunk_schedule = 2
    spb = wire.DEFAULT_SAMPLES_PER_BLOCK
    f0 = 0
    for n in spans:
        part = ref[:, f0:f0 + n]
        if fmt == "mulaw":
            np.testing.assert_array_equal(ctx.render_mulaw(n), wire.mulaw_encode_np(part))
        else:
            q = wire.quantize_i16(part)
            padded = np.concatenate([q, np.zeros((2, (-n) % spb), np.int16)], axis=1)
            np.testing.assert_array_equal(ctx.render_adpcm(n).blocks,
                                          wire.ima_encode_np(padded, spb))
        f0 += n
