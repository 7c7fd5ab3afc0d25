"""The port's audio IO (graphaudio_tpu_torch.io) against the JAX package's,
on the CPU: twins of tests/test_io.py's decode and encode tests.

* the port's codec source is a byte-for-byte copy of the JAX package's,
  built into the port's own ``_build/``; both report the same
  capabilities;
* every encoder writes the same bytes in both packages (WAV PCM16 and f32,
  FLAC 16/24, AIFF, AU, CAF, ALAC 16/24, MP3, Ogg Vorbis, Ogg Opus), and
  both decoders read every such file to the same samples, bit for bit,
  from a path and from bytes, before and after a seek;
* hand-built containers (AIFF, AIFC sowt, AU PCM/G.711, CAF, Wave64,
  RF64, WAV G.711, IMA and MS ADPCM, FLAC with a hostile partition order)
  decode alike; hostile headers are rejected alike; fuzzed and truncated
  files never crash, and whatever one package reads the other reads too;
* the pure-Python WAV reader and writer, ``decode_short`` and the ffmpeg
  interop (libavcodec's ALAC read by the port's decoder) likewise.

Each case skips exactly where tests/test_io.py skips for a codec this
machine lacks.
"""

import ctypes
import filecmp
import os
import struct
import wave

import numpy as np
import pytest

from graphaudio_tpu import io as jio
from graphaudio_tpu.io import decode as jdec
from graphaudio_tpu.io import native as jnative
from graphaudio_tpu_torch import io as tio
from graphaudio_tpu_torch.io import decode as tdec
from graphaudio_tpu_torch.io import native as tnative
from tests.test_io import _fmt, _ima_encode, _pcm16, _wav_adpcm, _wav_bytes

SR = 48000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MP3 = (("mp3", "mp3_encode"), "system mp3 codec unavailable")
OGG = (("ogg", "ogg_encode"), "system vorbis codec unavailable")
OPUS = (("opus", "opus_encode"), "system opus codec unavailable")
FLAC = (("flac", "flac_encode"), "native codec unavailable")
ALAC = (("alac", "alac_encode"), "native codec unavailable")
NONE = ((), None)

#: name: (writer, keyword arguments, the capabilities it needs and the
#: skip reason of tests/test_io.py, file suffix)
ENCODERS = {
    "wav_pcm16": ("write_wav", {}, NONE, "wav"),
    "wav_f32": ("write_wav", {"float32": True}, NONE, "wav"),
    "flac16": ("write_flac", {}, FLAC, "flac"),
    "flac24": ("write_flac", {"bits": 24}, FLAC, "flac"),
    "aiff": ("write_aiff", {}, NONE, "aiff"),
    "au_pcm16": ("write_au", {}, NONE, "au"),
    "au_f32": ("write_au", {"float32": True}, NONE, "au"),
    "caf_f32": ("write_caf", {}, NONE, "caf"),
    "caf_pcm16": ("write_caf", {"float32": False}, NONE, "caf"),
    "alac16": ("write_alac", {}, ALAC, "caf"),
    "alac24": ("write_alac", {"bits": 24}, ALAC, "caf"),
    "mp3": ("write_mp3", {}, MP3, "mp3"),
    "ogg": ("write_ogg", {}, OGG, "ogg"),
    "opus": ("write_opus", {}, OPUS, "opus"),
}


def _skip_unless(needs):
    keys, reason = needs
    caps = jio.codec_capabilities()
    if not all(caps.get(k) for k in keys):
        pytest.skip(reason)


def _signal(channels=2, frames=10000, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / SR
    tone = np.stack([np.sin(2 * np.pi * 440.0 * (c + 1) * t) for c in range(channels)]) * 0.4
    return (tone + rng.standard_normal((channels, frames)) * 0.05).astype(np.float32)


def _read_all(dec_cls, source, seek=None):
    """(channels, rate, frames, planar samples, planar int16, samples after
    a seek) of ``source`` through ``dec_cls``, or the exception's type."""
    try:
        with dec_cls(source) as dec:
            head = (dec.channels, dec.sample_rate, dec.frames)
            n = max(dec.frames, 0) + 64
            planar = dec.decode_planar(n)
            dec.try_rewind()
            short = dec.decode_planar_short(n)
            after = None
            if seek is not None:
                ok = dec.try_seek(seek)
                after = (ok, dec.decode_planar(n))
            return head, planar, short, after
    except Exception as e:  # noqa: BLE001 - the type is compared
        return type(e)


def _assert_same_reads(source, seek=None):
    """Both decoders read ``source`` alike; returns the port's read."""
    want = _read_all(jdec.AudioDecoder, source, seek)
    got = _read_all(tdec.AudioDecoder, source, seek)
    if isinstance(want, type):
        assert got is want
        return got
    assert not isinstance(got, type), f"the port's decoder raised {got}"
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    if seek is not None:
        assert got[3][0] == want[3][0]
        np.testing.assert_array_equal(got[3][1], want[3][1])
    return got


# -- the codec itself -------------------------------------------------------------


def test_codec_source_is_the_jax_packages_byte_for_byte():
    port = os.path.join(ROOT, "graphaudio_tpu_torch", "native", "gacodec.cpp")
    ref = os.path.join(ROOT, "graphaudio_tpu", "native", "gacodec.cpp")
    assert filecmp.cmp(port, ref, shallow=False)


def test_codec_builds_into_the_ports_build_dir_with_the_same_capabilities():
    lib = tnative.load()
    assert lib is not None
    assert os.path.dirname(lib._name) == os.path.join(ROOT, "graphaudio_tpu_torch", "_build")
    assert tio.codec_capabilities() == jio.codec_capabilities()
    assert sorted(tio.__all__) == sorted(jio.__all__)


# -- encoders and decoders over the writers' files --------------------------------


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_encoders_write_the_same_bytes(tmp_path, case):
    writer, kw, needs, ext = ENCODERS[case]
    _skip_unless(needs)
    sig = _signal()
    getattr(jio, writer)(tmp_path / f"j.{ext}", sig, SR, **kw)
    getattr(tio, writer)(tmp_path / f"t.{ext}", sig, SR, **kw)
    assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_decoders_read_the_same_samples(tmp_path, case):
    writer, kw, needs, ext = ENCODERS[case]
    _skip_unless(needs)
    path = tmp_path / f"j.{ext}"
    getattr(jio, writer)(path, _signal(), SR, **kw)
    head, planar, _, after = _assert_same_reads(str(path), seek=0.05)
    assert head[0] == 2 and np.abs(planar).max() > 0.1 and after[0]
    _assert_same_reads(path.read_bytes())
    got = tdec.AudioDecoder.load_from_file(str(path))
    want = jdec.AudioDecoder.load_from_file(str(path))
    assert got.sample_rate == want.sample_rate
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))


def test_lossless_writers_round_trip(tmp_path):
    """FLAC and ALAC at 16 and 24 bits and CAF f32 decode to the quantized
    (or the same) samples in the port, as in test_io."""
    _skip_unless(FLAC)
    _skip_unless(ALAC)
    sig = _signal(frames=4097)
    for writer, ext, bits in (("write_flac", "flac", 16), ("write_flac", "flac", 24),
                              ("write_alac", "caf", 16), ("write_alac", "caf", 24)):
        path = tmp_path / f"l{bits}.{ext}"
        getattr(tio, writer)(path, sig, SR, bits=bits)
        q = np.clip(np.rint(sig.astype(np.float64) * (1 << (bits - 1))),
                    -(1 << (bits - 1)), (1 << (bits - 1)) - 1)
        with tdec.AudioDecoder(str(path)) as dec:
            np.testing.assert_array_equal(dec.decode_planar(4097),
                                          (q / (1 << (bits - 1))).astype(np.float32))
    tio.write_caf(tmp_path / "f.caf", sig, SR)
    with tdec.AudioDecoder(str(tmp_path / "f.caf")) as dec:
        np.testing.assert_array_equal(dec.decode_planar(4097), sig)


# -- hand-built containers ---------------------------------------------------------


def _ext80(rate):
    e = int(rate).bit_length() - 1
    return struct.pack(">HQ", 16383 + e, int(rate) << (63 - e))


def _aiff(sig, form=b"AIFF", sowt=False):
    pcm = _pcm16(sig)
    comm = struct.pack(">hIh", 1, len(pcm), 16) + _ext80(SR)
    if sowt:
        comm += b"sowt" + b"\x00\x00"
    data = pcm.astype("<i2" if sowt else ">i2").tobytes()
    ssnd = struct.pack(">II", 0, 0) + data
    body = form + b"COMM" + struct.pack(">I", len(comm)) + comm
    body += b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    return b"FORM" + struct.pack(">I", len(body)) + body


def _au(encoding, payload, header=24):
    return (struct.pack(">4sIIIII", b".snd", header, len(payload), encoding, SR, 1)
            + b"\x00" * (header - 24) + payload)


def _caf(flags, bits, data, size=None, channels=2):
    desc = struct.pack(">d4sIIIII", float(SR), b"lpcm", flags, channels * (bits // 8), 1,
                       channels, bits)
    out = b"caff" + struct.pack(">HH", 1, 0)
    out += b"desc" + struct.pack(">q", len(desc)) + desc
    out += b"data" + struct.pack(">q", 4 + len(data) if size is None else size)
    return out + b"\x00" * 4 + data


def _w64(sig):
    guid = bytes([0xF3, 0xAC, 0xD3, 0x11, 0x8C, 0xD1, 0x00, 0xC0, 0x4F, 0x8E, 0xDB, 0x8A])
    riff = bytes([0x72, 0x69, 0x66, 0x66, 0x2E, 0x91, 0xCF, 0x11,
                  0xA5, 0xD6, 0x28, 0xDB, 0x04, 0xC1, 0x00, 0x00])
    pcm = _pcm16(sig).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, SR, SR * 2, 2, 16)
    body = b"fmt " + guid + struct.pack("<q", 24 + len(fmt)) + fmt
    body += b"\x00" * ((8 - (24 + len(fmt)) % 8) % 8)
    body += b"data" + guid + struct.pack("<q", 24 + len(pcm)) + pcm
    return riff + struct.pack("<q", 40 + len(body)) + b"wave" + guid + body


def _rf64(sig):
    pcm = _pcm16(sig).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, SR, SR * 2, 2, 16)
    ds64 = struct.pack("<QQQI", 0, len(pcm), len(sig), 0)
    blob = b"RF64" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
    blob += b"ds64" + struct.pack("<I", len(ds64)) + ds64
    blob += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    return blob + b"data" + struct.pack("<I", 0xFFFFFFFF) + pcm


def _wav_g711(tag, payload):
    fmt = struct.pack("<HHIIHH", tag, 1, 8000, 8000, 1, 8)
    return (b"RIFF" + struct.pack("<I", 4 + 24 + 8 + len(payload)) + b"WAVE"
            + b"fmt " + struct.pack("<I", 16) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload)


def _flac_hostile_partition():
    si = bytearray(34)
    si[0:2] = si[2:4] = (4096).to_bytes(2, "big")
    si[10], si[11], si[12], si[13] = 48000 >> 12, (48000 >> 4) & 0xFF, (48000 & 0xF) << 4, 15 << 4
    si[14:18] = (8192).to_bytes(4, "big")
    bits = ("11111111111110" "0" "0" "1100" "0000" "0000" "100" "0" + "0" * 16 + "0"
            "001100" "0" + "0" * 64 + "00" "1011" "0000" + "1" * 4096)
    bits += "0" * ((-len(bits)) % 8)
    frame = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return b"fLaC" + bytes([0x80, 0, 0, 34]) + bytes(si) + frame


def _containers():
    """name: bytes of each hand-built container of tests/test_io.py."""
    t = np.arange(1000) / SR
    sig = (np.sin(2 * np.pi * 440 * t) * 0.5).astype(np.float32)
    inter = np.stack([sig[:800], -sig[:800]], axis=1).reshape(-1)
    rng = np.random.default_rng(3)
    pcm = np.clip(np.rint(np.stack([sig[:700], sig[300:]]) * 32767), -32768, 32767
                  ).astype(np.int16)
    ima2, spb, ba = _ima_encode(pcm)
    ima1, spb1, ba1 = _ima_encode(pcm[:1])
    ms_spb, ms_ba = 128, 7 * 2 + (128 - 2)  # two channels, coefficient set 0
    ms_blocks = b"".join(
        bytes([0, 0]) + struct.pack("<hhhhhh", 64, 64, 100, -100, 50, -50)
        + rng.integers(0, 256, ms_ba - 14, dtype=np.uint8).tobytes() for _ in range(5))
    return {
        "aiff_pcm16": _aiff(sig),
        "aifc_sowt": _aiff(sig, b"AIFC", sowt=True),
        "au_be16": _au(3, _pcm16(sig).astype(">i2").tobytes(), header=28),
        "au_ulaw": _au(1, rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()),
        "au_alaw": _au(27, bytes([0xD5, 0x55]) * 50),
        "caf_f32le": _caf(3, 32, inter.astype("<f4").tobytes()),
        "caf_i16be": _caf(0, 16, _pcm16(inter).astype(">i2").tobytes()),
        "caf_until_eof": _caf(0, 16, _pcm16(sig[:300]).astype(">i2").tobytes(), size=-1,
                              channels=1),
        "w64_pcm16": _w64(sig[:600]),
        "rf64_ds64": _rf64(sig[:500]),
        "wav_mulaw": _wav_g711(7, bytes([0xFF, 0x00]) * 10),
        "wav_alaw": _wav_g711(6, bytes([0xD5, 0x55]) * 10),
        "ima_adpcm_mono": _wav_adpcm(0x11, 1, SR, ba1, spb1, 700, ima1),
        "ima_adpcm_stereo": _wav_adpcm(0x11, 2, SR, ba, spb, 700, ima2),
        "ms_adpcm": _wav_adpcm(0x02, 2, SR, ms_ba, ms_spb, 600, ms_blocks),
        "flac_hostile_partition": _flac_hostile_partition(),
    }


@pytest.mark.parametrize("case", sorted(_containers()))
def test_hand_built_containers_decode_alike(tmp_path, case):
    if "adpcm" in case:
        _skip_unless((("adpcm",), "native codec unavailable"))
    blob = _containers()[case]
    got = _assert_same_reads(blob, seek=0.002)
    path = tmp_path / "c.bin"
    path.write_bytes(blob)
    _assert_same_reads(str(path))
    if case != "flac_hostile_partition":
        assert not isinstance(got, type) and got[0][2] > 0


def _comm(channels=1, frames=16, bits=16, exp=0x400E, mant=0xBB80 << 48):
    return struct.pack(">HIH", channels, frames, bits) + struct.pack(">HQ", exp, mant)


def _aiff_comm(comm_payload):
    chunks = b"COMM" + struct.pack(">I", len(comm_payload)) + comm_payload
    if len(comm_payload) % 2:
        chunks += b"\x00"
    chunks += b"SSND" + struct.pack(">I", 8 + 64) + b"\x00" * (8 + 64)
    return b"FORM" + struct.pack(">I", 4 + len(chunks)) + b"AIFF" + chunks


#: name: (header bytes, whether the codec opens it), test_io's rejects.
HEADERS = {
    "truncated_fmt": (lambda: _wav_bytes(_fmt()[:10]), False),
    "zero_channels": (lambda: _wav_bytes(_fmt(channels=0)), False),
    "zero_bits": (lambda: _wav_bytes(_fmt(bits=0)), False),
    "float8": (lambda: _wav_bytes(_fmt(tag=3, bits=8)), False),
    "float16": (lambda: _wav_bytes(_fmt(tag=3, bits=16)), False),
    "float24": (lambda: _wav_bytes(_fmt(tag=3, bits=24)), False),
    "float32": (lambda: _wav_bytes(_fmt(tag=3, bits=32)), True),
    "extensible_without_subformat": (lambda: _wav_bytes(_fmt(tag=0xFFFE)), False),
    "giant_header_chunk": (lambda: (b"RIFF" + struct.pack("<I", 100) + b"WAVE" + b"fmt "
                                    + struct.pack("<I", 1 << 28) + _fmt()), False),
    "lying_data_size": (lambda: (_wav_bytes(_fmt())[: -4 - 64] + struct.pack("<I", 1 << 30)
                                 + b"\x00" * 64), True),
    "aiff_sane": (lambda: _aiff_comm(_comm()), True),
    "aiff_truncated_comm": (lambda: _aiff_comm(_comm()[:12]), False),
    "aiff_zero_channels": (lambda: _aiff_comm(_comm(channels=0)), False),
    "aiff_zero_bits": (lambda: _aiff_comm(_comm(bits=0)), False),
    "aiff_nan_rate": (lambda: _aiff_comm(_comm(exp=0x7FFF)), False),
    "adpcm_block_below_header": (lambda: _wav_adpcm(0x11, 2, SR, 8, 65, 100, b"\x00" * 64),
                                 False),
    "ms_adpcm_block_below_header": (lambda: _wav_adpcm(0x02, 1, SR, 6, 4, 100, b"\x00" * 64),
                                    False),
}


@pytest.mark.parametrize("case", sorted(HEADERS))
def test_hostile_headers_rejected_alike(case):
    build, opens = HEADERS[case]
    payload = build()
    frames = []
    for native in (jnative, tnative):
        lib = native.load()
        if lib is None:
            pytest.skip("no native codec on this machine")
        h = lib.gac_open_memory(payload, len(payload))
        assert bool(h) == opens
        if h:
            frames.append(lib.gac_frames(h))
            lib.gac_close(h)
    assert len(set(frames)) <= 1
    if case == "lying_data_size":
        assert frames == [16, 16]


def _fuzz_cases(rng):
    """test_io's hostile bytes: truncations and bit flips of valid AU, FLAC
    and WAV files, magic-only stubs and noise."""
    sig = (rng.standard_normal(256) * 0.3).astype(np.float32)
    valid = [struct.pack(">4sIIIII", b".snd", 24, 512, 3, SR, 1)
             + _pcm16(sig).astype(">i2").tobytes()]
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        for writer, name in ((tio.write_flac, "f.flac"), (tio.write_wav, "w.wav")):
            writer(os.path.join(td, name), sig[None], SR)
            with open(os.path.join(td, name), "rb") as f:
                valid.append(f.read())
    r = np.random.default_rng(99)
    cases = []
    for blob in valid:
        cases += [blob[:cut] for cut in (4, 9, 17, len(blob) // 2, len(blob) - 1)]
        for _ in range(8):
            b = bytearray(blob)
            for _ in range(6):
                b[int(r.integers(0, len(b)))] ^= int(r.integers(1, 255))
            cases.append(bytes(b))
    for magic in (b".snd", b"caff", b"fLaC", b"RF64", b"RIFF", b"FORM",
                  bytes([0x72, 0x69, 0x66, 0x66])):
        cases += [magic, magic + bytes(r.integers(0, 256, 64, dtype=np.uint8))]
    cases += [bytes(r.integers(0, 256, n, dtype=np.uint8)) for n in (0, 1, 16, 1024)]
    return cases


def _fuzz_read(dec_cls, blob):
    try:
        with dec_cls(blob) as dec:
            a = dec.decode(min(dec.frames, 4096) if dec.frames > 0 else 128)
            dec.try_seek(0.01)
            return a, dec.decode(64)
    except Exception as e:  # noqa: BLE001 - rejecting is fine, alike
        return type(e)


def test_malformed_inputs_never_crash_and_read_alike(rng):
    for blob in _fuzz_cases(rng):
        want, got = _fuzz_read(jdec.AudioDecoder, blob), _fuzz_read(tdec.AudioDecoder, blob)
        if isinstance(want, type):
            assert got is want
        else:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_adpcm_malformed_headers_never_crash_and_read_alike(rng):
    _skip_unless((("adpcm",), "native codec unavailable"))
    base = _wav_adpcm(0x11, 1, SR, 36, 65, 130, b"\x00" * 72)
    libs = (jnative.load(), tnative.load())
    for _ in range(200):
        buf = bytearray(base)
        for _ in range(rng.integers(1, 6)):
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        payload = bytes(buf)  # outlives the handles (memory-backed opens)
        reads = []
        for lib in libs:
            h = lib.gac_open_memory(payload, len(payload))
            out = np.zeros(4096, np.float32)
            n = None
            if h:
                n = lib.gac_read_f32(h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 1024)
                lib.gac_close(h)
            reads.append((n, out))
        assert reads[0][0] == reads[1][0]
        np.testing.assert_array_equal(reads[0][1], reads[1][1])


# -- the Python fallbacks, decode_short, ffmpeg interop ----------------------------


def test_python_fallback_reader_and_writer(tmp_path, monkeypatch):
    sig = _signal(frames=777)
    tio.write_wav(tmp_path / "f.wav", sig, SR, float32=True)
    data = (tmp_path / "f.wav").read_bytes()
    got, want = tdec._PyWavReader(data), jdec._PyWavReader(data)
    assert (got.channels, got.sample_rate, got.frames) == (want.channels, want.sample_rate,
                                                          want.frames)
    np.testing.assert_array_equal(got.read(777), want.read(777))
    # the no-compiler writers (f32 and PCM16) write the same bytes
    monkeypatch.setattr(tnative, "load", lambda: None)
    monkeypatch.setattr(jnative, "load", lambda: None)
    for f32 in (True, False):
        tio.write_wav(tmp_path / "t.wav", sig, SR, float32=f32)
        jio.write_wav(tmp_path / "j.wav", sig, SR, float32=f32)
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
        with tdec.AudioDecoder(str(tmp_path / "t.wav")) as dec:
            assert dec._handle is None  # the Python reader
            if f32:
                np.testing.assert_array_equal(dec.decode_planar(10 ** 6), sig)


def test_decode_short_bitexact_and_quantized(tmp_path, rng):
    pcm = rng.integers(-32768, 32768, size=(1000, 2)).astype(np.int16)
    with wave.open(str(tmp_path / "s.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    with tdec.AudioDecoder(str(tmp_path / "s.wav")) as dec:
        np.testing.assert_array_equal(dec.decode_short(1000), pcm)
    tio.write_wav(tmp_path / "f.wav", _signal(frames=500), SR, float32=True)
    for path in ("s.wav", "f.wav"):
        with tdec.AudioDecoder(str(tmp_path / path)) as t, \
                jdec.AudioDecoder(str(tmp_path / path)) as j:
            np.testing.assert_array_equal(t.decode_planar_short(1000), j.decode_planar_short(1000))


def test_alac_ffmpeg_interop(tmp_path):
    """libavcodec's own ALAC bitstreams decode in the port bit for bit as in
    the JAX package; libavcodec decodes the port's ALAC to the quantized
    samples (tests/test_io.py's two interop tests)."""
    caps = jio.codec_capabilities()
    if not (caps.get("alac") and caps.get("alac_encode")):
        pytest.skip("native codec unavailable")
    from graphaudio_tpu.testing import avoracle

    if avoracle.load() is None:
        pytest.skip("ffmpeg dev libraries unavailable")
    rng = np.random.default_rng(22)
    for n, ch in ((9001, 1), (6000, 6)):
        sig = np.clip(rng.standard_normal((ch, n)) * 0.3, -1, 1).astype(np.float32)
        q = np.clip(np.rint(sig.astype(np.float64) * 32768), -32768, 32767).astype(np.int16)
        path = tmp_path / f"ffm_{n}_{ch}.caf"
        avoracle.encode_alac(path, q.T, SR)
        got = _assert_same_reads(str(path))
        np.testing.assert_array_equal(got[1], (q.astype(np.float64) / 32768.0).astype(np.float32))
        ours = tmp_path / f"ours_{n}_{ch}.caf"
        tio.write_alac(ours, sig, SR)
        out, rate = avoracle.decode(ours)
        assert rate == SR
        np.testing.assert_array_equal(out, (q.astype(np.float64) / 32768.0).astype(np.float32).T)
