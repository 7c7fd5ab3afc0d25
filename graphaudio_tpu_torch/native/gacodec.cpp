// gacodec: native audio codec backend for graphaudio_tpu.
//
// Plays the role libsndfile plays for the reference
// (GraphAudio.IO/Libsndfile.cs:26-68 binds sf_open_virtual/sf_readf_float/...):
// container parsing + PCM decode off the render hot path, exposed through a
// minimal C ABI consumed via ctypes.
//
// Formats parsed natively: RIFF/WAVE (PCM u8/s16/s24/s32, float32/float64,
// WAVE_FORMAT_EXTENSIBLE), RF64, Sony Wave64, AIFF/AIFC (PCM incl. "sowt"
// little-endian), Sun/NeXT AU (PCM/float/G.711 mu-law+a-law), Apple CAF
// (LPCM int/float, either endianness), and FLAC (full decoder from the
// spec, incl. LPC and Rice/Rice2 residuals). MP3 (via the system's
// libmpg123) and Ogg/Vorbis (via libvorbisfile) are loaded lazily with
// dlopen so there are NO link-time codec dependencies — opening a compressed
// file fails cleanly where the system library is absent (parity: the
// reference ships libsndfile per-RID and fails open when missing).
// Decoding converts to interleaved float32 frames with sample-accurate
// seeking. Encoders: WAV (native), MP3 (libmp3lame), Ogg/Vorbis
// (libvorbisenc), the latter two also dlopen'd.
//
// Build: g++ -O2 -shared -fPIC -o libgacodec.so gacodec.cpp

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

#include <dlfcn.h>
#include <sys/types.h>

namespace {

struct Decoder {
    FILE* file = nullptr;
    const uint8_t* mem = nullptr;  // memory-backed alternative
    size_t mem_size = 0;
    size_t mem_pos = 0;

    // format info
    int channels = 0;
    int sample_rate = 0;
    int bits = 0;
    int format = 0;          // 1 = pcm int, 3 = float, 4 = aiff pcm (big endian)
    int64_t data_start = 0;  // byte offset of sample data
    int64_t total_frames = 0;
    int64_t frame_pos = 0;   // current frame position

    // compressed backends (0 = raw pcm parser, 1 = mpg123, 2 = vorbisfile,
    // 3 = native FLAC, 4 = native ADPCM, 5 = Ogg Opus, 6 = native ALAC)
    int backend = 0;
    void* mh = nullptr;           // mpg123 handle
    void* vf = nullptr;           // OggVorbis_File storage
    void* flac = nullptr;         // FlacStream storage
    void* opus = nullptr;         // OpusStream storage
    void* alac = nullptr;         // AlacStream storage
    std::vector<float> carry;     // interleaved overflow from block decodes
    size_t carry_pos = 0;

    // ADPCM (WAV tags 0x11 IMA / 0x02 MS): block-coded, decoded per block.
    uint16_t adpcm_tag = 0;
    uint32_t block_align = 0;
    uint32_t samples_per_block = 0;
    int64_t adpcm_block = -1;     // block index currently in `carry`

    size_t bytes_per_frame() const { return size_t(channels) * (bits / 8); }
};

bool dread(Decoder* d, void* out, size_t n) {
    if (d->file) return fread(out, 1, n, d->file) == n;
    if (d->mem_pos + n > d->mem_size) return false;
    memcpy(out, d->mem + d->mem_pos, n);
    d->mem_pos += n;
    return true;
}

bool dseek(Decoder* d, int64_t pos) {
    if (d->file) return fseeko(d->file, pos, SEEK_SET) == 0;
    if (pos < 0 || size_t(pos) > d->mem_size) return false;
    d->mem_pos = size_t(pos);
    return true;
}

int64_t dtell(Decoder* d) {
    if (d->file) return ftello(d->file);
    return int64_t(d->mem_pos);
}

uint32_t rd_u32le(const uint8_t* p) {
    return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
           (uint32_t(p[3]) << 24);
}
uint16_t rd_u16le(const uint8_t* p) { return uint16_t(p[0]) | (uint16_t(p[1]) << 8); }
uint32_t rd_u32be(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
           uint32_t(p[3]);
}
uint16_t rd_u16be(const uint8_t* p) { return (uint16_t(p[0]) << 8) | uint16_t(p[1]); }

// 80-bit IEEE extended (AIFF sample rate)
double read_extended(const uint8_t* p) {
    int sign = (p[0] & 0x80) ? -1 : 1;
    int exponent = ((p[0] & 0x7f) << 8) | p[1];
    uint64_t mantissa = 0;
    for (int i = 2; i < 10; i++) mantissa = (mantissa << 8) | p[i];
    if (exponent == 0 && mantissa == 0) return 0.0;
    return sign * double(mantissa) * pow(2.0, exponent - 16383 - 63);
}

int64_t dsize(Decoder* d);  // defined below

// Every file-supplied field is validated BEFORE it reaches arithmetic:
// chunk sizes before fixed-offset reads (heap overread otherwise),
// channels/bits before bytes_per_frame() (division by zero otherwise),
// and bit depths against what cvt_sample actually implements per format
// (float bits must be 32/64; a smaller stride would overread the buffer).
const uint32_t kMaxHeaderChunk = 1u << 20;
const int kMaxChannels = 1024;
const int kMaxSampleRate = 10000000;

bool valid_layout(const Decoder* d) {
    if (d->channels < 1 || d->channels > kMaxChannels) return false;
    if (d->sample_rate < 1 || d->sample_rate > kMaxSampleRate) return false;
    if (d->format == 3 || d->format == 7) return d->bits == 32 || d->bits == 64;
    if (d->format == 5 || d->format == 6) return d->bits == 8;
    if (d->format == 8) return d->bits == 4;  // ADPCM nibbles
    return d->bits == 8 || d->bits == 16 || d->bits == 24 || d->bits == 32;
}

bool parse_wav(Decoder* d) {
    uint8_t hdr[12];
    if (!dseek(d, 0) || !dread(d, hdr, 12)) return false;
    if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0) return false;

    bool have_fmt = false;
    bool have_data = false;
    int64_t data_bytes = 0;
    int64_t fact_samples = -1;
    while (true) {
        uint8_t ch[8];
        if (!dread(d, ch, 8)) break;
        uint32_t size = rd_u32le(ch + 4);
        if (memcmp(ch, "fmt ", 4) == 0) {
            if (size < 16 || size > kMaxHeaderChunk) return false;
            std::vector<uint8_t> fmt(size);
            if (!dread(d, fmt.data(), size)) return false;
            uint16_t tag = rd_u16le(fmt.data());
            d->channels = rd_u16le(fmt.data() + 2);
            d->sample_rate = int(rd_u32le(fmt.data() + 4));
            d->block_align = rd_u16le(fmt.data() + 12);
            d->bits = rd_u16le(fmt.data() + 14);
            if (tag == 0xFFFE) {  // WAVE_FORMAT_EXTENSIBLE
                if (size < 40) return false;
                tag = rd_u16le(fmt.data() + 24);
            }
            if (tag == 1) d->format = 1;       // PCM
            else if (tag == 3) d->format = 3;  // IEEE float
            else if (tag == 7) d->format = 5;  // G.711 mu-law
            else if (tag == 6) d->format = 6;  // G.711 a-law
            else if (tag == 2 || tag == 0x11) {  // MS / IMA ADPCM
                d->format = 8;
                d->backend = 4;
                d->adpcm_tag = tag;
                d->bits = 4;
                // Derive samples/block from the layout; header sizes are
                // 7 bytes/ch (MS: coef idx + delta + 2 history samples) and
                // 4 bytes/ch (IMA: predictor + step index).
                uint32_t chn = uint32_t(d->channels);
                if (chn < 1 || chn > 64) return false;
                uint32_t hdr_b = (tag == 2 ? 7 : 4) * chn;
                if (d->block_align <= hdr_b ||
                    d->block_align > (1u << 20)) return false;
                uint32_t payload = d->block_align - hdr_b;
                if (tag == 2) {
                    d->samples_per_block = payload * 2 / chn + 2;
                } else {
                    // IMA payload is 4-byte words per channel.
                    if (payload % (4 * chn)) return false;
                    d->samples_per_block = payload / chn * 2 + 1;
                }
                if (d->samples_per_block < 2 ||
                    d->samples_per_block > (1u << 18)) return false;
            }
            else return false;
            if (!valid_layout(d)) return false;
            have_fmt = true;
            if (size & 1) dseek(d, dtell(d) + 1);
        } else if (memcmp(ch, "fact", 4) == 0) {
            if (size < 4 || size > kMaxHeaderChunk) return false;
            uint8_t fc[4];
            if (!dread(d, fc, 4)) return false;
            fact_samples = int64_t(rd_u32le(fc));
            if (have_data) break;  // post-data fact: scan complete
            if (size > 4 && !dseek(d, dtell(d) + (size - 4))) return false;
            if (size & 1) dseek(d, dtell(d) + 1);
        } else if (memcmp(ch, "data", 4) == 0) {
            if (!have_fmt) return false;
            d->data_start = dtell(d);
            // Clamp to the bytes actually present: a lying data-chunk size
            // must not promise frames past EOF.
            int64_t avail = dsize(d) - d->data_start;
            if (avail < 0) avail = 0;
            data_bytes = int64_t(size) < avail ? int64_t(size) : avail;
            have_data = true;
            // ADPCM frame counts need the `fact` chunk (the final block may
            // be partial), and `fact` may legally FOLLOW data — keep
            // scanning for it instead of trusting block-derived padding.
            if (d->format != 8 || fact_samples >= 0) break;
            if (!dseek(d, d->data_start + size + (size & 1))) break;
        } else {
            if (!dseek(d, dtell(d) + size + (size & 1))) {
                break;
            }
        }
    }
    if (!have_fmt || !have_data) return false;
    if (d->format == 8) {
        int64_t blocks = data_bytes / int64_t(d->block_align);
        d->total_frames = blocks * int64_t(d->samples_per_block);
        // `fact` gives the true count (last block may be partial).
        if (fact_samples >= 0 && fact_samples < d->total_frames)
            d->total_frames = fact_samples;
    } else {
        d->total_frames = data_bytes / int64_t(d->bytes_per_frame());
    }
    return true;
}

bool parse_aiff(Decoder* d) {
    uint8_t hdr[12];
    if (!dseek(d, 0) || !dread(d, hdr, 12)) return false;
    if (memcmp(hdr, "FORM", 4) != 0 ||
        (memcmp(hdr + 8, "AIFF", 4) != 0 && memcmp(hdr + 8, "AIFC", 4) != 0))
        return false;

    bool have_comm = false;
    while (true) {
        uint8_t ch[8];
        if (!dread(d, ch, 8)) break;
        uint32_t size = rd_u32be(ch + 4);
        if (memcmp(ch, "COMM", 4) == 0) {
            if (size < 18 || size > kMaxHeaderChunk) return false;
            std::vector<uint8_t> comm(size);
            if (!dread(d, comm.data(), size)) return false;
            d->channels = rd_u16be(comm.data());
            d->total_frames = int64_t(rd_u32be(comm.data() + 2));
            d->bits = rd_u16be(comm.data() + 6);
            // read_extended can yield NaN/inf/huge values from hostile
            // bytes; range-check as double BEFORE the int cast (UB on
            // overflow otherwise).
            double sr = read_extended(comm.data() + 8);
            if (!(sr >= 1.0 && sr <= double(kMaxSampleRate))) return false;
            d->sample_rate = int(sr);
            bool sowt = size >= 22 && memcmp(comm.data() + 18, "sowt", 4) == 0;
            if (size >= 22 && memcmp(comm.data() + 18, "NONE", 4) != 0 && !sowt)
                return false;  // compressed AIFC unsupported
            // "sowt" = little-endian PCM; 8-bit stays format 4 (single
            // byte, signed — format 1's 8-bit is WAV-unsigned).
            d->format = (sowt && d->bits > 8) ? 1 : 4;
            if (!valid_layout(d)) return false;
            have_comm = true;
            if (size & 1) dseek(d, dtell(d) + 1);
        } else if (memcmp(ch, "SSND", 4) == 0) {
            if (!have_comm || size < 8) return false;
            uint8_t ssnd[8];
            if (!dread(d, ssnd, 8)) return false;
            uint32_t offset = rd_u32be(ssnd);
            d->data_start = dtell(d) + offset;
            // COMM's frame count must not promise frames past EOF.
            int64_t avail = dsize(d) - d->data_start;
            if (avail < 0) avail = 0;
            int64_t max_frames = avail / int64_t(d->bytes_per_frame());
            if (d->total_frames > max_frames) d->total_frames = max_frames;
            return true;
        } else {
            if (!dseek(d, dtell(d) + size + (size & 1))) return false;
        }
    }
    return false;
}

// Sun/NeXT AU (.au/.snd): big-endian header, PCM/float/G.711 payloads.
bool parse_au(Decoder* d) {
    uint8_t h[24];
    if (!dseek(d, 0) || !dread(d, h, 24)) return false;
    if (memcmp(h, ".snd", 4) != 0) return false;
    uint32_t data_off = rd_u32be(h + 4);
    uint32_t enc = rd_u32be(h + 12);
    d->sample_rate = int(rd_u32be(h + 16));
    d->channels = int(rd_u32be(h + 20));
    switch (enc) {
        case 1: d->format = 5; d->bits = 8; break;   // mu-law
        case 2: d->format = 4; d->bits = 8; break;   // signed 8-bit
        case 3: d->format = 4; d->bits = 16; break;  // BE PCM
        case 4: d->format = 4; d->bits = 24; break;
        case 5: d->format = 4; d->bits = 32; break;
        case 6: d->format = 7; d->bits = 32; break;  // BE float
        case 7: d->format = 7; d->bits = 64; break;  // BE double
        case 27: d->format = 6; d->bits = 8; break;  // a-law
        default: return false;
    }
    if (data_off < 24 || !valid_layout(d)) return false;
    d->data_start = int64_t(data_off);
    int64_t avail = dsize(d) - d->data_start;
    if (avail < 0) avail = 0;
    d->total_frames = avail / int64_t(d->bytes_per_frame());
    return true;
}

// ALAC-in-CAF pieces gathered by parse_caf and finished by the native ALAC
// backend (defined later in this TU; CAF chunk order is arbitrary so the
// parser collects first and finalizes after the scan).
struct AlacCafPieces {
    std::vector<uint8_t> kuki;
    std::vector<uint8_t> pakt;
    int64_t data_start = -1;
    int64_t data_bytes = -1;
    int channels = 0;
    uint32_t frames_per_packet = 0;
};
bool finish_alac_caf(Decoder* d, AlacCafPieces& pieces);

// Apple CAF: 'caff' magic, BE chunk headers with 64-bit sizes; LPCM and
// ALAC (native decoder below, parity: libsndfile's caf_alac path,
// GraphAudio.IO/Libsndfile.cs:26-68 + runtimes/).
bool parse_caf(Decoder* d) {
    uint8_t h[8];
    if (!dseek(d, 0) || !dread(d, h, 8)) return false;
    if (memcmp(h, "caff", 4) != 0) return false;
    bool have_desc = false;
    bool is_alac = false;
    AlacCafPieces alac;
    while (true) {
        uint8_t ch[12];
        if (!dread(d, ch, 12)) break;
        int64_t size = int64_t((uint64_t(rd_u32be(ch + 4)) << 32) |
                               rd_u32be(ch + 8));
        // -1 on the data chunk is Core Audio's standard "until EOF" marker
        // for streamed/recorded files; any other negative size is hostile.
        bool data_chunk = memcmp(ch, "data", 4) == 0;
        if (size < 0 && !(data_chunk && size == -1)) return false;
        if (memcmp(ch, "desc", 4) == 0) {
            if (size < 32) return false;
            uint8_t desc[32];
            if (!dread(d, desc, 32)) return false;
            uint64_t iu = (uint64_t(rd_u32be(desc)) << 32) | rd_u32be(desc + 4);
            double sr;
            memcpy(&sr, &iu, 8);
            if (!(sr >= 1.0 && sr <= double(kMaxSampleRate))) return false;
            d->sample_rate = int(sr);
            if (memcmp(desc + 8, "alac", 4) == 0) {
                is_alac = true;
                alac.channels = int(rd_u32be(desc + 24));
                alac.frames_per_packet = rd_u32be(desc + 20);
                if (alac.channels < 1 || alac.channels > 8) return false;
                if (size > 32 && !dseek(d, dtell(d) + (size - 32)))
                    return false;
                have_desc = true;
                continue;
            }
            if (memcmp(desc + 8, "lpcm", 4) != 0) return false;
            uint32_t flags = rd_u32be(desc + 12);
            d->channels = int(rd_u32be(desc + 24));
            d->bits = int(rd_u32be(desc + 28));
            bool is_float = flags & 1;
            bool is_le = flags & 2;
            if (is_float) d->format = is_le ? 3 : 7;
            else d->format = is_le ? 1 : 4;
            // packed samples only (bytesPerPacket == channels*bits/8)
            uint32_t bpp = rd_u32be(desc + 16);
            if (d->bits % 8 || bpp != uint32_t(d->channels) * (d->bits / 8))
                return false;
            if (!valid_layout(d)) return false;
            // LE 8-bit int would hit format 1's WAV-unsigned semantics;
            // CAF 8-bit is signed -> use the endian-neutral BE path.
            if (!is_float && d->bits == 8) d->format = 4;
            if (size > 32 && !dseek(d, dtell(d) + (size - 32))) return false;
            have_desc = true;
        } else if (data_chunk) {
            if (!have_desc || (size < 4 && size != -1)) return false;
            if (!dseek(d, dtell(d) + 4)) return false;  // edit count
            int64_t start = dtell(d);
            int64_t avail = dsize(d) - start;
            if (avail < 0) avail = 0;
            int64_t bytes = size == -1 ? avail : size - 4;
            if (bytes < 0 || bytes > avail) bytes = avail;
            if (is_alac) {
                alac.data_start = start;
                alac.data_bytes = bytes;
                // kuki/pakt may follow data; keep scanning unless data
                // runs to EOF.
                if (size == -1) break;
                if (!dseek(d, start + (size - 4))) return false;
                continue;
            }
            d->data_start = start;
            d->total_frames = bytes / int64_t(d->bytes_per_frame());
            return true;
        } else if (is_alac && memcmp(ch, "kuki", 4) == 0) {
            if (size > (1 << 20)) return false;
            alac.kuki.resize(size_t(size));
            if (!dread(d, alac.kuki.data(), alac.kuki.size())) return false;
        } else if (is_alac && memcmp(ch, "pakt", 4) == 0) {
            if (size < 24 || size > (64 << 20)) return false;
            alac.pakt.resize(size_t(size));
            if (!dread(d, alac.pakt.data(), alac.pakt.size())) return false;
        } else {
            if (!dseek(d, dtell(d) + size)) return false;
        }
    }
    if (is_alac) return finish_alac_caf(d, alac);
    return false;
}

// Sony Wave64: GUID-tagged chunks with 64-bit sizes (size INCLUDES the
// 24-byte chunk header); payload layout identical to WAV.
bool parse_w64(Decoder* d) {
    static const uint8_t riff_guid[16] = {
        0x72, 0x69, 0x66, 0x66, 0x2E, 0x91, 0xCF, 0x11,
        0xA5, 0xD6, 0x28, 0xDB, 0x04, 0xC1, 0x00, 0x00};
    static const uint8_t wave_guid[16] = {
        0x77, 0x61, 0x76, 0x65, 0xF3, 0xAC, 0xD3, 0x11,
        0x8C, 0xD1, 0x00, 0xC0, 0x4F, 0x8E, 0xDB, 0x8A};
    uint8_t h[40];
    if (!dseek(d, 0) || !dread(d, h, 40)) return false;
    if (memcmp(h, riff_guid, 16) != 0 || memcmp(h + 24, wave_guid, 16) != 0)
        return false;
    bool have_fmt = false;
    while (true) {
        uint8_t ch[24];
        if (!dread(d, ch, 24)) break;
        int64_t size = int64_t(rd_u32le(ch + 16)) |
                       (int64_t(rd_u32le(ch + 20)) << 32);
        if (size < 24) return false;
        int64_t body = size - 24;
        int64_t pad = (8 - (size & 7)) & 7;  // chunks align to 8 bytes
        if (memcmp(ch, "fmt ", 4) == 0) {  // fmt GUID starts with the fourcc
            if (body < 16 || body > kMaxHeaderChunk) return false;
            std::vector<uint8_t> fmt(static_cast<size_t>(body), 0);
            if (!dread(d, fmt.data(), fmt.size())) return false;
            uint16_t tag = rd_u16le(fmt.data());
            d->channels = rd_u16le(fmt.data() + 2);
            d->sample_rate = int(rd_u32le(fmt.data() + 4));
            d->bits = rd_u16le(fmt.data() + 14);
            if (tag == 0xFFFE) {
                if (body < 40) return false;
                tag = rd_u16le(fmt.data() + 24);
            }
            if (tag == 1) d->format = 1;
            else if (tag == 3) d->format = 3;
            else if (tag == 7) { d->format = 5; }       // mu-law
            else if (tag == 6) { d->format = 6; }       // a-law
            else return false;
            if (!valid_layout(d)) return false;
            have_fmt = true;
            if (pad && !dseek(d, dtell(d) + pad)) return false;
        } else if (memcmp(ch, "data", 4) == 0) {
            if (!have_fmt) return false;
            d->data_start = dtell(d);
            int64_t avail = dsize(d) - d->data_start;
            if (avail < 0) avail = 0;
            int64_t bytes = body < avail ? body : avail;
            d->total_frames = bytes / int64_t(d->bytes_per_frame());
            return true;
        } else {
            if (!dseek(d, dtell(d) + body + pad)) return false;
        }
    }
    return false;
}

// RF64 (EBU >4 GB WAV): 'RF64'+'WAVE' with a ds64 chunk carrying the
// 64-bit data size; everything else is WAV.
bool parse_rf64(Decoder* d) {
    uint8_t hdr[12];
    if (!dseek(d, 0) || !dread(d, hdr, 12)) return false;
    if (memcmp(hdr, "RF64", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
        return false;
    bool have_fmt = false;
    int64_t data_size64 = -1;
    while (true) {
        uint8_t ch[8];
        if (!dread(d, ch, 8)) break;
        uint32_t size = rd_u32le(ch + 4);
        if (memcmp(ch, "ds64", 4) == 0) {
            if (size < 28 || size > kMaxHeaderChunk) return false;
            std::vector<uint8_t> ds(size);
            if (!dread(d, ds.data(), size)) return false;
            data_size64 = int64_t(rd_u32le(ds.data() + 8)) |
                          (int64_t(rd_u32le(ds.data() + 12)) << 32);
            if (size & 1) dseek(d, dtell(d) + 1);
        } else if (memcmp(ch, "fmt ", 4) == 0) {
            if (size < 16 || size > kMaxHeaderChunk) return false;
            std::vector<uint8_t> fmt(size);
            if (!dread(d, fmt.data(), size)) return false;
            uint16_t tag = rd_u16le(fmt.data());
            d->channels = rd_u16le(fmt.data() + 2);
            d->sample_rate = int(rd_u32le(fmt.data() + 4));
            d->bits = rd_u16le(fmt.data() + 14);
            if (tag == 0xFFFE) {
                if (size < 40) return false;
                tag = rd_u16le(fmt.data() + 24);
            }
            if (tag == 1) d->format = 1;
            else if (tag == 3) d->format = 3;
            else return false;
            if (!valid_layout(d)) return false;
            have_fmt = true;
            if (size & 1) dseek(d, dtell(d) + 1);
        } else if (memcmp(ch, "data", 4) == 0) {
            if (!have_fmt) return false;
            d->data_start = dtell(d);
            int64_t bytes = (size == 0xFFFFFFFFu && data_size64 >= 0)
                                ? data_size64
                                : int64_t(size);
            int64_t avail = dsize(d) - d->data_start;
            if (avail < 0) avail = 0;
            if (bytes > avail) bytes = avail;
            d->total_frames = bytes / int64_t(d->bytes_per_frame());
            return true;
        } else {
            if (!dseek(d, dtell(d) + size + (size & 1))) return false;
        }
    }
    return false;
}

bool parse(Decoder* d) { return parse_wav(d) || parse_aiff(d); }

// ITU-T G.711 expansions (libsndfile-parity companding support).
inline float ulaw_expand(uint8_t u) {
    u = ~u;
    int sign = u & 0x80;
    int exponent = (u >> 4) & 0x07;
    int mantissa = u & 0x0F;
    int sample = ((mantissa << 3) + 0x84) << exponent;
    sample -= 0x84;
    return float(sign ? -sample : sample) / 32768.0f;
}

inline float alaw_expand(uint8_t a) {
    a ^= 0x55;
    int sign = a & 0x80;
    int exponent = (a >> 4) & 0x07;
    int mantissa = a & 0x0F;
    int sample = exponent ? ((mantissa << 4) + 0x108) << (exponent - 1)
                          : (mantissa << 4) + 0x8;
    // In A-law (after the 0x55 toggle) a SET sign bit means POSITIVE —
    // opposite of mu-law (Sun reference alaw2linear).
    return float(sign ? sample : -sample) / 32768.0f;
}

inline float cvt_sample(const uint8_t* p, int bits, int format) {
    if (format == 5) return ulaw_expand(p[0]);
    if (format == 6) return alaw_expand(p[0]);
    if (format == 3) {  // IEEE float little endian
        if (bits == 32) {
            float v;
            memcpy(&v, p, 4);
            return v;
        }
        double v;
        memcpy(&v, p, 8);
        return float(v);
    }
    if (format == 7) {  // IEEE float big endian (AU / BE CAF)
        if (bits == 32) {
            uint32_t u = rd_u32be(p);
            float v;
            memcpy(&v, &u, 4);
            return v;
        }
        uint64_t u = 0;
        for (int i = 0; i < 8; i++) u = (u << 8) | p[i];
        double v;
        memcpy(&v, &u, 8);
        return float(v);
    }
    bool be = (format == 4);
    switch (bits) {
        case 8:
            // WAV 8-bit is unsigned; AIFF 8-bit is signed.
            return be ? float(int8_t(p[0])) / 128.0f
                      : (float(p[0]) - 128.0f) / 128.0f;
        case 16: {
            int16_t v = be ? int16_t((p[0] << 8) | p[1]) : int16_t(p[0] | (p[1] << 8));
            return float(v) / 32768.0f;
        }
        case 24: {
            int32_t v = be ? int32_t((p[0] << 24) | (p[1] << 16) | (p[2] << 8))
                           : int32_t((p[2] << 24) | (p[1] << 16) | (p[0] << 8));
            return float(v >> 8) / 8388608.0f;
        }
        case 32: {
            int32_t v = be ? int32_t(rd_u32be(p)) : int32_t(rd_u32le(p));
            return float(double(v) / 2147483648.0);
        }
    }
    return 0.0f;
}

// ---- ADPCM (native, from spec) ----------------------------------------------
//
// IMA/DVI ADPCM (WAV tag 0x11) and Microsoft ADPCM (tag 0x02): the two
// block-coded 4-bit formats libsndfile decodes for game freight
// (GraphAudio.IO/Libsndfile.cs:26-68 format table). Each block is
// independently decodable (headers carry the predictor state), so seeking
// is exact at block granularity.

const int kImaIndexTable[16] = {-1, -1, -1, -1, 2, 4, 6, 8,
                                -1, -1, -1, -1, 2, 4, 6, 8};
const int kImaStepTable[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484,
    7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818,
    18500, 20350, 22385, 24623, 27086, 29794, 32767};
const int kMsAdapt[16] = {230, 230, 230, 230, 307, 409, 512, 614,
                          768, 614, 512, 409, 307, 230, 230, 230};
const int kMsCoef1[7] = {256, 512, 0, 192, 240, 460, 392};
const int kMsCoef2[7] = {0, -256, 0, 64, 0, -208, -232};

inline int16_t ima_step(int& pred, int& index, int nib) {
    int step = kImaStepTable[index];
    int diff = step >> 3;
    if (nib & 1) diff += step >> 2;
    if (nib & 2) diff += step >> 1;
    if (nib & 4) diff += step;
    if (nib & 8) pred -= diff; else pred += diff;
    if (pred > 32767) pred = 32767;
    if (pred < -32768) pred = -32768;
    index += kImaIndexTable[nib];
    if (index < 0) index = 0;
    if (index > 88) index = 88;
    return int16_t(pred);
}

// Decode one ADPCM block (possibly truncated) into interleaved float32.
// Returns the number of frames decoded.
uint32_t adpcm_decode_block(Decoder* d, const uint8_t* blk, size_t blk_size,
                            std::vector<float>& out) {
    const uint32_t ch = uint32_t(d->channels);
    const uint32_t spb = d->samples_per_block;
    out.assign(size_t(spb) * ch, 0.0f);
    const float inv = 1.0f / 32768.0f;
    if (d->adpcm_tag == 0x11) {  // IMA
        if (blk_size < size_t(4) * ch) return 0;
        std::vector<int> pred(ch), index(ch);
        for (uint32_t c = 0; c < ch; c++) {
            const uint8_t* h = blk + size_t(4) * c;
            pred[c] = int(int16_t(rd_u16le(h)));
            index[c] = h[2] > 88 ? 88 : h[2];
            out[c] = float(pred[c]) * inv;  // header predictor = sample 0
        }
        uint32_t frames = 1;
        size_t pos = size_t(4) * ch;
        // payload: per channel 4-byte words round-robin; 8 samples per word.
        uint32_t written = 1;
        while (written < spb && pos + size_t(4) * ch <= blk_size) {
            for (uint32_t c = 0; c < ch; c++) {
                const uint8_t* w = blk + pos + size_t(4) * c;
                for (int b = 0; b < 4; b++) {
                    uint32_t s0 = written + uint32_t(2 * b);
                    if (s0 < spb)
                        out[size_t(s0) * ch + c] =
                            float(ima_step(pred[c], index[c], w[b] & 0xF)) * inv;
                    if (s0 + 1 < spb)
                        out[size_t(s0 + 1) * ch + c] =
                            float(ima_step(pred[c], index[c], w[b] >> 4)) * inv;
                }
            }
            pos += size_t(4) * ch;
            uint32_t got = 8;
            written += got;
            frames = written < spb ? written : spb;
        }
        return frames;
    }
    // MS ADPCM
    if (blk_size < size_t(7) * ch) return 0;
    std::vector<int> coef1(ch), coef2(ch), delta(ch), s1(ch), s2(ch);
    for (uint32_t c = 0; c < ch; c++) {
        int ci = blk[c];
        if (ci > 6) ci = 6;
        coef1[c] = kMsCoef1[ci];
        coef2[c] = kMsCoef2[ci];
    }
    const uint8_t* p = blk + ch;
    for (uint32_t c = 0; c < ch; c++, p += 2) delta[c] = int(int16_t(rd_u16le(p)));
    for (uint32_t c = 0; c < ch; c++, p += 2) s1[c] = int(int16_t(rd_u16le(p)));
    for (uint32_t c = 0; c < ch; c++, p += 2) s2[c] = int(int16_t(rd_u16le(p)));
    // The two header samples are the block's first two frames (s2 older).
    for (uint32_t c = 0; c < ch; c++) {
        out[c] = float(s2[c]) * inv;
        if (spb > 1) out[size_t(ch) + c] = float(s1[c]) * inv;
    }
    uint32_t frames = spb < 2 ? spb : 2;
    size_t nibbles_avail = (blk_size - size_t(7) * ch) * 2;
    size_t nib_i = 0;
    const uint8_t* data = blk + size_t(7) * ch;
    for (uint32_t s = 2; s < spb; s++) {
        for (uint32_t c = 0; c < ch; c++, nib_i++) {
            if (nib_i >= nibbles_avail) return frames;
            uint8_t byte = data[nib_i >> 1];
            int nib = (nib_i & 1) ? (byte & 0xF) : (byte >> 4);
            int signed_nib = nib >= 8 ? nib - 16 : nib;
            int pred = (s1[c] * coef1[c] + s2[c] * coef2[c]) >> 8;
            pred += signed_nib * delta[c];
            if (pred > 32767) pred = 32767;
            if (pred < -32768) pred = -32768;
            out[size_t(s) * ch + c] = float(pred) * inv;
            s2[c] = s1[c];
            s1[c] = pred;
            delta[c] = (kMsAdapt[nib] * delta[c]) >> 8;
            if (delta[c] < 16) delta[c] = 16;
        }
        frames = s + 1;
    }
    return frames;
}

// Ensure the block containing `frame` is decoded into d->carry.
bool adpcm_load_block(Decoder* d, int64_t block_idx) {
    if (d->adpcm_block == block_idx) return true;
    if (!dseek(d, d->data_start + block_idx * int64_t(d->block_align)))
        return false;
    std::vector<uint8_t> blk(d->block_align);
    size_t got = 0;
    {
        // tolerate a truncated final block
        uint8_t* p = blk.data();
        if (d->file) got = fread(p, 1, blk.size(), d->file);
        else {
            size_t avail = d->mem_size - d->mem_pos;
            got = blk.size() < avail ? blk.size() : avail;
            memcpy(p, d->mem + d->mem_pos, got);
            d->mem_pos += got;
        }
    }
    if (got == 0) return false;
    adpcm_decode_block(d, blk.data(), got, d->carry);
    d->adpcm_block = block_idx;
    return true;
}

int64_t read_adpcm(Decoder* d, float* out, int64_t frames) {
    int64_t avail = d->total_frames - d->frame_pos;
    if (frames > avail) frames = avail;
    if (frames <= 0) return 0;
    const uint32_t ch = uint32_t(d->channels);
    const int64_t spb = int64_t(d->samples_per_block);
    int64_t done = 0;
    while (done < frames) {
        int64_t block_idx = d->frame_pos / spb;
        int64_t in_block = d->frame_pos % spb;
        if (!adpcm_load_block(d, block_idx)) break;
        int64_t take = spb - in_block;
        if (take > frames - done) take = frames - done;
        memcpy(out + size_t(done) * ch,
               d->carry.data() + size_t(in_block) * ch,
               size_t(take) * ch * sizeof(float));
        done += take;
        d->frame_pos += take;
    }
    return done;
}

// ---- shared raw-stream helpers for the dlopen'd backends --------------------

size_t dread_some(Decoder* d, void* out, size_t n) {
    if (d->file) return fread(out, 1, n, d->file);
    size_t avail = d->mem_size - d->mem_pos;
    if (n > avail) n = avail;
    memcpy(out, d->mem + d->mem_pos, n);
    d->mem_pos += n;
    return n;
}

int64_t dsize(Decoder* d) {
    if (d->file) {
        int64_t cur = ftello(d->file);
        fseeko(d->file, 0, SEEK_END);
        int64_t sz = ftello(d->file);
        fseeko(d->file, cur, SEEK_SET);
        return sz;
    }
    return int64_t(d->mem_size);
}

// ---- MP3 via libmpg123 (dlopen) ---------------------------------------------

struct Mpg123Api {
    void* lib = nullptr;
    int (*init_)() = nullptr;
    void* (*new_)(const char*, int*) = nullptr;
    int (*param)(void*, int, long, double) = nullptr;
    int (*replace_reader_handle)(void*, ssize_t (*)(void*, void*, size_t),
                                 off_t (*)(void*, off_t, int),
                                 void (*)(void*)) = nullptr;
    int (*open_handle)(void*, void*) = nullptr;
    int (*scan)(void*) = nullptr;
    off_t (*length)(void*) = nullptr;
    int (*getformat)(void*, long*, int*, int*) = nullptr;
    int (*format_none)(void*) = nullptr;
    int (*format)(void*, long, int, int) = nullptr;
    int (*read)(void*, unsigned char*, size_t, size_t*) = nullptr;
    off_t (*seek)(void*, off_t, int) = nullptr;
    int (*close)(void*) = nullptr;
    void (*delete_)(void*) = nullptr;
    bool ok = false;
};

// mpg123.h constants (stable public ABI)
enum { MPG123_FLAGS_PARAM = 1 };
enum { MPG123_QUIET = 0x20, MPG123_GAPLESS = 0x40, MPG123_FORCE_FLOAT = 0x400 };
enum { MPG123_ENC_FLOAT_32 = 0x200 };
enum { MPG123_OK = 0, MPG123_DONE = -12 };

Mpg123Api& mpg123_api() {
    static Mpg123Api a;
    static bool tried = false;
    if (tried) return a;
    tried = true;
    a.lib = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!a.lib) a.lib = dlopen("libmpg123.so", RTLD_NOW | RTLD_LOCAL);
    if (!a.lib) return a;
#define SYM(field, name) \
    a.field = reinterpret_cast<decltype(a.field)>(dlsym(a.lib, name)); \
    if (!a.field) return a;
    SYM(init_, "mpg123_init")
    SYM(new_, "mpg123_new")
    SYM(param, "mpg123_param")
    SYM(replace_reader_handle, "mpg123_replace_reader_handle")
    SYM(open_handle, "mpg123_open_handle")
    SYM(scan, "mpg123_scan")
    SYM(length, "mpg123_length")
    SYM(getformat, "mpg123_getformat")
    SYM(format_none, "mpg123_format_none")
    SYM(format, "mpg123_format")
    SYM(read, "mpg123_read")
    SYM(seek, "mpg123_seek")
    SYM(close, "mpg123_close")
    SYM(delete_, "mpg123_delete")
#undef SYM
    a.init_();
    a.ok = true;
    return a;
}

ssize_t mp_read_cb(void* h, void* buf, size_t n) {
    return ssize_t(dread_some(static_cast<Decoder*>(h), buf, n));
}

off_t mp_seek_cb(void* h, off_t off, int whence) {
    Decoder* d = static_cast<Decoder*>(h);
    int64_t base = (whence == SEEK_SET) ? 0
                 : (whence == SEEK_CUR) ? dtell(d)
                                        : dsize(d);
    int64_t target = base + int64_t(off);
    if (!dseek(d, target)) return -1;
    return off_t(target);
}

bool open_mp3(Decoder* d) {
    Mpg123Api& a = mpg123_api();
    if (!a.ok) return false;
    int err = 0;
    void* mh = a.new_(nullptr, &err);
    if (!mh) return false;
    a.param(mh, MPG123_FLAGS_PARAM,
            MPG123_QUIET | MPG123_GAPLESS | MPG123_FORCE_FLOAT, 0.0);
    a.replace_reader_handle(mh, mp_read_cb, mp_seek_cb, nullptr);
    dseek(d, 0);
    if (a.open_handle(mh, d) != MPG123_OK) {
        a.delete_(mh);
        return false;
    }
    long rate = 0;
    int channels = 0, enc = 0;
    if (a.getformat(mh, &rate, &channels, &enc) != MPG123_OK || rate <= 0 ||
        channels <= 0) {
        a.close(mh);
        a.delete_(mh);
        return false;
    }
    a.format_none(mh);
    a.format(mh, rate, channels, MPG123_ENC_FLOAT_32);
    a.scan(mh);
    off_t frames = a.length(mh);
    d->backend = 1;
    d->mh = mh;
    d->channels = channels;
    d->sample_rate = int(rate);
    d->bits = 32;
    d->total_frames = (frames > 0) ? int64_t(frames) : 0;
    d->frame_pos = 0;
    return true;
}

int64_t read_mp3(Decoder* d, float* out, int64_t frames) {
    Mpg123Api& a = mpg123_api();
    size_t want = size_t(frames) * d->channels * sizeof(float);
    size_t got = 0;
    while (got < want) {
        size_t done = 0;
        int r = a.read(d->mh, reinterpret_cast<unsigned char*>(out) + got,
                       want - got, &done);
        got += done;
        // Stop at end-of-stream or when no progress is made (decode errors
        // that still produce samples keep going, libmpg123 style).
        if (r == MPG123_DONE || done == 0) break;
    }
    int64_t n = int64_t(got / (size_t(d->channels) * sizeof(float)));
    d->frame_pos += n;
    return n;
}

// ---- Ogg/Vorbis via libvorbisfile (dlopen) ----------------------------------

struct OvCallbacks {
    size_t (*read)(void*, size_t, size_t, void*);
    int (*seek)(void*, int64_t, int);
    int (*close)(void*);
    long (*tell)(void*);
};

struct VorbisInfoHead {  // leading fields of vorbis_info (stable ABI)
    int version;
    int channels;
    long rate;
};

struct VorbisApi {
    void* lib = nullptr;
    int (*open_callbacks)(void*, void*, const char*, long, OvCallbacks) = nullptr;
    void* (*info)(void*, int) = nullptr;
    int64_t (*pcm_total)(void*, int) = nullptr;
    long (*read_float)(void*, float***, int, int*) = nullptr;
    int (*pcm_seek)(void*, int64_t) = nullptr;
    int (*clear)(void*) = nullptr;
    bool ok = false;
};

// sizeof(OggVorbis_File) is ~944 on 64-bit; allocate with a wide margin since
// we never include the header.
constexpr size_t kOvFileSize = 8192;

VorbisApi& vorbis_api() {
    static VorbisApi a;
    static bool tried = false;
    if (tried) return a;
    tried = true;
    a.lib = dlopen("libvorbisfile.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (!a.lib) a.lib = dlopen("libvorbisfile.so", RTLD_NOW | RTLD_GLOBAL);
    if (!a.lib) return a;
#define SYM(field, name) \
    a.field = reinterpret_cast<decltype(a.field)>(dlsym(a.lib, name)); \
    if (!a.field) return a;
    SYM(open_callbacks, "ov_open_callbacks")
    SYM(info, "ov_info")
    SYM(pcm_total, "ov_pcm_total")
    SYM(read_float, "ov_read_float")
    SYM(pcm_seek, "ov_pcm_seek")
    SYM(clear, "ov_clear")
#undef SYM
    a.ok = true;
    return a;
}

size_t ov_read_cb(void* ptr, size_t size, size_t nmemb, void* h) {
    if (size == 0) return 0;
    size_t got = dread_some(static_cast<Decoder*>(h), ptr, size * nmemb);
    return got / size;
}

int ov_seek_cb(void* h, int64_t off, int whence) {
    Decoder* d = static_cast<Decoder*>(h);
    int64_t base = (whence == SEEK_SET) ? 0
                 : (whence == SEEK_CUR) ? dtell(d)
                                        : dsize(d);
    return dseek(d, base + off) ? 0 : -1;
}

long ov_tell_cb(void* h) { return long(dtell(static_cast<Decoder*>(h))); }

bool open_vorbis(Decoder* d) {
    VorbisApi& a = vorbis_api();
    if (!a.ok) return false;
    dseek(d, 0);
    void* vf = calloc(1, kOvFileSize);
    OvCallbacks cb{ov_read_cb, ov_seek_cb, nullptr, ov_tell_cb};
    if (a.open_callbacks(d, vf, nullptr, 0, cb) != 0) {
        free(vf);
        return false;
    }
    const VorbisInfoHead* vi =
        static_cast<const VorbisInfoHead*>(a.info(vf, -1));
    if (!vi || vi->channels <= 0 || vi->rate <= 0) {
        a.clear(vf);
        free(vf);
        return false;
    }
    d->backend = 2;
    d->vf = vf;
    d->channels = vi->channels;
    d->sample_rate = int(vi->rate);
    d->bits = 32;
    int64_t total = a.pcm_total(vf, -1);
    d->total_frames = (total > 0) ? total : 0;
    d->frame_pos = 0;
    return true;
}

int64_t read_vorbis(Decoder* d, float* out, int64_t frames) {
    VorbisApi& a = vorbis_api();
    int ch = d->channels;
    int64_t filled = 0;
    // (No carry drain here: ov_read_float is bounded by the remaining
    // request and can never overshoot — only the opus/flac/alac backends
    // populate d->carry.)
    while (filled < frames) {
        float** pcm = nullptr;
        int bitstream = 0;
        long got = a.read_float(d->vf, &pcm, int(frames - filled), &bitstream);
        if (got <= 0) break;
        for (long i = 0; i < got && filled < frames; i++, filled++) {
            for (int c = 0; c < ch; c++) out[filled * ch + c] = pcm[c][i];
        }
    }
    d->frame_pos += filled;
    return filled;
}

// ---- encoders: MP3 (libmp3lame) and Ogg/Vorbis (libvorbisenc) ---------------

struct LameApi {
    void* lib = nullptr;
    void* (*init_)() = nullptr;
    int (*set_in_samplerate)(void*, int) = nullptr;
    int (*set_num_channels)(void*, int) = nullptr;
    int (*set_brate)(void*, int) = nullptr;
    int (*init_params)(void*) = nullptr;
    int (*encode_buffer_ieee_float)(void*, const float*, const float*, int,
                                    unsigned char*, int) = nullptr;
    int (*encode_flush)(void*, unsigned char*, int) = nullptr;
    size_t (*get_lametag_frame)(void*, unsigned char*, size_t) = nullptr;
    int (*close)(void*) = nullptr;
    bool ok = false;
};

LameApi& lame_api() {
    static LameApi a;
    static bool tried = false;
    if (tried) return a;
    tried = true;
    a.lib = dlopen("libmp3lame.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!a.lib) a.lib = dlopen("libmp3lame.so", RTLD_NOW | RTLD_LOCAL);
    if (!a.lib) return a;
#define SYM(field, name) \
    a.field = reinterpret_cast<decltype(a.field)>(dlsym(a.lib, name)); \
    if (!a.field) return a;
    SYM(init_, "lame_init")
    SYM(set_in_samplerate, "lame_set_in_samplerate")
    SYM(set_num_channels, "lame_set_num_channels")
    SYM(set_brate, "lame_set_brate")
    SYM(init_params, "lame_init_params")
    SYM(encode_buffer_ieee_float, "lame_encode_buffer_ieee_float")
    SYM(encode_flush, "lame_encode_flush")
    SYM(get_lametag_frame, "lame_get_lametag_frame")
    SYM(close, "lame_close")
#undef SYM
    a.ok = true;
    return a;
}

// vorbis encode: caller-allocated opaque structs, sized with wide margins.
constexpr size_t kViSize = 1024;   // vorbis_info
constexpr size_t kVcSize = 1024;   // vorbis_comment
constexpr size_t kVdSize = 8192;   // vorbis_dsp_state
constexpr size_t kVbSize = 8192;   // vorbis_block
constexpr size_t kOsSize = 4096;   // ogg_stream_state

struct OggPacket {  // stable libogg ABI
    unsigned char* packet;
    long bytes;
    long b_o_s;
    long e_o_s;
    int64_t granulepos;
    int64_t packetno;
};

struct OggPage {
    unsigned char* header;
    long header_len;
    unsigned char* body;
    long body_len;
};

struct VorbisEncApi {
    void* enc = nullptr;
    void* vorbis = nullptr;
    void* ogg = nullptr;
    void (*info_init)(void*) = nullptr;
    int (*encode_init_vbr)(void*, long, long, float) = nullptr;
    void (*comment_init)(void*) = nullptr;
    int (*analysis_init)(void*, void*) = nullptr;
    int (*block_init)(void*, void*) = nullptr;
    int (*analysis_headerout)(void*, void*, OggPacket*, OggPacket*, OggPacket*) = nullptr;
    float** (*analysis_buffer)(void*, int) = nullptr;
    int (*analysis_wrote)(void*, int) = nullptr;
    int (*analysis_blockout)(void*, void*) = nullptr;
    int (*analysis)(void*, OggPacket*) = nullptr;
    int (*bitrate_addblock)(void*) = nullptr;
    int (*bitrate_flushpacket)(void*, OggPacket*) = nullptr;
    int (*block_clear)(void*) = nullptr;
    void (*dsp_clear)(void*) = nullptr;
    void (*comment_clear)(void*) = nullptr;
    void (*info_clear)(void*) = nullptr;
    int (*stream_init)(void*, int) = nullptr;
    int (*stream_packetin)(void*, OggPacket*) = nullptr;
    int (*stream_pageout)(void*, OggPage*) = nullptr;
    int (*stream_flush)(void*, OggPage*) = nullptr;
    int (*stream_clear)(void*) = nullptr;
    bool ok = false;
};

VorbisEncApi& vorbisenc_api() {
    static VorbisEncApi a;
    static bool tried = false;
    if (tried) return a;
    tried = true;
    a.ogg = dlopen("libogg.so.0", RTLD_NOW | RTLD_GLOBAL);
    a.vorbis = dlopen("libvorbis.so.0", RTLD_NOW | RTLD_GLOBAL);
    a.enc = dlopen("libvorbisenc.so.2", RTLD_NOW | RTLD_GLOBAL);
    if (!a.ogg || !a.vorbis || !a.enc) return a;
#define VSYM(field, lib, name) \
    a.field = reinterpret_cast<decltype(a.field)>(dlsym(a.lib, name)); \
    if (!a.field) return a;
    VSYM(info_init, vorbis, "vorbis_info_init")
    VSYM(encode_init_vbr, enc, "vorbis_encode_init_vbr")
    VSYM(comment_init, vorbis, "vorbis_comment_init")
    VSYM(analysis_init, vorbis, "vorbis_analysis_init")
    VSYM(block_init, vorbis, "vorbis_block_init")
    VSYM(analysis_headerout, vorbis, "vorbis_analysis_headerout")
    VSYM(analysis_buffer, vorbis, "vorbis_analysis_buffer")
    VSYM(analysis_wrote, vorbis, "vorbis_analysis_wrote")
    VSYM(analysis_blockout, vorbis, "vorbis_analysis_blockout")
    VSYM(analysis, vorbis, "vorbis_analysis")
    VSYM(bitrate_addblock, vorbis, "vorbis_bitrate_addblock")
    VSYM(bitrate_flushpacket, vorbis, "vorbis_bitrate_flushpacket")
    VSYM(block_clear, vorbis, "vorbis_block_clear")
    VSYM(dsp_clear, vorbis, "vorbis_dsp_clear")
    VSYM(comment_clear, vorbis, "vorbis_comment_clear")
    VSYM(info_clear, vorbis, "vorbis_info_clear")
    VSYM(stream_init, ogg, "ogg_stream_init")
    VSYM(stream_packetin, ogg, "ogg_stream_packetin")
    VSYM(stream_pageout, ogg, "ogg_stream_pageout")
    VSYM(stream_flush, ogg, "ogg_stream_flush")
    VSYM(stream_clear, ogg, "ogg_stream_clear")
#undef VSYM
    a.ok = true;
    return a;
}

// ---- Ogg Opus via libogg + libopus (dlopen) ---------------------------------
//
// libsndfile decodes Ogg Opus (GraphAudio.IO/Libsndfile.cs format table);
// this image ships libopus + libogg but NOT libopusfile, so the Ogg layer
// (page sync, packet reassembly, RFC 7845 OpusHead/OpusTags) runs through
// dlopen'd libogg and packets decode through dlopen'd libopus. Output is
// always 48 kHz float (Opus's native rate); preskip and end trimming follow
// the granulepos rules. Encoder: 20 ms frames, mapping family 0.

struct OpusApi {
    void* ogg = nullptr;
    void* opus = nullptr;
    // libogg
    int (*sync_init)(void*) = nullptr;
    char* (*sync_buffer)(void*, long) = nullptr;
    int (*sync_wrote)(void*, long) = nullptr;
    int (*sync_pageout)(void*, OggPage*) = nullptr;
    int (*sync_clear)(void*) = nullptr;
    int (*stream_init)(void*, int) = nullptr;
    int (*stream_pagein)(void*, OggPage*) = nullptr;
    int (*stream_packetout)(void*, OggPacket*) = nullptr;
    int (*stream_packetin)(void*, OggPacket*) = nullptr;
    int (*stream_pageout)(void*, OggPage*) = nullptr;
    int (*stream_flush)(void*, OggPage*) = nullptr;
    int (*stream_clear)(void*) = nullptr;
    int (*page_serialno)(OggPage*) = nullptr;
    int64_t (*page_granulepos)(OggPage*) = nullptr;
    int (*page_bos)(OggPage*) = nullptr;
    // libopus
    void* (*decoder_create)(int32_t, int, int*) = nullptr;
    int (*decode_float)(void*, const unsigned char*, int32_t, float*, int, int) = nullptr;
    void (*decoder_destroy)(void*) = nullptr;
    void* (*encoder_create)(int32_t, int, int, int*) = nullptr;
    int32_t (*encode_float)(void*, const float*, int, unsigned char*, int32_t) = nullptr;
    int (*encoder_ctl)(void*, int, ...) = nullptr;
    void (*encoder_destroy)(void*) = nullptr;
    bool ok = false;
};

OpusApi& opus_api() {
    static OpusApi a;
    static bool tried = false;
    if (tried) return a;
    tried = true;
    a.ogg = dlopen("libogg.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!a.ogg) a.ogg = dlopen("libogg.so", RTLD_NOW | RTLD_GLOBAL);
    a.opus = dlopen("libopus.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!a.opus) a.opus = dlopen("libopus.so", RTLD_NOW | RTLD_GLOBAL);
    if (!a.ogg || !a.opus) return a;
#define OSYM(field, lib, name) \
    a.field = reinterpret_cast<decltype(a.field)>(dlsym(a.lib, name)); \
    if (!a.field) return a;
    OSYM(sync_init, ogg, "ogg_sync_init")
    OSYM(sync_buffer, ogg, "ogg_sync_buffer")
    OSYM(sync_wrote, ogg, "ogg_sync_wrote")
    OSYM(sync_pageout, ogg, "ogg_sync_pageout")
    OSYM(sync_clear, ogg, "ogg_sync_clear")
    OSYM(stream_init, ogg, "ogg_stream_init")
    OSYM(stream_pagein, ogg, "ogg_stream_pagein")
    OSYM(stream_packetout, ogg, "ogg_stream_packetout")
    OSYM(stream_packetin, ogg, "ogg_stream_packetin")
    OSYM(stream_pageout, ogg, "ogg_stream_pageout")
    OSYM(stream_flush, ogg, "ogg_stream_flush")
    OSYM(stream_clear, ogg, "ogg_stream_clear")
    OSYM(page_serialno, ogg, "ogg_page_serialno")
    OSYM(page_granulepos, ogg, "ogg_page_granulepos")
    OSYM(page_bos, ogg, "ogg_page_bos")
    OSYM(decoder_create, opus, "opus_decoder_create")
    OSYM(decode_float, opus, "opus_decode_float")
    OSYM(decoder_destroy, opus, "opus_decoder_destroy")
    OSYM(encoder_create, opus, "opus_encoder_create")
    OSYM(encode_float, opus, "opus_encode_float")
    OSYM(encoder_ctl, opus, "opus_encoder_ctl")
    OSYM(encoder_destroy, opus, "opus_encoder_destroy")
#undef OSYM
    a.ok = true;
    return a;
}

constexpr size_t kOggStateSize = 4096;  // >= sizeof(ogg_sync/stream_state)
constexpr int kOpusMaxFrame = 5760;     // 120 ms @ 48 kHz

struct OpusStream {
    uint8_t sync[kOggStateSize];
    uint8_t stream[kOggStateSize];
    bool sync_inited = false;
    bool stream_inited = false;
    void* dec = nullptr;
    int serial = 0;
    int preskip = 0;          // 48 kHz samples to drop at stream start
    float gain = 1.0f;        // OpusHead output gain (Q7.8 dB)
    int64_t skip_left = 0;    // remaining samples to drop (preskip / seek)
    int packets_seen = 0;     // OpusHead + OpusTags are packets 0 and 1
    bool at_end = false;

    ~OpusStream() {
        OpusApi& a = opus_api();
        if (dec) a.decoder_destroy(dec);
        if (stream_inited) a.stream_clear(stream);
        if (sync_inited) a.sync_clear(sync);
    }
};

// Feed raw bytes until the next page is available. Returns false at EOF.
bool opus_next_page(Decoder* d, OpusStream* os, OggPage* pg) {
    OpusApi& a = opus_api();
    while (a.sync_pageout(os->sync, pg) != 1) {
        char* buf = a.sync_buffer(os->sync, 65536);
        if (!buf) return false;
        size_t got = dread_some(d, buf, 65536);
        if (got == 0) return false;
        a.sync_wrote(os->sync, long(got));
    }
    return true;
}

// Parse OpusHead (RFC 7845 section 5.1) from the first BOS page whose
// payload starts "OpusHead". Returns false if none is found.
bool opus_read_head(Decoder* d, OpusStream* os) {
    OpusApi& a = opus_api();
    OggPage pg;
    while (opus_next_page(d, os, &pg)) {
        if (!a.page_bos(&pg) || pg.body_len < 19 ||
            memcmp(pg.body, "OpusHead", 8) != 0)
            continue;
        os->serial = a.page_serialno(&pg);
        a.stream_init(os->stream, os->serial);
        os->stream_inited = true;
        a.stream_pagein(os->stream, &pg);
        OggPacket pkt;
        if (a.stream_packetout(os->stream, &pkt) != 1 || pkt.bytes < 19)
            return false;
        const uint8_t* b = pkt.packet;
        int version = b[8];
        if ((version >> 4) != 0) return false;
        d->channels = b[9];
        os->preskip = int(rd_u16le(b + 10));
        int16_t gain_q8 = int16_t(rd_u16le(b + 16));
        os->gain = powf(10.0f, float(gain_q8) / (20.0f * 256.0f));
        int mapping = b[18];
        if (mapping != 0 || d->channels < 1 || d->channels > 2)
            return false;  // mapping family 0 only (mono/stereo)
        os->packets_seen = 1;
        return true;
    }
    return false;
}

bool open_opus(Decoder* d) {
    OpusApi& a = opus_api();
    if (!a.ok) return false;
    OpusStream* os = new OpusStream();
    a.sync_init(os->sync);
    os->sync_inited = true;
    dseek(d, 0);
    if (!opus_read_head(d, os)) { delete os; return false; }

    // Duration: last granulepos of our serial (granulepos counts 48 kHz
    // samples INCLUDING preskip, RFC 7845 §4). Pages are enumerated with a
    // second ogg_sync state — libogg CRC-checks each candidate — because a
    // raw 'OggS' byte scan can alias page-header patterns inside compressed
    // packet payloads and report a bogus final granulepos.
    int64_t last_gp = -1;
    {
        int64_t pos = dtell(d);
        dseek(d, 0);
        uint8_t scan_state[kOggStateSize];
        a.sync_init(scan_state);
        OggPage pg;
        for (;;) {
            char* dst = a.sync_buffer(scan_state, 1 << 16);
            size_t got = dread_some(d, (uint8_t*)dst, 1 << 16);
            if (got == 0) break;
            a.sync_wrote(scan_state, long(got));
            for (;;) {
                int r = a.sync_pageout(scan_state, &pg);
                if (r == 0) break;      // need more data
                if (r != 1) continue;   // desync: bytes skipped, retry
                if (a.page_serialno(&pg) != os->serial) continue;
                int64_t gp = a.page_granulepos(&pg);
                if (gp >= 0) last_gp = gp;
            }
        }
        a.sync_clear(scan_state);
        dseek(d, pos);
    }
    int64_t total = last_gp >= 0 ? last_gp - os->preskip : 0;
    if (total < 0) total = 0;

    int err = 0;
    os->dec = a.decoder_create(48000, d->channels, &err);
    if (!os->dec || err != 0) { delete os; return false; }
    os->skip_left = os->preskip;
    d->backend = 5;
    d->opus = os;
    d->sample_rate = 48000;
    d->bits = 32;
    d->format = 3;
    d->total_frames = total;
    d->frame_pos = 0;
    return true;
}

int64_t read_opus(Decoder* d, float* out, int64_t frames) {
    OpusApi& a = opus_api();
    OpusStream* os = (OpusStream*)d->opus;
    const int ch = d->channels;
    int64_t avail = d->total_frames - d->frame_pos;
    if (frames > avail) frames = avail;
    if (frames <= 0) return 0;
    int64_t done = 0;
    std::vector<float> pcm(size_t(kOpusMaxFrame) * ch);
    while (done < frames) {
        // serve carried samples first
        size_t have = d->carry.size() / size_t(ch) - d->carry_pos;
        if (have > 0) {
            size_t take = size_t(frames - done) < have
                              ? size_t(frames - done) : have;
            memcpy(out + size_t(done) * ch,
                   d->carry.data() + d->carry_pos * size_t(ch),
                   take * size_t(ch) * sizeof(float));
            d->carry_pos += take;
            done += int64_t(take);
            continue;
        }
        d->carry.clear();
        d->carry_pos = 0;
        if (os->at_end) break;
        OggPacket pkt;
        int r = a.stream_packetout(os->stream, &pkt);
        if (r == 0) {
            OggPage pg;
            if (!opus_next_page(d, os, &pg)) { os->at_end = true; continue; }
            if (a.page_serialno(&pg) == os->serial)
                a.stream_pagein(os->stream, &pg);
            continue;
        }
        if (r < 0) continue;  // hole in data; resync
        os->packets_seen++;
        if (os->packets_seen <= 2) continue;  // OpusTags
        int n = a.decode_float(os->dec, pkt.packet, int32_t(pkt.bytes),
                               pcm.data(), kOpusMaxFrame, 0);
        if (n <= 0) continue;
        int64_t start = 0;
        if (os->skip_left > 0) {
            start = os->skip_left < n ? os->skip_left : n;
            os->skip_left -= start;
        }
        if (start >= n) continue;
        size_t count = size_t(n - start) * size_t(ch);
        const float* src = pcm.data() + size_t(start) * ch;
        d->carry.resize(count);
        if (os->gain != 1.0f) {
            for (size_t i = 0; i < count; i++)
                d->carry[i] = src[i] * os->gain;
        } else {
            memcpy(d->carry.data(), src, count * sizeof(float));
        }
    }
    d->frame_pos += done;
    return done;
}

int opus_seek(Decoder* d, int64_t frame) {
    // Sample-exact by decode-from-start (packet boundaries are not
    // addressable without an index; streaming seeks are rare and short).
    OpusStream* os = (OpusStream*)d->opus;
    OpusApi& a = opus_api();
    if (os->dec) { a.decoder_destroy(os->dec); os->dec = nullptr; }
    if (os->stream_inited) { a.stream_clear(os->stream); os->stream_inited = false; }
    if (os->sync_inited) { a.sync_clear(os->sync); os->sync_inited = false; }
    a.sync_init(os->sync);
    os->sync_inited = true;
    dseek(d, 0);
    if (!opus_read_head(d, os)) return -1;
    int err = 0;
    os->dec = a.decoder_create(48000, d->channels, &err);
    if (!os->dec || err != 0) return -1;
    os->at_end = false;
    os->skip_left = int64_t(os->preskip) + frame;
    d->carry.clear();
    d->carry_pos = 0;
    d->frame_pos = frame;
    return 0;
}

// ---- FLAC (native, from the format spec — no libFLAC dependency) ------------
//
// Decoder: full subframe coverage (CONSTANT / VERBATIM / FIXED 0-4 /
// LPC 1-32), Rice and Rice2 residual partitions with escape codes, wasted
// bits, and all four channel assignments (independent, left/side,
// right/side, mid/side). Plays the role of libsndfile's FLAC support
// (GraphAudio.IO/Libsndfile.cs:26-68 format table). Frame CRCs are parsed
// but not verified (decode errors surface as sync loss instead).
// Encoder: streamable subset with fixed predictors (orders 0-2, best by
// residual magnitude) + Rice coding, correct header CRC-8 / frame CRC-16.

struct FlacBitReader {
    Decoder* d = nullptr;
    uint64_t bitbuf = 0;  // MSB-justified bits
    int nbits = 0;
    bool eof = false;

    bool fill() {
        // NOTE: running out of file bytes is NOT eof for the reader — the
        // final frame legitimately drains the buffered tail; only a read
        // that cannot be satisfied from the remaining bits flags eof.
        while (nbits <= 56) {
            uint8_t b;
            if (!dread(d, &b, 1)) return false;
            bitbuf |= uint64_t(b) << (56 - nbits);
            nbits += 8;
        }
        return true;
    }
    // Read up to 32 bits (n >= 1).
    uint32_t bits(int n) {
        if (nbits < n && !fill() && nbits < n) { eof = true; return 0; }
        uint32_t v = uint32_t(bitbuf >> (64 - n));
        bitbuf <<= n;
        nbits -= n;
        return v;
    }
    int32_t sbits(int n) {
        uint32_t v = bits(n);
        // sign-extend
        if (n < 32 && (v & (1u << (n - 1)))) v |= ~((1u << n) - 1);
        return int32_t(v);
    }
    uint32_t unary() {
        uint32_t q = 0;
        for (;;) {
            if (nbits == 0) {
                fill();
                if (nbits == 0) { eof = true; return q; }
            }
            if (bitbuf == 0) {  // all zeros buffered
                q += nbits;
                bitbuf = 0;
                nbits = 0;
                continue;
            }
            int lead = __builtin_clzll(bitbuf);
            if (lead >= nbits) {
                q += nbits;
                bitbuf = 0;
                nbits = 0;
                continue;
            }
            q += lead;
            bitbuf <<= lead + 1;
            nbits -= lead + 1;
            return q;
        }
    }
    void align() {
        int drop = nbits % 8;
        bitbuf <<= drop;
        nbits -= drop;
    }
    int64_t byte_pos() {  // position of the next unconsumed byte
        return dtell(d) - nbits / 8;
    }
    void reset_at(int64_t pos) {
        dseek(d, pos);
        bitbuf = 0;
        nbits = 0;
        eof = false;
    }
};

struct FlacStream {
    FlacBitReader br;
    int64_t first_frame_off = 0;
    int streaminfo_bps = 16;
    uint32_t max_block = 4096;
    std::vector<int64_t> ch[8];  // per-channel sample workspace
};

bool flac_decode_frame(Decoder* d, FlacStream* fs, std::vector<float>& out,
                       uint32_t* out_frames) {
    FlacBitReader& br = fs->br;
    *out_frames = 0;
    // Sync: 11111111 111110xx
    uint32_t sync = br.bits(14);
    if (br.eof) return false;
    if (sync != 0x3FFE) return false;
    br.bits(1);  // reserved
    br.bits(1);  // blocking strategy
    uint32_t bs_code = br.bits(4);
    uint32_t sr_code = br.bits(4);
    uint32_t ch_asgn = br.bits(4);
    uint32_t ss_code = br.bits(3);
    br.bits(1);  // reserved
    // UTF-8 coded frame/sample number (up to 7 bytes), value unused — we
    // track position ourselves.
    uint32_t lead = br.bits(8);
    int follow = 0;
    if (lead >= 0xC0) {
        uint32_t m = 0xE0;
        follow = 1;
        while (lead >= m && follow < 6) { m = (m >> 1) | 0x80; follow++; }
        follow -= 1;
        for (int i = 0; i < follow + 1 && !br.eof; i++) br.bits(8);
    }
    uint32_t block = 0;
    switch (bs_code) {
        case 1: block = 192; break;
        case 2: case 3: case 4: case 5: block = 576u << (bs_code - 2); break;
        case 6: block = br.bits(8) + 1; break;
        case 7: block = br.bits(16) + 1; break;
        default:
            if (bs_code >= 8) block = 256u << (bs_code - 8);
            else return false;  // 0 reserved
    }
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    else if (sr_code == 15) return false;
    br.bits(8);  // header CRC-8 (unverified)

    int channels;
    int mode = 0;  // 0 independent, 1 L/S, 2 R/S, 3 M/S
    if (ch_asgn <= 7) channels = int(ch_asgn) + 1;
    else if (ch_asgn <= 10) { channels = 2; mode = int(ch_asgn) - 7; }
    else return false;
    if (channels != d->channels) return false;

    int bps;
    switch (ss_code) {
        case 0: bps = fs->streaminfo_bps; break;
        case 1: bps = 8; break;
        case 2: bps = 12; break;
        case 4: bps = 16; break;
        case 5: bps = 20; break;
        case 6: bps = 24; break;
        case 7: bps = 32; break;
        default: return false;
    }
    if (block == 0 || block > (1u << 16)) return false;

    for (int c = 0; c < channels; c++) {
        std::vector<int64_t>& s = fs->ch[c];
        s.assign(block, 0);
        int sub_bps = bps;
        if ((mode == 1 && c == 1) || (mode == 2 && c == 0) ||
            (mode == 3 && c == 1))
            sub_bps += 1;  // side channel carries one extra bit
        // subframe header
        if (br.bits(1) != 0) return false;
        uint32_t type = br.bits(6);
        int wasted = 0;
        if (br.bits(1)) wasted = int(br.unary()) + 1;
        sub_bps -= wasted;
        // (33-bit side subframes — 32-bit sources with inter-channel
        // decorrelation — are not supported; nothing common emits them.)
        if (sub_bps < 1 || sub_bps > 32) return false;

        int order = 0;
        bool is_lpc = false, is_fixed = false;
        if (type == 0) {  // CONSTANT
            int64_t v = br.sbits(sub_bps);
            for (uint32_t i = 0; i < block; i++) s[i] = v;
        } else if (type == 1) {  // VERBATIM
            for (uint32_t i = 0; i < block; i++) s[i] = br.sbits(sub_bps);
        } else if ((type & 0x38) == 0x08 && (type & 7) <= 4) {  // FIXED
            is_fixed = true;
            order = int(type & 7);
        } else if (type & 0x20) {  // LPC
            is_lpc = true;
            order = int(type & 0x1F) + 1;
        } else {
            return false;
        }

        if (is_fixed || is_lpc) {
            if (uint32_t(order) > block) return false;
            for (int i = 0; i < order; i++) s[i] = br.sbits(sub_bps);
            int qshift = 0, prec = 0;
            int32_t qlp[32];
            if (is_lpc) {
                prec = int(br.bits(4)) + 1;
                if (prec == 16) return false;  // code 15 invalid
                qshift = br.sbits(5);
                if (qshift < 0) return false;
                for (int i = 0; i < order; i++) qlp[i] = br.sbits(prec);
            }
            // residual
            uint32_t method = br.bits(2);
            if (method > 1) return false;
            int pbits = method == 0 ? 4 : 5;
            uint32_t escape = method == 0 ? 0xF : 0x1F;
            uint32_t po = br.bits(4);
            uint32_t nparts = 1u << po;
            if ((block >> po) == 0 || (block % nparts) != 0) return false;
            // Partition 0's residual count is (block >> po) - order; a
            // hostile frame with order > samples-per-partition would wrap
            // the unsigned count into ~4e9 heap writes.
            if ((block >> po) < uint32_t(order)) return false;
            uint32_t idx = uint32_t(order);
            for (uint32_t part = 0; part < nparts; part++) {
                uint32_t cnt = (block >> po) - (part == 0 ? order : 0);
                uint32_t param = br.bits(pbits);
                if (param == escape) {
                    uint32_t raw = br.bits(5);
                    for (uint32_t i = 0; i < cnt; i++)
                        s[idx++] = raw ? br.sbits(int(raw)) : 0;
                } else {
                    for (uint32_t i = 0; i < cnt; i++) {
                        uint32_t q = br.unary();
                        uint32_t r = param ? br.bits(int(param)) : 0;
                        uint64_t u = (uint64_t(q) << param) | r;
                        s[idx++] = (u & 1) ? -int64_t(u >> 1) - 1
                                           : int64_t(u >> 1);
                    }
                }
                if (br.eof) return false;
            }
            // prediction
            if (is_fixed) {
                switch (order) {
                    case 0: break;
                    case 1:
                        for (uint32_t i = 1; i < block; i++) s[i] += s[i - 1];
                        break;
                    case 2:
                        for (uint32_t i = 2; i < block; i++)
                            s[i] += 2 * s[i - 1] - s[i - 2];
                        break;
                    case 3:
                        for (uint32_t i = 3; i < block; i++)
                            s[i] += 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3];
                        break;
                    case 4:
                        for (uint32_t i = 4; i < block; i++)
                            s[i] += 4 * s[i - 1] - 6 * s[i - 2] +
                                    4 * s[i - 3] - s[i - 4];
                        break;
                }
            } else {
                for (uint32_t i = uint32_t(order); i < block; i++) {
                    int64_t acc = 0;
                    for (int j = 0; j < order; j++)
                        acc += int64_t(qlp[j]) * s[i - 1 - j];
                    s[i] += acc >> qshift;
                }
            }
        }
        if (wasted)
            for (uint32_t i = 0; i < block; i++) s[i] <<= wasted;
    }
    br.align();
    br.bits(16);  // frame CRC-16 (unverified)
    if (br.eof) return false;

    // channel decorrelation
    if (mode == 1) {  // left/side: R = L - S
        for (uint32_t i = 0; i < block; i++)
            fs->ch[1][i] = fs->ch[0][i] - fs->ch[1][i];
    } else if (mode == 2) {  // right/side (stored side, right): L = S + R
        for (uint32_t i = 0; i < block; i++)
            fs->ch[0][i] = fs->ch[0][i] + fs->ch[1][i];
    } else if (mode == 3) {  // mid/side
        for (uint32_t i = 0; i < block; i++) {
            int64_t side = fs->ch[1][i];
            int64_t mid = (fs->ch[0][i] << 1) | (side & 1);
            fs->ch[0][i] = (mid + side) >> 1;
            fs->ch[1][i] = (mid - side) >> 1;
        }
    }

    float scale = 1.0f / float(1u << (bps - 1));
    if (bps == 32) scale = 1.0f / 2147483648.0f;
    out.resize(size_t(block) * channels);
    for (uint32_t i = 0; i < block; i++)
        for (int c = 0; c < channels; c++)
            out[size_t(i) * channels + c] = float(fs->ch[c][i]) * scale;
    *out_frames = block;
    return true;
}

bool open_flac(Decoder* d) {
    uint8_t magic[4];
    if (!dseek(d, 0) || !dread(d, magic, 4)) return false;
    if (memcmp(magic, "fLaC", 4) != 0) return false;
    bool got_streaminfo = false;
    FlacStream* fs = new FlacStream();
    for (;;) {
        uint8_t h[4];
        if (!dread(d, h, 4)) { delete fs; return false; }
        bool last = (h[0] & 0x80) != 0;
        int type = h[0] & 0x7F;
        uint32_t len = (uint32_t(h[1]) << 16) | (uint32_t(h[2]) << 8) | h[3];
        if (type == 0) {  // STREAMINFO
            if (len < 34) { delete fs; return false; }
            uint8_t si[34];
            if (!dread(d, si, 34)) { delete fs; return false; }
            if (len > 34 && !dseek(d, dtell(d) + (len - 34))) {
                delete fs; return false;
            }
            fs->max_block = rd_u16be(si + 2);
            d->sample_rate = int((uint32_t(si[10]) << 12) |
                                 (uint32_t(si[11]) << 4) | (si[12] >> 4));
            d->channels = int((si[12] >> 1) & 0x7) + 1;
            fs->streaminfo_bps =
                int(((si[12] & 1) << 4) | (si[13] >> 4)) + 1;
            d->total_frames =
                (int64_t(si[13] & 0x0F) << 32) | int64_t(rd_u32be(si + 14));
            got_streaminfo = true;
        } else {
            if (!dseek(d, dtell(d) + len)) { delete fs; return false; }
        }
        if (last) break;
    }
    if (!got_streaminfo || d->channels < 1 || d->channels > 8 ||
        d->sample_rate < 1 || fs->streaminfo_bps < 4 ||
        fs->streaminfo_bps > 32) {
        delete fs;
        return false;
    }
    d->bits = fs->streaminfo_bps;
    d->format = 0;
    d->backend = 3;
    d->flac = fs;
    fs->first_frame_off = dtell(d);
    fs->br.d = d;
    fs->br.reset_at(fs->first_frame_off);
    return true;
}

int64_t read_flac(Decoder* d, float* out, int64_t frames) {
    FlacStream* fs = (FlacStream*)d->flac;
    int ch = d->channels;
    int64_t got = 0;
    while (got < frames) {
        if (d->carry_pos < d->carry.size()) {
            int64_t have = int64_t(d->carry.size() - d->carry_pos) / ch;
            int64_t take = std::min(have, frames - got);
            memcpy(out + got * ch, d->carry.data() + d->carry_pos,
                   size_t(take) * ch * 4);
            d->carry_pos += size_t(take) * ch;
            got += take;
            continue;
        }
        if (d->total_frames > 0 && d->frame_pos + got >= d->total_frames)
            break;
        std::vector<float> block;
        uint32_t n = 0;
        if (!flac_decode_frame(d, fs, block, &n) || n == 0) break;
        d->carry = std::move(block);
        d->carry_pos = 0;
    }
    d->frame_pos += got;
    return got;
}

int flac_seek(Decoder* d, int64_t frame) {
    FlacStream* fs = (FlacStream*)d->flac;
    if (frame < d->frame_pos) {
        fs->br.reset_at(fs->first_frame_off);
        d->carry.clear();
        d->carry_pos = 0;
        d->frame_pos = 0;
    }
    // Decode-and-discard forward (no SEEKTABLE use; exact and simple).
    while (d->frame_pos < frame) {
        int64_t skip = frame - d->frame_pos;
        std::vector<float> tmp(size_t(std::min<int64_t>(skip, 4096)) *
                               d->channels);
        int64_t n = read_flac(d, tmp.data(),
                              std::min<int64_t>(skip, 4096));
        if (n <= 0) return -1;
    }
    return 0;
}

// ---- FLAC encoder (fixed predictors + Rice; streamable subset) --------------

struct FlacBitWriter {
    std::vector<uint8_t> bytes;
    uint64_t acc = 0;
    int nacc = 0;
    size_t crc16_from = 0;

    void put(uint32_t v, int n) {
        acc = (acc << n) | (uint64_t(v) & ((n == 64 ? ~0ull : (1ull << n) - 1)));
        nacc += n;
        while (nacc >= 8) {
            bytes.push_back(uint8_t(acc >> (nacc - 8)));
            nacc -= 8;
        }
    }
    void sput(int32_t v, int n) { put(uint32_t(v), n); }
    void align() { if (nacc) put(0, 8 - nacc); }
};

uint8_t flac_crc8(const uint8_t* p, size_t n) {
    uint8_t crc = 0;
    for (size_t i = 0; i < n; i++) {
        crc ^= p[i];
        for (int b = 0; b < 8; b++)
            crc = (crc & 0x80) ? uint8_t((crc << 1) ^ 0x07) : uint8_t(crc << 1);
    }
    return crc;
}

uint16_t flac_crc16(const uint8_t* p, size_t n) {
    uint16_t crc = 0;
    for (size_t i = 0; i < n; i++) {
        crc ^= uint16_t(p[i]) << 8;
        for (int b = 0; b < 8; b++)
            crc = (crc & 0x8000) ? uint16_t((crc << 1) ^ 0x8005)
                                 : uint16_t(crc << 1);
    }
    return crc;
}

void flac_utf8_number(FlacBitWriter& w, uint64_t v) {
    if (v < 0x80) { w.put(uint32_t(v), 8); return; }
    int n = 1;
    uint64_t lim = 0x800;
    while (v >= lim && n < 6) { lim <<= 5; n++; }
    // n continuation bytes
    uint32_t first = uint32_t((0xFFu << (7 - n)) & 0xFF) |
                     uint32_t(v >> (6 * n));
    w.put(first, 8);
    for (int i = n - 1; i >= 0; i--)
        w.put(0x80u | (uint32_t(v >> (6 * i)) & 0x3F), 8);
}

void flac_rice_encode(FlacBitWriter& w, const int32_t* res, uint32_t n) {
    // choose the Rice parameter from the mean magnitude; switch to the
    // Rice2 method (5-bit parameters) when 24-bit-scale residuals need
    // parameters beyond the 4-bit range
    uint64_t sum = 0;
    for (uint32_t i = 0; i < n; i++)
        sum += uint64_t(res[i] < 0 ? -(int64_t)res[i] : res[i]);
    int param = 0;
    uint64_t mean = n ? sum / n : 0;
    while ((1ull << (param + 1)) < mean + 1 && param < 30) param++;
    if (param <= 14) {
        w.put(0, 2);  // method: 4-bit Rice
        w.put(0, 4);  // partition order 0
        w.put(uint32_t(param), 4);
    } else {
        w.put(1, 2);  // method: 5-bit Rice2
        w.put(0, 4);
        w.put(uint32_t(param), 5);
    }
    for (uint32_t i = 0; i < n; i++) {
        int64_t v = res[i];
        uint64_t u = v < 0 ? (uint64_t(-(v + 1)) << 1) | 1 : uint64_t(v) << 1;
        uint64_t q = u >> param;
        for (; q >= 32; q -= 32) w.put(0, 32);
        w.put(1, int(q) + 1);  // q zeros then a 1
        if (param) w.put(uint32_t(u & ((1ull << param) - 1)), param);
    }
}

// ---- ALAC (native, from the published bitstream format) ---------------------
//
// Apple Lossless decode + encode with no external dependency, closing the
// last gap vs the reference's libsndfile backend (Libsndfile.cs:26-68 reads
// ALAC inside CAF). The bitstream layout follows the published format
// (Apple open-sourced the codec; the element syntax, adaptive Golomb-Rice
// residual coding and sign-adaptive FIR predictor are documented there and
// in every independent implementation). Validated two ways in tests/test_io:
// byte-exact round-trip through our own encoder, and cross-validated against
// a third-party ALAC implementation (libavcodec) in BOTH directions where
// its dev headers are present.

struct AlacConfig {
    uint32_t frame_length = 4096;
    int bit_depth = 16;
    int pb = 40;  // rice history multiplier
    int mb = 10;  // rice initial history
    int kb = 14;  // rice k limit
    int channels = 2;
    uint32_t sample_rate = 44100;
};

struct AlacStream {
    AlacConfig cfg;
    std::vector<int64_t> pkt_off;    // absolute byte offset per packet
    std::vector<uint32_t> pkt_size;
    int64_t priming = 0;             // leading frames to trim (usually 0)
    int64_t next_pkt = 0;
    std::vector<int32_t> ch[8];      // per-channel packet decode buffers
    std::vector<int32_t> err;        // residual scratch
    std::vector<int32_t> shift[2];   // shifted-out low bits (bytesShifted)
};

struct AlacBits {
    const uint8_t* p = nullptr;
    size_t n = 0;       // bytes
    size_t pos = 0;     // bit position
    bool fail = false;

    uint32_t get(int bits) {
        uint32_t v = 0;
        while (bits > 0) {
            if (pos >= n * 8) { fail = true; return 0; }
            size_t byte = pos >> 3;
            int off = int(pos & 7);
            int take = std::min(bits, 8 - off);
            int sh = 8 - off - take;
            v = (v << take) | uint32_t((p[byte] >> sh) & ((1u << take) - 1));
            pos += size_t(take);
            bits -= take;
        }
        return v;
    }
    int32_t sget(int bits) {
        uint32_t v = get(bits);
        if (bits <= 0 || bits >= 32) return int32_t(v);
        return int32_t(v << (32 - bits)) >> (32 - bits);
    }
    uint32_t peek(int bits) {
        size_t s = pos;
        bool f = fail;
        uint32_t v = get(bits);
        pos = s;
        fail = f;
        return v;
    }
};

inline int ilog2u(uint32_t x) { return x ? 31 - __builtin_clz(x) : 0; }
inline int32_t sext32(int64_t v, int bits) {
    if (bits >= 32) return int32_t(v);
    return int32_t(uint32_t(v) << (32 - bits)) >> (32 - bits);
}
inline int sign_of(int64_t x) { return (x > 0) - (x < 0); }

// One adaptive-Golomb value: unary prefix (up to 9 ones; a 0 terminates and
// is consumed), "economical" k-bit suffix with modulus m = 2^k - 1 (a
// suffix of 0/1 spends only k-1 bits), full-9 prefix escapes to a raw
// `bps`-bit value with no terminator.
uint32_t alac_rice_get(AlacBits& b, int k, int bps) {
    int pre = 0;
    while (pre < 9) {
        if (b.fail) return 0;
        if (b.get(1) == 0) break;
        pre++;
    }
    if (pre >= 9) return b.get(bps);
    uint32_t x = uint32_t(pre);
    if (k != 1) {
        x *= (1u << k) - 1;
        uint32_t t = b.peek(k);
        if (t > 1) {
            x += t - 1;
            b.get(k);
        } else {
            b.get(k - 1);
        }
    }
    return x;
}

// Adaptive Rice residual decode: an exponentially-smoothed history drives
// the rice parameter; near-zero history switches to zero-run coding with a
// one-shot sign modifier on the next value.
bool alac_rice_decomp(AlacBits& b, int32_t* out, uint32_t n, int bps,
                      int pb_mult, int mb0, int kb) {
    unsigned history = unsigned(mb0);
    unsigned sign_mod = 0;
    for (uint32_t i = 0; i < n; i++) {
        int k = std::min(ilog2u((history >> 9) + 3), kb);
        uint32_t x = alac_rice_get(b, k, bps);
        if (b.fail) return false;
        x += sign_mod;
        sign_mod = 0;
        out[i] = int32_t((x >> 1) ^ (~(x & 1) + 1));
        if (x > 0xFFFF) {
            history = 0xFFFF;
        } else {
            history += x * unsigned(pb_mult) -
                       ((history * unsigned(pb_mult)) >> 9);
        }
        if (history < 128 && i + 1 < n) {
            int kr = std::min(
                7 - ilog2u(history) + int((history + 16) >> 6), kb);
            uint32_t run = alac_rice_get(b, kr, 16);
            if (b.fail) return false;
            if (run > 0) {
                if (run > n - i - 1) run = n - i - 1;  // hostile-input clamp
                memset(out + i + 1, 0, run * sizeof(int32_t));
                i += run;
            }
            if (run <= 0xFFFF) sign_mod = 1;
            history = 0;
        }
    }
    return true;
}

// Sign-adaptive FIR predictor reconstruction: warm-up is first-order;
// coefficient j multiplies (out[i-order+j] - out[i-order-1]); after each
// sample the coefficients step by +-1 toward the residual's sign, draining
// the residual by the quantized contribution as they go. order 31 is the
// pure first-order special case; order 0 copies.
void alac_predict(const int32_t* err, int32_t* out, uint32_t n, int bps,
                  int16_t* coefs, int order, int quant) {
    out[0] = err[0];
    if (n <= 1) return;
    if (order == 0) {
        if (out != err) memcpy(out + 1, err + 1, (n - 1) * sizeof(int32_t));
        return;
    }
    if (order == 31) {
        for (uint32_t i = 1; i < n; i++)
            out[i] = sext32(int64_t(out[i - 1]) + err[i], bps);
        return;
    }
    uint32_t i = 1;
    for (; i <= uint32_t(order) && i < n; i++)
        out[i] = sext32(int64_t(out[i - 1]) + err[i], bps);
    for (; i < n; i++) {
        int64_t acc = 0;
        int32_t d0 = out[i - order - 1];
        int32_t* pred = out + (i - order);
        for (int j = 0; j < order; j++)
            acc += int64_t(pred[j] - d0) * coefs[j];
        int64_t v = (acc + (int64_t(1) << (quant - 1))) >> quant;
        int64_t e = err[i];
        out[i] = sext32(v + d0 + e, bps);
        int es = sign_of(e);
        if (es) {
            for (int j = 0; j < order && e * es > 0; j++) {
                int64_t dv = int64_t(d0) - pred[j];
                int s = sign_of(dv) * es;
                coefs[j] = int16_t(coefs[j] - s);
                dv *= s;
                e -= (dv >> quant) * (j + 1);
            }
        }
    }
}

// Inverse of the encoder's mid/side mix: stored (u, v) with weight w and
// shift give R = u - ((v*w) >> shift), L = v + R.
void alac_unmix_stereo(int32_t* c0, int32_t* c1, uint32_t n, int shift,
                       int w) {
    for (uint32_t i = 0; i < n; i++) {
        int32_t u = c0[i], v = c1[i];
        int32_t r = int32_t(u - ((int64_t(v) * w) >> shift));
        c0[i] = v + r;
        c1[i] = r;
    }
}

// Decode one channel element (SCE/LFE mono or CPE stereo) into out[0..nch).
// Returns samples decoded, 0 on error.
uint32_t alac_decode_element(AlacBits& b, const AlacConfig& cfg, int nch,
                             int32_t** out, AlacStream* st) {
    b.get(4);   // element instance tag
    b.get(12);  // unused header bits
    uint32_t header = b.get(4);
    int partial = int(header >> 3);
    int bytes_shifted = int((header >> 1) & 3);
    int escape = int(header & 1);
    if (b.fail || bytes_shifted == 3) return 0;
    uint32_t nsamp = cfg.frame_length;
    if (partial) nsamp = b.get(32);
    if (b.fail || nsamp == 0 || nsamp > cfg.frame_length) return 0;
    int extra = bytes_shifted * 8;
    int mixbits = 0, mixres = 0;
    if (!escape) {
        int bps = cfg.bit_depth - extra + nch - 1;
        if (bps < 1 || bps > 32) return 0;
        mixbits = int(b.get(8));
        mixres = int(int8_t(b.get(8)));
        int mode[2], quant[2], pbf[2], order[2];
        int16_t coefs[2][32];
        for (int c = 0; c < nch; c++) {
            mode[c] = int(b.get(4));
            quant[c] = int(b.get(4));
            pbf[c] = int(b.get(3));
            order[c] = int(b.get(5));
            if (order[c] != 31 && order[c] > 30) return 0;
            // Stream order is NEWEST tap first: slot [order-1] is read
            // first (the predictor loop pairs coefs[j] with the older
            // sample out[i-order+j], ffmpeg alac.c reads the table
            // reversed the same way; verified against libavcodec-encoded
            // order-4 streams, tests/test_io.py interop tests).
            for (int j = order[c] - 1; j >= 0; j--)
                coefs[c][j] = int16_t(b.get(16));
        }
        if (b.fail) return 0;
        if (extra) {
            for (int c = 0; c < nch; c++) st->shift[c].resize(nsamp);
            for (uint32_t i = 0; i < nsamp; i++)
                for (int c = 0; c < nch; c++)
                    st->shift[c][i] = int32_t(b.get(extra));
        }
        st->err.resize(nsamp);
        for (int c = 0; c < nch; c++) {
            if (!alac_rice_decomp(b, st->err.data(), nsamp, bps,
                                  (pbf[c] * cfg.pb) / 4, cfg.mb, cfg.kb))
                return 0;
            if (mode[c] == 15) {
                // two-pass: an order-31 first-order stage below the FIR
                alac_predict(st->err.data(), st->err.data(), nsamp, bps,
                             nullptr, 31, 0);
            } else if (mode[c] != 0) {
                return 0;
            }
            alac_predict(st->err.data(), out[c], nsamp, bps, coefs[c],
                         order[c], quant[c]);
        }
    } else {
        // verbatim: sample-interleaved raw values at full depth
        for (uint32_t i = 0; i < nsamp; i++)
            for (int c = 0; c < nch; c++)
                out[c][i] = b.sget(cfg.bit_depth);
        if (b.fail) return 0;
        extra = 0;
        mixres = 0;
    }
    if (nch == 2 && mixres != 0)
        alac_unmix_stereo(out[0], out[1], nsamp, mixbits, mixres);
    if (extra) {
        for (int c = 0; c < nch; c++)
            for (uint32_t i = 0; i < nsamp; i++)
                out[c][i] = int32_t((uint32_t(out[c][i]) << extra) |
                                    uint32_t(st->shift[c][i]));
    }
    return nsamp;
}

// Decode one whole packet into st->ch[]; returns frames, 0 on error.
// Standard ALAC multichannel layouts (Apple spec; same table as
// libavcodec's ff_alac_channel_layout_offsets): element k's decoded
// channel i lands at output position offsets[channels-1][pos + i], where
// pos counts decoded channels so far. 6ch, e.g., is SCE(C) CPE(L R)
// CPE(Ls Rs) SCE(LFE) with output order L R C LFE Ls Rs.
static const uint8_t kAlacChanOffsets[8][8] = {
    {0},
    {0, 1},
    {2, 0, 1},
    {2, 0, 1, 3},
    {2, 0, 1, 3, 4},
    {2, 0, 1, 4, 5, 3},
    {2, 0, 1, 4, 5, 6, 3},
    {2, 6, 7, 0, 1, 4, 5, 3},
};
// Element channel counts per layout (SCE=1, CPE=2), zero-terminated.
static const uint8_t kAlacElements[8][6] = {
    {1, 0},          {2, 0},          {1, 2, 0},       {1, 2, 1, 0},
    {1, 2, 2, 0},    {1, 2, 2, 1, 0}, {1, 2, 2, 1, 1, 0},
    {1, 2, 2, 2, 1, 0},
};

uint32_t alac_decode_packet(AlacStream* st, const uint8_t* data,
                            size_t size) {
    AlacBits b{data, size, 0, false};
    const AlacConfig& cfg = st->cfg;
    int pos = 0;  // decoded channels so far
    uint32_t nsamp = 0;
    const uint8_t* offsets = kAlacChanOffsets[cfg.channels - 1];
    for (int c = 0; c < cfg.channels; c++)
        st->ch[c].resize(cfg.frame_length);
    for (;;) {
        uint32_t tag = b.get(3);
        if (b.fail) return 0;
        if (tag == 7) break;                    // END
        int nch = (tag == 1) ? 2 : (tag == 0 || tag == 3) ? 1 : 0;
        if (nch == 0 || pos + nch > cfg.channels) return 0;
        int32_t* out[2] = {
            st->ch[offsets[pos]].data(),
            nch == 2 ? st->ch[offsets[pos + 1]].data() : nullptr,
        };
        uint32_t got = alac_decode_element(b, cfg, nch, out, st);
        if (got == 0) return 0;
        if (nsamp == 0) nsamp = got;
        else if (nsamp != got) return 0;
        pos += nch;
    }
    if (pos != cfg.channels) return 0;
    return nsamp;
}

// Parse the magic cookie: a bare 24-byte ALACSpecificConfig, optionally
// wrapped in 'frma'/'alac' atoms (and an atom version word) by Core Audio.
bool alac_parse_cookie(const std::vector<uint8_t>& kuki, AlacConfig* cfg,
                       int want_channels) {
    auto plausible = [&](const uint8_t* p, size_t left) {
        if (left < 24) return false;
        uint32_t fl = rd_u32be(p);
        int depth = p[5];
        int chans = p[9];
        uint32_t sr = rd_u32be(p + 20);
        return fl >= 1 && fl <= (1u << 20) && p[4] == 0 &&
               (depth == 16 || depth == 20 || depth == 24 || depth == 32) &&
               chans >= 1 && chans <= 8 &&
               (want_channels == 0 || chans == want_channels) &&
               sr >= 1 && sr <= uint32_t(kMaxSampleRate);
    };
    const uint8_t* base = kuki.data();
    size_t n = kuki.size();
    for (size_t off : {size_t(0), size_t(4), size_t(12), size_t(16),
                       size_t(24), size_t(28)}) {
        if (off >= n || !plausible(base + off, n - off)) continue;
        const uint8_t* p = base + off;
        cfg->frame_length = rd_u32be(p);
        cfg->bit_depth = p[5];
        cfg->pb = p[6];
        cfg->mb = p[7];
        cfg->kb = p[8];
        cfg->channels = p[9];
        cfg->sample_rate = rd_u32be(p + 20);
        if (cfg->pb < 1 || cfg->kb < 1 || cfg->kb > 30) return false;
        return true;
    }
    return false;
}

bool finish_alac_caf(Decoder* d, AlacCafPieces& pieces) {
    if (pieces.kuki.empty() || pieces.pakt.size() < 24 ||
        pieces.data_start < 0)
        return false;
    AlacStream* st = new AlacStream();
    if (!alac_parse_cookie(pieces.kuki, &st->cfg, pieces.channels)) {
        delete st;
        return false;
    }
    const uint8_t* pk = pieces.pakt.data();
    int64_t n_pkts = int64_t((uint64_t(rd_u32be(pk)) << 32) | rd_u32be(pk + 4));
    int64_t valid = int64_t((uint64_t(rd_u32be(pk + 8)) << 32) |
                            rd_u32be(pk + 12));
    int32_t priming = int32_t(rd_u32be(pk + 16));
    if (n_pkts < 0 || n_pkts > (64 << 20) || valid < 0 || priming < 0) {
        delete st;
        return false;
    }
    // BER-varint packet sizes -> absolute offsets.
    size_t p = 24;
    int64_t off = pieces.data_start;
    int64_t data_end = pieces.data_start +
                       (pieces.data_bytes >= 0 ? pieces.data_bytes : 0);
    st->pkt_off.reserve(size_t(n_pkts));
    st->pkt_size.reserve(size_t(n_pkts));
    for (int64_t i = 0; i < n_pkts; i++) {
        uint64_t v = 0;
        int nb = 0;
        for (;;) {
            if (p >= pieces.pakt.size() || ++nb > 9) { delete st; return false; }
            uint8_t byte = pieces.pakt[p++];
            v = (v << 7) | (byte & 0x7F);
            if (!(byte & 0x80)) break;
        }
        if (v == 0 || v > (64u << 20) || off + int64_t(v) > data_end) {
            delete st;
            return false;
        }
        st->pkt_off.push_back(off);
        st->pkt_size.push_back(uint32_t(v));
        off += int64_t(v);
    }
    int64_t max_frames = n_pkts * int64_t(st->cfg.frame_length);
    if (valid == 0) valid = max_frames;
    if (valid + priming > max_frames) {
        delete st;
        return false;
    }
    // Some muxers (ffmpeg's cafenc) write mNumberValidFrames lazily as
    // packets*frame_length even when the final packet is partial. ALAC
    // elements carry their true sample count in-stream, so when the
    // header claims an exactly-full file, probe the last packet and trust
    // the bitstream over the header.
    if (n_pkts > 0 && valid + priming == max_frames) {
        size_t last = size_t(n_pkts - 1);
        std::vector<uint8_t> buf(st->pkt_size[last]);
        if (dseek(d, st->pkt_off[last]) && dread(d, buf.data(), buf.size())) {
            uint32_t nsamp = alac_decode_packet(st, buf.data(), buf.size());
            if (nsamp > 0)
                valid = (n_pkts - 1) * int64_t(st->cfg.frame_length) +
                        int64_t(nsamp) - priming;
        }
    }
    st->priming = priming;
    d->alac = st;
    d->backend = 6;
    d->channels = st->cfg.channels;
    d->bits = st->cfg.bit_depth;
    d->format = 0;
    d->data_start = pieces.data_start;
    d->total_frames = valid;
    d->frame_pos = 0;
    return true;
}

int64_t read_alac(Decoder* d, float* out, int64_t frames) {
    AlacStream* st = (AlacStream*)d->alac;
    int ch = d->channels;
    float scale = 1.0f / float(1u << (st->cfg.bit_depth - 1));
    int64_t got = 0;
    while (got < frames) {
        if (d->carry_pos < d->carry.size()) {
            int64_t have = int64_t(d->carry.size() - d->carry_pos) / ch;
            int64_t take = std::min(have, frames - got);
            memcpy(out + got * ch, d->carry.data() + d->carry_pos,
                   size_t(take) * ch * 4);
            d->carry_pos += size_t(take) * ch;
            got += take;
            continue;
        }
        if (d->frame_pos + got >= d->total_frames) break;
        if (st->next_pkt >= int64_t(st->pkt_off.size())) break;
        int64_t pkt = st->next_pkt++;
        std::vector<uint8_t> buf(st->pkt_size[size_t(pkt)]);
        if (!dseek(d, st->pkt_off[size_t(pkt)]) ||
            !dread(d, buf.data(), buf.size()))
            break;
        uint32_t nsamp = alac_decode_packet(st, buf.data(), buf.size());
        if (nsamp == 0) break;
        // Trim priming at the head and validity at the tail.
        int64_t pkt_start = pkt * int64_t(st->cfg.frame_length) - st->priming;
        int64_t lo = pkt_start < 0 ? -pkt_start : 0;
        int64_t hi = std::min<int64_t>(nsamp,
                                       d->total_frames - pkt_start);
        if (hi <= lo) continue;
        d->carry.resize(size_t(hi - lo) * ch);
        d->carry_pos = 0;
        for (int64_t i = lo; i < hi; i++)
            for (int c = 0; c < ch; c++)
                d->carry[size_t(i - lo) * ch + c] =
                    float(st->ch[c][size_t(i)]) * scale;
    }
    d->frame_pos += got;
    return got;
}

int alac_seek(Decoder* d, int64_t frame) {
    AlacStream* st = (AlacStream*)d->alac;
    int64_t fl = int64_t(st->cfg.frame_length);
    int64_t pkt = (frame + st->priming) / fl;
    if (pkt >= int64_t(st->pkt_off.size()))
        pkt = int64_t(st->pkt_off.size()) - 1;
    if (pkt < 0) pkt = 0;
    st->next_pkt = pkt;
    d->carry.clear();
    d->carry_pos = 0;
    d->frame_pos = std::max<int64_t>(0, pkt * fl - st->priming);
    // Packet-exact position, then decode-and-discard the sub-packet rest.
    while (d->frame_pos < frame) {
        int64_t skip = std::min<int64_t>(frame - d->frame_pos, 4096);
        std::vector<float> tmp(size_t(skip) * d->channels);
        if (read_alac(d, tmp.data(), skip) <= 0) return -1;
    }
    return 0;
}

// ---- ALAC encoder -----------------------------------------------------------
//
// Mirrors the decoder's exact control flow (rice history, zero-run, sign
// modifier) in reverse so round-trips are byte-deterministic. Predictor:
// the order-31 first-order special case; stereo packs u = L, v = L - R
// (mixbits 0, mixres 1 -> R = u - v, L = v + R). Any packet whose residual
// escapes the bps range is written verbatim (the escape bit), as Apple's
// encoder does on overflow.

struct AlacBitWriter {
    std::vector<uint8_t> bytes;
    uint64_t acc = 0;
    int nacc = 0;
    void put(uint32_t v, int n) {
        acc = (acc << n) | (uint64_t(v) & ((n >= 64 ? ~0ull : (1ull << n) - 1)));
        nacc += n;
        while (nacc >= 8) {
            bytes.push_back(uint8_t(acc >> (nacc - 8)));
            nacc -= 8;
        }
    }
    void align() {
        if (nacc) put(0, 8 - nacc);
    }
};

// Encode one value with the decoder's exact rice geometry. Returns false if
// the value needs the escape and does not fit in bps bits.
bool alac_rice_put(AlacBitWriter& w, uint32_t x, int k, int bps) {
    uint32_t m = (1u << k) - 1;
    if (k == 1) m = 1;
    uint32_t pre = x / m;
    if (pre > 8) {
        if (bps < 32 && x >= (1u << bps)) return false;
        w.put(0x1FF, 9);  // nine ones, no terminator
        w.put(x, bps);
        return true;
    }
    // unary prefix + terminator
    w.put((1u << (pre + 1)) - 2, int(pre) + 1);
    if (k != 1) {
        uint32_t r = x - pre * m;
        if (r > 0) w.put(r + 1, k);
        else w.put(0, k - 1);
    }
    return true;
}

// Residual sequence -> adaptive rice stream (decoder's mirror). Returns
// false on escape-overflow (caller falls back to a verbatim packet).
bool alac_rice_comp(AlacBitWriter& w, const int32_t* res, uint32_t n,
                    int bps, int pb_mult, int mb0, int kb) {
    unsigned history = unsigned(mb0);
    unsigned sign_mod = 0;
    for (uint32_t i = 0; i < n; i++) {
        int k = std::min(ilog2u((history >> 9) + 3), kb);
        int32_t e = res[i];
        uint32_t zz = (uint32_t(e) << 1) ^ uint32_t(e >> 31);  // zigzag
        if (zz < sign_mod) return false;  // cannot represent (never happens)
        uint32_t x = zz - sign_mod;
        sign_mod = 0;
        if (!alac_rice_put(w, x, k, bps)) return false;
        // History tracks the value the DECODER reconstructs (zz = x +
        // sign_mod there), not the raw coded value, or the adaptive k
        // diverges after every zero run.
        if (zz > 0xFFFF) {
            history = 0xFFFF;
        } else {
            history += zz * unsigned(pb_mult) -
                       ((history * unsigned(pb_mult)) >> 9);
        }
        if (history < 128 && i + 1 < n) {
            // count the zero run that follows
            uint32_t run = 0;
            while (run < n - i - 1 && run < 0xFFFE && res[i + 1 + run] == 0)
                run++;
            int kr = std::min(
                7 - ilog2u(history) + int((history + 16) >> 6), kb);
            if (!alac_rice_put(w, run, kr, 16)) return false;
            i += run;
            sign_mod = 1;
            history = 0;
        }
    }
    return true;
}

// One compressed CPE/SCE element for one packet; falls back to verbatim on
// rice escape overflow. samples: per-channel int32 at bit_depth.
void alac_encode_element(AlacBitWriter& w, const AlacConfig& cfg,
                         const int32_t* const* chans, int nch, uint32_t n) {
    int tag = (nch == 2) ? 1 : 0;  // CPE : SCE
    int partial = n < cfg.frame_length ? 1 : 0;
    int bps = cfg.bit_depth + nch - 1;

    // Try the compressed form into a scratch writer first.
    AlacBitWriter body;
    bool ok = true;
    std::vector<int32_t> u(n), v(n), res(n);
    if (nch == 2) {
        // u = L, v = L - R with mixbits 0 / mixres 1:
        // decoder computes R = u - v, L = v + R.
        for (uint32_t i = 0; i < n; i++) {
            u[i] = chans[0][i];
            v[i] = chans[0][i] - chans[1][i];
        }
    } else {
        for (uint32_t i = 0; i < n; i++) u[i] = chans[0][i];
    }
    const int32_t* coded[2] = {u.data(), v.data()};
    if (nch == 2) {
        body.put(0, 8);                    // mixbits
        body.put(uint32_t(1) & 0xFF, 8);   // mixres = 1
    } else {
        body.put(0, 8);
        body.put(0, 8);
    }
    for (int c = 0; c < nch; c++) {
        body.put(0, 4);   // prediction mode 0
        // quant is unused by the order-31 first-order path, but strict
        // decoders (libavcodec) reject lpc_quant == 0 outright (the
        // rounding term 1 << (quant-1) is UB at 0) — write a benign 9.
        body.put(9, 4);
        body.put(4, 3);   // rice history mult factor (4/4 = neutral)
        body.put(31, 5);  // order 31: pure first-order predictor
        // The coefficient table is present in the stream for ANY order,
        // including the order-31 special case (decoders read `order` 16-bit
        // slots before the residuals; the first-order path then ignores
        // them). 31 zero slots keep the layout spec-exact.
        for (int j = 0; j < 31; j++) body.put(0, 16);
    }
    for (int c = 0; c < nch && ok; c++) {
        const int32_t* x = coded[c];
        res[0] = x[0];
        for (uint32_t i = 1; i < n; i++) res[i] = x[i] - x[i - 1];
        ok = alac_rice_comp(body, res.data(), n, bps, cfg.pb, cfg.mb,
                            cfg.kb);
    }

    w.put(uint32_t(tag), 3);
    w.put(0, 4);   // element instance
    w.put(0, 12);  // unused header
    if (ok) {
        w.put(uint32_t((partial << 3) | 0), 4);  // bytesShifted 0, escape 0
        if (partial) w.put(n, 32);
        for (uint8_t byte : body.bytes) w.put(byte, 8);
        if (body.nacc) w.put(uint32_t(body.acc & ((1u << body.nacc) - 1)),
                             body.nacc);
    } else {
        // verbatim fallback (Apple's overflow path): escape bit set,
        // sample-interleaved raw values at full depth.
        w.put(uint32_t((partial << 3) | 1), 4);
        if (partial) w.put(n, 32);
        for (uint32_t i = 0; i < n; i++)
            for (int c = 0; c < nch; c++)
                w.put(uint32_t(chans[c][i]), cfg.bit_depth);
    }
}

void alac_encode_packet(AlacBitWriter& w, const AlacConfig& cfg,
                        const int32_t* const* chans, uint32_t n) {
    // Standard element layout + channel-position mapping (see
    // kAlacChanOffsets): e.g. 6ch emits SCE(C) CPE(L R) CPE(Ls Rs)
    // SCE(LFE) with the input channels in layout order L R C LFE Ls Rs —
    // the layout strict decoders (libavcodec) require.
    const uint8_t* offsets = kAlacChanOffsets[cfg.channels - 1];
    const uint8_t* els = kAlacElements[cfg.channels - 1];
    int pos = 0;
    for (int e = 0; els[e]; e++) {
        int nch = els[e];
        const int32_t* el[2] = {
            chans[offsets[pos]],
            nch == 2 ? chans[offsets[pos + 1]] : nullptr,
        };
        alac_encode_element(w, cfg, el, nch, n);
        pos += nch;
    }
    w.put(7, 3);  // END
    w.align();
}

// ---- format sniffing + unified open -----------------------------------------

bool open_any(Decoder* d) {
    uint8_t magic[4] = {0, 0, 0, 0};
    dseek(d, 0);
    dread_some(d, magic, 4);
    if (memcmp(magic, "RIFF", 4) == 0 || memcmp(magic, "FORM", 4) == 0) {
        if (!parse(d)) return false;
        dseek(d, d->data_start);
        return true;
    }
    if (memcmp(magic, "OggS", 4) == 0) {
        // Opus vs Vorbis: the first page's payload starts at byte 28 for a
        // single-segment BOS page; "OpusHead" vs "\x01vorbis" identifies
        // the codec (both begin their ID header there).
        uint8_t probe[64] = {0};
        dseek(d, 0);
        size_t got = dread_some(d, probe, sizeof(probe));
        bool is_opus = false;
        for (size_t i = 28; got >= 8 && i + 8 <= got && i < 40; i++) {
            if (memcmp(probe + i, "OpusHead", 8) == 0) { is_opus = true; break; }
        }
        dseek(d, 0);
        if (is_opus) return open_opus(d);
        return open_vorbis(d);
    }
    if (memcmp(magic, "fLaC", 4) == 0) return open_flac(d);
    if (memcmp(magic, ".snd", 4) == 0) {
        if (!parse_au(d)) return false;
        dseek(d, d->data_start);
        return true;
    }
    if (memcmp(magic, "caff", 4) == 0) {
        if (!parse_caf(d)) return false;
        dseek(d, d->data_start);
        return true;
    }
    if (memcmp(magic, "riff", 4) == 0) {  // Wave64 GUID starts 'riff'
        if (!parse_w64(d)) return false;
        dseek(d, d->data_start);
        return true;
    }
    if (memcmp(magic, "RF64", 4) == 0) {
        if (!parse_rf64(d)) return false;
        dseek(d, d->data_start);
        return true;
    }
    // MP3: ID3 tag or an MPEG audio sync word right at the start. (mpg123
    // itself would resync into arbitrary junk, so gate on the magic.)
    if (memcmp(magic, "ID3", 3) == 0 ||
        (magic[0] == 0xFF && (magic[1] & 0xE0) == 0xE0)) {
        return open_mp3(d);
    }
    return false;
}

}  // namespace

extern "C" {

void* gac_open_file(const char* path) {
    Decoder* d = new Decoder();
    d->file = fopen(path, "rb");
    if (d->file && open_any(d)) return d;
    if (d->file) fclose(d->file);
    delete d;
    return nullptr;
}

void* gac_open_memory(const uint8_t* data, size_t size) {
    Decoder* d = new Decoder();
    d->mem = data;
    d->mem_size = size;
    if (open_any(d)) return d;
    delete d;
    return nullptr;
}

// Capability probes (which system codec libraries resolved).
int gac_has_mp3() { return mpg123_api().ok ? 1 : 0; }
int gac_has_vorbis() { return vorbis_api().ok ? 1 : 0; }
int gac_has_mp3_encode() { return lame_api().ok ? 1 : 0; }
int gac_has_vorbis_encode() { return vorbisenc_api().ok ? 1 : 0; }
int gac_has_flac() { return 1; }         // native decoder, no system library
int gac_has_flac_encode() { return 1; }  // native encoder
int gac_has_adpcm() { return 1; }        // native IMA/MS ADPCM decoder
int gac_has_opus() { return opus_api().ok ? 1 : 0; }
int gac_has_opus_encode() { return opus_api().ok ? 1 : 0; }
int gac_has_alac() { return 1; }         // native decoder, no system library
int gac_has_alac_encode() { return 1; }  // native encoder

// Encode interleaved float32 frames as ALAC in CAF (desc/kuki/pakt/data).
// bits: 16 or 24. Returns 0 on success.
int gac_write_alac(const char* path, const float* data, int64_t frames,
                   int channels, int sample_rate, int bits) {
    if (channels < 1 || channels > 8 || frames <= 0 || sample_rate < 1)
        return -1;
    if (bits != 16 && bits != 24) return -1;
    AlacConfig cfg;
    cfg.frame_length = 4096;
    cfg.bit_depth = bits;
    cfg.channels = channels;
    cfg.sample_rate = uint32_t(sample_rate);

    const double scale = double(1u << (bits - 1));
    const int32_t lim = int32_t((1u << (bits - 1)) - 1);
    const size_t nchan = size_t(channels);
    std::vector<std::vector<int32_t>> chans(nchan);
    std::vector<const int32_t*> chp(nchan);
    std::vector<uint8_t> payload;
    std::vector<uint32_t> pkt_sizes;
    int64_t n_pkts = (frames + cfg.frame_length - 1) / cfg.frame_length;
    if (n_pkts == 0) n_pkts = 1;  // a single (empty-trimmed) packet
    for (int64_t pkt = 0; pkt < n_pkts; pkt++) {
        int64_t start = pkt * int64_t(cfg.frame_length);
        uint32_t n = uint32_t(std::min<int64_t>(
            cfg.frame_length, std::max<int64_t>(frames - start, 1)));
        for (int c = 0; c < channels; c++) {
            chans[size_t(c)].assign(n, 0);
            for (uint32_t i = 0; i < n; i++) {
                int64_t fi = start + int64_t(i);
                float v = fi < frames ? data[fi * channels + c] : 0.0f;
                double s = double(v) * scale;
                int32_t q = int32_t(lrint(s));
                if (q > lim) q = lim;
                if (q < -lim - 1) q = -lim - 1;
                chans[size_t(c)][i] = q;
            }
            chp[size_t(c)] = chans[size_t(c)].data();
        }
        AlacBitWriter w;
        alac_encode_packet(w, cfg, chp.data(), n);
        pkt_sizes.push_back(uint32_t(w.bytes.size()));
        payload.insert(payload.end(), w.bytes.begin(), w.bytes.end());
    }

    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    auto w32 = [&](uint32_t v) {
        uint8_t b[4] = {uint8_t(v >> 24), uint8_t(v >> 16), uint8_t(v >> 8),
                        uint8_t(v)};
        fwrite(b, 1, 4, f);
    };
    auto w64 = [&](uint64_t v) {
        w32(uint32_t(v >> 32));
        w32(uint32_t(v));
    };
    auto w16 = [&](uint16_t v) {
        uint8_t b[2] = {uint8_t(v >> 8), uint8_t(v)};
        fwrite(b, 1, 2, f);
    };
    fwrite("caff", 1, 4, f);
    w16(1);  // file version
    w16(0);  // file flags
    // desc
    fwrite("desc", 1, 4, f);
    w64(32);
    double sr = double(sample_rate);
    uint64_t sru;
    memcpy(&sru, &sr, 8);
    w64(sru);
    fwrite("alac", 1, 4, f);
    w32(0);                  // format flags
    w32(0);                  // bytes per packet (variable)
    w32(cfg.frame_length);   // frames per packet
    w32(uint32_t(channels));
    w32(0);                  // bits per channel: 0 for compressed (the
                             // cookie carries the real depth)
    // kuki: bare 24-byte ALACSpecificConfig
    fwrite("kuki", 1, 4, f);
    w64(24);
    w32(cfg.frame_length);
    {
        uint8_t b[6] = {0, uint8_t(bits), uint8_t(cfg.pb), uint8_t(cfg.mb),
                        uint8_t(cfg.kb), uint8_t(channels)};
        fwrite(b, 1, 6, f);
    }
    w16(255);                          // maxRun
    w32(0);                            // maxFrameBytes (0 = unknown)
    w32(0);                            // avgBitRate
    w32(uint32_t(sample_rate));
    // pakt
    std::vector<uint8_t> varints;
    for (uint32_t s : pkt_sizes) {
        uint8_t tmp[5];
        int nb = 0;
        uint32_t v = s;
        do {
            tmp[nb++] = uint8_t(v & 0x7F);
            v >>= 7;
        } while (v);
        for (int i = nb - 1; i >= 0; i--)
            varints.push_back(uint8_t(tmp[i] | (i ? 0x80 : 0)));
    }
    fwrite("pakt", 1, 4, f);
    w64(24 + varints.size());
    w64(uint64_t(n_pkts));
    w64(uint64_t(frames));             // valid frames
    w32(0);                            // priming
    w32(uint32_t(n_pkts * int64_t(cfg.frame_length) - frames));  // remainder
    fwrite(varints.data(), 1, varints.size(), f);
    // data
    fwrite("data", 1, 4, f);
    w64(4 + payload.size());
    w32(0);  // edit count
    fwrite(payload.data(), 1, payload.size(), f);
    fclose(f);
    return 0;
}

// Encode interleaved float32 frames as an Ogg Opus file (RFC 7845, mapping
// family 0, 20 ms frames). sample_rate must be one of Opus's native rates
// (8/12/16/24/48 kHz); output always decodes at 48 kHz. Returns 0 on
// success, -1 on error/unavailable codec.
int gac_write_opus(const char* path, const float* data, int64_t frames,
                   int channels, int sample_rate, int bitrate_bps) {
    OpusApi& a = opus_api();
    if (!a.ok || channels < 1 || channels > 2 || frames < 0) return -1;
    if (sample_rate != 8000 && sample_rate != 12000 && sample_rate != 16000 &&
        sample_rate != 24000 && sample_rate != 48000)
        return -1;
    if (bitrate_bps <= 0) bitrate_bps = 96000;
    int err = 0;
    void* enc = a.encoder_create(sample_rate, channels, 2049 /*AUDIO*/, &err);
    if (!enc || err != 0) return -1;
    a.encoder_ctl(enc, 4002 /*OPUS_SET_BITRATE*/, bitrate_bps);
    int lookahead = 0;
    a.encoder_ctl(enc, 4027 /*OPUS_GET_LOOKAHEAD*/, &lookahead);
    const int up = 48000 / sample_rate;
    const uint16_t preskip48 = uint16_t(lookahead * up);

    FILE* f = fopen(path, "wb");
    if (!f) { a.encoder_destroy(enc); return -1; }
    std::vector<uint8_t> osbuf(kOggStateSize);
    a.stream_init(osbuf.data(), 0x6F707573);
    int rc = 0;
    OggPage pg;
    auto write_pages = [&](bool flush) {
        for (;;) {
            int r = flush ? a.stream_flush(osbuf.data(), &pg)
                          : a.stream_pageout(osbuf.data(), &pg);
            if (r == 0) break;
            if (fwrite(pg.header, 1, size_t(pg.header_len), f) !=
                    size_t(pg.header_len) ||
                fwrite(pg.body, 1, size_t(pg.body_len), f) !=
                    size_t(pg.body_len)) {
                rc = -1;
                break;
            }
        }
    };

    // OpusHead (own page) + OpusTags (own page).
    uint8_t head[19];
    memcpy(head, "OpusHead", 8);
    head[8] = 1;
    head[9] = uint8_t(channels);
    head[10] = uint8_t(preskip48 & 0xFF);
    head[11] = uint8_t(preskip48 >> 8);
    uint32_t insr = uint32_t(sample_rate);
    memcpy(head + 12, &insr, 4);
    head[16] = head[17] = 0;  // output gain 0 dB
    head[18] = 0;             // mapping family 0
    OggPacket pkt{};
    pkt.packet = head;
    pkt.bytes = 19;
    pkt.b_o_s = 1;
    pkt.packetno = 0;
    a.stream_packetin(osbuf.data(), &pkt);
    write_pages(true);
    static const char vendor[] = "gacodec";
    uint8_t tags[8 + 4 + sizeof(vendor) - 1 + 4];
    memcpy(tags, "OpusTags", 8);
    uint32_t vlen = uint32_t(sizeof(vendor) - 1);
    memcpy(tags + 8, &vlen, 4);
    memcpy(tags + 12, vendor, vlen);
    memset(tags + 12 + vlen, 0, 4);  // zero user comments
    pkt = OggPacket{};
    pkt.packet = tags;
    pkt.bytes = long(sizeof(tags));
    pkt.packetno = 1;
    a.stream_packetin(osbuf.data(), &pkt);
    write_pages(true);

    const int fsz = sample_rate / 50;  // 20 ms
    const int64_t total48 = frames * up;
    // Encode past the input by the lookahead so the decoder still has
    // `frames` samples left after trimming preskip from the front.
    const int64_t enc_end = frames + lookahead;
    std::vector<float> frame_buf(size_t(fsz) * channels);
    std::vector<uint8_t> out(8192);
    int64_t pos = 0;
    // granulepos = total 48 kHz samples decodable through this packet; the
    // preskip junk at the stream head is part of that count already, so gp
    // starts at ZERO (an opusfile-style demuxer seeks at gp - preskip, and
    // seeding gp with preskip48 would offset every intermediate page by it).
    int64_t gp = 0;
    int64_t packetno = 2;
    while (pos < enc_end && rc == 0) {
        int64_t n = frames - pos < fsz ? frames - pos : fsz;
        if (n < 0) n = 0;
        if (n > 0)
            memcpy(frame_buf.data(), data + size_t(pos) * channels,
                   size_t(n) * channels * sizeof(float));
        if (n < fsz)
            memset(frame_buf.data() + size_t(n) * channels, 0,
                   size_t(fsz - n) * channels * sizeof(float));
        int32_t bytes = a.encode_float(enc, frame_buf.data(), fsz, out.data(),
                                       int32_t(out.size()));
        if (bytes < 0) { rc = -1; break; }
        pos += fsz;
        bool last = pos >= enc_end;
        gp += int64_t(fsz) * up;
        pkt = OggPacket{};
        pkt.packet = out.data();
        pkt.bytes = long(bytes);
        pkt.e_o_s = last ? 1 : 0;
        // final granulepos = preskip + source length, signalling how many
        // trailing padding samples to trim (RFC 7845 section 4.5)
        pkt.granulepos = last ? int64_t(preskip48) + total48 : gp;
        pkt.packetno = packetno++;
        a.stream_packetin(osbuf.data(), &pkt);
        write_pages(last);
    }
    a.stream_clear(osbuf.data());
    a.encoder_destroy(enc);
    fclose(f);
    return rc;
}

// Encode interleaved float32 frames as a FLAC file (fixed predictors 0-2 +
// Rice residuals, fixed 4096-sample blocks). bits: 16 or 24. Returns 0 on
// success. Parity surface: libsndfile SF_FORMAT_FLAC write support.
int gac_write_flac(const char* path, const float* data, int64_t frames,
                   int channels, int sample_rate, int bits) {
    if (channels < 1 || channels > 8 || frames < 0) return -1;
    if (bits != 16 && bits != 24) return -1;
    if (sample_rate < 1 || sample_rate >= (1 << 20)) return -1;
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    const uint32_t BS = 4096;

    // fLaC + STREAMINFO (last metadata block), MD5 unset (all zero = unknown)
    uint8_t hdr[4 + 4 + 34] = {0};
    memcpy(hdr, "fLaC", 4);
    hdr[4] = 0x80;  // last block, type 0
    hdr[7] = 34;
    uint8_t* si = hdr + 8;
    si[0] = BS >> 8; si[1] = BS & 0xFF;   // min blocksize
    si[2] = BS >> 8; si[3] = BS & 0xFF;   // max blocksize
    // min/max framesize: 0 = unknown (bytes 4-9 already zero)
    uint32_t sr = uint32_t(sample_rate);
    si[10] = uint8_t(sr >> 12);
    si[11] = uint8_t(sr >> 4);
    si[12] = uint8_t((sr & 0xF) << 4) | uint8_t((channels - 1) << 1) |
             uint8_t((bits - 1) >> 4);
    uint64_t total = uint64_t(frames);
    si[13] = uint8_t(((bits - 1) & 0xF) << 4) | uint8_t((total >> 32) & 0xF);
    si[14] = uint8_t(total >> 24);
    si[15] = uint8_t(total >> 16);
    si[16] = uint8_t(total >> 8);
    si[17] = uint8_t(total);
    if (fwrite(hdr, 1, sizeof(hdr), f) != sizeof(hdr)) { fclose(f); return -1; }

    const int32_t maxv = (1 << (bits - 1)) - 1;
    const int32_t minv = -(1 << (bits - 1));
    // double-precision quantization: at 24-bit scale a float32 product has
    // less resolution than the target grid
    const double scale = double(1 << (bits - 1));
    std::vector<int32_t> chan(BS);
    std::vector<int32_t> res(BS);
    uint64_t frame_no = 0;
    int64_t pos = 0;
    int rc = 0;
    while (pos < frames || (frames == 0 && frame_no == 0)) {
        uint32_t bs = uint32_t(std::min<int64_t>(BS, frames - pos));
        if (bs == 0) break;
        FlacBitWriter w;
        // frame header: sync + fixed blocking
        w.put(0x3FFE, 14);
        w.put(0, 1);  // reserved
        w.put(0, 1);  // fixed blocksize stream
        w.put(bs == BS ? 12u : 7u, 4);       // 4096 = 256<<4; else 16-bit-1
        w.put(0, 4);                          // sample rate: from STREAMINFO
        w.put(uint32_t(channels - 1), 4);     // independent channels
        w.put(bits == 16 ? 4u : 6u, 3);
        w.put(0, 1);
        flac_utf8_number(w, frame_no);
        if (bs != BS) w.put(bs - 1, 16);
        w.bytes.push_back(flac_crc8(w.bytes.data(), w.bytes.size()));

        for (int c = 0; c < channels; c++) {
            for (uint32_t i = 0; i < bs; i++) {
                double v = double(data[(pos + i) * channels + c]) * scale;
                int32_t q = int32_t(lrint(v));
                chan[i] = q < minv ? minv : (q > maxv ? maxv : q);
            }
            // pick the fixed predictor (0-2) with the smallest |residual|
            int best_order = 0;
            uint64_t best_cost = ~0ull;
            bool constant = true;
            for (uint32_t i = 1; i < bs; i++)
                if (chan[i] != chan[0]) { constant = false; break; }
            if (constant) {
                w.put(0, 1);
                w.put(0, 6);  // CONSTANT
                w.put(0, 1);
                w.sput(chan[0], bits);
                continue;
            }
            int max_order = bs > 2 ? 2 : int(bs) - 1;
            for (int order = 0; order <= max_order; order++) {
                uint64_t cost = 0;
                for (uint32_t i = uint32_t(order); i < bs; i++) {
                    int64_t r = chan[i];
                    if (order >= 1) r -= chan[i - 1];
                    if (order == 2) r -= int64_t(chan[i - 1]) - chan[i - 2];
                    cost += uint64_t(r < 0 ? -r : r);
                }
                if (cost < best_cost) { best_cost = cost; best_order = order; }
            }
            for (uint32_t i = uint32_t(best_order); i < bs; i++) {
                int64_t r = chan[i];
                if (best_order >= 1) r -= chan[i - 1];
                if (best_order == 2) r -= int64_t(chan[i - 1]) - chan[i - 2];
                res[i - best_order] = int32_t(r);
            }
            w.put(0, 1);
            w.put(0x08u | uint32_t(best_order), 6);  // FIXED
            w.put(0, 1);                              // no wasted bits
            for (int i = 0; i < best_order; i++) w.sput(chan[i], bits);
            flac_rice_encode(w, res.data(), bs - uint32_t(best_order));
        }
        w.align();
        uint16_t crc = flac_crc16(w.bytes.data(), w.bytes.size());
        w.bytes.push_back(uint8_t(crc >> 8));
        w.bytes.push_back(uint8_t(crc));
        if (fwrite(w.bytes.data(), 1, w.bytes.size(), f) != w.bytes.size()) {
            rc = -1;
            break;
        }
        pos += bs;
        frame_no++;
    }
    fclose(f);
    return rc;
}

int gac_channels(void* h) { return ((Decoder*)h)->channels; }
int gac_sample_rate(void* h) { return ((Decoder*)h)->sample_rate; }
int64_t gac_frames(void* h) { return ((Decoder*)h)->total_frames; }

// Read up to `frames` interleaved float32 frames; returns frames read.
int64_t gac_read_f32(void* h, float* out, int64_t frames) {
    Decoder* d = (Decoder*)h;
    if (d->backend == 1) return read_mp3(d, out, frames);
    if (d->backend == 2) return read_vorbis(d, out, frames);
    if (d->backend == 3) {
        int64_t avail = d->total_frames - d->frame_pos;
        if (d->total_frames > 0 && frames > avail) frames = avail;
        return frames > 0 ? read_flac(d, out, frames) : 0;
    }
    if (d->backend == 4) return read_adpcm(d, out, frames);
    if (d->backend == 5) return read_opus(d, out, frames);
    if (d->backend == 6) {
        int64_t avail = d->total_frames - d->frame_pos;
        if (frames > avail) frames = avail;
        return frames > 0 ? read_alac(d, out, frames) : 0;
    }
    int64_t avail = d->total_frames - d->frame_pos;
    if (frames > avail) frames = avail;
    if (frames <= 0) return 0;
    size_t bpf = d->bytes_per_frame();
    size_t bps = size_t(d->bits / 8);
    std::vector<uint8_t> buf(size_t(frames) * bpf);
    if (!dread(d, buf.data(), buf.size())) {
        // Partial read (e.g. a file truncated after open): the stream may
        // have consumed a fraction of a frame — re-seek to the last known
        // frame boundary so the next call stays byte-aligned instead of
        // decoding rotated channels from mid-frame.
        dseek(d, d->data_start + d->frame_pos * int64_t(bpf));
        return 0;
    }
    const uint8_t* p = buf.data();
    int64_t n = frames * d->channels;
    for (int64_t i = 0; i < n; i++, p += bps) {
        out[i] = cvt_sample(p, d->bits, d->format);
    }
    d->frame_pos += frames;
    return frames;
}

// Seek to an absolute frame. Returns 0 on success.
int gac_seek(void* h, int64_t frame) {
    Decoder* d = (Decoder*)h;
    if (frame < 0) frame = 0;
    if (frame > d->total_frames) frame = d->total_frames;
    if (d->backend == 1) {
        if (mpg123_api().seek(d->mh, off_t(frame), SEEK_SET) < 0) return -1;
        d->frame_pos = frame;
        return 0;
    }
    if (d->backend == 2) {
        d->carry.clear();
        d->carry_pos = 0;
        if (vorbis_api().pcm_seek(d->vf, frame) != 0) return -1;
        d->frame_pos = frame;
        return 0;
    }
    if (d->backend == 3) return flac_seek(d, frame);
    if (d->backend == 4) {  // block-exact: decode resumes mid-block
        d->frame_pos = frame;
        return 0;
    }
    if (d->backend == 5) return opus_seek(d, frame);
    if (d->backend == 6) return alac_seek(d, frame);
    if (!dseek(d, d->data_start + frame * int64_t(d->bytes_per_frame()))) return -1;
    d->frame_pos = frame;
    return 0;
}

int64_t gac_tell(void* h) { return ((Decoder*)h)->frame_pos; }

void gac_close(void* h) {
    Decoder* d = (Decoder*)h;
    if (d->backend == 1 && d->mh) {
        mpg123_api().close(d->mh);
        mpg123_api().delete_(d->mh);
    }
    if (d->backend == 2 && d->vf) {
        vorbis_api().clear(d->vf);
        free(d->vf);
    }
    if (d->backend == 3 && d->flac) delete (FlacStream*)d->flac;
    if (d->backend == 5 && d->opus) delete (OpusStream*)d->opus;
    if (d->backend == 6 && d->alac) delete (AlacStream*)d->alac;
    if (d->file) fclose(d->file);
    delete d;
}

// Encode interleaved float32 frames as a PCM16 or float32 WAV file.
// fmt: 1 = pcm16, 3 = float32. Returns 0 on success.
int gac_write_wav(const char* path, const float* data, int64_t frames,
                  int channels, int sample_rate, int fmt) {
    int bits = (fmt == 3) ? 32 : 16;
    if (frames < 0 || channels < 1) return -2;
    // RIFF sizes are 32-bit: refuse payloads that would wrap the header
    // (a silently truncated data-chunk size corrupts the file while all
    // the bytes are still written). RF64 would be the >4 GiB answer.
    int64_t payload = frames * int64_t(channels) * (bits / 8);
    if (payload > int64_t(0xFFFFFFFFu) - 36) return -3;
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    uint32_t data_size = uint32_t(payload);
    uint8_t hdr[44];
    memcpy(hdr, "RIFF", 4);
    uint32_t riff = 36 + data_size;
    memcpy(hdr + 4, &riff, 4);
    memcpy(hdr + 8, "WAVEfmt ", 8);
    uint32_t fmtsize = 16;
    memcpy(hdr + 16, &fmtsize, 4);
    uint16_t tag = uint16_t(fmt);
    memcpy(hdr + 20, &tag, 2);
    uint16_t ch = uint16_t(channels);
    memcpy(hdr + 22, &ch, 2);
    uint32_t sr = uint32_t(sample_rate);
    memcpy(hdr + 24, &sr, 4);
    uint32_t brate = sr * channels * (bits / 8);
    memcpy(hdr + 28, &brate, 4);
    uint16_t align = uint16_t(channels * (bits / 8));
    memcpy(hdr + 32, &align, 2);
    uint16_t b = uint16_t(bits);
    memcpy(hdr + 34, &b, 2);
    memcpy(hdr + 36, "data", 4);
    memcpy(hdr + 40, &data_size, 4);
    bool ok = fwrite(hdr, 1, 44, f) == 44;

    int64_t n = frames * channels;
    if (fmt == 3) {
        ok = ok && fwrite(data, 4, size_t(n), f) == size_t(n);
    } else {
        std::vector<int16_t> pcm{};
        pcm.resize(size_t(n));
        for (int64_t i = 0; i < n; i++) {
            float v = data[i];
            if (v > 1.0f) v = 1.0f;
            if (v < -1.0f) v = -1.0f;
            pcm[size_t(i)] = int16_t(v * 32767.0f);
        }
        ok = ok && fwrite(pcm.data(), 2, size_t(n), f) == size_t(n);
    }
    // A short write (disk full) must not report success: the file on disk
    // would be a truncated WAV whose header promises missing data.
    if (fclose(f) != 0) ok = false;
    return ok ? 0 : -4;
}

// Encode interleaved float32 frames as MP3 (CBR, bitrate_kbps). Returns 0 on
// success, -1 if libmp3lame is unavailable or encoding fails.
int gac_write_mp3(const char* path, const float* data, int64_t frames,
                  int channels, int sample_rate, int bitrate_kbps) {
    LameApi& a = lame_api();
    if (!a.ok || channels < 1 || channels > 2) return -1;
    void* gf = a.init_();
    if (!gf) return -1;
    a.set_in_samplerate(gf, sample_rate);
    a.set_num_channels(gf, channels);
    a.set_brate(gf, bitrate_kbps > 0 ? bitrate_kbps : 192);
    if (a.init_params(gf) < 0) {
        a.close(gf);
        return -1;
    }
    FILE* f = fopen(path, "wb");
    if (!f) {
        a.close(gf);
        return -1;
    }
    // Chunked encode: one whole-length call would truncate at INT_MAX
    // frames and hold ~3x the source in memory; 64k-frame chunks need
    // constant memory (same pattern as the ogg/flac writers).
    const int64_t kChunk = 65536;
    std::vector<float> left(size_t(std::min(frames, kChunk)));
    std::vector<float> right(left.size());
    std::vector<unsigned char> out(size_t(kChunk) * 5 / 4 + 7200);
    for (int64_t pos = 0; pos < frames; pos += kChunk) {
        int64_t m = std::min(kChunk, frames - pos);
        for (int64_t i = 0; i < m; i++) {
            const float* fr = data + (pos + i) * channels;
            left[size_t(i)] = fr[0];
            right[size_t(i)] = fr[channels > 1 ? 1 : 0];
        }
        int n = a.encode_buffer_ieee_float(gf, left.data(), right.data(),
                                           int(m), out.data(),
                                           int(out.size()));
        if (n < 0 || fwrite(out.data(), 1, size_t(n), f) != size_t(n)) {
            fclose(f);
            a.close(gf);
            return -1;
        }
    }
    bool ok = true;
    int n = a.encode_flush(gf, out.data(), int(out.size()));
    if (n > 0) ok = fwrite(out.data(), 1, size_t(n), f) == size_t(n);
    // LAME/Xing gapless tag: rewrite the reserved first frame so decoders
    // (mpg123 included) trim the codec delay and report exact length.
    size_t tag = a.get_lametag_frame(gf, out.data(), out.size());
    if (tag > 0 && tag <= out.size()) {
        if (fseeko(f, 0, SEEK_SET) != 0 ||
            fwrite(out.data(), 1, tag, f) != tag) ok = false;
    }
    // Short tail writes (disk full) must not report success — same rule
    // as gac_write_wav.
    if (fclose(f) != 0) ok = false;
    a.close(gf);
    return ok ? 0 : -1;
}

// Encode interleaved float32 frames as Ogg/Vorbis (VBR quality in [-0.1, 1]).
// Returns 0 on success, -1 if the system vorbis encoder is unavailable.
int gac_write_ogg(const char* path, const float* data, int64_t frames,
                  int channels, int sample_rate, float quality) {
    VorbisEncApi& a = vorbisenc_api();
    if (!a.ok || channels < 1) return -1;
    // Open the output BEFORE codec init: encode_init_vbr/analysis_init
    // heap-allocate codebooks and DSP state inside the opaque structs, and
    // an early return on fopen failure would leak all of it on every retry.
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    std::vector<uint8_t> vi(kViSize), vc(kVcSize), vd(kVdSize), vb(kVbSize),
        os(kOsSize);
    a.info_init(vi.data());
    if (a.encode_init_vbr(vi.data(), channels, sample_rate, quality) != 0) {
        a.info_clear(vi.data());
        fclose(f);
        return -1;
    }
    a.comment_init(vc.data());
    a.analysis_init(vd.data(), vi.data());
    a.block_init(vd.data(), vb.data());
    a.stream_init(os.data(), 0x67616f);  // arbitrary stream serial

    OggPage page;
    auto write_pages = [&](bool flush) {
        while ((flush ? a.stream_flush(os.data(), &page)
                      : a.stream_pageout(os.data(), &page)) != 0) {
            fwrite(page.header, 1, size_t(page.header_len), f);
            fwrite(page.body, 1, size_t(page.body_len), f);
        }
    };

    OggPacket hdr, hdr_comm, hdr_code;
    a.analysis_headerout(vd.data(), vc.data(), &hdr, &hdr_comm, &hdr_code);
    a.stream_packetin(os.data(), &hdr);
    a.stream_packetin(os.data(), &hdr_comm);
    a.stream_packetin(os.data(), &hdr_code);
    write_pages(true);  // headers must end their own page

    const int64_t kChunk = 4096;
    int64_t pos = 0;
    bool done = false;
    while (!done) {
        int64_t n = frames - pos;
        if (n > kChunk) n = kChunk;
        if (n <= 0) {
            a.analysis_wrote(vd.data(), 0);  // end-of-stream marker
            done = true;
        } else {
            float** buf = a.analysis_buffer(vd.data(), int(n));
            for (int c = 0; c < channels; c++) {
                for (int64_t i = 0; i < n; i++) {
                    buf[c][i] = data[(pos + i) * channels + c];
                }
            }
            a.analysis_wrote(vd.data(), int(n));
            pos += n;
        }
        while (a.analysis_blockout(vd.data(), vb.data()) == 1) {
            a.analysis(vb.data(), nullptr);
            a.bitrate_addblock(vb.data());
            OggPacket op;
            while (a.bitrate_flushpacket(vd.data(), &op) == 1) {
                a.stream_packetin(os.data(), &op);
                write_pages(false);
            }
        }
    }
    write_pages(true);
    fclose(f);
    a.stream_clear(os.data());
    a.block_clear(vb.data());
    a.dsp_clear(vd.data());
    a.comment_clear(vc.data());
    a.info_clear(vi.data());
    return 0;
}

}  // extern "C"
