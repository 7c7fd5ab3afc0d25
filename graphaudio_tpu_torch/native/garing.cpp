// garing: lock-free SPSC audio ring buffer + realtime output device layer.
//
// Plays the role of the reference's native-memory RingBuffer
// (GraphAudio.Realtime/RingBuffer.cs:9-98: volatile write/read positions,
// split wraparound memcpy, semaphore backpressure) and of miniaudio's device
// layer (GraphAudio.Realtime/Miniaudio.cs). The device callback thread only
// touches native memory — no Python, mirroring the reference's GC-free
// [UnmanagedCallersOnly] discipline (RealtimeAudioContext.cs:167-235).
//
// Backends:
//   * "null": a clock-paced consumer thread that drains the ring in real
//     time (zero-filling underruns and counting them) — usable on any
//     machine, including CI containers with no sound hardware.
//   * "alsa": real hardware playback via a dlopen'd libasound.so.2 (no
//     build-time ALSA dependency; prototypes declared locally). Mirrors the
//     reference's miniaudio playback path (Miniaudio.cs:303-349,
//     RealtimeAudioContext.cs:167-235): interleaved float32, period-sized
//     writes from the ring, xrun recovery counted as underruns.
//   * "auto": alsa if the library and a playback device are usable,
//     else null.
//
// Build: g++ -O2 -shared -fPIC -pthread -o libgaring.so garing.cpp
// (links nothing; libasound is dlopen'd at gadev_open time)

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Ring {
    std::vector<float> buf;       // capacity * channels interleaved samples
    std::atomic<uint64_t> wpos{0};  // total frames written
    std::atomic<uint64_t> rpos{0};  // total frames read
    uint32_t capacity = 0;          // frames
    uint32_t channels = 0;
    // Semaphore-equivalent backpressure (RingBuffer.cs:51 WaitForSpace).
    std::mutex m;
    std::condition_variable cv;

    uint64_t available_read() const {
        return wpos.load(std::memory_order_acquire) -
               rpos.load(std::memory_order_acquire);
    }
    uint64_t available_write() const { return capacity - available_read(); }
};

// ---- minimal ALSA surface (resolved via dlopen; no headers needed) --------
//
// Public libasound ABI, stable since ALSA 1.x. Only the playback subset the
// device loop needs is declared.

typedef struct _snd_pcm snd_pcm_t;
typedef long snd_pcm_sframes_t;
typedef unsigned long snd_pcm_uframes_t;

struct AlsaApi {
    void* handle = nullptr;
    int (*pcm_open)(snd_pcm_t**, const char*, int /*stream*/, int /*mode*/);
    int (*pcm_close)(snd_pcm_t*);
    int (*pcm_set_params)(snd_pcm_t*, int /*format*/, int /*access*/,
                          unsigned /*channels*/, unsigned /*rate*/,
                          int /*soft_resample*/, unsigned /*latency_us*/);
    snd_pcm_sframes_t (*pcm_writei)(snd_pcm_t*, const void*, snd_pcm_uframes_t);
    int (*pcm_recover)(snd_pcm_t*, int /*err*/, int /*silent*/);
    int (*pcm_prepare)(snd_pcm_t*);
    int (*pcm_drain)(snd_pcm_t*);
    int (*device_name_hint)(int, const char*, void***);
    char* (*device_name_get_hint)(const void*, const char*);
    int (*device_name_free_hint)(void**);

    bool load() {
        if (handle) return true;
        handle = dlopen("libasound.so.2", RTLD_NOW | RTLD_LOCAL);
        if (!handle) handle = dlopen("libasound.so", RTLD_NOW | RTLD_LOCAL);
        if (!handle) return false;
        auto sym = [&](const char* n) { return dlsym(handle, n); };
        pcm_open = (decltype(pcm_open))sym("snd_pcm_open");
        pcm_close = (decltype(pcm_close))sym("snd_pcm_close");
        pcm_set_params = (decltype(pcm_set_params))sym("snd_pcm_set_params");
        pcm_writei = (decltype(pcm_writei))sym("snd_pcm_writei");
        pcm_recover = (decltype(pcm_recover))sym("snd_pcm_recover");
        pcm_prepare = (decltype(pcm_prepare))sym("snd_pcm_prepare");
        pcm_drain = (decltype(pcm_drain))sym("snd_pcm_drain");
        device_name_hint = (decltype(device_name_hint))sym("snd_device_name_hint");
        device_name_get_hint =
            (decltype(device_name_get_hint))sym("snd_device_name_get_hint");
        device_name_free_hint =
            (decltype(device_name_free_hint))sym("snd_device_name_free_hint");
        return pcm_open && pcm_close && pcm_set_params && pcm_writei &&
               pcm_recover;
    }
};

AlsaApi g_alsa;
std::mutex g_alsa_m;

// ALSA enum constants (sound/asound.h ABI, stable).
constexpr int SND_PCM_STREAM_PLAYBACK_ = 0;
constexpr int SND_PCM_FORMAT_FLOAT_LE_ = 14;
constexpr int SND_PCM_ACCESS_RW_INTERLEAVED_ = 3;
constexpr int SND_PCM_NONBLOCK_ = 1;

struct Device {
    Ring* ring = nullptr;
    uint32_t sample_rate = 48000;
    uint32_t channels = 2;
    uint32_t period_frames = 256;
    std::atomic<bool> running{false};
    std::atomic<bool> quit{false};
    std::atomic<uint64_t> frames_played{0};
    std::atomic<uint64_t> underrun_frames{0};
    std::thread thread;
    std::vector<float> scratch;
    // Optional tap: most recent period is kept for host inspection.
    std::vector<float> tap;
    std::mutex tap_m;
    snd_pcm_t* pcm = nullptr;  // set iff the alsa backend is active
    char backend[16] = "null";
};

uint32_t ring_read_into(Ring* r, float* out, uint32_t frames,
                        uint64_t* underrun) {
    uint32_t ch = r->channels;
    uint64_t avail = r->available_read();
    uint32_t take = (uint32_t)(avail < frames ? avail : frames);
    uint64_t rp = r->rpos.load(std::memory_order_relaxed);
    uint32_t start = (uint32_t)(rp % r->capacity);
    uint32_t first = std::min(take, r->capacity - start);
    memcpy(out, r->buf.data() + (size_t)start * ch, (size_t)first * ch * 4);
    if (take > first) {
        memcpy(out + (size_t)first * ch, r->buf.data(),
               (size_t)(take - first) * ch * 4);
    }
    if (take < frames) {  // underrun: zero-fill (RealtimeAudioContext.cs:224-228)
        memset(out + (size_t)take * ch, 0, (size_t)(frames - take) * ch * 4);
        if (underrun) *underrun += frames - take;
    }
    r->rpos.store(rp + take, std::memory_order_release);
    {
        std::lock_guard<std::mutex> lk(r->m);
    }
    r->cv.notify_all();  // release space semaphore
    return take;
}

void null_device_loop(Device* d) {
    using clock = std::chrono::steady_clock;
    auto period = std::chrono::nanoseconds(
        (uint64_t)d->period_frames * 1000000000ull / d->sample_rate);
    auto next = clock::now() + period;
    while (!d->quit.load(std::memory_order_acquire)) {
        if (!d->running.load(std::memory_order_acquire)) {
            std::this_thread::sleep_for(std::chrono::milliseconds(1));
            next = clock::now() + period;
            continue;
        }
        uint64_t under = 0;
        ring_read_into(d->ring, d->scratch.data(), d->period_frames, &under);
        d->underrun_frames.fetch_add(under, std::memory_order_relaxed);
        d->frames_played.fetch_add(d->period_frames, std::memory_order_relaxed);
        {
            std::lock_guard<std::mutex> lk(d->tap_m);
            d->tap = d->scratch;
        }
        std::this_thread::sleep_until(next);
        next += period;
    }
}

// ALSA playback loop: period-sized interleaved float writes, xrun recovery.
// Mirrors the reference device callback (RealtimeAudioContext.cs:167-235):
// the audio thread touches only native memory; ring shortfalls zero-fill
// and count as underruns.
void alsa_device_loop(Device* d) {
    while (!d->quit.load(std::memory_order_acquire)) {
        if (!d->running.load(std::memory_order_acquire)) {
            std::this_thread::sleep_for(std::chrono::milliseconds(1));
            continue;
        }
        uint64_t under = 0;
        ring_read_into(d->ring, d->scratch.data(), d->period_frames, &under);
        d->underrun_frames.fetch_add(under, std::memory_order_relaxed);
        {
            std::lock_guard<std::mutex> lk(d->tap_m);
            d->tap = d->scratch;
        }
        const float* p = d->scratch.data();
        snd_pcm_uframes_t left = d->period_frames;
        bool counted_xrun = false;
        while (left > 0 && !d->quit.load(std::memory_order_acquire)) {
            snd_pcm_sframes_t n = g_alsa.pcm_writei(d->pcm, p, left);
            if (n < 0) {
                // xrun / suspend: recover and retry. Telemetry counts the
                // audible gap: the period that hit the xrun once (counting
                // `left` on every retry would double-count frames that
                // play after a successful recover), plus ~1 ms of frames
                // per failed-recover retry so a sustained device stall
                // accrues in proportion to its real duration.
                n = g_alsa.pcm_recover(d->pcm, (int)n, 1);
                if (!counted_xrun) {
                    counted_xrun = true;
                    d->underrun_frames.fetch_add(left,
                                                 std::memory_order_relaxed);
                }
                if (n < 0) {
                    std::this_thread::sleep_for(std::chrono::milliseconds(1));
                    d->underrun_frames.fetch_add(
                        d->sample_rate / 1000, std::memory_order_relaxed);
                }
                continue;
            }
            p += (size_t)n * d->channels;
            left -= (snd_pcm_uframes_t)n;
        }
        d->frames_played.fetch_add(d->period_frames, std::memory_order_relaxed);
    }
    if (g_alsa.pcm_drain) g_alsa.pcm_drain(d->pcm);
}

// Try to open an ALSA playback device; returns nullptr (and leaves the
// caller to fall back to the null backend) when libasound or the device is
// unavailable. device_name: "default" unless kind carries "alsa:<name>".
snd_pcm_t* alsa_try_open(const char* device_name, uint32_t rate,
                         uint32_t channels, uint32_t period_frames) {
    std::lock_guard<std::mutex> lk(g_alsa_m);
    if (!g_alsa.load()) return nullptr;
    snd_pcm_t* pcm = nullptr;
    if (g_alsa.pcm_open(&pcm, device_name, SND_PCM_STREAM_PLAYBACK_, 0) < 0)
        return nullptr;
    // Target latency: 5 periods (the reference's ring is bufferSize*5,
    // RealtimeAudioContext.cs:38).
    unsigned latency_us =
        (unsigned)((uint64_t)period_frames * 5u * 1000000ull / rate);
    int err = g_alsa.pcm_set_params(pcm, SND_PCM_FORMAT_FLOAT_LE_,
                                    SND_PCM_ACCESS_RW_INTERLEAVED_, channels,
                                    rate, 1 /*soft resample*/, latency_us);
    if (err < 0) {
        g_alsa.pcm_close(pcm);
        return nullptr;
    }
    return pcm;
}

}  // namespace

extern "C" {

// ---- ring buffer ----------------------------------------------------------

void* garing_create(uint32_t channels, uint32_t capacity_frames) {
    Ring* r = new Ring();
    r->channels = channels;
    r->capacity = capacity_frames;
    r->buf.assign((size_t)capacity_frames * channels, 0.0f);
    return r;
}

void garing_destroy(void* h) { delete (Ring*)h; }

uint64_t garing_available_write(void* h) { return ((Ring*)h)->available_write(); }
uint64_t garing_available_read(void* h) { return ((Ring*)h)->available_read(); }

// Write interleaved frames; returns frames actually written
// (split wraparound copy, RingBuffer.cs:56-86).
uint32_t garing_write(void* h, const float* data, uint32_t frames) {
    Ring* r = (Ring*)h;
    uint32_t ch = r->channels;
    uint64_t space = r->available_write();
    uint32_t put = (uint32_t)(space < frames ? space : frames);
    uint64_t wp = r->wpos.load(std::memory_order_relaxed);
    uint32_t start = (uint32_t)(wp % r->capacity);
    uint32_t first = std::min(put, r->capacity - start);
    memcpy(r->buf.data() + (size_t)start * ch, data, (size_t)first * ch * 4);
    if (put > first) {
        memcpy(r->buf.data(), data + (size_t)first * ch,
               (size_t)(put - first) * ch * 4);
    }
    r->wpos.store(wp + put, std::memory_order_release);
    return put;
}

// Read interleaved frames (zero-fills shortfall); returns frames actually
// consumed from the ring (a pre-read availability snapshot could undercount
// frames the producer published between the two loads, reporting real audio
// as zero-fill).
uint32_t garing_read(void* h, float* out, uint32_t frames) {
    return ring_read_into((Ring*)h, out, frames, nullptr);
}

// Block until at least `frames` of write space or timeout; returns 1 on space.
int garing_wait_space(void* h, uint32_t frames, uint32_t timeout_ms) {
    Ring* r = (Ring*)h;
    std::unique_lock<std::mutex> lk(r->m);
    bool ok = r->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                             [&] { return r->available_write() >= frames; });
    return ok ? 1 : 0;
}

// ---- device layer -----------------------------------------------------------

// kind: "null", "alsa", "alsa:<pcm name>", or "auto" (alsa if usable, else
// null — the reference's miniaudio default-device behavior).
void* gadev_open(const char* kind, void* ring, uint32_t sample_rate,
                 uint32_t channels, uint32_t period_frames) {
    Device* d = new Device();
    d->ring = (Ring*)ring;
    d->sample_rate = sample_rate;
    d->channels = channels;
    d->period_frames = period_frames;
    d->scratch.assign((size_t)period_frames * channels, 0.0f);

    const char* k = kind ? kind : "auto";
    bool want_alsa = strncmp(k, "alsa", 4) == 0 || strcmp(k, "auto") == 0;
    if (want_alsa) {
        const char* name = "default";
        if (strncmp(k, "alsa:", 5) == 0 && k[5]) name = k + 5;
        d->pcm = alsa_try_open(name, sample_rate, channels, period_frames);
        if (!d->pcm && strncmp(k, "alsa", 4) == 0 && strcmp(k, "auto") != 0) {
            // explicit alsa request that failed -> report, don't silently
            // run the clock-paced null device
            delete d;
            return nullptr;
        }
    }
    if (d->pcm) {
        strncpy(d->backend, "alsa", sizeof(d->backend) - 1);
        d->thread = std::thread(alsa_device_loop, d);
    } else {
        strncpy(d->backend, "null", sizeof(d->backend) - 1);
        d->thread = std::thread(null_device_loop, d);
    }
    return d;
}

// Actual backend selected by gadev_open ("alsa" or "null").
const char* gadev_backend(void* h) { return ((Device*)h)->backend; }

void gadev_start(void* h) { ((Device*)h)->running.store(true); }
void gadev_stop(void* h) { ((Device*)h)->running.store(false); }

void gadev_close(void* h) {
    Device* d = (Device*)h;
    d->quit.store(true);
    d->running.store(false);
    if (d->thread.joinable()) d->thread.join();
    if (d->pcm) g_alsa.pcm_close(d->pcm);
    delete d;
}

uint64_t gadev_frames_played(void* h) { return ((Device*)h)->frames_played.load(); }
uint64_t gadev_underruns(void* h) { return ((Device*)h)->underrun_frames.load(); }

// Copy the most recent device period into `out` (period_frames*channels).
void gadev_tap(void* h, float* out) {
    Device* d = (Device*)h;
    std::lock_guard<std::mutex> lk(d->tap_m);
    if (!d->tap.empty()) {
        memcpy(out, d->tap.data(), d->tap.size() * 4);
    }
}

// Backend/device enumeration (miniaudio surface parity, Miniaudio.cs:303-349).
// Writes up to `max` null-separated names into `out`; returns the count.
// "null" is always present; with libasound available, ALSA playback PCMs are
// listed as "alsa:<name>" via snd_device_name_hint.
int gadev_enumerate(char* out, int out_size, int max) {
    int n = 0;
    int off = 0;
    auto emit = [&](const char* name) {
        int len = (int)strlen(name) + 1;
        if (n >= max || off + len > out_size) return false;
        memcpy(out + off, name, len);
        off += len;
        n++;
        return true;
    };
    emit("null");
    std::lock_guard<std::mutex> lk(g_alsa_m);
    if (g_alsa.load() && g_alsa.device_name_hint &&
        g_alsa.device_name_get_hint && g_alsa.device_name_free_hint) {
        emit("alsa:default");
        void** hints = nullptr;
        if (g_alsa.device_name_hint(-1, "pcm", &hints) >= 0 && hints) {
            for (void** h = hints; *h; ++h) {
                char* name = g_alsa.device_name_get_hint(*h, "NAME");
                char* ioid = g_alsa.device_name_get_hint(*h, "IOID");
                bool playback = !ioid || strcmp(ioid, "Output") == 0;
                if (name && playback && strcmp(name, "default") != 0) {
                    char full[256];
                    snprintf(full, sizeof(full), "alsa:%s", name);
                    if (!emit(full)) {
                        free(name);
                        if (ioid) free(ioid);
                        break;
                    }
                }
                if (name) free(name);
                if (ioid) free(ioid);
            }
            g_alsa.device_name_free_hint(hints);
        }
    }
    return n;
}

}  // extern "C"
