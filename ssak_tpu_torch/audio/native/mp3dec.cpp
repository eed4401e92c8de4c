// Native MP3 decode for the port's audio ingest (ssak_tpu_torch/audio/mp3.py).
//
// Wraps the system libmpg123 (dlopen'd, stable ABI: no headers required)
// behind a single C entry point consumed via ctypes. A host without
// libmpg123 still builds this file; the entry point then returns -1 and
// read_mp3 raises by name. The port's own copy of ssak_tpu's mp3dec.cpp.
//
// Build (ops/_build.host_library): g++ -O3 -shared -fPIC -std=c++17 mp3dec.cpp -ldl

#include <cstddef>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>

namespace {

// --- minimal mpg123 ABI (from the stable public API) ----------------------
constexpr int MPG123_OK = 0;
constexpr int MPG123_DONE = -12;
constexpr int MPG123_NEW_FORMAT = -11;
constexpr int MPG123_NEED_MORE = -10;
constexpr int MPG123_ENC_FLOAT_32 = 0x200;
constexpr int MPG123_MONO = 1;
constexpr int MPG123_STEREO = 2;

using mpg123_init_t = int (*)();
using mpg123_new_t = void* (*)(const char*, int*);
using mpg123_delete_t = void (*)(void*);
using mpg123_open_feed_t = int (*)(void*);
using mpg123_feed_t = int (*)(void*, const unsigned char*, size_t);
using mpg123_read_t = int (*)(void*, unsigned char*, size_t, size_t*);
using mpg123_getformat_t = int (*)(void*, long*, int*, int*);
using mpg123_format_none_t = int (*)(void*);
using mpg123_format_t = int (*)(void*, long, int, int);
using mpg123_close_t = int (*)(void*);

struct Mpg123Lib {
    void* dl = nullptr;
    mpg123_init_t init = nullptr;
    mpg123_new_t create = nullptr;
    mpg123_delete_t destroy = nullptr;
    mpg123_open_feed_t open_feed = nullptr;
    mpg123_feed_t feed = nullptr;
    mpg123_read_t read = nullptr;
    mpg123_getformat_t getformat = nullptr;
    mpg123_format_none_t format_none = nullptr;
    mpg123_format_t format = nullptr;
    mpg123_close_t close = nullptr;
    bool ok = false;
};

Mpg123Lib& lib() {
    static Mpg123Lib L;
    static bool tried = false;
    if (tried) return L;
    tried = true;
    const char* names[] = {"libmpg123.so.0", "libmpg123.so"};
    for (const char* n : names) {
        L.dl = dlopen(n, RTLD_NOW | RTLD_GLOBAL);
        if (L.dl) break;
    }
    if (!L.dl) return L;
    L.init = (mpg123_init_t)dlsym(L.dl, "mpg123_init");
    L.create = (mpg123_new_t)dlsym(L.dl, "mpg123_new");
    L.destroy = (mpg123_delete_t)dlsym(L.dl, "mpg123_delete");
    L.open_feed = (mpg123_open_feed_t)dlsym(L.dl, "mpg123_open_feed");
    L.feed = (mpg123_feed_t)dlsym(L.dl, "mpg123_feed");
    L.read = (mpg123_read_t)dlsym(L.dl, "mpg123_read");
    L.getformat = (mpg123_getformat_t)dlsym(L.dl, "mpg123_getformat");
    L.format_none = (mpg123_format_none_t)dlsym(L.dl, "mpg123_format_none");
    L.format = (mpg123_format_t)dlsym(L.dl, "mpg123_format");
    L.close = (mpg123_close_t)dlsym(L.dl, "mpg123_close");
    L.ok = L.init && L.create && L.destroy && L.open_feed && L.feed && L.read && L.getformat && L.format_none && L.format;
    if (L.ok && L.init() != MPG123_OK) L.ok = false;
    return L;
}

constexpr long kRates[] = {8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000};

}  // namespace

extern "C" {

// 1 when libmpg123 loads and initialises, else 0.
int ssak_mp3_available() { return lib().ok ? 1 : 0; }

// Decode an in-memory MP3 stream to interleaved float32.
// Returns frames decoded (>=0) or a negative error code:
//   -1 libmpg123 unavailable, -2 decoder init failed, -3 decode error.
// out receives up to out_cap floats; *out_rate / *out_channels are set from
// the stream format.
long ssak_mp3_decode(const char* data, size_t size, float* out, size_t out_cap,
                     int* out_rate, int* out_channels) {
    Mpg123Lib& L = lib();
    if (!L.ok) return -1;
    int err = 0;
    void* h = L.create(nullptr, &err);
    if (!h) return -2;
    L.format_none(h);
    for (long r : kRates) L.format(h, r, MPG123_MONO | MPG123_STEREO, MPG123_ENC_FLOAT_32);
    if (L.open_feed(h) != MPG123_OK) { L.destroy(h); return -2; }
    if (L.feed(h, (const unsigned char*)data, size) != MPG123_OK) { L.destroy(h); return -3; }

    long rate = 0;
    int channels = 0, enc = 0;
    size_t total_floats = 0;
    unsigned char buf[32768];
    for (;;) {
        size_t done = 0;
        int rc = L.read(h, buf, sizeof(buf), &done);
        if (done > 0) {
            size_t nf = done / sizeof(float);
            size_t can = (total_floats + nf <= out_cap) ? nf : (out_cap > total_floats ? out_cap - total_floats : 0);
            if (can > 0) std::memcpy(out + total_floats, buf, can * sizeof(float));
            total_floats += can;
            if (can < nf) break;  // output buffer full
        }
        if (rc == MPG123_NEW_FORMAT) {
            L.getformat(h, &rate, &channels, &enc);
        } else if (rc == MPG123_NEED_MORE || rc == MPG123_DONE) {
            break;  // fed everything already
        } else if (rc != MPG123_OK) {
            break;
        }
    }
    if (rate == 0) L.getformat(h, &rate, &channels, &enc);
    L.close(h);
    L.destroy(h);
    if (out_rate) *out_rate = (int)rate;
    if (out_channels) *out_channels = channels > 0 ? channels : 1;
    if (channels <= 0) channels = 1;
    return (long)(total_floats / (size_t)channels);
}

}  // extern "C"
