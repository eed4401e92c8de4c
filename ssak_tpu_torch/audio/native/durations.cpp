// Parallel audio-duration scanner (wav-to-duration equivalent), the port's
// own copy of ssak_tpu's durations.cpp.
//
// Parses WAV (RIFF/RF64) and FLAC STREAMINFO headers (no decode, a few
// hundred bytes of I/O per file) across a thread pool, one C call for the
// whole scp. Files it cannot parse (mp3, command pipes) return -1 and the
// Python layer reads their durations one file at a time.
//
// Build (ops/_build.host_library): g++ -O3 -shared -fPIC -std=c++17 durations.cpp -pthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

static uint32_t rd32le(const unsigned char* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}
static uint64_t rd64le(const unsigned char* p) {
    return (uint64_t)rd32le(p) | ((uint64_t)rd32le(p + 4) << 32);
}

// RIFF/WAVE (+ RF64/ds64): duration = data_bytes / (block_align) / rate.
static double wav_duration(FILE* f) {
    unsigned char hdr[12];
    if (fread(hdr, 1, 12, f) != 12) return -1;
    bool rf64 = memcmp(hdr, "RF64", 4) == 0;
    if (!rf64 && memcmp(hdr, "RIFF", 4) != 0) return -1;
    if (memcmp(hdr + 8, "WAVE", 4) != 0) return -1;

    uint32_t sample_rate = 0;
    uint16_t block_align = 0, channels = 0, bits = 0, fmt_tag = 0;
    uint64_t data_size = 0, ds64_data = 0;
    bool have_fmt = false, have_data = false;

    unsigned char ch[8];
    while (fread(ch, 1, 8, f) == 8) {
        uint32_t size = rd32le(ch + 4);
        if (memcmp(ch, "ds64", 4) == 0 && size >= 28) {
            unsigned char b[28];
            if (fread(b, 1, 28, f) != 28) return -1;
            ds64_data = rd64le(b + 8);
            if (size > 28) fseek(f, size - 28 + (size & 1), SEEK_CUR);
            else if (size & 1) fseek(f, 1, SEEK_CUR);
            continue;
        }
        if (memcmp(ch, "fmt ", 4) == 0) {
            unsigned char b[16];
            if (size < 16 || fread(b, 1, 16, f) != 16) return -1;
            fmt_tag = (uint16_t)(b[0] | (b[1] << 8));
            channels = (uint16_t)(b[2] | (b[3] << 8));
            sample_rate = rd32le(b + 4);
            block_align = (uint16_t)(b[12] | (b[13] << 8));
            bits = (uint16_t)(b[14] | (b[15] << 8));
            have_fmt = true;
            if (size > 16) fseek(f, size - 16 + (size & 1), SEEK_CUR);
            else if (size & 1) fseek(f, 1, SEEK_CUR);
            continue;
        }
        if (memcmp(ch, "data", 4) == 0) {
            data_size = (size == 0xFFFFFFFFu && ds64_data) ? ds64_data : size;
            have_data = true;
            break;  // header scan only; data is the last thing we need
        }
        fseek(f, (long)size + (size & 1), SEEK_CUR);
    }
    if (!have_fmt || !have_data || !sample_rate) return -1;
    if (!block_align) {
        if (!channels || !bits) return -1;
        block_align = (uint16_t)(channels * ((bits + 7) / 8));
    }
    (void)fmt_tag;  // PCM/A-law/mu-law/float all use block_align framing
    return (double)(data_size / block_align) / (double)sample_rate;
}

// FLAC STREAMINFO: sample rate (20 bits) + total samples (36 bits).
static double flac_duration(FILE* f) {
    unsigned char magic[4];
    if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "fLaC", 4) != 0) return -1;
    for (;;) {
        unsigned char bh[4];
        if (fread(bh, 1, 4, f) != 4) return -1;
        bool last = bh[0] & 0x80;
        int type = bh[0] & 0x7F;
        uint32_t size = ((uint32_t)bh[1] << 16) | ((uint32_t)bh[2] << 8) | bh[3];
        if (type == 0) {  // STREAMINFO
            unsigned char b[34];
            if (size < 34 || fread(b, 1, 34, f) != 34) return -1;
            uint32_t rate = ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4) | (b[12] >> 4);
            uint64_t total = ((uint64_t)(b[13] & 0x0F) << 32) | ((uint64_t)b[14] << 24) |
                             ((uint64_t)b[15] << 16) | ((uint64_t)b[16] << 8) | b[17];
            if (!rate || !total) return -1;
            return (double)total / (double)rate;
        }
        if (last) return -1;
        fseek(f, (long)size, SEEK_CUR);
    }
}

static double scan_one(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    unsigned char head[4];
    size_t got = fread(head, 1, 4, f);
    rewind(f);
    double d = -1;
    if (got == 4) {
        if (memcmp(head, "RIFF", 4) == 0 || memcmp(head, "RF64", 4) == 0) d = wav_duration(f);
        else if (memcmp(head, "fLaC", 4) == 0) d = flac_duration(f);
    }
    fclose(f);
    return d;
}

}  // namespace

extern "C" {

// paths: n C strings; out: n doubles (seconds; -1 = unparseable, caller
// falls back). Scans with up to n_threads workers.
void ssak_scan_durations(const char** paths, int32_t n, int32_t n_threads, double* out) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = n > 0 ? n : 1;
    std::atomic<int32_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1);
            if (i >= n) return;
            out[i] = scan_one(paths[i]);
        }
    };
    if (n_threads == 1) { worker(); return; }
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

}  // extern "C"
