// FLAC decoder of the port's own (no libFLAC, no libav).
//
// ssak_tpu decodes FLAC through libavcodec (audio/native/avdec.cpp); a host
// without ffmpeg's libraries cannot. This file reads a whole .flac file in
// memory: STREAMINFO; frame headers (fixed and variable block sizes, every
// block-size, sample-rate and sample-size code) with their CRC-8 and the
// frame's CRC-16; CONSTANT, VERBATIM, FIXED (orders 0-4) and LPC subframes
// (orders 1-32); Rice and Rice2 residuals over 2^k partitions, escape
// codes included; wasted bits; independent, left/side, side/right and
// mid/side channels; 4-24 bit samples.
//
// The output is interleaved float32 scaled as avdec.cpp converts what
// libavcodec's FLAC decoder gives: samples of <= 16 bits as int16 shifted
// up to 16 bits over 32768, wider ones as int32 shifted up to 32 bits over
// 2^31. Both are exact, so the floats equal ssak_tpu's bit for bit.
//
// Build (ops/_build.host_library): g++ -O3 -shared -fPIC -std=c++17 flacdec.cpp

#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Err {
    kNotFlac = -1,      // no "fLaC" marker
    kBadMeta = -2,      // STREAMINFO missing or malformed
    kBadHeader = -3,    // frame sync, reserved code or CRC-8 wrong
    kBadSubframe = -4,  // reserved subframe type, bad LPC precision or shift, residual overrun
    kBadCrc16 = -5,     // frame CRC-16 wrong
    kUnsupported = -6,  // sample size outside 4-24 bits, or a frame that changes the stream's layout
    kTruncated = -7,    // data ends inside a frame
    kNoMemory = -8,
};

struct Bits {
    const uint8_t* p;
    size_t n;       // bytes
    size_t pos = 0; // bits read
    bool over = false;

    // the 64 bits from byte `at` on, big-endian, zeros past the end
    uint64_t window(size_t at) const {
        uint64_t w = 0;
        if (at + 8 <= n) {
            for (int i = 0; i < 8; ++i) w = (w << 8) | p[at + i];
        } else {
            for (int i = 0; i < 8; ++i) w = (w << 8) | (at + i < n ? p[at + i] : 0);
        }
        return w;
    }
    uint32_t bit() { return (uint32_t)get(1); }
    uint64_t get(int k) {  // k <= 56 unsigned bits
        if (k == 0) return 0;
        if (pos + (size_t)k > n * 8) { over = true; pos = n * 8; return 0; }
        uint64_t v = (window(pos >> 3) << (pos & 7)) >> (64 - k);
        pos += (size_t)k;
        return v;
    }
    int64_t sget(int k) {  // k-bit two's complement
        if (k == 0) return 0;
        uint64_t v = get(k);
        if (v >> (k - 1)) return (int64_t)v - ((int64_t)1 << k);
        return (int64_t)v;
    }
    uint32_t unary() {  // zeros before a one
        uint32_t q = 0;
        for (;;) {
            if (pos >= n * 8) { over = true; return q; }
            uint64_t w = window(pos >> 3) << (pos & 7);
            int avail = 64 - (int)(pos & 7);
            if (w) {
                int z = __builtin_clzll(w);
                if (z < avail) {
                    pos += (size_t)z + 1;
                    if (pos > n * 8) { over = true; pos = n * 8; }
                    return q + (uint32_t)z;
                }
            }
            q += (uint32_t)avail;
            pos += (size_t)avail;
        }
    }
    void align() { pos = (pos + 7) & ~(size_t)7; }
};

uint8_t crc8(const uint8_t* d, size_t n) {
    uint8_t c = 0;
    for (size_t i = 0; i < n; ++i) {
        c ^= d[i];
        for (int b = 0; b < 8; ++b) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
    }
    return c;
}

std::array<uint16_t, 256> crc16_table() {
    std::array<uint16_t, 256> t{};
    for (int i = 0; i < 256; ++i) {
        uint16_t c = (uint16_t)(i << 8);
        for (int b = 0; b < 8; ++b) c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
        t[i] = c;
    }
    return t;
}

uint16_t crc16(const uint8_t* d, size_t n) {
    static const std::array<uint16_t, 256> table = crc16_table();  // initialised once, thread-safe
    uint16_t c = 0;
    for (size_t i = 0; i < n; ++i) c = (uint16_t)((c << 8) ^ table[(c >> 8) ^ d[i]]);
    return c;
}

struct StreamInfo {
    uint32_t rate = 0, channels = 0, bps = 0;
    uint64_t total = 0;
    size_t frames_at = 0;  // byte offset of the first frame
};

size_t skip_id3(const uint8_t* d, size_t n) {
    if (n >= 10 && d[0] == 'I' && d[1] == 'D' && d[2] == '3')
        return 10 + (((size_t)(d[6] & 0x7F) << 21) | ((size_t)(d[7] & 0x7F) << 14) | ((size_t)(d[8] & 0x7F) << 7) |
                     (size_t)(d[9] & 0x7F));
    return 0;
}

int read_streaminfo(const uint8_t* d, size_t n, StreamInfo* si) {
    size_t p = skip_id3(d, n);
    if (p + 4 > n || memcmp(d + p, "fLaC", 4) != 0) return kNotFlac;
    p += 4;
    bool have = false;
    for (;;) {
        if (p + 4 > n) return kBadMeta;
        bool last = d[p] & 0x80;
        int type = d[p] & 0x7F;
        size_t size = ((size_t)d[p + 1] << 16) | ((size_t)d[p + 2] << 8) | d[p + 3];
        p += 4;
        if (p + size > n) return kBadMeta;
        if (type == 0) {
            if (size < 34) return kBadMeta;
            const uint8_t* b = d + p;
            si->rate = ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4) | (b[12] >> 4);
            si->channels = ((b[12] >> 1) & 7) + 1;
            si->bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
            si->total = ((uint64_t)(b[13] & 0x0F) << 32) | ((uint64_t)b[14] << 24) | ((uint64_t)b[15] << 16) |
                        ((uint64_t)b[16] << 8) | b[17];
            have = true;
        }
        p += size;
        if (last) break;
    }
    if (!have || si->rate == 0) return kBadMeta;
    if (si->bps < 4 || si->bps > 24) return kUnsupported;
    si->frames_at = p;
    return 0;
}

// residual of one subframe into res[order..blocksize)
int read_residual(Bits& br, int order, uint32_t blocksize, int64_t* res) {
    uint32_t method = (uint32_t)br.get(2);
    if (method > 1) return kBadSubframe;
    int pbits = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 15 : 31;
    uint32_t porder = (uint32_t)br.get(4);
    uint32_t parts = 1u << porder;
    if ((blocksize & (parts - 1)) != 0 || (blocksize >> porder) < (uint32_t)order) return kBadSubframe;
    uint32_t i = (uint32_t)order;
    for (uint32_t part = 0; part < parts; ++part) {
        uint32_t end = (part + 1) * (blocksize >> porder);
        uint32_t k = (uint32_t)br.get(pbits);
        if (k == escape) {
            int raw = (int)br.get(5);
            for (; i < end; ++i) res[i] = br.sget(raw);
        } else {
            for (; i < end; ++i) {
                uint64_t q = br.unary();
                uint64_t v = (q << k) | br.get((int)k);
                res[i] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
                if (br.over) return kTruncated;
            }
        }
        if (br.over) return kTruncated;
    }
    return 0;
}

int read_subframe(Bits& br, uint32_t blocksize, int bps, int64_t* s) {
    if (br.bit() != 0) return kBadSubframe;
    uint32_t type = (uint32_t)br.get(6);
    int wasted = 0;
    if (br.bit()) wasted = (int)br.unary() + 1;
    if (wasted >= bps) return kBadSubframe;
    bps -= wasted;
    int rc = 0;
    if (type == 0) {  // CONSTANT
        int64_t v = br.sget(bps);
        for (uint32_t i = 0; i < blocksize; ++i) s[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (uint32_t i = 0; i < blocksize; ++i) s[i] = br.sget(bps);
    } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
        int order = (int)(type - 8);
        if ((uint32_t)order > blocksize) return kBadSubframe;
        for (int i = 0; i < order; ++i) s[i] = br.sget(bps);
        if ((rc = read_residual(br, order, blocksize, s)) != 0) return rc;
        for (uint32_t i = (uint32_t)order; i < blocksize; ++i) {
            switch (order) {
                case 0: break;
                case 1: s[i] += s[i - 1]; break;
                case 2: s[i] += 2 * s[i - 1] - s[i - 2]; break;
                case 3: s[i] += 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3]; break;
                case 4: s[i] += 4 * s[i - 1] - 6 * s[i - 2] + 4 * s[i - 3] - s[i - 4]; break;
            }
        }
    } else if (type >= 32) {  // LPC, order 1-32
        int order = (int)(type - 31);
        if ((uint32_t)order > blocksize) return kBadSubframe;
        for (int i = 0; i < order; ++i) s[i] = br.sget(bps);
        int precision = (int)br.get(4) + 1;
        if (precision == 16) return kBadSubframe;
        int shift = (int)br.sget(5);
        if (shift < 0) return kBadSubframe;
        int64_t coef[32];
        for (int j = 0; j < order; ++j) coef[j] = br.sget(precision);
        if ((rc = read_residual(br, order, blocksize, s)) != 0) return rc;
        for (uint32_t i = (uint32_t)order; i < blocksize; ++i) {
            int64_t sum = 0;
            for (int j = 0; j < order; ++j) sum += coef[j] * s[i - 1 - j];
            s[i] += sum >> shift;
        }
    } else {
        return kBadSubframe;
    }
    if (br.over) return kTruncated;
    if (wasted)
        for (uint32_t i = 0; i < blocksize; ++i) s[i] = (int64_t)((uint64_t)s[i] << wasted);
    return 0;
}

const uint32_t kRates[12] = {0, 88200, 176400, 192000, 8000, 16000, 22050, 24000, 32000, 44100, 48000, 96000};
const int kSizes[8] = {0, 8, 12, -1, 16, 20, 24, 32};

// one frame at data[*pos]: appends blocksize x channels samples (as int64)
int read_frame(const uint8_t* d, size_t n, size_t* pos, const StreamInfo& si, std::vector<int64_t>& chans,
               std::vector<float>& out) {
    size_t start = *pos;
    if (start + 2 > n) return kTruncated;
    if (d[start] != 0xFF || (d[start + 1] & 0xFE) != 0xF8) return kBadHeader;
    Bits br{d + start, n - start};
    br.get(16);  // sync, reserved, blocking strategy
    uint32_t bs_code = (uint32_t)br.get(4), sr_code = (uint32_t)br.get(4);
    uint32_t ch_code = (uint32_t)br.get(4), ss_code = (uint32_t)br.get(3);
    if (br.bit() != 0 || bs_code == 0 || sr_code == 15 || ch_code > 10 || ss_code == 3) return kBadHeader;
    // the coded frame or sample number: UTF-8-like, 1-7 bytes
    uint32_t lead = (uint32_t)br.get(8);
    int extra = 0;
    if (lead & 0x80) {
        if ((lead & 0xC0) == 0x80 || lead == 0xFF) return kBadHeader;
        while (lead & (0x80 >> (extra + 1))) ++extra;
    }
    for (int i = 0; i < extra; ++i)
        if ((br.get(8) & 0xC0) != 0x80) return kBadHeader;
    uint32_t blocksize;
    if (bs_code == 1) blocksize = 192;
    else if (bs_code <= 5) blocksize = 576u << (bs_code - 2);
    else if (bs_code == 6) blocksize = (uint32_t)br.get(8) + 1;
    else if (bs_code == 7) blocksize = (uint32_t)br.get(16) + 1;
    else blocksize = 256u << (bs_code - 8);
    uint32_t rate = si.rate;
    if (sr_code >= 1 && sr_code <= 11) rate = kRates[sr_code];
    else if (sr_code == 12) rate = (uint32_t)br.get(8) * 1000;
    else if (sr_code == 13) rate = (uint32_t)br.get(16);
    else if (sr_code == 14) rate = (uint32_t)br.get(16) * 10;
    int bps = ss_code == 0 ? (int)si.bps : kSizes[ss_code];
    if (br.over) return kTruncated;
    size_t hdr_bytes = br.pos / 8;
    uint8_t crc = (uint8_t)br.get(8);
    if (br.over) return kTruncated;
    if (crc8(d + start, hdr_bytes) != crc) return kBadHeader;
    uint32_t channels = ch_code < 8 ? ch_code + 1 : 2;
    if (channels != si.channels || bps != (int)si.bps || rate != si.rate) return kUnsupported;

    chans.assign((size_t)channels * blocksize, 0);
    for (uint32_t c = 0; c < channels; ++c) {
        bool side = (ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) || (ch_code == 10 && c == 1);
        int rc = read_subframe(br, blocksize, bps + (side ? 1 : 0), chans.data() + (size_t)c * blocksize);
        if (rc) return rc;
    }
    br.align();
    if (br.pos / 8 + 2 > n - start) return kTruncated;
    size_t body = br.pos / 8;
    uint16_t want = (uint16_t)br.get(16);
    if (crc16(d + start, body) != want) return kBadCrc16;
    *pos = start + body + 2;

    int64_t* a = chans.data();
    int64_t* b = chans.data() + blocksize;
    for (uint32_t i = 0; i < blocksize && channels == 2; ++i) {
        if (ch_code == 8) b[i] = a[i] - b[i];            // left, side -> right
        else if (ch_code == 9) a[i] = a[i] + b[i];       // side, right -> left
        else if (ch_code == 10) {                        // mid, side
            int64_t mid = (int64_t)((uint64_t)a[i] << 1) | (b[i] & 1), sd = b[i];
            a[i] = (mid + sd) >> 1;
            b[i] = (mid - sd) >> 1;
        }
    }
    size_t at = out.size();
    out.resize(at + (size_t)blocksize * channels);
    float* dst = out.data() + at;
    for (uint32_t i = 0; i < blocksize; ++i)
        for (uint32_t c = 0; c < channels; ++c) {
            int64_t v = chans[(size_t)c * blocksize + i];
            // as libavcodec hands them to avdec.cpp's append_frame: S16 or S32, shifted to the top
            dst[(size_t)i * channels + c] = bps <= 16 ? (int16_t)(v << (16 - bps)) / 32768.0f
                                                      : (int32_t)(v << (32 - bps)) / 2147483648.0f;
        }
    return 0;
}

}  // namespace

extern "C" {

// STREAMINFO of an in-memory FLAC file; 0 or a negative error code.
int ssak_flac_info(const char* data, size_t size, int* rate, int* channels, int* bps, uint64_t* total) {
    StreamInfo si;
    int rc = read_streaminfo((const uint8_t*)data, size, &si);
    if (rc) return rc;
    *rate = (int)si.rate;
    *channels = (int)si.channels;
    *bps = (int)si.bps;
    *total = si.total;
    return 0;
}

// Decode an in-memory FLAC file to interleaved float32 in a malloc'd buffer
// (*out, freed by ssak_flac_free). Returns the frames (samples per channel)
// decoded, or a negative error code. Decoding stops at STREAMINFO's total
// when it is set, else at the end of the data.
long ssak_flac_decode(const char* data, size_t size, float** out, int* rate, int* channels) {
    const uint8_t* d = (const uint8_t*)data;
    StreamInfo si;
    int rc = read_streaminfo(d, size, &si);
    if (rc) return rc;
    std::vector<float> buf;
    std::vector<int64_t> chans;
    if (si.total) buf.reserve((size_t)si.total * si.channels);
    size_t pos = si.frames_at;
    while (pos < size && (si.total == 0 || buf.size() < si.total * si.channels)) {
        rc = read_frame(d, size, &pos, si, chans, buf);
        if (rc) return rc;
    }
    if (si.total && buf.size() > si.total * si.channels) buf.resize(si.total * si.channels);
    *rate = (int)si.rate;
    *channels = (int)si.channels;
    *out = (float*)malloc(buf.size() * sizeof(float) + 1);
    if (!*out) return kNoMemory;
    memcpy(*out, buf.data(), buf.size() * sizeof(float));
    return (long)(buf.size() / si.channels);
}

void ssak_flac_free(float* p) { free(p); }

}  // extern "C"
