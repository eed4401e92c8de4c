// Writes the MP3 and FLAC fixtures of tests/data_torch/ through libavformat
// and libavcodec (libmp3lame for MP3, libavcodec's own FLAC encoder).
//
//   g++ -O2 -std=c++17 -o encode_fixtures encode_fixtures.cpp -lavformat -lavcodec -lavutil
//   ./encode_fixtures tests/data_torch
//
// The signal is a sum of three tones and a little noise from a fixed linear
// congruential generator, so a rerun with the same libraries writes the
// same files. The fixtures are committed; the tests only read them.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
}

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <string>

static uint32_t lcg_state = 12345u;
static double noise() {
    lcg_state = lcg_state * 1664525u + 1013904223u;
    return (lcg_state >> 8) / double(1 << 24) - 0.5;
}

static double sample(int c, long i, int rate) {
    double t = double(i) / rate;
    double f0 = c == 0 ? 220.0 : 330.0;
    return 0.3 * std::sin(2 * M_PI * f0 * t) + 0.2 * std::sin(2 * M_PI * 1250.0 * t + c) +
           0.1 * std::sin(2 * M_PI * 3100.0 * t) + 0.02 * noise();
}

static int fail(const char* what) {
    std::fprintf(stderr, "encode_fixtures: %s\n", what);
    return 1;
}

static int write_one(const std::string& path, AVCodecID id, const char* encoder, int rate, int channels, long n,
                     int64_t bit_rate, int bits) {
    AVFormatContext* oc = nullptr;
    if (avformat_alloc_output_context2(&oc, nullptr, nullptr, path.c_str()) < 0) return fail("output context");
    const AVCodec* codec = encoder ? avcodec_find_encoder_by_name(encoder) : avcodec_find_encoder(id);
    if (!codec) return fail("no encoder");
    AVStream* st = avformat_new_stream(oc, nullptr);
    AVCodecContext* ctx = avcodec_alloc_context3(codec);
    ctx->sample_rate = rate;
    av_channel_layout_default(&ctx->ch_layout, channels);
    if (id == AV_CODEC_ID_MP3) {
        ctx->sample_fmt = AV_SAMPLE_FMT_FLTP;
        ctx->bit_rate = bit_rate;
    } else {
        ctx->sample_fmt = bits > 16 ? AV_SAMPLE_FMT_S32 : AV_SAMPLE_FMT_S16;
        ctx->bits_per_raw_sample = bits;
    }
    ctx->time_base = AVRational{1, rate};
    if (oc->oformat->flags & AVFMT_GLOBALHEADER) ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(ctx, codec, nullptr) < 0) return fail("open encoder");
    avcodec_parameters_from_context(st->codecpar, ctx);
    st->time_base = ctx->time_base;
    if (avio_open(&oc->pb, path.c_str(), AVIO_FLAG_WRITE) < 0) return fail("open file");
    if (avformat_write_header(oc, nullptr) < 0) return fail("header");

    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    auto drain = [&]() {
        while (avcodec_receive_packet(ctx, pkt) >= 0) {
            av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
            pkt->stream_index = st->index;
            av_interleaved_write_frame(oc, pkt);
        }
    };
    const int fs = ctx->frame_size > 0 ? ctx->frame_size : 4096;
    for (long at = 0; at < n; at += fs) {
        int m = (int)std::min<long>(fs, n - at);
        frame->nb_samples = m;
        frame->format = ctx->sample_fmt;
        av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
        frame->sample_rate = rate;
        if (av_frame_get_buffer(frame, 0) < 0) return fail("frame buffer");
        for (int i = 0; i < m; ++i)
            for (int c = 0; c < channels; ++c) {
                double v = sample(c, at + i, rate);
                if (ctx->sample_fmt == AV_SAMPLE_FMT_FLTP) ((float*)frame->data[c])[i] = (float)v;
                else if (ctx->sample_fmt == AV_SAMPLE_FMT_S16) ((int16_t*)frame->data[0])[i * channels + c] = (int16_t)std::lrint(v * 32767);
                else ((int32_t*)frame->data[0])[i * channels + c] = (int32_t)std::lrint(v * 8388607) * 256;
            }
        frame->pts = at;
        if (avcodec_send_frame(ctx, frame) < 0) return fail("send frame");
        drain();
        av_frame_unref(frame);
    }
    avcodec_send_frame(ctx, nullptr);
    drain();
    av_write_trailer(oc);
    avio_closep(&oc->pb);
    av_frame_free(&frame);
    av_packet_free(&pkt);
    avcodec_free_context(&ctx);
    avformat_free_context(oc);
    return 0;
}

int main(int argc, char** argv) {
    std::string dir = argc > 1 ? argv[1] : ".";
    int rc = 0;
    rc |= write_one(dir + "/stereo_44k.mp3", AV_CODEC_ID_MP3, "libmp3lame", 44100, 2, 88200, 96000, 16);
    rc |= write_one(dir + "/mono_16k.mp3", AV_CODEC_ID_MP3, "libmp3lame", 16000, 1, 16000, 32000, 16);
    rc |= write_one(dir + "/stereo_48k.flac", AV_CODEC_ID_FLAC, nullptr, 48000, 2, 24000, 0, 16);
    rc |= write_one(dir + "/mono_16k_24bit.flac", AV_CODEC_ID_FLAC, nullptr, 16000, 1, 16000, 0, 24);
    return rc;
}
