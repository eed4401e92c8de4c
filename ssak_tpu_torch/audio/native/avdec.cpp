// Universal audio decode via ffmpeg libraries (libavformat/libavcodec), the
// port's own copy of ssak_tpu's avdec.cpp.
//
// Gives the ingest layer the containers and codecs the system ffmpeg
// supports beyond WAV, MP3 and FLAC (OGG/Vorbis, Opus, M4A/AAC, WMA, ...).
// Output is interleaved float32 at the stream's native rate; resampling
// happens in the Python pipeline. FLAC does not come here: flacdec.cpp
// decodes it without libav.
//
// Build (ops/_build.host_library): g++ -O3 -shared -fPIC -std=c++17 avdec.cpp -lavformat -lavcodec -lavutil

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
}

#include <cstring>
#include <vector>

namespace {

// convert one decoded frame to interleaved float32, append to out
void append_frame(const AVFrame* frame, const AVCodecContext* ctx, std::vector<float>& out) {
    const int ch = ctx->ch_layout.nb_channels;
    const int n = frame->nb_samples;
    const AVSampleFormat fmt = (AVSampleFormat)frame->format;
    const bool planar = av_sample_fmt_is_planar(fmt) != 0;
    const AVSampleFormat base = av_get_packed_sample_fmt(fmt);
    size_t start = out.size();
    out.resize(start + (size_t)n * ch);
    float* dst = out.data() + start;

    auto sample = [&](int c, int i) -> float {
        const uint8_t* plane = planar ? frame->data[c] : frame->data[0];
        const int idx = planar ? i : i * ch + c;
        switch (base) {
            case AV_SAMPLE_FMT_FLT: return ((const float*)plane)[idx];
            case AV_SAMPLE_FMT_DBL: return (float)((const double*)plane)[idx];
            case AV_SAMPLE_FMT_S16: return ((const int16_t*)plane)[idx] / 32768.0f;
            case AV_SAMPLE_FMT_S32: return ((const int32_t*)plane)[idx] / 2147483648.0f;
            case AV_SAMPLE_FMT_U8: return (((const uint8_t*)plane)[idx] - 128) / 128.0f;
            default: return 0.0f;
        }
    };
    for (int i = 0; i < n; ++i)
        for (int c = 0; c < ch; ++c)
            dst[i * ch + c] = sample(c, i);
}

}  // namespace

extern "C" {

// Decode any audio file to interleaved float32.
// Returns frames decoded (>=0) or negative error:
//   -1 open failed, -2 no audio stream, -3 decoder init failed, -4 decode error.
long ssak_av_decode(const char* path, float* out, size_t out_cap,
                    int* out_rate, int* out_channels) {
    AVFormatContext* fc = nullptr;
    if (avformat_open_input(&fc, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fc, nullptr) < 0) { avformat_close_input(&fc); return -1; }
    int stream = av_find_best_stream(fc, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
    if (stream < 0) { avformat_close_input(&fc); return -2; }
    const AVCodec* codec = avcodec_find_decoder(fc->streams[stream]->codecpar->codec_id);
    if (!codec) { avformat_close_input(&fc); return -3; }
    AVCodecContext* ctx = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(ctx, fc->streams[stream]->codecpar);
    if (avcodec_open2(ctx, codec, nullptr) < 0) {
        avcodec_free_context(&ctx); avformat_close_input(&fc); return -3;
    }

    std::vector<float> buf;
    buf.reserve(1 << 20);
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    int rc = 0;
    while ((rc = av_read_frame(fc, pkt)) >= 0) {
        if (pkt->stream_index == stream) {
            if (avcodec_send_packet(ctx, pkt) >= 0) {
                while (avcodec_receive_frame(ctx, frame) >= 0) append_frame(frame, ctx, buf);
            }
        }
        av_packet_unref(pkt);
    }
    // flush
    avcodec_send_packet(ctx, nullptr);
    while (avcodec_receive_frame(ctx, frame) >= 0) append_frame(frame, ctx, buf);

    const int ch = ctx->ch_layout.nb_channels > 0 ? ctx->ch_layout.nb_channels : 1;
    if (out_rate) *out_rate = ctx->sample_rate;
    if (out_channels) *out_channels = ch;
    size_t n_copy = buf.size() < out_cap ? buf.size() : out_cap;
    std::memcpy(out, buf.data(), n_copy * sizeof(float));

    av_frame_free(&frame);
    av_packet_free(&pkt);
    avcodec_free_context(&ctx);
    avformat_close_input(&fc);
    return (long)(n_copy / (size_t)ch);
}

// Duration in seconds from container metadata (fast, no decode); <0 on error.
double ssak_av_duration(const char* path) {
    AVFormatContext* fc = nullptr;
    if (avformat_open_input(&fc, path, nullptr, nullptr) < 0) return -1.0;
    if (avformat_find_stream_info(fc, nullptr) < 0) { avformat_close_input(&fc); return -1.0; }
    double dur = fc->duration > 0 ? fc->duration / (double)AV_TIME_BASE : -1.0;
    avformat_close_input(&fc);
    return dur;
}

}  // extern "C"
