"""FLAC, and the other ffmpeg formats (counterpart of ssak_tpu.audio.flac).

ssak_tpu decodes FLAC and everything else but WAV and MP3 through
libavcodec (its avdec.cpp). The port decodes FLAC with a decoder of its own
(audio/native/flacdec.cpp: no libav needed, the same floats bit for bit),
and takes its duration from STREAMINFO rounded to microseconds, as
libavformat gives it. Other extensions (OGG, Opus, M4A, ...) go through the
port's copy of avdec.cpp, linked to ffmpeg's libraries; where they are
missing, `read_any` raises by name.
"""

import ctypes
import os

import numpy as np


def read_flac(path):
    """Decode a FLAC file to (float32 (frames, channels), sample_rate)."""
    from ssak_tpu_torch.audio.native import library

    lib = library("flacdec")
    with open(path, "rb") as f:
        data = f.read()
    buf = ctypes.POINTER(ctypes.c_float)()
    rate, ch = ctypes.c_int(0), ctypes.c_int(0)
    n = lib.ssak_flac_decode(data, len(data), ctypes.byref(buf), ctypes.byref(rate), ctypes.byref(ch))
    if n < 0:
        raise ValueError(f"decode failed for {path} (code {n})")
    try:
        audio = np.ctypeslib.as_array(buf, shape=(n * ch.value,)).copy() if n else np.zeros(0, np.float32)
    finally:
        lib.ssak_flac_free(buf)
    return audio.reshape(-1, ch.value), rate.value


def flac_info(path):
    """(sample_rate, channels, bits_per_sample, total_samples) of STREAMINFO."""
    from ssak_tpu_torch.audio.native import library

    with open(path, "rb") as f:
        head = f.read(1 << 16)
    rate, ch, bps, total = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_uint64()
    rc = library("flacdec").ssak_flac_info(head, len(head), ctypes.byref(rate), ctypes.byref(ch), ctypes.byref(bps),
                                           ctypes.byref(total))
    if rc < 0:
        raise ValueError(f"not a FLAC file, or a broken STREAMINFO: {path} (code {rc})")
    return rate.value, ch.value, bps.value, total.value


def _av_lib():
    from ssak_tpu_torch.audio.native import library

    try:
        return library("avdec")
    except RuntimeError as e:
        raise RuntimeError("decoding this format needs ffmpeg's libavformat, libavcodec and libavutil with their "
                           f"headers, to build audio/native/avdec.cpp; the build failed:\n{e}") from e


def read_any(path):
    """Decode any ffmpeg-supported audio file to (float32 (frames, ch), rate)."""
    if os.path.splitext(str(path))[1].lower() == ".flac":
        return read_flac(path)
    lib = _av_lib()
    dur = lib.ssak_av_duration(path.encode())
    # generous capacity guess: duration * 96kHz * 2ch (+1 min safety)
    est_frames = int((max(dur, 0) + 60) * 96000)
    cap = est_frames * 2
    out = np.zeros(cap, dtype=np.float32)
    rate = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    n = lib.ssak_av_decode(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
                           ctypes.byref(rate), ctypes.byref(ch))
    if n < 0:
        raise ValueError(f"decode failed for {path} (code {n})")
    c = max(1, ch.value)
    return out[: n * c].reshape(-1, c).copy(), rate.value


def flac_duration(path) -> float:
    """Seconds from the header: for FLAC, STREAMINFO's samples over its rate
    rounded to the microsecond (libavformat's AV_TIME_BASE, to nearest, ties
    away from zero); other formats ask libavformat. Without a sample count
    in the header, the decoded length."""
    if os.path.splitext(str(path))[1].lower() == ".flac":
        rate, _ch, _bps, total = flac_info(path)
        if total == 0:
            audio, sr = read_flac(path)
            return len(audio) / sr
        return ((2 * total * 1_000_000 + rate) // (2 * rate)) / 1e6
    dur = _av_lib().ssak_av_duration(path.encode())
    if dur < 0:
        audio, sr = read_any(path)
        return len(audio) / sr
    return float(dur)
