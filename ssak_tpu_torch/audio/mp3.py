"""MP3 (MPEG-1/2/2.5 Layer III): duration by walking the frame headers in
Python, decoding through the system libmpg123 (audio/native/mp3dec.cpp,
dlopen'd). The port's own copy of ssak_tpu.audio.mp3.

A host without libmpg123 still gets durations; `read_mp3` raises there by
name (the port carries no Layer III decoder of its own yet, ROADMAP.md).
"""

import ctypes
import struct

import numpy as np

_BITRATES_V1_L3 = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320]
_BITRATES_V2_L3 = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160]
_RATES = {3: [44100, 48000, 32000], 2: [22050, 24000, 16000], 0: [11025, 12000, 8000]}


def _parse_frame_header(hdr: int):
    """Return (frame_bytes, samples_per_frame, sample_rate, channels) or None."""
    if (hdr >> 21) & 0x7FF != 0x7FF:
        return None
    version = (hdr >> 19) & 0x3  # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
    layer = (hdr >> 17) & 0x3  # 1 = Layer III
    if version == 1 or layer != 1:
        return None
    bitrate_idx = (hdr >> 12) & 0xF
    rate_idx = (hdr >> 10) & 0x3
    if bitrate_idx in (0, 15) or rate_idx == 3:
        return None
    padding = (hdr >> 9) & 0x1
    mode = (hdr >> 6) & 0x3
    channels = 1 if mode == 3 else 2
    sample_rate = _RATES[version][rate_idx]
    if version == 3:
        bitrate = _BITRATES_V1_L3[bitrate_idx] * 1000
        samples = 1152
        frame_bytes = 144 * bitrate // sample_rate + padding
    else:
        bitrate = _BITRATES_V2_L3[bitrate_idx] * 1000
        samples = 576
        frame_bytes = 72 * bitrate // sample_rate + padding
    return frame_bytes, samples, sample_rate, channels


def _skip_id3(data: bytes) -> int:
    if data[:3] == b"ID3" and len(data) >= 10:
        size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        return 10 + size
    return 0


def walk_frames(data: bytes):
    """Yield (offset, frame_bytes, samples, sample_rate, channels) per frame."""
    pos = _skip_id3(data)
    n = len(data)
    while pos + 4 <= n:
        hdr = struct.unpack(">I", data[pos : pos + 4])[0]
        info = _parse_frame_header(hdr)
        if info is None:
            pos += 1
            continue
        frame_bytes, samples, sr, ch = info
        if frame_bytes <= 0:
            pos += 1
            continue
        yield pos, frame_bytes, samples, sr, ch
        pos += frame_bytes


def mp3_duration(path) -> float:
    """Duration by walking frame headers (handles VBR correctly)."""
    with open(path, "rb") as f:
        data = f.read()
    total = 0.0
    for _pos, _fb, samples, sr, _ch in walk_frames(data):
        total += samples / sr
    return total


def mp3_available() -> bool:
    """Whether this host's libmpg123 loads (mp3dec.cpp is built to ask)."""
    from ssak_tpu_torch.audio.native import library

    return bool(library("mp3dec").ssak_mp3_available())


def read_mp3(path):
    """Decode an MP3 file to (float32 (frames, channels), sample_rate)."""
    from ssak_tpu_torch.audio.native import library

    if not mp3_available():
        raise RuntimeError(f"{path}: MP3 decoding needs the system libmpg123 (libmpg123.so.0), which this host lacks")
    with open(path, "rb") as f:
        data = f.read()
    # upper bound on sample count from frame walk
    total_samples = 0
    sample_rate = 0
    channels = 1
    for _pos, _fb, samples, sr, ch in walk_frames(data):
        total_samples += samples
        sample_rate = sr
        channels = max(channels, ch)
    if total_samples == 0:
        raise ValueError(f"no MPEG audio frames found in {path}")
    # decoder may emit up to 2 extra frames of delay compensation
    cap = (total_samples + 4 * 1152) * channels
    out = np.zeros(cap, dtype=np.float32)
    out_sr = ctypes.c_int(0)
    out_ch = ctypes.c_int(0)
    n = library("mp3dec").ssak_mp3_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
                            ctypes.byref(out_sr), ctypes.byref(out_ch))
    if n < 0:
        raise ValueError(f"MP3 decode failed for {path} (code {n})")
    ch = max(1, out_ch.value)
    return out[: n * ch].reshape(-1, ch).copy(), out_sr.value or sample_rate
