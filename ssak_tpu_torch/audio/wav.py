"""RIFF/WAVE codec with offset reads.

Decodes PCM 8/16/24/32-bit, IEEE float 32/64, A-law and mu-law WAV files
(including WAVE_FORMAT_EXTENSIBLE) into float32 numpy arrays in [-1, 1].
Supports reading only a [start_frame, start_frame+n_frames) window without
touching the rest of the file — the capability the reference gets from
libsox offset reads (ssak/utils/audio.py:84-94).

Pure numpy: the port's own copy of ssak_tpu.audio.wav (the port imports
nothing of the JAX package).
"""

import struct

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavFormat:
    __slots__ = ("audio_format", "channels", "sample_rate", "bits_per_sample", "block_align", "data_offset", "data_size")

    def __init__(self, audio_format, channels, sample_rate, bits_per_sample, block_align, data_offset, data_size):
        self.audio_format = audio_format
        self.channels = channels
        self.sample_rate = sample_rate
        self.bits_per_sample = bits_per_sample
        self.block_align = block_align
        self.data_offset = data_offset
        self.data_size = data_size

    @property
    def num_frames(self) -> int:
        return self.data_size // self.block_align if self.block_align else 0

    @property
    def duration(self) -> float:
        return self.num_frames / self.sample_rate if self.sample_rate else 0.0


def read_wav_header(f) -> WavFormat:
    """Parse RIFF chunks up to (and including) the 'data' chunk header."""
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError("no 'data' chunk found")
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:8])[0]
        if cid == b"fmt ":
            body = f.read(size + (size & 1))
            audio_format, channels, rate, _byte_rate, block_align, bits = struct.unpack("<HHIIHH", body[:16])
            if audio_format == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # SubFormat GUID: first 2 bytes are the actual format code
                audio_format = struct.unpack("<H", body[24:26])[0]
            fmt = (audio_format, channels, rate, block_align, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("'data' chunk before 'fmt ' chunk")
            offset = f.tell()
            audio_format, channels, rate, block_align, bits = fmt
            return WavFormat(audio_format, channels, rate, bits, block_align, offset, size)
        else:
            f.seek(size + (size & 1), 1)


# --- companding tables (ITU-T G.711) -------------------------------------

def _alaw_table() -> np.ndarray:
    idx = np.arange(256, dtype=np.int32) ^ 0x55
    sign = np.where(idx & 0x80, -1, 1)
    exponent = (idx >> 4) & 0x07
    mantissa = idx & 0x0F
    mag = np.where(
        exponent == 0,
        (mantissa << 4) + 8,
        ((mantissa << 4) + 0x108) << (exponent - 1),
    )
    return (sign * mag).astype(np.float32) / 32768.0


def _mulaw_table() -> np.ndarray:
    idx = (~np.arange(256)).astype(np.uint8).astype(np.int32)
    sign = np.where(idx & 0x80, -1, 1)
    exponent = (idx >> 4) & 0x07
    mantissa = idx & 0x0F
    mag = (((mantissa << 3) + 0x84) << exponent) - 0x84
    return (sign * mag).astype(np.float32) / 32768.0


_ALAW = _alaw_table()
_MULAW = _mulaw_table()


def _decode_frames(raw: bytes, fmt: WavFormat) -> np.ndarray:
    """bytes -> float32 array of shape (frames, channels), range [-1, 1]."""
    bits, afmt, ch = fmt.bits_per_sample, fmt.audio_format, fmt.channels
    if afmt == WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif afmt == WAVE_FORMAT_IEEE_FLOAT:
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    elif afmt == WAVE_FORMAT_ALAW:
        x = _ALAW[np.frombuffer(raw, np.uint8)]
    elif afmt == WAVE_FORMAT_MULAW:
        x = _MULAW[np.frombuffer(raw, np.uint8)]
    else:
        raise ValueError(f"unsupported WAV audio format code: {afmt}")
    return x.reshape(-1, ch)


def read_wav(path, start_frame: int = 0, n_frames: int = -1):
    """Read a window of a WAV file.

    Returns (audio, sample_rate) where audio is float32 (frames, channels).
    Only the requested byte range of the data chunk is read from disk.
    """
    with open(path, "rb") as f:
        fmt = read_wav_header(f)
        total = fmt.num_frames
        start_frame = max(0, min(start_frame, total))
        if n_frames < 0:
            n_frames = total - start_frame
        n_frames = max(0, min(n_frames, total - start_frame))
        f.seek(fmt.data_offset + start_frame * fmt.block_align)
        raw = f.read(n_frames * fmt.block_align)
    audio = _decode_frames(raw, fmt)
    return audio, fmt.sample_rate


def write_wav(path, audio: np.ndarray, sample_rate: int, bits: int = 16):
    """Write float32/float64 audio (frames,) or (frames, channels) as PCM WAV."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    channels = audio.shape[1]
    if bits == 16:
        data = np.clip(np.round(audio * 32768.0), -32768, 32767).astype("<i2").tobytes()
    elif bits == 32:
        data = np.clip(np.round(audio * float(1 << 31)), -(1 << 31), (1 << 31) - 1).astype("<i4").tobytes()
    else:
        raise ValueError(f"unsupported write bit depth: {bits}")
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, WAVE_FORMAT_PCM, channels, sample_rate, sample_rate * block_align, block_align, bits))
        f.write(b"data" + struct.pack("<I", len(data)))
        f.write(data)
