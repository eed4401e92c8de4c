"""Audio ingest: load_audio / save_audio / durations (counterpart of
ssak_tpu.audio.io).

WAV is decoded in numpy (audio/wav.py), FLAC by the port's own C++ decoder
(audio/flac.py), MP3 through the system libmpg123 (audio/mp3.py), other
ffmpeg formats through libav (audio/flac.read_any), and sox / flac / cat
command pipes of Kaldi wav.scp files are interpreted in-process
(audio/soxcmd.py).
"""

import os

import numpy as np

from ssak_tpu_torch.audio import wav as _wav
from ssak_tpu_torch.audio.resample import resample, to_mono

SUPPORTED_EXTENSIONS = (".wav", ".mp3", ".flac")  # files that a list or a path names as audio (data.dataset)


def _window(audio, sr, start, end):
    s = int(round(start * sr)) if start else 0
    e = len(audio) if end is None else int(round(end * sr))
    return audio[s:e]


def _decode_file(path: str, start: float = 0.0, end: float = None):
    """Decode a file to (audio float32 (frames, ch), native sample rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        info = _wav.wav_info(path)
        sr = info.sample_rate
        start_frame = int(round(start * sr)) if start else 0
        n_frames = -1 if end is None else max(0, int(round(end * sr)) - start_frame)
        return _wav.read_wav(path, start_frame, n_frames)
    if ext == ".mp3":
        from ssak_tpu_torch.audio import mp3 as _mp3

        audio, sr = _mp3.read_mp3(path)
    else:
        # FLAC by the port's own decoder; OGG / Opus / M4A / ... through libav
        from ssak_tpu_torch.audio import flac as _flac

        audio, sr = _flac.read_any(path)
    if start or end is not None:
        audio = _window(audio, sr, start, end)
    return audio, sr


def load_audio(
    path,
    start: float = None,
    end: float = None,
    sample_rate: int = 16000,
    mono: bool = True,
    return_format: str = "array",
    device=None,
):
    """Load (a segment of) an audio file as float32 at the target rate.

    path may be a plain file path or a Kaldi-style command pipe such as
    ``sox in.flac -t wav -r 16k -b 16 -c 1 - |`` (interpreted in-process, no
    sox binary: audio/soxcmd.py).

    return_format: "array" (np.float32), "bytes" (int16 little-endian PCM),
    or "torch" (a float32 tensor on `device`: cuda unless "cpu" is asked
    for; raises without a card).
    """
    if isinstance(path, str) and path.rstrip().endswith("|"):
        from ssak_tpu_torch.audio.soxcmd import decode_pipe_command

        audio, sr = decode_pipe_command(path, start=start, end=end)
    else:
        audio, sr = _decode_file(str(path), start=start or 0.0, end=end)
    if mono:
        audio = to_mono(audio)
    if sample_rate is not None and sr != sample_rate:
        audio = resample(audio, sr, sample_rate, axis=0)
        sr = sample_rate
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    if return_format == "array":
        return audio
    if return_format == "bytes":
        return array_to_bytes(audio)
    if return_format == "torch":
        import torch

        from ssak_tpu_torch.utils.env import resolve_device

        return torch.from_numpy(audio).to(resolve_device(device))
    raise ValueError(f"unknown return_format: {return_format}")


def array_to_bytes(audio: np.ndarray) -> bytes:
    """float32 [-1,1] -> int16 little-endian PCM bytes."""
    return np.clip(np.round(audio * 32768.0), -32768, 32767).astype("<i2").tobytes()


def bytes_to_array(data: bytes) -> np.ndarray:
    return np.frombuffer(data, "<i2").astype(np.float32) / 32768.0


def save_audio(path, audio, sample_rate: int = 16000, bits: int = 16):
    _wav.write_wav(path, np.asarray(audio), sample_rate, bits=bits)


def get_audio_duration(path) -> float:
    """Duration in seconds from headers only (no full decode when possible)."""
    if isinstance(path, str) and path.rstrip().endswith("|"):
        from ssak_tpu_torch.audio.soxcmd import pipe_command_duration

        return pipe_command_duration(path)
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".wav":
        return _wav.wav_info(path).duration
    if ext == ".mp3":
        from ssak_tpu_torch.audio import mp3 as _mp3

        return _mp3.mp3_duration(path)
    from ssak_tpu_torch.audio import flac as _flac

    return _flac.flac_duration(path)


def get_audio_total_duration(paths) -> float:
    return float(sum(get_audio_duration(p) for p in paths))


def mix_audios(paths, output_path, sample_rate: int = 16000):
    """Mix several audio files into one (sum, renormalized if clipping)."""
    sigs = [load_audio(p, sample_rate=sample_rate) for p in paths]
    n = max(len(s) for s in sigs)
    out = np.zeros(n, dtype=np.float32)
    for s in sigs:
        out[: len(s)] += s
    peak = np.abs(out).max()
    if peak > 1.0:
        out /= peak
    save_audio(output_path, out, sample_rate)
    return output_path
