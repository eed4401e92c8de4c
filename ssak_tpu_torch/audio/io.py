"""Audio ingest: `load_audio` (counterpart of ssak_tpu.audio.io).

WAV files, whole or a [start, end) window in seconds (Kaldi `segments`),
through ssak_tpu_torch.audio.wav; MP3, FLAC and sox command pipes are later
slices of the port and raise NotImplementedError.
"""

import os

import numpy as np

from ssak_tpu_torch.audio import wav as _wav
from ssak_tpu_torch.audio.resample import resample, to_mono


def load_audio(path, start: float = None, end: float = None, sample_rate: int = 16000):
    """Load (a window in seconds of) a WAV file as mono float32 at the target rate."""
    path = str(path)
    if os.path.splitext(path)[1].lower() != ".wav":
        raise NotImplementedError(f"{path}: only WAV input is ported so far (MP3, FLAC and pipes come later)")
    if start or end is not None:
        with open(path, "rb") as f:
            sr = _wav.read_wav_header(f).sample_rate
        start_frame = int(round(start * sr)) if start else 0
        n_frames = -1 if end is None else max(0, int(round(end * sr)) - start_frame)
        audio, sr = _wav.read_wav(path, start_frame, n_frames)
    else:
        audio, sr = _wav.read_wav(path)
    audio = to_mono(audio)
    if sample_rate is not None and sr != sample_rate:
        audio = resample(audio, sr, sample_rate, axis=0)
    return np.ascontiguousarray(audio, dtype=np.float32)


def save_audio(path, audio, sample_rate: int = 16000, bits: int = 16):
    _wav.write_wav(path, np.asarray(audio), sample_rate, bits=bits)
