"""Audio ingest: `load_audio` (counterpart of ssak_tpu.audio.io).

Whole WAV files only for now (ssak_tpu_torch.audio.wav); segment reads,
MP3, FLAC and sox command pipes are later slices of the port and raise
NotImplementedError.
"""

import os

import numpy as np

from ssak_tpu_torch.audio import wav as _wav
from ssak_tpu_torch.audio.resample import resample, to_mono


def load_audio(path, sample_rate: int = 16000):
    """Load a WAV file as mono float32 at the target rate."""
    path = str(path)
    if os.path.splitext(path)[1].lower() != ".wav":
        raise NotImplementedError(f"{path}: only WAV input is ported so far (MP3, FLAC and pipes come later)")
    audio, sr = _wav.read_wav(path)
    audio = to_mono(audio)
    if sample_rate is not None and sr != sample_rate:
        audio = resample(audio, sr, sample_rate, axis=0)
    return np.ascontiguousarray(audio, dtype=np.float32)


def save_audio(path, audio, sample_rate: int = 16000, bits: int = 16):
    _wav.write_wav(path, np.asarray(audio), sample_rate, bits=bits)
