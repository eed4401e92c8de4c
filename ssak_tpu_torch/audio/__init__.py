from ssak_tpu_torch.audio.io import (
    array_to_bytes,
    bytes_to_array,
    get_audio_duration,
    get_audio_total_duration,
    load_audio,
    mix_audios,
    save_audio,
)
from ssak_tpu_torch.audio.resample import resample, resample_torch, to_mono

__all__ = [
    "load_audio",
    "save_audio",
    "get_audio_duration",
    "get_audio_total_duration",
    "array_to_bytes",
    "bytes_to_array",
    "mix_audios",
    "resample",
    "resample_torch",
    "to_mono",
]
