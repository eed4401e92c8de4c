"""Sample-rate conversion on the host (counterpart of the host half of
ssak_tpu.audio.resample: `resample` and `to_mono`).

Polyphase windowed-sinc resampling (Kaiser window) via
scipy.signal.resample_poly, the same filter the JAX package uses.
"""

import math

import numpy as np


def resample(audio: np.ndarray, orig_sr: int, target_sr: int, axis: int = 0) -> np.ndarray:
    """Band-limited resampling on host. audio: float32 array."""
    if orig_sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    out = resample_poly(audio.astype(np.float64), up, down, axis=axis, window=("kaiser", 14.769656459379492))
    return out.astype(np.float32)


def to_mono(audio: np.ndarray) -> np.ndarray:
    """Downmix (frames, channels) to (frames,) by channel averaging."""
    if audio.ndim == 2:
        if audio.shape[1] == 1:
            return audio[:, 0]
        return audio.mean(axis=1)
    return audio
