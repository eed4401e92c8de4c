"""Sample-rate conversion (counterpart of ssak_tpu.audio.resample).

Polyphase windowed-sinc resampling (Kaiser window): on the host via
scipy.signal.resample_poly (`resample`), and on a tensor's own device
(`resample_torch`, the counterpart of `resample_jax`): the zero-stuffing
upsample and the anti-aliasing filter as one `conv_transpose1d`, then every
`down`-th sample, clamped to the last.
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


def _polyphase_filter(up: int, down: int, taps_per_phase: int = 24, beta: float = 14.769656459379492):
    """The anti-aliasing lowpass: 2 * taps_per_phase * max(up, down) + 1
    float32 taps, cut at the lower Nyquist, gain `up`."""
    max_rate = max(up, down)
    cutoff = 1.0 / max_rate  # relative to Nyquist of the upsampled signal
    half_len = taps_per_phase * max_rate
    n = 2 * half_len + 1
    t = np.arange(n) - half_len
    h = cutoff * np.sinc(cutoff * t)
    h *= np.kaiser(n, beta)
    h *= up
    return h.astype(np.float32)


def resample_torch(audio, orig_sr: int, target_sr: int, taps_per_phase: int = 24):
    """Resample (..., time) on the tensor's device (a numpy array goes to
    the CPU): ceil(time * up / down) samples out, as resample_jax gives.

    ssak_tpu's lax.conv_transpose pads the stuffed input by (half, half) and
    correlates with the filter; conv_transpose1d with padding `half` and
    the filter reversed gives the same (t_in - 1) * up + 1 samples."""
    import torch
    import torch.nn.functional as F

    if orig_sr == target_sr:
        return audio
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    h = _polyphase_filter(up, down, taps_per_phase)
    n_taps = h.shape[0]
    half = n_taps // 2

    x = torch.as_tensor(audio)
    lead_shape = x.shape[:-1]
    t_in = x.shape[-1]
    w = torch.from_numpy(np.ascontiguousarray(h[::-1])).to(device=x.device, dtype=x.dtype).reshape(1, 1, n_taps)
    y = F.conv_transpose1d(x.reshape(-1, 1, t_in), w, stride=up, padding=half)
    t_out_full = y.shape[-1]
    n_out = int(math.ceil(t_in * up / down))
    idx = (torch.arange(n_out, device=x.device) * down).clamp_(max=t_out_full - 1)
    return y[..., idx].reshape(lead_shape + (n_out,))


def to_mono(audio: np.ndarray) -> np.ndarray:
    """Downmix (frames, channels) to (frames,) by channel averaging."""
    if audio.ndim == 2:
        if audio.shape[1] == 1:
            return audio[:, 0]
        return audio.mean(axis=1)
    return audio
