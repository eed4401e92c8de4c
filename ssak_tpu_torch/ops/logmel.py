"""Log-mel spectrograms in PyTorch (counterpart of ssak_tpu.ops.logmel).

Same numerics as the JAX package, the windowed DFT as one matmul against
precomputed cos/sin matrices (hann pre-applied) in both frontends:
- Whisper: reflect padding, magnitude², slaney mel filterbank, log10 with a
  1e-10 floor, clamp to (max - 8), (x + 4) / 4, the final frame dropped;
- NeMo (`nemo_log_mel_spectrogram`, the features of NeMo Conformer
  checkpoints): pre-emphasis 0.97, a 400-sample window padded to n_fft 512,
  natural log with a 2^-24 guard, per-feature normalisation over the valid
  frames, the final frame kept.
"""

import functools
import math

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH = 30  # seconds per Whisper window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def hann_window(n: int) -> np.ndarray:
    return (0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / n))).astype(np.float32)


@functools.lru_cache(maxsize=4)
def dft_matrices(n_fft: int = N_FFT, win_length: int = None):
    """Real/imag DFT matrices (n_fft, n_fft//2+1) with hann pre-applied.
    win_length < n_fft pads the window symmetrically (torch.stft layout)."""
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * k * f / n_fft
    win_length = win_length or n_fft
    w = hann_window(win_length)
    if win_length < n_fft:
        lo = (n_fft - win_length) // 2
        w = np.pad(w, (lo, n_fft - win_length - lo))
    w = w[:, None]
    return (np.cos(ang) * w).astype(np.float32), (np.sin(ang) * w).astype(np.float32)


@functools.lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale mel filterbank, matching librosa.filters.mel(htk=False)."""
    n_freqs = n_fft // 2 + 1
    fmin, fmax = 0.0, sample_rate / 2.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        linear = f / (200.0 / 3)
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, linear)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        linear = m * (200.0 / 3)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), linear)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz = mel_to_hz(mels)
    freqs = np.linspace(0, fmax, n_freqs)
    fb = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lower = (freqs - hz[i]) / (hz[i + 1] - hz[i])
        upper = (hz[i + 2] - freqs) / (hz[i + 2] - hz[i + 1])
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz[2 : n_mels + 2] - hz[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


def log_mel_spectrogram(audio, n_mels: int = N_MELS):
    """audio: (..., T) float32 tensor at 16 kHz -> (..., n_mels, n_frames)
    f32 on the same device, with n_frames = T // 160."""
    import torch
    import torch.nn.functional as F

    lead = audio.shape[:-1]
    x = audio.reshape(-1, 1, audio.shape[-1]).to(torch.float32)
    pad = N_FFT // 2
    x = F.pad(x, (pad, pad), mode="reflect")[:, 0]  # reflect needs the (B, C, T) view
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)[:, :-1]  # (B, F, n_fft); whisper drops the final frame
    cos_m, sin_m = dft_matrices()
    dev = audio.device
    re = torch.matmul(frames, torch.from_numpy(cos_m).to(dev))
    im = torch.matmul(frames, torch.from_numpy(sin_m).to(dev))
    power = re**2 + im**2
    mel = torch.matmul(power, torch.from_numpy(mel_filterbank(n_mels)).to(dev).T)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    maxval = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, maxval - 8.0)
    out = ((log_spec + 4.0) / 4.0).transpose(-2, -1)
    return out.reshape(*lead, n_mels, out.shape[-1])


def nemo_log_mel_spectrogram(audio, n_mels: int = 80, sample_lengths=None):
    """NeMo AudioToMelSpectrogramPreprocessor features: audio (B, T) f32 at
    16 kHz -> ((B, n_mels, F) f32, frame_lengths (B,) int32) on the same
    device, F = T // 160 + 1. Samples past each length are zeroed before
    the pre-emphasis; mean and unbiased std per mel bin over the valid
    frames, (x - mean) / (std + 1e-5), pad frames zeroed."""
    import torch
    import torch.nn.functional as F

    n_fft, win, hop = 512, 400, 160
    x = audio.to(torch.float32)
    dev = x.device
    if sample_lengths is None:
        sample_lengths = torch.full((x.shape[0],), x.shape[-1], dtype=torch.int32, device=dev)
    sample_lengths = torch.as_tensor(sample_lengths, device=dev)
    valid = torch.arange(x.shape[-1], device=dev)[None, :] < sample_lengths[:, None]
    x = torch.where(valid, x, 0.0)
    x = torch.cat([x[..., :1], x[..., 1:] - 0.97 * x[..., :-1]], dim=-1)

    cos_m, sin_m = dft_matrices(n_fft, win)
    pad = n_fft // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]  # reflect needs the (B, C, T) view
    frames = xp.unfold(-1, n_fft, hop)  # (B, F, n_fft), F = T // hop + 1
    n_frames = frames.shape[1]
    re = torch.matmul(frames, torch.from_numpy(cos_m).to(dev))
    im = torch.matmul(frames, torch.from_numpy(sin_m).to(dev))
    power = re**2 + im**2
    mel = torch.matmul(power, torch.from_numpy(mel_filterbank(n_mels, n_fft)).to(dev).T)
    log_mel = torch.log(mel + 2.0**-24)  # (B, F, n_mels)

    frame_lengths = torch.clamp(sample_lengths // hop + 1, max=n_frames).to(torch.int32)
    fmask = (torch.arange(n_frames, device=dev)[None, :] < frame_lengths[:, None])[..., None]
    n = torch.clamp(frame_lengths, min=1).to(torch.float32)[:, None, None]
    mean = torch.where(fmask, log_mel, 0.0).sum(dim=-2, keepdim=True) / n
    var = torch.where(fmask, (log_mel - mean) ** 2, 0.0).sum(dim=-2, keepdim=True) / torch.clamp(n - 1, min=1.0)
    out = (log_mel - mean) / (torch.sqrt(var) + 1e-5)
    out = torch.where(fmask, out, 0.0)
    return out.transpose(-2, -1), frame_lengths  # (B, n_mels, F)


def pad_or_trim(audio, length: int = N_SAMPLES, axis: int = -1):
    """Whisper's pad_or_trim: zero-pad or cut to exactly `length` samples."""
    import torch
    import torch.nn.functional as F

    n = audio.shape[axis]
    if n > length:
        return torch.narrow(audio, axis, 0, length)
    if n < length:
        axis = axis % audio.ndim
        pads = [0, 0] * (audio.ndim - 1 - axis) + [0, length - n]
        return F.pad(audio, pads)
    return audio
