"""Waveform augmentation on the host (counterpart of
ssak_tpu.augment.speech; numpy and scipy, in the data loader).

`SpeechAugment` applies, with probability `apply_prob`, ONE transform
chosen at random among gaussian noise, clipping, band-stop, gain, pitch
shift, background noise (a noise directory) and reverberation (room
impulse responses: a directory, or Kaldi RIR lists in it), then a time
stretch in [0.95, 1.05] (one factor for a whole batch in `augment_batch`).
It keeps ssak_tpu's generators (`random.Random(seed)` and
`np.random.RandomState(seed)`) and draws from them in ssak_tpu's order, so
one seed gives the same waveforms bit for bit in both packages.
"""

import os
import random

import numpy as np


class SpeechAugment:
    def __init__(
        self,
        noise_dir: str = None,
        rir_dir: str = None,
        rir_lists=None,
        apply_prob: float = 0.5,
        sample_rate: int = 16000,
        seed: int = None,
    ):
        self.sample_rate = sample_rate
        self.apply_prob = apply_prob
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.noise_files = self._collect(noise_dir)
        self.rir_files = self._collect_rirs(rir_dir, rir_lists)
        self.transforms = [
            self.gaussian_noise,
            self.clipping,
            self.band_stop,
            self.gain,
            self.pitch_shift,
        ]
        if self.noise_files:
            self.transforms.append(self.background_noise)
        if self.rir_files:
            self.transforms.append(self.reverberation)

    @staticmethod
    def _collect(d):
        if not d or not os.path.isdir(d):
            return []
        out = []
        for root, _dirs, files in os.walk(d):
            out.extend(os.path.join(root, f) for f in sorted(files) if f.lower().endswith((".wav", ".mp3", ".flac")))
        return sorted(out)

    def _collect_rirs(self, rir_dir, rir_lists):
        """rir_lists: Kaldi-format list files with lines
        '--rir-id X ... path/to/rir.wav' (reference augment_reverberation.py:72)."""
        files = []
        if rir_dir and rir_lists:
            for lst in rir_lists:
                path = os.path.join(rir_dir, lst)
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    for line in f:
                        toks = line.split()
                        if toks:
                            rel = toks[-1]
                            files.append(rel if os.path.isabs(rel) else os.path.join(rir_dir, rel))
        elif rir_dir:
            files = self._collect(rir_dir)
        return [f for f in files if os.path.exists(f)]

    # --- individual transforms -------------------------------------------

    def gaussian_noise(self, x):
        amp = self.np_rng.uniform(0.001, 0.015)
        return x + amp * self.np_rng.randn(len(x)).astype(np.float32)

    def clipping(self, x):
        pct = self.np_rng.uniform(0.0, 0.1)
        if pct <= 0:
            return x
        lo, hi = np.percentile(x, [pct * 50, 100 - pct * 50])
        return np.clip(x, lo, hi).astype(np.float32)

    def band_stop(self, x):
        from scipy.signal import butter, sosfilt

        f0 = self.np_rng.uniform(200, self.sample_rate / 2 * 0.8)
        bw = f0 * self.np_rng.uniform(0.2, 0.8)
        lo = max(20.0, f0 - bw / 2)
        hi = min(self.sample_rate / 2 - 100, f0 + bw / 2)
        sos = butter(4, [lo, hi], btype="bandstop", fs=self.sample_rate, output="sos")
        return sosfilt(sos, x).astype(np.float32)

    def gain(self, x):
        db = self.np_rng.uniform(-12, 12)
        return (x * (10 ** (db / 20))).astype(np.float32)

    def pitch_shift(self, x):
        """Resample-based pitch shift (±2 semitones) keeping duration."""
        from ssak_tpu_torch.audio.resample import resample

        semitones = self.np_rng.uniform(-2, 2)
        factor = 2 ** (semitones / 12)
        y = resample(x, self.sample_rate, int(round(self.sample_rate / factor)))
        # stretch back to original length by linear interp
        idx = np.linspace(0, len(y) - 1, num=len(x))
        return np.interp(idx, np.arange(len(y)), y).astype(np.float32)

    def background_noise(self, x):
        from ssak_tpu_torch.audio import load_audio

        path = self.rng.choice(self.noise_files)
        noise = load_audio(path, sample_rate=self.sample_rate)
        if len(noise) < len(x):
            noise = np.tile(noise, int(np.ceil(len(x) / max(1, len(noise)))))
        start = self.rng.randrange(max(1, len(noise) - len(x) + 1))
        noise = noise[start : start + len(x)]
        snr_db = self.np_rng.uniform(3, 30)
        px = np.mean(x**2) + 1e-10
        pn = np.mean(noise**2) + 1e-10
        scale = np.sqrt(px / (pn * 10 ** (snr_db / 10)))
        return (x + scale * noise).astype(np.float32)

    def reverberation(self, x):
        from ssak_tpu_torch.audio import load_audio

        rir = load_audio(self.rng.choice(self.rir_files), sample_rate=self.sample_rate)
        rir = rir / (np.abs(rir).max() + 1e-10)
        from scipy.signal import fftconvolve

        y = fftconvolve(x, rir)[: len(x)]
        peak_in = np.abs(x).max() + 1e-10
        peak_out = np.abs(y).max() + 1e-10
        return (y * (peak_in / peak_out)).astype(np.float32)

    def time_stretch(self, x, low: float = 0.95, high: float = 1.05, factor: float = None):
        factor = factor if factor is not None else self.np_rng.uniform(low, high)
        n_out = int(round(len(x) / factor))
        idx = np.linspace(0, len(x) - 1, num=n_out)
        return np.interp(idx, np.arange(len(x)), x).astype(np.float32), factor

    # --- main entry -------------------------------------------------------

    def __call__(self, x, freeze_speed: float = None):
        """Augment one waveform. freeze_speed pins the time-stretch factor
        (reference batch mode freezes speed across a batch :182-194)."""
        x = np.asarray(x, np.float32)
        if self.rng.random() < self.apply_prob and self.transforms:
            x = self.rng.choice(self.transforms)(x)
        x, factor = self.time_stretch(x, factor=freeze_speed)
        return x

    def augment_batch(self, batch):
        """Same speed factor across the batch (keeps bucket lengths usable)."""
        factor = self.np_rng.uniform(0.95, 1.05)
        return [self(x, freeze_speed=factor) for x in batch]
