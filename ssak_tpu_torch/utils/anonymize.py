"""Voice anonymization over Kaldi folders (counterpart of
ssak_tpu.utils.anonymize: `anonymize_waveform`, `anonymize_kaldi_dir`).

Host NumPy code, the same as ssak_tpu's: a per-speaker random pitch shift
(a speed change by linear interpolation, then an overlap-add time-stretch
back to the original duration) that de-identifies speakers while keeping
the content intelligible for ASR training. A model-based converter can be
plugged in through `convert_fn` (for instance augment.vc's).
"""

import os
import random

import numpy as np


def _ola_stretch(x: np.ndarray, rate: float, sample_rate: int, grain_s: float = 0.05) -> np.ndarray:
    """Time-stretch by `rate` (output ~len(x)*rate) WITHOUT changing pitch:
    hann-windowed grains taken at input hop/rate, overlap-added at hop."""
    grain = int(sample_rate * grain_s)
    hop = grain // 2
    n_out = int(len(x) * rate)
    out = np.zeros(n_out + grain, np.float64)
    norm = np.zeros_like(out)
    win = np.hanning(grain)
    n_grains = max(1, (n_out - grain) // hop + 1)
    for g in range(n_grains):
        out_pos = g * hop
        in_pos = int(out_pos / rate)
        if in_pos + grain > len(x):
            break
        out[out_pos : out_pos + grain] += x[in_pos : in_pos + grain] * win
        norm[out_pos : out_pos + grain] += win
    out = out / np.maximum(norm, 1e-6)
    return out[:n_out].astype(np.float32)


def anonymize_waveform(audio: np.ndarray, sample_rate: int = 16000, semitones: float = 3.0, rng=None):
    """Pitch-shift by ±semitones keeping duration: speed change (pitch ×
    factor, duration ÷ factor) followed by an OLA time-stretch back."""
    factor = 2 ** (semitones / 12.0)
    # speed change by plain resampling-to-same-rate playback
    idx = np.arange(0, len(audio) - 1, factor)
    sped = np.interp(idx, np.arange(len(audio)), audio).astype(np.float32)
    out = _ola_stretch(sped, len(audio) / max(1, len(sped)), sample_rate)
    if len(out) < len(audio):
        out = np.pad(out, (0, len(audio) - len(out)))
    return out[: len(audio)]


def anonymize_kaldi_dir(
    input_dir: str,
    output_dir: str,
    audio_out_dir: str = None,
    sample_rate: int = 16000,
    semitone_range=(2.0, 5.0),
    seed: int = 0,
    convert_fn=None,
):
    """Re-synthesize every utterance with a per-speaker transform; writes a
    new Kaldi dir pointing at the anonymized audio; speaker ids are renamed
    spk001.... Returns the output dir."""
    from ssak_tpu_torch.audio import load_audio, save_audio
    from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset, KaldiDatasetRow

    ds = KaldiDataset.load(input_dir)
    audio_out_dir = audio_out_dir or os.path.join(output_dir, "audio")
    os.makedirs(audio_out_dir, exist_ok=True)
    rng = random.Random(seed)
    spk_map = {}
    spk_shift = {}
    out = KaldiDataset(name=ds.name + "_anon")
    for r in ds:
        spk = r.speaker or r.id
        if spk not in spk_map:
            spk_map[spk] = f"spk{len(spk_map)+1:03d}"
            sign = rng.choice([-1, 1])
            spk_shift[spk] = sign * rng.uniform(*semitone_range)
        audio = load_audio(r.audio_path, start=r.start, end=r.end, sample_rate=sample_rate)
        if convert_fn is not None:
            anon = convert_fn(audio, spk_map[spk])
        else:
            anon = anonymize_waveform(audio, sample_rate, semitones=spk_shift[spk])
        path = os.path.join(audio_out_dir, f"{r.id}.wav")
        save_audio(path, anon, sample_rate)
        out.append(
            KaldiDatasetRow(
                id=r.id, text=r.text, audio_id=r.id, audio_path=path,
                duration=len(anon) / sample_rate, speaker=spk_map[spk], gender=r.gender,
            )
        )
    out.save(output_dir)
    return output_dir
