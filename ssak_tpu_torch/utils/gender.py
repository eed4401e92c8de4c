"""Speaker gender classification (counterpart of ssak_tpu.utils.gender:
`estimate_f0_autocorr`, `predict_gender`, `classify_speech`,
`predict_gender_kaldi_dir`).

Two routes, as in ssak_tpu: a pitch heuristic on the host that needs no
model (median F0 by autocorrelation: female voices typically > 165 Hz,
male < 155 Hz), and a classification head on a wav2vec2 encoder (hidden
states mean-pooled over the valid frames, then one dense layer), run on the
model's device. At >= 4,096 frames (about 82 s of audio) the encoder's
self-attention goes through L1 on the card (models.layers._can_flash).
"""

import numpy as np


def estimate_f0_autocorr(audio: np.ndarray, sample_rate: int = 16000, fmin: float = 60.0, fmax: float = 400.0, frame_s: float = 0.04):
    """Median fundamental frequency over voiced frames (autocorrelation)."""
    frame = int(sample_rate * frame_s)
    hop = frame // 2
    lags_min = int(sample_rate / fmax)
    lags_max = int(sample_rate / fmin)
    f0s = []
    for start in range(0, max(1, len(audio) - frame), hop):
        x = audio[start : start + frame]
        if len(x) < frame or np.sqrt((x**2).mean() + 1e-12) < 0.01:
            continue
        x = x - x.mean()
        ac = np.correlate(x, x, mode="full")[len(x) - 1 :]
        if ac[0] <= 0:
            continue
        ac = ac / ac[0]
        seg = ac[lags_min:lags_max]
        if len(seg) == 0:
            continue
        peak = int(np.argmax(seg)) + lags_min
        # voiced only when the autocorrelation peak is strong
        if ac[peak] > 0.5:
            f0s.append(sample_rate / peak)
    return float(np.median(f0s)) if f0s else 0.0


def predict_gender(audio, sample_rate: int = 16000, model=None, return_proba: bool = False):
    """'m' | 'f' (or probabilities). model: optional LoadedModel whose
    module carries a classifier head; default is the pitch heuristic."""
    audio = np.asarray(audio, np.float32)
    if model is not None:
        probs = classify_speech(model, audio)
        label = "f" if probs.get("f", 0) >= probs.get("m", 0) else "m"
        return probs if return_proba else label
    f0 = estimate_f0_autocorr(audio, sample_rate)
    if f0 <= 0:
        return {"m": 0.5, "f": 0.5} if return_proba else "m"
    # logistic transition centered at 160 Hz
    pf = 1.0 / (1.0 + np.exp(-(f0 - 160.0) / 12.0))
    if return_proba:
        return {"m": float(1 - pf), "f": float(pf), "f0": f0}
    return "f" if pf >= 0.5 else "m"


def classify_speech(model, audio, labels=("m", "f")):
    """One utterance (f32 samples at 16 kHz) -> {label: probability}: the
    wav2vec2 encoder (models.wav2vec2.encode) on model.device, its hidden
    states mean-pooled over the valid frames, the classifier head
    (model.module.classifier, a dense layer: models.convert carries
    ssak_tpu's 'classifier' {kernel, bias} leaf) in the model's compute
    dtype, and a softmax over the labels in f32."""
    import torch

    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.models.layers import dense

    head = getattr(model.module, "classifier", None)
    if head is None:
        raise ValueError("classify_speech needs a classifier head on the wav2vec2 model (its 'classifier' leaf)")
    x = torch.as_tensor(np.asarray(audio, np.float32), device=model.device)[None]
    with torch.no_grad():
        hidden, fl = wav2vec2.encode(model.module, x, model.cfg)
        n = int(fl[0])
        pooled = hidden[:, :n].mean(dim=1)
        logits = dense(pooled, head).to(torch.float32)
        probs = torch.exp(logits - torch.logsumexp(logits, dim=-1, keepdim=True))[0].cpu().numpy()
    return {lab: float(p) for lab, p in zip(labels, probs)}


def predict_gender_kaldi_dir(kaldi_dir: str, output_path: str = None, sample_rate: int = 16000):
    """Fill spk2gender for a Kaldi dir by majority vote over each speaker's
    utterances (the pitch heuristic, on the host)."""
    from collections import Counter, defaultdict

    from ssak_tpu_torch.audio import load_audio
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.data.kaldi import write_keyed_file

    _meta, rows = kaldi_folder_to_manifest(kaldi_dir)
    votes = defaultdict(Counter)
    for r in rows:
        audio = load_audio(r["audio"], start=r["start"], end=r["end"], sample_rate=sample_rate)
        votes[r["speaker"] or r["id"]][predict_gender(audio, sample_rate)] += 1
    s2g = {spk: c.most_common(1)[0][0] for spk, c in votes.items()}
    if output_path:
        write_keyed_file(output_path, s2g)
    return s2g
