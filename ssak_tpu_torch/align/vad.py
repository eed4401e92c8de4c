"""Voice activity detection (counterpart of ssak_tpu.align.vad; host
numpy).

The default engine is an energy detector (frame RMS in dB against an
adaptive floor); method="nn" takes the trainable neural VAD of
align.nn_vad. Both feed the same merge of close segments, dilatation and
minimum length. `remove_non_speech` keeps the speech and a map back to the
original times; `convert_timestamps` applies it.
"""

import numpy as np


def get_vad_segments(
    audio: np.ndarray,
    sample_rate: int = 16000,
    method: str = "energy",
    min_speech_duration: float = 0.25,
    min_silence_duration: float = 0.33,
    dilatation: float = 0.1,
    energy_threshold_db: float = -35.0,
    frame_ms: float = 30.0,
    nn_params=None,
    nn_threshold: float = 0.5,
):
    """Returns a list of {"start": sec, "end": sec} speech segments.

    method: "energy" or "nn" (nn_params: an align.nn_vad model from
    train_nn_vad / load_vad / vad_from_tree; it runs on its own device)."""
    if method == "nn":
        from ssak_tpu_torch.align import nn_vad

        if nn_params is None:
            raise ValueError("method='nn' requires nn_params (train_nn_vad/load_vad)")
        probs = nn_vad.speech_probs(nn_params, audio, sample_rate)
        active = probs > nn_threshold
        frame = int(sample_rate * nn_vad.FRAME_MS / 1000)
        n_frames = len(active)
    elif method == "energy":
        frame = int(sample_rate * frame_ms / 1000)
        n_frames = max(1, len(audio) // frame)
        x = audio[: n_frames * frame].reshape(n_frames, frame)
        rms = np.sqrt((x**2).mean(axis=1) + 1e-12)
        db = 20 * np.log10(rms + 1e-12)
        # adaptive floor: the threshold is relative to the loud frames
        ref = np.percentile(db, 95)
        active = db > max(ref + energy_threshold_db / 2, energy_threshold_db)
    else:
        raise NotImplementedError(f"VAD method {method!r} ('energy' or 'nn')")

    segs = []
    start = None
    for i, a in enumerate(active):
        if a and start is None:
            start = i
        elif not a and start is not None:
            segs.append((start, i))
            start = None
    if start is not None:
        segs.append((start, n_frames))

    sec = frame / sample_rate
    segs = [(s * sec, e * sec) for s, e in segs]
    segs = [(max(0, s - dilatation), min(len(audio) / sample_rate, e + dilatation)) for s, e in segs]
    merged = []
    for s, e in segs:
        if merged and s - merged[-1][1] < min_silence_duration:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    merged = [(s, e) for s, e in merged if e - s >= min_speech_duration]
    return [{"start": float(s), "end": float(e)} for s, e in merged]


def remove_non_speech(
    audio: np.ndarray,
    sample_rate: int = 16000,
    use_sample: bool = False,
    **kwargs,
):
    """The speech segments concatenated; returns (audio, mapping), where
    each mapping entry takes positions in the new audio back to the
    original times."""
    segs = get_vad_segments(audio, sample_rate, **kwargs)
    if not segs:
        return audio, [{"start": 0.0, "end": len(audio) / sample_rate, "new_start": 0.0, "new_end": len(audio) / sample_rate}]
    pieces = []
    mapping = []
    pos = 0.0
    for seg in segs:
        s, e = seg["start"], seg["end"]
        piece = audio[int(s * sample_rate) : int(e * sample_rate)]
        pieces.append(piece)
        mapping.append({"start": s, "end": e, "new_start": pos, "new_end": pos + (e - s)})
        pos += e - s
    return np.concatenate(pieces) if pieces else audio[:0], mapping


def convert_timestamps(timestamps, mapping):
    """{'start', 'end'} times in VAD-cropped audio back to the original
    times, through remove_non_speech's mapping."""
    out = []
    for ts in timestamps:
        s, e = ts["start"], ts["end"]
        out.append({**ts, "start": _map_time(s, mapping), "end": _map_time(e, mapping)})
    return out


def _map_time(t, mapping):
    for m in mapping:
        if m["new_start"] <= t <= m["new_end"]:
            return m["start"] + (t - m["new_start"])
    if mapping:
        last = mapping[-1]
        return last["end"]
    return t
