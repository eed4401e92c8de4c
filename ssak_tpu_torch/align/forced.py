"""CTC forced alignment: transcript -> char and word segments (counterpart
of ssak_tpu.align.forced).

The trellis runs on the log-probs' device (ops.ctc.ctc_alignment_trellis:
one CUDA graph replayed per frame on the card); host code merges the
Viterbi path into char and word segments with per-segment scores, as
ssak_tpu's does: a label the path skips gets an empty segment at the end
of the previous one, and T < U frames give a uniform alignment with score 0.
"""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Segment:
    label: str
    start: int  # frame index
    end: int    # frame index (exclusive)
    score: float

    def to_seconds(self, ratio: float):
        return Segment(self.label, self.start * ratio, self.end * ratio, self.score)


def tokenize_transcript(transcript: str, vocab, word_delimiter: str = "|", fallback_char=None):
    """Transcript chars -> token ids, trying the char, its lower and upper
    case, then its transliteration (accents stripped) and that in lower
    case; an unknown char takes `fallback_char` when the vocabulary has it,
    else it is dropped. Returns (ids int32, kept chars)."""
    from ssak_tpu_torch.text.basic import transliterate

    index = {}
    for i, tok in enumerate(vocab):
        index.setdefault(tok, i)
    ids = []
    chars = []
    text = transcript.replace(" ", word_delimiter)
    for ch in text:
        cand = [ch, ch.lower(), ch.upper(), transliterate(ch), transliterate(ch).lower()]
        tid = None
        for c in cand:
            if c in index:
                tid = index[c]
                break
        if tid is None:
            if fallback_char is not None and fallback_char in index:
                tid = index[fallback_char]
            else:
                continue
        ids.append(tid)
        chars.append(ch)
    return np.asarray(ids, np.int32), chars


def compute_alignment(log_probas, transcript: str, vocab, blank_id: int = 0, word_delimiter: str = "|",
                      use_max: bool = True, device=None):
    """Align one utterance. log_probas: (T, V) log-softmax frames, a numpy
    array or a tensor. The trellis runs on `device`, by default the
    log-probs' own (the CPU for a numpy array); the scores are read from a
    numpy array as given, so a host copy goes up once and never comes back.
    Returns (char_segments, word_segments) in frame indices; seconds =
    frame * total_seconds / T."""
    from ssak_tpu_torch.ops.ctc import ctc_alignment_trellis

    tokens, chars = tokenize_transcript(transcript, vocab, word_delimiter)
    if len(tokens) == 0:
        return [], []
    T = log_probas.shape[0]
    if T < len(tokens):
        # not enough frames: a uniform alignment, as the reference
        char_segs = [Segment(c, int(i * T / len(chars)), int((i + 1) * T / len(chars)), 0.0) for i, c in enumerate(chars)]
        return char_segs, merge_words(char_segs, word_delimiter)

    lp = torch.as_tensor(log_probas, device=device)
    _trellis, path = ctc_alignment_trellis(lp, tokens, blank_id=blank_id, use_max=use_max)
    path = path.numpy()
    host = log_probas if isinstance(log_probas, np.ndarray) else lp.cpu().numpy()
    probs = np.exp(host)

    # state s odd -> label (s - 1) // 2; the frames of each label occurrence
    char_segs = []
    for u, ch in enumerate(chars):
        s = 2 * u + 1
        frames = np.where(path == s)[0]
        if len(frames) == 0:
            # label skipped by the Viterbi path: an empty segment at the previous end
            prev_end = char_segs[-1].end if char_segs else 0
            char_segs.append(Segment(ch, prev_end, prev_end, 0.0))
            continue
        start, end = int(frames[0]), int(frames[-1]) + 1
        score = float(np.mean(probs[frames, tokens[u]]))
        char_segs.append(Segment(ch, start, end, score))
    return char_segs, merge_words(char_segs, word_delimiter)


def merge_words(char_segments, word_delimiter: str = "|"):
    """Char segments grouped into word segments, each scored by the mean of
    its non-empty chars' scores."""
    words = []
    cur = []
    for seg in char_segments:
        if seg.label == word_delimiter or seg.label == " ":
            if cur:
                words.append(_merge(cur))
                cur = []
        else:
            cur.append(seg)
    if cur:
        words.append(_merge(cur))
    return words


def _merge(segs):
    label = "".join(s.label for s in segs)
    scores = [s.score for s in segs if s.end > s.start]
    return Segment(label, segs[0].start, segs[-1].end, float(np.mean(scores)) if scores else 0.0)


def align_audio_to_transcript(model, audio: np.ndarray, transcript: str, sample_rate: int = 16000):
    """One utterance end to end: the model's log-probs (140 s chunks, on
    the model's device), the trellis on that device -> word segments in
    seconds. model: a CTC LoadedModel."""
    from ssak_tpu_torch.infer.ctc_infer import ctc_compute_logits_chunked

    lp = ctc_compute_logits_chunked(model, audio)
    vocab = model.vocab()
    chars, words = compute_alignment(lp, transcript, vocab, blank_id=model.cfg.blank_id, device=model.device)
    ratio = (len(audio) / sample_rate) / max(1, lp.shape[0])
    return [w.to_seconds(ratio) for w in words]
