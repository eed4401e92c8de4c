"""Split long Kaldi utterances at word boundaries by CTC forced alignment
(the port's counterpart of tools/align_audio_transcript.py):

    python -m ssak_tpu_torch.tools.align_audio_transcript INPUT_DIR OUTPUT_DIR --model CTC_DIR \
        [--max_duration 30] [--language fr] [--device cpu]

Utterances longer than --max_duration are aligned with a CTC model (its
log-probs and the trellis on the model's device: cuda unless --device
cpu), words are gathered greedily and cut at word boundaries into segments
with `_cutNN` id suffixes; a first or last segment whose mean word score is
below min_segment_score is dropped (when there is more than one). The
result passes check_kaldi_dir.
"""

import argparse
import os
import re

import numpy as np


def split_long_audio_kaldifolder(
    input_dir: str,
    output_dir: str,
    model_dir: str = None,
    max_duration: float = 30.0,
    language: str = "fr",
    min_segment_score: float = 0.4,
    seeded_test_config: str = None,
    device=None,
):
    from ssak_tpu_torch.align.forced import align_audio_to_transcript
    from ssak_tpu_torch.audio import load_audio
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.data.kaldi import check_kaldi_dir, utt2spk_to_spk2utt, write_keyed_file, write_segments
    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.text import format_text
    from ssak_tpu_torch.utils.monitoring import logger

    model = load_model(model_dir, seeded_test_config=seeded_test_config, device=device)
    _meta, rows = kaldi_folder_to_manifest(input_dir)

    os.makedirs(output_dir, exist_ok=True)
    wavscp, text, segments, utt2spk, utt2dur, spk2gender = {}, {}, {}, {}, {}, {}

    def norm(t):
        try:
            return format_text(t, language, extract_parenthesized=False, safety_checks=False).replace("\n", " ")
        except Exception:
            return t.lower()

    for row in rows:
        rec = row["audio"]
        base_start = row["start"] or 0.0
        dur = row["duration"] or 0.0
        wav_key = _wav_key(row, wavscp)
        wavscp[wav_key] = rec
        spk = row["speaker"] or wav_key
        if dur <= max_duration:
            utt = row["id"]
            segments[utt] = (wav_key, base_start, base_start + dur)
            text[utt] = row["text"] or ""
            utt2spk[utt] = spk
            utt2dur[utt] = f"{dur:.6f}"
            if row.get("gender"):
                spk2gender[spk] = row["gender"]
            continue

        # a long utterance: align and cut
        audio = load_audio(rec, start=row["start"], end=row["end"], sample_rate=model.sample_rate)
        transcript = norm(row["text"] or "")
        words = align_audio_to_transcript(model, audio, transcript, model.sample_rate)
        if not words:
            logger.warning(f"{row['id']}: no alignment, keeping whole utterance")
            words = []
        cuts = []
        cur_words, cur_start = [], 0.0
        for w in words:
            if w.end - cur_start > max_duration and cur_words:
                cuts.append((cur_start, cur_words[-1].end, cur_words))
                cur_start = w.start
                cur_words = [w]
            else:
                cur_words.append(w)
        if cur_words:
            cuts.append((cur_start, cur_words[-1].end, cur_words))
        if not cuts:
            cuts = [(0.0, dur, [])]
        for n, (s, e, ws) in enumerate(cuts):
            # a first or last segment with a low alignment score is dropped
            if ws and n in (0, len(cuts) - 1) and np.mean([w.score for w in ws]) < min_segment_score and len(cuts) > 1:
                logger.warning(f"{row['id']}_cut{n:02d}: low alignment score, dropped")
                continue
            utt = f"{row['id']}_cut{n:02d}"
            seg_s, seg_e = base_start + s, base_start + min(e if ws else dur, dur)
            segments[utt] = (wav_key, seg_s, seg_e)
            text[utt] = " ".join(w.label for w in ws) if ws else (row["text"] or "")
            utt2spk[utt] = spk
            utt2dur[utt] = f"{seg_e - seg_s:.6f}"
            if row.get("gender"):
                spk2gender[spk] = row["gender"]

    write_keyed_file(os.path.join(output_dir, "wav.scp"), wavscp)
    write_segments(os.path.join(output_dir, "segments"), segments)
    write_keyed_file(os.path.join(output_dir, "text"), text)
    write_keyed_file(os.path.join(output_dir, "utt2spk"), utt2spk)
    write_keyed_file(os.path.join(output_dir, "utt2dur"), utt2dur)
    if spk2gender:
        write_keyed_file(os.path.join(output_dir, "spk2gender"), spk2gender)
    write_keyed_file(os.path.join(output_dir, "spk2utt"), utt2spk_to_spk2utt(utt2spk))
    return check_kaldi_dir(output_dir, fix=True, compute_utt2dur=False)


def _wav_key(row, wavscp):
    src = row["audio"]
    for k, v in wavscp.items():
        if v == src:
            return k
    m = re.search(r"([\w.-]+)\.(wav|mp3|flac)", src)
    base = m.group(1) if m else f"rec{len(wavscp):04d}"
    key = base
    i = 0
    while key in wavscp and wavscp[key] != src:
        i += 1
        key = f"{base}_{i}"
    return key


def main(argv=None):
    p = argparse.ArgumentParser(description="Split long Kaldi utterances at word boundaries by CTC forced alignment")
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("--model", default=None, help="CTC model directory")
    p.add_argument("--max_duration", type=float, default=30.0)
    p.add_argument("--language", default="fr")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--seeded_test_config", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    report = split_long_audio_kaldifolder(
        args.input_dir, args.output_dir, args.model, max_duration=args.max_duration, language=args.language,
        seeded_test_config=args.seeded_test_config, device=args.device,
    )
    print(report)


if __name__ == "__main__":
    main()
