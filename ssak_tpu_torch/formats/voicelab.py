"""LeVoiceLab speech-data-hub exchange format.

Counterpart of ssak_tpu.formats.voicelab (host Python). A database is a
folder of

    <pseudo>.audio.wav          one file per recording
    <pseudo>.meta.json          per-audio metadata (audio-format schema)
    meta.json                   database metadata (main-db schema)
    <annotations>/meta.json     annotation-batch metadata
    <annotations>/<pseudo>.annotations.json
        {"version", "format_specification_uri",
         "transcripts": [{"transcript", "timestamp_start_milliseconds",
                          "timestamp_end_milliseconds", "speaker"?, ...}]}

Export normalizes audio to mono 16 kHz 16-bit WAV through the port's own
codec, clips overlapping segments (a later segment starting before the
previous ends is clipped at the midpoint, or dropped when fully contained)
and fills the metadata fields. Import slugifies speakers and emits a
plain-path wav.scp.
"""

import json
import os
import re
import unicodedata

from ssak_tpu_torch.utils.monitoring import logger

SCHEMA_URI = "http://levoicelab.org/schemas/{version}/{schema}.schema.json"
DEFAULT_CONTACT = {"organization": "", "name": "", "email": "", "uri": ""}


def slugify(text: str) -> str:
    """ASCII slug (lowercase, hyphen-separated)."""
    text = unicodedata.normalize("NFKD", str(text)).encode("ascii", "ignore").decode()
    return re.sub(r"[^a-z0-9]+", "-", text.lower()).strip("-") or "x"


def _json_dump(d, path):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(d, f, indent=2, ensure_ascii=False)


def _clip_overlaps(segments):
    """Sort by start; a segment starting before the
    previous one ends is clipped at the midpoint of the overlap, and dropped
    when fully contained in the previous segment."""
    out = []
    prev_end = 0.0
    for seg in sorted(segments, key=lambda s: s["start"]):
        start, end = seg["start"], seg["end"]
        if out and start < prev_end:
            if end <= prev_end:
                logger.warning(f"voicelab export: dropping fully-overlapped segment {seg.get('id')}")
                continue
            middle = (start + prev_end) / 2
            out[-1]["end"] = middle
            seg = dict(seg, start=middle)
        out.append(dict(seg))
        prev_end = out[-1]["end"]
    return out


def kaldi_to_voicelab(
    kaldi_dir: str,
    out_dir: str,
    name: str = None,
    version: str = "0.0.2",
    description: str = None,
    license: str = "CC-BY-NC-SA 4.0",
    languages=("fr",),
    contact: dict = None,
    annotations_dirname: str = None,
    sample_rate: int = 16000,
    is_private: bool = True,
    ignore_speakers: bool = False,
    date_created: str = "",
) -> str:
    """Export a Kaldi data dir as a LeVoiceLab database."""
    from ssak_tpu_torch.audio import load_audio, save_audio
    from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset

    ds = KaldiDataset.load(kaldi_dir)
    name = name or os.path.basename(os.path.normpath(kaldi_dir))
    annotations_dirname = annotations_dirname or slugify(name) + "-annotations"
    annot_dir = os.path.join(out_dir, annotations_dirname)
    os.makedirs(annot_dir, exist_ok=True)
    contact = contact or DEFAULT_CONTACT

    by_rec = {}
    for r in ds:
        by_rec.setdefault(r.audio_path, []).append(r)

    genders = {}
    speakers = set()
    total_speech = 0.0
    total_audio = 0.0
    utt_durations = []
    speaker_missing = False

    for n_rec, (audio_path, rows) in enumerate(sorted(by_rec.items())):
        pseudo = slugify(os.path.splitext(os.path.basename(audio_path))[0])
        out_wav = os.path.join(out_dir, pseudo + ".audio.wav")
        if not os.path.exists(out_wav):
            audio = load_audio(audio_path, sample_rate=sample_rate)
            save_audio(out_wav, audio, sample_rate)
        from ssak_tpu_torch.audio import get_audio_duration

        duration = get_audio_duration(out_wav)
        total_audio += duration

        segments = []
        for r in rows:
            start = r.start if r.start is not None else 0.0
            end = r.end if r.end is not None else (start + (r.duration or duration))
            segments.append({"id": r.id, "start": start, "end": end, "text": r.text or "", "speaker": r.speaker, "gender": r.gender})
        transcripts = []
        for seg in _clip_overlaps(segments):
            spk = None if ignore_speakers else seg["speaker"]
            if spk is None:
                speaker_missing = True
            else:
                speakers.add(spk)
                if seg.get("gender"):
                    genders[spk] = seg["gender"]
            entry = {
                "transcript": seg["text"],
                "timestamp_start_milliseconds": int(round(seg["start"] * 1000)),
                "timestamp_end_milliseconds": int(round(seg["end"] * 1000)),
            }
            if spk is not None:
                entry["speaker"] = spk
            transcripts.append(entry)
            total_speech += seg["end"] - seg["start"]
            utt_durations.append(seg["end"] - seg["start"])

        _json_dump(
            {
                "version": version,
                "format_specification_uri": f"http://levoicelab.org/schemas/{version}/annotation-single.schema.transcription.json",
                "transcripts": transcripts,
            },
            os.path.join(annot_dir, pseudo + ".annotations.json"),
        )
        _json_dump(
            {
                "version": version,
                "format_specification_uri": SCHEMA_URI.format(version=version, schema="audio-format"),
                "duration_milliseconds": int(duration * 1000),
                "is_natural": True,
                "is_augmented": False,
                "is_synthetic": False,
                "date_created": date_created,
                "collection_date": "",
            },
            os.path.join(out_dir, pseudo + ".meta.json"),
        )

    extra = {} if ignore_speakers else {"num_speakers": len(speakers)}
    fcount = sum(1 for g in genders.values() if g == "f")
    mcount = sum(1 for g in genders.values() if g == "m")
    if fcount and mcount:
        extra["gender"] = {"female": fcount, "male": mcount}
    _json_dump(
        {
            "name": name,
            "description": description or name,
            "date_created": date_created,
            "collection_date_from": "",
            "collection_date_to": "",
            "version": version,
            "format_specification_uri": SCHEMA_URI.format(version=version, schema="main-db"),
            "num_channels": 1,
            "sample_rate": sample_rate,
            "license": license,
            "is_private": is_private,
            "contact": contact,
            "contains_augmented_speech": False,
            "contains_synthetic_speech": False,
            "contains_natural_speech": True,
            "total_duration_seconds": round(total_audio),
            "natural_speech_duration_seconds": round(total_speech),
            "audio_format": "wav",
            "bit_depth": 16,
            "num_audio_files": len(by_rec),
            "augmented_speech_duration_seconds": 0,
            "synthetic_speech_duration_seconds": 0,
            "languages": list(languages),
            "extra": extra,
        },
        os.path.join(out_dir, "meta.json"),
    )
    speaker_information = "none" if ignore_speakers else ("uuid-with-missing" if speaker_missing else "uuid")
    _json_dump(
        {
            "version": version,
            "format_specification_uri": SCHEMA_URI.format(version=version, schema="annotation-batch"),
            "date_created": date_created,
            "annotation_date_from": "",
            "annotation_date_to": "",
            "annotation_type": "transcription",
            "speaker_information": speaker_information,
            "contact": contact,
            "extra": {
                "word_alignement": False,
                "utt_alignement": True,
                "avg_utt_alignement_duration_second": (sum(utt_durations) / len(utt_durations)) if utt_durations else 0.0,
            },
        },
        os.path.join(annot_dir, "meta.json"),
    )
    return out_dir


def augment_database(
    db_dir: str,
    out_dir: str,
    noise_dir: str = None,
    rir_dir: str = None,
    rir_lists=None,
    apply_prob: float = 1.0,
    seed: int = 0,
    suffix: str = "-augmented",
) -> str:
    """Write an augmented copy of a LeVoiceLab database: every
    ``*.audio.wav`` is passed through the waveform augmentation pipeline
    (noise / RIR reverberation / gain / band-stop ...), annotations are
    copied unchanged, and the audio + db metadata are re-marked
    ``is_augmented``."""
    import shutil

    from ssak_tpu_torch.audio import load_audio, save_audio
    from ssak_tpu_torch.augment.speech import SpeechAugment

    os.makedirs(out_dir, exist_ok=True)
    augment = SpeechAugment(noise_dir=noise_dir, rir_dir=rir_dir, rir_lists=rir_lists, apply_prob=apply_prob, seed=seed)

    with open(os.path.join(db_dir, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    meta["name"] = meta.get("name", "") + suffix
    meta["contains_augmented_speech"] = True
    meta["contains_natural_speech"] = False
    meta["augmented_speech_duration_seconds"] = meta.get("natural_speech_duration_seconds", 0)
    meta["natural_speech_duration_seconds"] = 0
    _json_dump(meta, os.path.join(out_dir, "meta.json"))

    for filename in sorted(os.listdir(db_dir)):
        full = os.path.join(db_dir, filename)
        parts = filename.split(".")
        if os.path.isdir(full):
            shutil.copytree(full, os.path.join(out_dir, filename), dirs_exist_ok=True)
        elif len(parts) >= 3 and parts[-2] == "audio":
            sr = meta.get("sample_rate", 16000)
            audio = load_audio(full, sample_rate=sr)
            # freeze_speed=1.0: keep the length so annotation timestamps stay valid
            save_audio(os.path.join(out_dir, filename), augment(audio, freeze_speed=1.0), sr)
        elif filename.endswith(".meta.json"):
            with open(full, encoding="utf-8") as f:
                m = json.load(f)
            m["is_natural"] = False
            m["is_augmented"] = True
            _json_dump(m, os.path.join(out_dir, filename))
    return out_dir


def voicelab_to_kaldi(
    db_dir: str,
    out_dir: str,
    annotdir: str = None,
    language: str = "fr",
    normalize: bool = False,
    name_genders: dict = None,
) -> str:
    """Import a LeVoiceLab database as a Kaldi data dir.

    Speakers are slugified; utterance ids are
    ``{db}_{speakerslug}_{pseudo}_{nnn}``. Genders come from the
    annotations' extra fields when present, else from ``name_genders``
    (a first-name -> "m"/"f" mapping; upstream SSAK downloads the INSEE
    first-name statistics, which is not possible offline).
    """
    from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset, KaldiDatasetRow

    if annotdir is None:
        for d in sorted(os.listdir(db_dir)):
            full = os.path.join(db_dir, d)
            if os.path.isdir(full) and any(f.endswith(".annotations.json") for f in os.listdir(full)):
                annotdir = full
                break
    elif os.path.basename(annotdir) == annotdir:
        annotdir = os.path.join(db_dir, annotdir)
    if annotdir is None:
        raise FileNotFoundError(f"no annotations dir under {db_dir}")

    db_name = slugify(os.path.basename(os.path.normpath(db_dir)))
    ds = KaldiDataset(name=db_name)
    speaker_names = {}
    for filename in sorted(os.listdir(db_dir)):
        parts = filename.split(".")
        if len(parts) < 3 or parts[-2] != "audio":
            continue
        pseudo = ".".join(parts[:-2])
        audio_path = os.path.join(db_dir, filename)
        annotfile = os.path.join(annotdir, pseudo + ".annotations.json")
        if not os.path.isfile(annotfile):
            raise FileNotFoundError(f"missing annotation file: {annotfile}")
        with open(annotfile, encoding="utf-8") as f:
            annotations = json.load(f)
        wavname = f"{db_name}_{pseudo}"
        for i, tr in enumerate(annotations.get("transcripts", [])):
            speaker = tr.get("speaker") or tr.get("extra", {}).get("speaker") or f"spk-{wavname}-{i:03d}"
            spk_slug = slugify(speaker).replace("-", "")
            speaker_names[spk_slug] = speaker
            start = tr["timestamp_start_milliseconds"] / 1000.0
            end = tr["timestamp_end_milliseconds"] / 1000.0
            if end <= start:
                logger.warning(f"voicelab import: end <= start for {wavname}_{i}")
                continue
            text = tr["transcript"]
            if normalize:
                from ssak_tpu_torch.text import format_text

                text = format_text(text, language=language)
            gender = tr.get("gender") or tr.get("extra", {}).get("gender")
            if gender not in ("m", "f") and name_genders:
                first = str(speaker).split()[0].lower()
                gender = name_genders.get(first)
            ds.append(
                KaldiDatasetRow(
                    id=f"{db_name}_{spk_slug}_{pseudo}_{i:03d}",
                    audio_id=wavname,
                    audio_path=os.path.abspath(audio_path),
                    start=start, end=end, text=text,
                    speaker=spk_slug, gender=gender if gender in ("m", "f") else None,
                )
            )
    ds.save(out_dir)
    return out_dir
