"""Object-oriented Kaldi dataset API (counterpart of
ssak_tpu.data.kaldi_dataset): row-level validation, load/save of Kaldi
dirs, filtering by speaker/audio/duration, text normalization, audio
checks, and train/dev/test splitting.
"""

import os
import random
from dataclasses import dataclass

from ssak_tpu_torch.utils.monitoring import logger


@dataclass
class KaldiDatasetRow:
    id: str
    text: str = None
    audio_id: str = None
    audio_path: str = None
    start: float = None
    end: float = None
    duration: float = None
    speaker: str = None
    gender: str = None
    split: str = None

    def check(self, show_warnings: bool = True):
        """Fill derivable fields and validate."""
        if self.audio_id is None:
            self.audio_id = self.id
        if self.speaker is None:
            self.speaker = self.id
        if self.duration is None and self.start is not None and self.end is not None:
            self.duration = self.end - self.start
        if self.start is not None and self.end is not None and self.end <= self.start:
            if show_warnings:
                logger.warning(f"{self.id}: end <= start ({self.start}-{self.end})")
            return False
        if self.gender is not None and self.gender not in ("m", "f"):
            self.gender = None
        return True


class KaldiDataset:
    def __init__(self, rows=None, name: str = ""):
        self.name = name
        self.rows = list(rows or [])

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def append(self, row, show_warnings: bool = True):
        if isinstance(row, dict):
            row = KaldiDatasetRow(**row)
        if row.check(show_warnings):
            self.rows.append(row)
            return True
        return False

    # --- I/O --------------------------------------------------------------

    @classmethod
    def load(cls, kaldi_dir: str, name: str = None):
        from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest

        _meta, manifest = kaldi_folder_to_manifest(kaldi_dir)
        ds = cls(name=name or os.path.basename(os.path.normpath(kaldi_dir)))
        for m in manifest:
            ds.append(
                KaldiDatasetRow(
                    id=m["id"], text=m["text"], audio_path=m["audio"],
                    start=m["start"], end=m["end"], duration=m["duration"],
                    speaker=m["speaker"], gender=m["gender"],
                )
            )
        return ds

    def save(self, output_dir: str, check: bool = True):
        from ssak_tpu_torch.data.kaldi import check_kaldi_dir, utt2spk_to_spk2utt, write_keyed_file, write_segments

        os.makedirs(output_dir, exist_ok=True)
        wavscp, text, segments, utt2spk, utt2dur, spk2gender = {}, {}, {}, {}, {}, {}
        audio_keys = {}
        for r in self.rows:
            key = r.audio_id or r.id
            if r.audio_path:
                audio_keys[key] = r.audio_path
            text[r.id] = r.text or ""
            utt2spk[r.id] = r.speaker or r.id
            if r.duration is not None:
                utt2dur[r.id] = f"{r.duration:.6f}"
            if r.start is not None and r.end is not None:
                segments[r.id] = (key, r.start, r.end)
            if r.gender:
                spk2gender[r.speaker or r.id] = r.gender
        write_keyed_file(os.path.join(output_dir, "wav.scp"), audio_keys)
        write_keyed_file(os.path.join(output_dir, "text"), text)
        write_keyed_file(os.path.join(output_dir, "utt2spk"), utt2spk)
        write_keyed_file(os.path.join(output_dir, "spk2utt"), utt2spk_to_spk2utt(utt2spk))
        if segments:
            write_segments(os.path.join(output_dir, "segments"), segments)
        if utt2dur:
            write_keyed_file(os.path.join(output_dir, "utt2dur"), utt2dur)
        if spk2gender:
            write_keyed_file(os.path.join(output_dir, "spk2gender"), spk2gender)
        if check:
            check_kaldi_dir(output_dir, fix=True)
        return output_dir

    # --- transforms -------------------------------------------------------

    def normalize_dataset(self, language: str = "fr"):
        """Normalize all texts in place."""
        from ssak_tpu_torch.text import format_text

        for r in self.rows:
            if r.text:
                r.text = format_text(r.text, language, extract_parenthesized=False, safety_checks=False).replace("\n", " ")
        return self

    def filter_by_speaker(self, speakers, keep: bool = True):
        speakers = set(speakers)
        rows = [r for r in self.rows if (r.speaker in speakers) == keep]
        return KaldiDataset(rows, name=self.name)

    def filter_by_duration(self, min_duration: float = None, max_duration: float = None):
        rows = [
            r for r in self.rows
            if (min_duration is None or (r.duration or 0) >= min_duration)
            and (max_duration is None or (r.duration or 0) <= max_duration)
        ]
        return KaldiDataset(rows, name=self.name)

    def filter_by_audio(self, predicate):
        return KaldiDataset([r for r in self.rows if predicate(r)], name=self.name)

    def audio_checks(self, sample_rate: int = 16000, fix_paths: bool = False):
        """Read every audio source's duration; returns the ids of the rows
        whose source fails."""
        from ssak_tpu_torch.audio import get_audio_duration

        bad = []
        seen = {}
        for r in self.rows:
            src = r.audio_path
            if src in seen:
                ok = seen[src]
            else:
                try:
                    get_audio_duration(src)
                    ok = True
                except Exception as e:
                    logger.warning(f"{r.id}: audio check failed: {e}")
                    ok = False
                seen[src] = ok
            if not ok:
                bad.append(r.id)
        return bad

    def speakers(self):
        return sorted({r.speaker for r in self.rows if r.speaker})

    def total_duration(self) -> float:
        return sum(r.duration or 0.0 for r in self.rows)

    def split(self, ratios=(0.8, 0.1, 0.1), by_speaker: bool = True, seed: int = 0):
        """Train/dev/test split, speaker-disjoint by default."""
        rng = random.Random(seed)
        if by_speaker:
            spks = self.speakers()
            rng.shuffle(spks)
            n = len(spks)
            cut1 = int(ratios[0] * n)
            cut2 = cut1 + int(ratios[1] * n)
            groups = (set(spks[:cut1]), set(spks[cut1:cut2]), set(spks[cut2:]))
            return tuple(KaldiDataset([r for r in self.rows if r.speaker in g], name=f"{self.name}_{i}") for i, g in enumerate(groups))
        rows = list(self.rows)
        rng.shuffle(rows)
        n = len(rows)
        cut1 = int(ratios[0] * n)
        cut2 = cut1 + int(ratios[1] * n)
        return (
            KaldiDataset(rows[:cut1], name=f"{self.name}_train"),
            KaldiDataset(rows[cut1:cut2], name=f"{self.name}_dev"),
            KaldiDataset(rows[cut2:], name=f"{self.name}_test"),
        )
