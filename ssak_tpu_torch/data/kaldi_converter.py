"""Composable corpus -> Kaldi importer framework (counterpart of
ssak_tpu.data.kaldi_converter: Reader2Kaldi executing ordered ToKaldi
processors merged on ids): each processor
contributes columns for a set of row ids; Reader2Kaldi runs them in order,
merges on id, and emits a KaldiDataset ready to save().
"""

import os
import re

from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset, KaldiDatasetRow
from ssak_tpu_torch.utils.misc import walk_files


class ToKaldi:
    """Base processor: returns {row_id: {column: value}} updates."""

    def process(self, rows: dict, root: str) -> dict:
        raise NotImplementedError


class AudioFolder2Kaldi(ToKaldi):
    """Discover audio files under a folder; id = filename stem.

    With merge_on="id" (default) each audio file creates/extends the row of
    the same id. With merge_on="audio_id" the files are matched against the
    existing rows' ``audio_id`` column instead (segment corpora where many
    utterances share one recording, e.g. TEDX/MLS layouts)."""

    def __init__(self, subdir: str = "", extensions=(".wav", ".mp3", ".flac"), id_from=os.path.basename, merge_on: str = "id"):
        self.subdir = subdir
        self.extensions = tuple(extensions) if not isinstance(extensions, str) else (extensions,)
        self.id_from = id_from
        self.merge_on = merge_on

    def process(self, rows, root):
        folder = os.path.join(root, self.subdir)
        stem2path = {}
        for path in walk_files(folder):
            if path.lower().endswith(self.extensions):
                stem2path[os.path.splitext(self.id_from(path))[0]] = path
        if self.merge_on == "id":
            for stem, path in stem2path.items():
                rows.setdefault(stem, {})["audio_path"] = path
        else:
            for rid, cols in rows.items():
                key = cols.get(self.merge_on, rid)
                if key in stem2path:
                    cols["audio_path"] = stem2path[key]
        return rows


class TextFolder2Kaldi(ToKaldi):
    """One .txt per utterance id."""

    def __init__(self, subdir: str = "", extension: str = ".txt"):
        self.subdir = subdir
        self.extension = extension

    def process(self, rows, root):
        folder = os.path.join(root, self.subdir)
        for path in walk_files(folder):
            if path.endswith(self.extension):
                rid = os.path.splitext(os.path.basename(path))[0]
                with open(path, encoding="utf-8") as f:
                    rows.setdefault(rid, {})["text"] = f.read().strip()
        return rows


class ColumnFile2Kaldi(ToKaldi):
    """Delimited file with one row per utterance; columns named by
    `columns` (use 'id', 'text', 'speaker', 'start', 'end', 'gender',
    'audio_path', or None to skip)."""

    def __init__(self, path: str, columns, sep: str = "\t", skip_header: bool = False, merge_on: str = "id"):
        self.path = path
        self.columns = columns
        self.sep = sep
        self.skip_header = skip_header
        self.merge_on = merge_on

    def process(self, rows, root):
        path = os.path.join(root, self.path)
        entries = []
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                if self.skip_header and i == 0:
                    continue
                vals = [v.strip() for v in line.rstrip("\n").split(self.sep)]
                entry = {c: v for c, v in zip(self.columns, vals) if c}
                for k in ("start", "end"):
                    if k in entry:
                        entry[k] = float(entry[k])
                entries.append(entry)
        if self.merge_on == "id":
            for entry in entries:
                rid = entry.pop("id", None)
                if rid is not None:
                    rows.setdefault(rid, {}).update(entry)
        else:
            # merge keyed on an arbitrary column of already-present rows
            # (e.g. per-speaker gender files, merge_on="speaker")
            keyed = {e.get(self.merge_on): e for e in entries if e.get(self.merge_on) is not None}
            for cols in rows.values():
                e = keyed.get(cols.get(self.merge_on))
                if e:
                    cols.update({k: v for k, v in e.items() if k != self.merge_on})
        return rows


class ListFile2Kaldi(ToKaldi):
    """A file with one value per line, aligned positionally with the rows in
    their current (insertion) order — e.g.
    TEDX's ``txt/train.fr`` transcript lines matching ``txt/segments``."""

    def __init__(self, path: str, column: str = "text"):
        self.path = path
        self.column = column

    def process(self, rows, root):
        with open(os.path.join(root, self.path), encoding="utf-8") as f:
            lines = [l.rstrip("\n") for l in f]
        if len(lines) != len(rows):
            raise ValueError(f"{self.path}: {len(lines)} lines for {len(rows)} rows")
        for cols, val in zip(rows.values(), lines):
            cols[self.column] = val
        return rows


class TextGrid2Kaldi(ToKaldi):
    """Walk a folder (optionally recursively) for .TextGrid files; each
    non-empty interval of the selected tier(s) becomes one segment row with
    id "<stem>_<n>" over recording <stem> (formats.transcription's
    parse_textgrid_tiers reads the tiers)."""

    def __init__(self, subdir: str = "", tiers=(0,), min_duration: float = 0.01):
        self.subdir = subdir
        self.tiers = tiers
        self.min_duration = min_duration

    def process(self, rows, root):
        from ssak_tpu_torch.formats.transcription import parse_textgrid_tiers

        folder = os.path.join(root, self.subdir)
        for path in walk_files(folder):
            if not path.lower().endswith(".textgrid"):
                continue
            stem = os.path.splitext(os.path.basename(path))[0]
            with open(path, encoding="utf-8", errors="replace") as f:
                tiers = parse_textgrid_tiers(f.read())
            for ti in self.tiers:
                if ti >= len(tiers):
                    continue
                for n, (start, end, text) in enumerate(tiers[ti]):
                    if not text.strip() or end - start < self.min_duration:
                        continue
                    rows[f"{stem}_{n:04d}"] = {
                        "audio_id": stem, "start": start, "end": end, "text": text.strip(),
                    }
        return rows


class Row2Info(ToKaldi):
    """Derive a column from the id via regex,
    e.g. speaker from 'spk1-utt003'."""

    def __init__(self, column: str, pattern: str, group: int = 1):
        self.column = column
        self.rx = re.compile(pattern)
        self.group = group

    def process(self, rows, root):
        for rid, cols in rows.items():
            m = self.rx.search(rid)
            if m:
                cols.setdefault(self.column, m.group(self.group))
        return rows


class Row2Duration(ToKaldi):
    """Compute duration from the audio header."""

    def process(self, rows, root):
        from ssak_tpu_torch.audio import get_audio_duration

        for rid, cols in rows.items():
            if "duration" not in cols and cols.get("audio_path"):
                try:
                    cols["duration"] = get_audio_duration(cols["audio_path"])
                except Exception:
                    pass
        return rows


class TextRegexFilter(ToKaldi):
    """Drop rows whose text matches (or doesn't match) a regex."""

    def __init__(self, pattern: str, keep_matching: bool = False):
        self.rx = re.compile(pattern)
        self.keep = keep_matching

    def process(self, rows, root):
        out = {}
        for rid, cols in rows.items():
            has = bool(self.rx.search(cols.get("text", "")))
            if has == self.keep:
                out[rid] = cols
        return out


def _localname(tag) -> str:
    return tag.rsplit("}", 1)[-1] if isinstance(tag, str) else ""


class Tei2Kaldi(ToKaldi):
    """TEI-CES transcription XML (CLAPI-style) -> segment rows.

    A <timeline> of <when xml:id absolute="HH:MM:SS.ss"> timecodes, a body
    of <u who="#SPK"> turns whose <w> words are split into segments at
    <anchor synch="#Tn"/> markers; <person sex="1|2"> gives genders.
    Namespace-agnostic (matches element local names)."""

    def __init__(self, subdir: str = "", extension: str = ".xml", max_speakers_per_segment: int = 2):
        self.subdir = subdir
        self.extension = extension
        self.max_speakers = max_speakers_per_segment

    @staticmethod
    def _abs_seconds(s: str) -> float:
        h, m, sec = s.split(":")
        return int(h) * 3600 + int(m) * 60 + float(sec)

    def _parse(self, path: str, rows: dict):
        import xml.etree.ElementTree as ET

        file_id = os.path.splitext(os.path.basename(path))[0]
        root = ET.parse(path).getroot()
        genders = {}
        timecodes = {}
        for el in root.iter():
            name = _localname(el.tag)
            if name == "person":
                pid = next((v for k, v in el.attrib.items() if k.endswith("id")), None)
                sex = el.attrib.get("sex")
                if pid:
                    genders[pid] = "f" if sex == "2" else "m"
            elif name == "when":
                wid = next((v for k, v in el.attrib.items() if k.endswith("id")), None)
                if wid and el.attrib.get("absolute"):
                    timecodes[wid] = self._abs_seconds(el.attrib["absolute"])

        body = next((el for el in root.iter() if _localname(el.tag) == "body"), None)
        if body is None:
            return rows

        counters = {}

        def emit(speaker, text, start, end):
            text = text.strip()
            if len(text) <= 1 or start is None or end is None or end <= start:
                return
            ct = counters.get(speaker, 0)
            counters[speaker] = ct + 1
            rows[f"{file_id}_{speaker}_{ct:04d}"] = {
                "audio_id": file_id, "speaker": f"{file_id}_{speaker}",
                "gender": genders.get(speaker), "text": text,
                "start": start, "end": end,
            }

        def anchor_time(el):
            ref = el.attrib.get("synch", "").lstrip("# ").strip()
            return timecodes.get(ref)

        def walk_u(u, speaker, start):
            # returns (pending_text, segment_start) after consuming children
            text = ""
            for child in u:
                name = _localname(child.tag)
                if name == "anchor":
                    t = anchor_time(child)
                    if t is not None:
                        emit(speaker, text, start, t)
                        text, start = "", t
                elif name == "w":
                    text += " " + "".join(child.itertext())
                elif name == "choice":
                    reg = next((c for c in child.iter() if _localname(c.tag) == "reg"), None)
                    if reg is not None:
                        text += " " + "".join(reg.itertext())
                elif name == "seg":
                    leftover, start = walk_u(child, speaker, start)
                    text += leftover
            return text, start

        current = None
        for el in body:
            name = _localname(el.tag)
            if name == "anchor":
                t = anchor_time(el)
                if t is not None:
                    current = t
            elif name == "u":
                speaker = el.attrib.get("who", "spk").lstrip("# ")
                leftover, seg_start = walk_u(el, speaker, current)
                # close an open tail segment at the next known time if any
                if leftover.strip() and seg_start is not None:
                    later = [t for t in timecodes.values() if t > seg_start]
                    if later:
                        emit(speaker, leftover, seg_start, min(later))
        return rows

    def process(self, rows, root):
        folder = os.path.join(root, self.subdir)
        for path in walk_files(folder):
            if path.endswith(self.extension):
                self._parse(path, rows)
        return rows


class Reader2Kaldi:
    """Run processors in order over a corpus root; merge on ids."""

    def __init__(self, root: str, processors):
        self.root = root
        self.processors = processors

    def load(self, require=("audio_path",)) -> KaldiDataset:
        rows = {}
        for proc in self.processors:
            rows = proc.process(rows, self.root)
        ds = KaldiDataset(name=os.path.basename(os.path.normpath(self.root)))
        gender_map = {"m": "m", "f": "f", "male": "m", "female": "f", "h": "m", "1": "m", "2": "f"}
        for rid in sorted(rows):
            cols = rows[rid]
            if any(cols.get(k) is None for k in require):
                continue
            if cols.get("gender"):
                cols["gender"] = gender_map.get(str(cols["gender"]).strip().lower())
            ds.append(KaldiDatasetRow(id=rid, **{k: v for k, v in cols.items() if k in KaldiDatasetRow.__dataclass_fields__}))
        return ds
