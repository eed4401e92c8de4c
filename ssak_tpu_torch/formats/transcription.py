"""Canonical transcription format and its converters (counterpart of
ssak_tpu.formats.transcription; host Python).

Every supported input (canonical or Whisper-style JSON, plain text, CSV,
TextGrid, .srt / .vtt) converts to the canonical dict

    {"transcription_result": str,
     "raw_transcription": str,
     "confidence": float,
     "segments": [{"spk_id", "start", "end", "duration", "raw_segment",
                   "segment", "words": [{"word","start","end","conf"}]}]}

with words assigned to speakers when a diarization is given;
`transcription_to` writes text / srt / vtt / csv / textgrid, and
`parse_textgrid_tiers` reads a TextGrid's tiers for the corpus importers.
"""

import csv as _csv
import io
import json
import os
import re
from dataclasses import dataclass, field


@dataclass
class Word:
    word: str
    start: float
    end: float
    conf: float = 1.0

    def to_dict(self):
        return {"word": self.word, "start": round(self.start, 2), "end": round(self.end, 2), "conf": round(self.conf, 2)}


@dataclass
class SpeechSegment:
    spk_id: str = None
    start: float = 0.0
    end: float = 0.0
    raw_segment: str = ""
    segment: str = ""
    words: list = field(default_factory=list)

    def to_dict(self):
        return {
            "spk_id": self.spk_id,
            "start": round(self.start, 2),
            "end": round(self.end, 2),
            "duration": round(self.end - self.start, 2),
            "raw_segment": self.raw_segment,
            "segment": self.segment,
            "words": [w.to_dict() for w in self.words],
        }


@dataclass
class TranscriptionResult:
    segments: list = field(default_factory=list)
    confidence: float = 1.0

    def to_dict(self):
        text = " ".join(s.segment or s.raw_segment for s in self.segments).strip()
        raw = " ".join(s.raw_segment for s in self.segments).strip()
        return {
            "transcription_result": text,
            "raw_transcription": raw,
            "confidence": round(self.confidence, 2),
            "segments": [s.to_dict() for s in self.segments],
        }

    def set_diarization(self, diarization):
        """Assign words to diarization turns; split segments at speaker
        changes."""
        turns = diarization.get("segments", diarization) if isinstance(diarization, dict) else diarization
        new_segments = []
        for seg in self.segments:
            if not seg.words:
                seg.spk_id = _speaker_at(turns, (seg.start + seg.end) / 2) or seg.spk_id
                new_segments.append(seg)
                continue
            cur_words, cur_spk = [], None
            for w in seg.words:
                spk = _speaker_at(turns, (w.start + w.end) / 2)
                if cur_words and spk != cur_spk:
                    new_segments.append(_mk_segment(cur_words, cur_spk))
                    cur_words = []
                cur_words.append(w)
                cur_spk = spk
            if cur_words:
                new_segments.append(_mk_segment(cur_words, cur_spk))
        self.segments = new_segments
        return self


def _mk_segment(words, spk):
    text = " ".join(w.word for w in words)
    return SpeechSegment(spk_id=spk, start=words[0].start, end=words[-1].end, raw_segment=text, segment=text, words=list(words))


def _speaker_at(turns, t):
    for turn in turns:
        s = turn.get("seg_begin", turn.get("start"))
        e = turn.get("seg_end", turn.get("end"))
        if s is not None and e is not None and s <= t <= e:
            return turn.get("spk_id", turn.get("speaker"))
    return None


# --- hallucination filter --------------------------------------------------

HALLUCINATIONS = [
    "sous-titres réalisés para la communauté d'amara.org",
    "sous-titres réalisés par la communauté d'amara.org",
    "merci d'avoir regardé cette vidéo",
    "thank you for watching",
    "subtitles by the amara.org community",
    "♪",
]


def remove_hallucinations(text: str) -> str:
    low = text.lower()
    for h in HALLUCINATIONS:
        low_idx = low.find(h)
        if low_idx >= 0:
            text = text[:low_idx] + text[low_idx + len(h):]
            low = text.lower()
    return text.strip()


# --- converters ------------------------------------------------------------


def to_transcription(data, format: str = None, remove_hallucination: bool = False):
    """Convert any supported input into the canonical dict.

    data: path or parsed object. format: autodetected from extension /
    structure when None (json | whisper | text | csv | textgrid | srt | vtt).
    """
    if isinstance(data, str) and os.path.exists(data):
        ext = os.path.splitext(data)[1].lower().lstrip(".")
        with open(data, encoding="utf-8") as f:
            content = f.read()
        if format is None:
            format = {"json": "json", "txt": "text", "csv": "csv", "textgrid": "textgrid", "srt": "srt", "vtt": "vtt"}.get(ext, "text")
        if format == "json":
            data = json.loads(content)
        else:
            data = content
    if isinstance(data, dict) and "transcription_result" in data:
        out = dict(data)  # already canonical
        if remove_hallucination:
            out["transcription_result"] = remove_hallucinations(out["transcription_result"])
        return out
    if format in (None, "json") and isinstance(data, dict):
        result = _from_json(data)
    elif format == "csv":
        result = _from_csv(data)
    elif format == "textgrid":
        result = _from_textgrid(data)
    elif format in ("srt", "vtt"):
        result = _from_srt(data)
    else:
        result = _from_text(str(data))
    out = result.to_dict()
    if remove_hallucination:
        out["transcription_result"] = remove_hallucinations(out["transcription_result"])
        for seg in out["segments"]:
            seg["segment"] = remove_hallucinations(seg["segment"])
    return out


def _from_json(d) -> TranscriptionResult:
    # already canonical?
    if "transcription_result" in d:
        r = TranscriptionResult()
        for s in d.get("segments", []):
            r.segments.append(
                SpeechSegment(
                    spk_id=s.get("spk_id"), start=s.get("start", 0.0), end=s.get("end", 0.0),
                    raw_segment=s.get("raw_segment", ""), segment=s.get("segment", ""),
                    words=[Word(w["word"], w["start"], w["end"], w.get("conf", 1.0)) for w in s.get("words", [])],
                )
            )
        r.confidence = d.get("confidence", 1.0)
        return r
    # whisper-style {"text", "segments": [{"start","end","text","words"?}]}
    if "segments" in d:
        r = TranscriptionResult()
        for s in d["segments"]:
            text = (s.get("text") or "").strip()
            words = [Word(w.get("word", w.get("text", "")).strip(), w["start"], w["end"], w.get("probability", w.get("conf", 1.0))) for w in s.get("words", [])]
            r.segments.append(SpeechSegment(start=s.get("start", 0.0), end=s.get("end", 0.0), raw_segment=text, segment=text, words=words))
        return r
    if "text" in d:
        return _from_text(d["text"])
    raise ValueError("unrecognized transcription JSON structure")


def _from_text(text: str) -> TranscriptionResult:
    text = text.strip()
    return TranscriptionResult(segments=[SpeechSegment(raw_segment=text, segment=text)])


def _from_csv(content: str) -> TranscriptionResult:
    r = TranscriptionResult()
    reader = _csv.DictReader(io.StringIO(content))
    for row in reader:
        norm = {k.lower().strip(): v for k, v in row.items() if k}
        text = norm.get("text", norm.get("segment", "")).strip()
        start = float(norm.get("start", 0) or 0)
        end = float(norm.get("end", 0) or 0)
        r.segments.append(SpeechSegment(spk_id=norm.get("speaker"), start=start, end=end, raw_segment=text, segment=text))
    return r


_TG_INTERVAL = re.compile(r'intervals\s*\[\d+\]:\s*xmin\s*=\s*([\d.]+)\s*xmax\s*=\s*([\d.]+)\s*text\s*=\s*"([^"]*)"', re.S)


def parse_textgrid_tiers(content: str):
    """Parse a TextGrid into per-tier interval lists
    [[(xmin, xmax, text), ...], ...], keeping empty-text intervals out.
    Used by the corpus importers."""
    # split on IntervalTier item headers; header chunk before the first tier
    chunks = re.split(r"item\s*\[\d+\]\s*:", content)
    tiers = []
    for chunk in chunks[1:] if len(chunks) > 1 else chunks:
        intervals = [
            (float(m.group(1)), float(m.group(2)), m.group(3))
            for m in _TG_INTERVAL.finditer(chunk)
            if m.group(3).strip()
        ]
        if intervals or len(chunks) > 1:
            tiers.append(intervals)
    return tiers


def _from_textgrid(content: str) -> TranscriptionResult:
    r = TranscriptionResult()
    for m in _TG_INTERVAL.finditer(content):
        text = m.group(3).strip()
        if not text:
            continue
        r.segments.append(SpeechSegment(start=float(m.group(1)), end=float(m.group(2)), raw_segment=text, segment=text))
    return r


_SRT_TIME = re.compile(r"(\d+):(\d+):(\d+)[.,](\d+)\s*-->\s*(\d+):(\d+):(\d+)[.,](\d+)")


def _from_srt(content: str) -> TranscriptionResult:
    r = TranscriptionResult()
    blocks = re.split(r"\n\s*\n", content.strip())
    for block in blocks:
        lines = [l for l in block.splitlines() if l.strip()]
        if not lines:
            continue
        m = None
        ti = -1
        for i, l in enumerate(lines):
            m = _SRT_TIME.search(l)
            if m:
                ti = i
                break
        if not m:
            continue
        start = int(m.group(1)) * 3600 + int(m.group(2)) * 60 + int(m.group(3)) + float("0." + m.group(4))
        end = int(m.group(5)) * 3600 + int(m.group(6)) * 60 + int(m.group(7)) + float("0." + m.group(8))
        text = " ".join(lines[ti + 1:]).strip()
        text = re.sub(r"\s+", " ", re.sub(r"<[^>]+>", "", text)).strip()
        if text:
            r.segments.append(SpeechSegment(start=start, end=end, raw_segment=text, segment=text))
    return r


def _fmt_ts(seconds: float, sep: str = ",") -> str:
    h, rem = divmod(max(0.0, seconds), 3600)
    m, s = divmod(rem, 60)
    return f"{int(h):02d}:{int(m):02d}:{int(s):02d}{sep}{int(round((s % 1) * 1000)):03d}"


def transcription_to(transcription: dict, fmt: str) -> str:
    """Serialize a canonical transcription dict to text / srt / vtt / csv /
    textgrid (the write direction of to_transcription)."""
    segs = transcription.get("segments", [])

    def seg_fields(s):
        return (
            s.get("start", s.get("stime", 0.0)) or 0.0,
            s.get("end", s.get("etime", 0.0)) or 0.0,
            (s.get("segment") or s.get("text") or s.get("raw_segment") or "").strip(),
        )

    if fmt in ("text", "txt"):
        body = "\n".join(seg_fields(s)[2] for s in segs if seg_fields(s)[2])
        return body or (transcription.get("transcription_result") or transcription.get("text") or "")
    if fmt == "srt":
        blocks = []
        for i, s in enumerate(segs):
            start, end, text = seg_fields(s)
            blocks.append(f"{i + 1}\n{_fmt_ts(start)} --> {_fmt_ts(end)}\n{text}")
        return "\n\n".join(blocks)
    if fmt == "vtt":
        blocks = ["WEBVTT"]
        for s in segs:
            start, end, text = seg_fields(s)
            blocks.append(f"{_fmt_ts(start, '.')} --> {_fmt_ts(end, '.')}\n{text}")
        return "\n\n".join(blocks)
    if fmt == "csv":
        lines = ["text,start,end,speaker"]
        for s in segs:
            start, end, text = seg_fields(s)
            spk = s.get("spk_id") or s.get("speaker") or ""
            text = '"' + text.replace('"', '""') + '"'
            lines.append(f"{text},{start:.3f},{end:.3f},{spk}")
        return "\n".join(lines)
    if fmt == "textgrid":
        xmax = max((seg_fields(s)[1] for s in segs), default=0.0)
        lines = [
            'File type = "ooTextFile"', 'Object class = "TextGrid"', "",
            "xmin = 0", f"xmax = {xmax:.3f}", "tiers? <exists>", "size = 1",
            "item []:", "    item [1]:", '        class = "IntervalTier"',
            '        name = "transcription"', "        xmin = 0",
            f"        xmax = {xmax:.3f}", f"        intervals: size = {len(segs)}",
        ]
        for i, s in enumerate(segs):
            start, end, text = seg_fields(s)
            lines += [
                f"        intervals [{i + 1}]:",
                f"            xmin = {start:.3f}",
                f"            xmax = {end:.3f}",
                f'            text = "{text}"',
            ]
        return "\n".join(lines)
    raise ValueError(f"unknown serialization format: {fmt}")


def shorten_transcription(transcription: dict, max_len: int = 500) -> dict:
    """Truncated view for logging."""
    out = dict(transcription)
    if len(out.get("transcription_result", "")) > max_len:
        out["transcription_result"] = out["transcription_result"][:max_len] + "…"
    out["segments"] = f"[{len(transcription.get('segments', []))} segments]"
    return out
