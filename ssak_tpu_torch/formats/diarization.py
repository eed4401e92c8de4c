"""Diarization formats: RTTM <-> the canonical JSON (counterpart of
ssak_tpu.formats.diarization; host Python).
"""



def import_rttm(path_or_lines):
    """RTTM -> [{'spk_id', 'seg_begin', 'seg_end'}] sorted by start."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines, encoding="utf-8") as f:
            lines = f.readlines()
    else:
        lines = path_or_lines
    segs = []
    for line in lines:
        parts = line.split()
        if len(parts) >= 8 and parts[0] == "SPEAKER":
            start = float(parts[3])
            dur = float(parts[4])
            segs.append({"spk_id": parts[7], "seg_begin": start, "seg_end": start + dur})
    return sorted(segs, key=lambda s: s["seg_begin"])


def to_diarization(segments, remove_overlaps: bool = True):
    """Canonical diarization dict {'speakers': [...], 'segments': [...]}"""
    segs = [dict(s) for s in segments]
    if remove_overlaps:
        segs = _remove_overlaps(segs)
    speakers = sorted({s["spk_id"] for s in segs})
    return {
        "speakers": [{"spk_id": spk} for spk in speakers],
        "segments": [
            {"spk_id": s["spk_id"], "seg_begin": round(s["seg_begin"], 3), "seg_end": round(s["seg_end"], 3)}
            for s in segs
        ],
    }


def _remove_overlaps(segs):
    """Truncate overlapping turns at the midpoint."""
    segs = sorted(segs, key=lambda s: s["seg_begin"])
    out = []
    for s in segs:
        if out and s["seg_begin"] < out[-1]["seg_end"]:
            mid = (s["seg_begin"] + out[-1]["seg_end"]) / 2
            out[-1]["seg_end"] = mid
            s = {**s, "seg_begin": mid}
        if s["seg_end"] > s["seg_begin"]:
            out.append(dict(s))
    return out


def json2rttm(diarization, output_path: str = None, file_id: str = "file"):
    """Canonical diarization JSON -> RTTM lines."""
    segs = diarization.get("segments", diarization) if isinstance(diarization, dict) else diarization
    lines = []
    for s in segs:
        start = s.get("seg_begin", s.get("start"))
        end = s.get("seg_end", s.get("end"))
        spk = s.get("spk_id", s.get("speaker", "spk1"))
        lines.append(f"SPEAKER {file_id} 1 {start:.3f} {end - start:.3f} <NA> <NA> {spk} <NA> <NA>")
    text = "\n".join(lines) + "\n"
    if output_path:
        with open(output_path, "w", encoding="utf-8") as f:
            f.write(text)
    return text
