"""Transcriber (.trs XML) reader (counterpart of
ssak_tpu.formats.transcriber; host Python): Turns and Syncs become timed
per-speaker segments, Events become <tags>, the encoding comes from the XML
declaration, speakers may be anonymised.
"""

import re
import xml.etree.ElementTree as ET


def _read_text(path: str) -> str:
    with open(path, "rb") as f:
        raw = f.read()
    m = re.search(rb'encoding="([^"]+)"', raw[:200])
    enc = m.group(1).decode() if m else "utf-8"
    for candidate in (enc, "utf-8", "latin-1"):
        try:
            return raw.decode(candidate)
        except (UnicodeDecodeError, LookupError):
            continue
    return raw.decode("utf-8", errors="replace")


def read_transcriber(path: str, anonymize_speakers: bool = False, include_events: bool = True):
    """Returns list of {'speaker','gender','start','end','text'} segments."""
    content = _read_text(path)
    # Transcriber DTDs are often missing; strip the doctype
    content = re.sub(r"<!DOCTYPE[^>]*>", "", content)
    root = ET.fromstring(content)

    speakers = {}
    for spk in root.iter("Speaker"):
        sid = spk.get("id")
        speakers[sid] = {
            "name": f"spk{len(speakers)+1:03d}" if anonymize_speakers else (spk.get("name") or sid),
            "gender": {"male": "m", "female": "f"}.get(spk.get("type", "").lower())
            or {"m": "m", "f": "f"}.get(spk.get("dialect", "").lower()),
        }

    segments = []
    for turn in root.iter("Turn"):
        t_start = float(turn.get("startTime", 0))
        t_end = float(turn.get("endTime", t_start))
        spk_ids = (turn.get("speaker") or "").split()
        cur_start = t_start
        cur_text = []

        def flush(end_time):
            text = " ".join(" ".join(cur_text).split())
            if text:
                for sid in spk_ids or [None]:
                    info = speakers.get(sid, {"name": sid or "unknown", "gender": None})
                    segments.append(
                        {"speaker": info["name"], "gender": info["gender"], "start": cur_start, "end": end_time, "text": text}
                    )

        for node in turn.iter():
            if node is turn:
                if turn.text and turn.text.strip():
                    cur_text.append(turn.text.strip())
                continue
            if node.tag == "Sync":
                t = float(node.get("time", cur_start))
                flush(t)
                cur_text = []
                cur_start = t
            elif node.tag == "Event" and include_events:
                desc = node.get("desc", "noise")
                cur_text.append(f"<{desc}>")
            elif node.tag == "Who":
                pass
            if node.tail and node.tail.strip():
                cur_text.append(node.tail.strip())
        flush(t_end)
    return segments
