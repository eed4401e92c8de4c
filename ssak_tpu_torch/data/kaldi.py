"""Kaldi data-folder format: parse, write, validate, fix (counterpart of
ssak_tpu.data.kaldi).

`check_kaldi_dir` enforces what Kaldi's validate_data_dir.sh and
fix_data_dir.sh check, and computes utt2dur from audio headers: WAV and
FLAC headers in one parallel C++ scan (audio/native/durations.cpp), other
files and command pipes one at a time in a thread pool.

A Kaldi data dir contains whitespace-separated "<key> <value...>" files:
  wav.scp   recording-id -> path or command pipe ("... |")
  text      utterance-id -> transcript
  segments  utterance-id recording-id start end   (optional)
  utt2spk   utterance-id -> speaker-id
  spk2utt   speaker-id -> utterance list (derived)
  utt2dur   utterance-id -> seconds
  spk2gender speaker-id -> m|f
All files must be sorted by key (C locale) — the validator enforces the
same invariants as validate_data_dir.sh.
"""

import os
import re
from concurrent.futures import ThreadPoolExecutor

from ssak_tpu_torch.utils.monitoring import logger

KNOWN_FILES = ("wav.scp", "text", "segments", "utt2spk", "spk2utt", "utt2dur", "spk2gender", "reco2dur")


def parse_line(line: str):
    parts = line.strip().split(None, 1)
    if not parts:
        return None, None
    return parts[0], parts[1] if len(parts) > 1 else ""


def read_keyed_file(path: str) -> dict:
    """Read a '<key> <value>' file into an ordered dict."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            k, v = parse_line(line)
            if k is not None:
                out[k] = v
    return out


def write_keyed_file(path: str, mapping: dict, sort: bool = True):
    keys = sorted(mapping) if sort else list(mapping)
    with open(path, "w", encoding="utf-8") as f:
        for k in keys:
            v = mapping[k]
            f.write(f"{k} {v}\n" if v != "" else f"{k}\n")


def parse_wavscp(path: str) -> dict:
    """recording-id -> audio source (file path or command pipe ending in '|').

    Values are kept verbatim, environment variables included: load_audio
    interprets pipes and expands their variables at decode time.
    """
    return read_keyed_file(path)


def parse_segments(path: str) -> dict:
    """utterance-id -> (recording-id, start_sec, end_sec)."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                out[parts[0]] = (parts[1], float(parts[2]), float(parts[3]))
    return out


def write_segments(path: str, segments: dict):
    with open(path, "w", encoding="utf-8") as f:
        for utt in sorted(segments):
            rec, start, end = segments[utt]
            f.write(f"{utt} {rec} {start:.3f} {end:.3f}\n")


def utt2spk_to_spk2utt(utt2spk: dict) -> dict:
    spk2utt = {}
    for utt in sorted(utt2spk):
        spk2utt.setdefault(utt2spk[utt], []).append(utt)
    return {spk: " ".join(utts) for spk, utts in sorted(spk2utt.items())}


def spk2utt_to_utt2spk(spk2utt: dict) -> dict:
    utt2spk = {}
    for spk, utts in spk2utt.items():
        for utt in utts.split():
            utt2spk[utt] = spk
    return dict(sorted(utt2spk.items()))


class KaldiValidationError(ValueError):
    pass


def compute_durations(wavscp: dict, num_workers: int = 8) -> dict:
    """recording-id -> seconds, from audio headers (parallel scan).

    WAV and FLAC files in one C++ thread-pool call; command pipes, MP3 and
    what the scan cannot parse, one file at a time in a thread pool.
    """
    from ssak_tpu_torch.audio import get_audio_duration
    from ssak_tpu_torch.audio.native import scan_durations

    items = list(wavscp.items())
    # fast path: one C++ thread-pool call parses all plain-file WAV/FLAC
    # headers; command pipes / mp3 / parse failures fall back per-file
    plain = [not (isinstance(v, str) and v.rstrip().endswith("|")) for _k, v in items]
    native = scan_durations([v for (_k, v), p in zip(items, plain) if p], n_threads=num_workers)
    durs, ni = [None] * len(items), 0
    for i, p in enumerate(plain):
        if p:
            durs[i] = native[ni]
            ni += 1
    missing = [i for i, d in enumerate(durs) if d is None]
    if missing:
        with ThreadPoolExecutor(max_workers=num_workers) as ex:
            slow = list(ex.map(lambda i: get_audio_duration(items[i][1]), missing))
        for i, d in zip(missing, slow):
            durs[i] = d
    return {k: d for (k, _v), d in zip(items, durs)}


def load_kaldi_dir(path: str) -> dict:
    """Load all known files of a Kaldi dir into a dict of dicts."""
    out = {"path": path}
    for name in KNOWN_FILES:
        p = os.path.join(path, name)
        if os.path.exists(p):
            if name == "segments":
                out[name] = parse_segments(p)
            else:
                out[name] = read_keyed_file(p)
    return out


def check_kaldi_dir(path: str, fix: bool = True, compute_utt2dur: bool = True, language: str = None) -> dict:
    """Validate (and optionally fix) a Kaldi data dir in place.

    Enforces the invariants of validate_data_dir.sh / fix_data_dir.sh:
      - files sorted by key; keys unique
      - text/utt2spk/segments keyed on the same utterance set (intersect+fix)
      - segments reference existing recordings; 0 <= start < end
      - spk2utt consistent with utt2spk (regenerated)
      - utt2dur present (computed from audio headers when missing)
      - spk2gender values in {m,f}
    Returns a report dict {removed_utts, n_utts, n_recordings, warnings}.
    """
    report = {"removed_utts": [], "warnings": []}
    wavscp_p = os.path.join(path, "wav.scp")
    if not os.path.exists(wavscp_p):
        raise KaldiValidationError(f"{path}: missing wav.scp")
    wavscp = parse_wavscp(wavscp_p)
    if not wavscp:
        raise KaldiValidationError(f"{path}: empty wav.scp")

    text_p = os.path.join(path, "text")
    text = read_keyed_file(text_p) if os.path.exists(text_p) else None
    seg_p = os.path.join(path, "segments")
    segments = parse_segments(seg_p) if os.path.exists(seg_p) else None
    u2s_p = os.path.join(path, "utt2spk")
    utt2spk = read_keyed_file(u2s_p) if os.path.exists(u2s_p) else None
    dur_p = os.path.join(path, "utt2dur")
    utt2dur = {k: float(v) for k, v in read_keyed_file(dur_p).items()} if os.path.exists(dur_p) else None

    # utterance universe
    if segments is not None:
        utts = set(segments)
    elif text is not None:
        utts = set(text) & set(wavscp)
        ghost = set(text) - set(wavscp)
        if ghost:
            report["warnings"].append(f"text: {len(ghost)} utterances without recording")
    else:
        utts = set(wavscp)

    def _restrict(name, d):
        if d is None:
            return None
        missing = set(d) - utts
        lacking = utts - set(d)
        if missing:
            report["warnings"].append(f"{name}: {len(missing)} entries without matching utterance")
        if lacking:
            report["warnings"].append(f"{name}: {len(lacking)} utterances missing")
        return d

    _restrict("text", text)
    _restrict("utt2spk", utt2spk)

    # intersection of all keyed files defines the surviving utterances
    keep = set(utts)
    for d in (text, utt2spk):
        if d is not None:
            keep &= set(d)
    if segments is not None:
        keep &= {u for u, (rec, s, e) in segments.items() if rec in wavscp and 0 <= s < e}
        bad_seg = utts - keep
        if bad_seg:
            report["warnings"].append(f"segments: {len(bad_seg)} invalid (bad recording or times)")
    removed = sorted(utts - keep)
    report["removed_utts"] = removed
    if removed and not fix:
        raise KaldiValidationError(f"{path}: {len(removed)} inconsistent utterances (run with fix=True)")

    # durations
    if utt2dur is None and compute_utt2dur:
        if segments is not None:
            utt2dur = {u: segments[u][2] - segments[u][1] for u in keep}
        else:
            rec_durs = compute_durations({k: v for k, v in wavscp.items()})
            utt2dur = {u: rec_durs[u] for u in keep if u in rec_durs}

    # gender sanity
    g_p = os.path.join(path, "spk2gender")
    if os.path.exists(g_p):
        s2g = read_keyed_file(g_p)
        bad = {k: v for k, v in s2g.items() if v not in ("m", "f")}
        if bad:
            report["warnings"].append(f"spk2gender: invalid values {bad}")

    if language:
        _report_weird_characters(text, language, report)

    if fix:
        if text is not None:
            write_keyed_file(text_p, {u: text[u] for u in sorted(keep & set(text))})
        if utt2spk is not None:
            kept_u2s = {u: utt2spk[u] for u in sorted(keep & set(utt2spk))}
            write_keyed_file(u2s_p, kept_u2s)
            write_keyed_file(os.path.join(path, "spk2utt"), utt2spk_to_spk2utt(kept_u2s))
            if os.path.exists(g_p):
                spks = set(kept_u2s.values())
                s2g = read_keyed_file(g_p)
                write_keyed_file(g_p, {s: g for s, g in s2g.items() if s in spks})
        if segments is not None:
            write_segments(seg_p, {u: segments[u] for u in keep})
            used_recs = {segments[u][0] for u in keep}
            write_keyed_file(wavscp_p, {r: wavscp[r] for r in sorted(used_recs)})
        else:
            write_keyed_file(wavscp_p, {r: wavscp[r] for r in sorted(set(wavscp) & (keep | set(wavscp) - utts))} or wavscp)
        if utt2dur is not None:
            write_keyed_file(dur_p, {u: f"{utt2dur[u]:.6f}" for u in sorted(set(utt2dur) & keep)})

    report["n_utts"] = len(keep)
    report["n_recordings"] = len(wavscp)
    for w in report["warnings"]:
        logger.warning(f"{path}: {w}")
    return report


_WEIRD_OK = {
    "fr": re.compile(r"[a-zA-Zàâäéèêëîïôöùûüÿçœæ'\- <>_0-9.,;:!?()\[\]\"%€$£/+=&@°«»…–—’]"),
    "en": re.compile(r"[a-zA-Z'\- <>_0-9.,;:!?()\[\]\"%€$£/+=&@°«»…–—’]"),
}


def _report_weird_characters(text: dict, language: str, report: dict):
    """Per-language unexpected-character report."""
    ok = _WEIRD_OK.get(language.split("-")[0].lower())
    if ok is None or text is None:
        return
    weird = {}
    for utt, t in text.items():
        for ch in t:
            if not ok.match(ch):
                weird.setdefault(ch, 0)
                weird[ch] += 1
    if weird:
        report["warnings"].append(f"text: unexpected characters for language {language}: {dict(sorted(weird.items(), key=lambda kv: -kv[1])[:20])}")
