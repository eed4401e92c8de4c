"""Kaldi data-folder readers (counterpart of the reading half of
ssak_tpu.data.kaldi: `load_kaldi_dir` and the parsers it uses).

A Kaldi data dir holds whitespace-separated "<key> <value...>" files:
wav.scp (recording-id -> path or command pipe "... |"), text, segments
(utterance-id recording-id start end), utt2spk, spk2utt, utt2dur,
spk2gender, reco2dur. Values are kept verbatim; command pipes are parsed
here but refused when a manifest is built (ssak_tpu_torch.data.dataset),
since decoding them is a later slice of the port. Validation and fixing
(`check_kaldi_dir`) come with the port of the data tools.
"""

import os

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


def parse_segments(path: str) -> dict:
    """utterance-id -> (recording-id, start_sec, end_sec)."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                out[parts[0]] = (parts[1], float(parts[2]), float(parts[3]))
    return out


def load_kaldi_dir(path: str) -> dict:
    """Load all known files of a Kaldi dir into a dict of dicts."""
    out = {"path": path}
    for name in KNOWN_FILES:
        p = os.path.join(path, name)
        if os.path.exists(p):
            out[name] = parse_segments(p) if name == "segments" else read_keyed_file(p)
    return out
