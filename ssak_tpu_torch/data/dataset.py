"""Manifests and audio batching (counterpart of ssak_tpu.data.dataset).

`to_audio_batches` (serving): a np.ndarray, a list of arrays, audio paths
and/or wav.scp command pipes, a single audio path (optionally with
':start-end,...' windows in seconds, one row each), a list file of audio
paths or Kaldi dirs, or a Kaldi dir (with `segments` windows).

Training: `kaldi_folder_to_manifest` turns Kaldi dirs (one dir, a list of
dirs, or a list file of "<dir> [weight]" lines) into a manifest, a list of
row dicts {id, audio, start, end, duration, text, speaker, gender}, with the
duration / text-length filters, `max_data` subsets and weighted upsampling
of ssak_tpu; `audio` is the wav.scp value verbatim (a path or a command
pipe; environment variables are expanded when it is decoded). With
use_cache the manifest is kept as JSONL under the port's cache directory,
keyed on the dirs' file mtimes and sizes and on the arguments.
`bucketed_audio_batches` cuts it into duration-bucketed batches padded to
the bucket's sample count and to the full batch size (dummy rows of one
zero sample).
"""

import json
import os
import random

import numpy as np

from ssak_tpu_torch.audio.io import SUPPORTED_EXTENSIONS
from ssak_tpu_torch.data import kaldi as K
from ssak_tpu_torch.utils.misc import get_cache_dir, hashmd5
from ssak_tpu_torch.utils.monitoring import logger


AUDIO_SPEC_SEP = ":"


def _parse_audio_spec(spec: str):
    """'file.wav:3.2-5.4,7-8.5' -> (path, [(3.2, 5.4), (7.0, 8.5)]); a spec
    without windows, or whose path does not exist, -> (spec, None)."""
    if AUDIO_SPEC_SEP in spec:
        path, ranges = spec.rsplit(AUDIO_SPEC_SEP, 1)
        try:
            windows = []
            for rng in ranges.split(","):
                a, b = rng.split("-")
                windows.append((float(a), float(b)))
            if os.path.exists(path):
                return path, windows
        except ValueError:
            pass
    return spec, None


def to_audio_batches(
    source,
    batch_size: int = 1,
    sample_rate: int = 16000,
    output_ids: bool = False,
    sort_by_len: bool = False,
    io_threads: int = 0,
):
    """Universal input adapter: yields batches (lists) of float32 audio
    arrays, or (batch, ids) pairs with output_ids=True. A Kaldi dir is read
    through its manifest (kaldi_folder_to_manifest), in id order or, with
    sort_by_len, by ascending utt2dur duration. io_threads>1 decodes files
    in an ordered thread pool (prefetch.prefetch_map)."""
    from ssak_tpu_torch.audio import load_audio

    def gen_rows():
        if isinstance(source, np.ndarray):
            yield {"id": "audio000", "array": source}
            return
        if isinstance(source, (list, tuple)):
            for i, item in enumerate(source):
                if isinstance(item, np.ndarray):
                    yield {"id": f"audio{i:03d}", "array": item}
                else:
                    yield from _file_rows(item)
            return
        if isinstance(source, str):
            if os.path.isdir(source):
                yield from kaldi_folder_to_manifest(source, sort_by_len=1 if sort_by_len else 0)[1]
                return
            yield from _file_rows(source)
            return
        raise ValueError(f"unsupported audio source: {type(source)}")

    def _file_rows(item):
        path, windows = _parse_audio_spec(str(item))
        ext = os.path.splitext(path)[1].lower()
        if ext in SUPPORTED_EXTENSIONS or path.rstrip().endswith("|"):
            base = os.path.splitext(os.path.basename(path))[0]
            if windows:
                for start, end in windows:
                    yield {"id": f"{base}_{start:.2f}-{end:.2f}", "audio": path, "start": start, "end": end}
            else:
                yield {"id": base, "audio": path}
        elif os.path.isfile(path):
            # a list file of audio paths or Kaldi dirs
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = os.path.expandvars(line.strip())
                    if not line:
                        continue
                    if os.path.isdir(line.split()[0]):
                        yield from kaldi_folder_to_manifest(line.split()[0])[1]
                    else:
                        yield from _file_rows(line)
        else:
            raise FileNotFoundError(path)

    def _load_row(row):
        if "array" in row:
            return row, np.asarray(row["array"], dtype=np.float32)
        return row, load_audio(row["audio"], start=row.get("start"), end=row.get("end"), sample_rate=sample_rate)

    if io_threads and io_threads > 1:
        from ssak_tpu_torch.data.prefetch import prefetch_map

        loaded = prefetch_map(_load_row, gen_rows(), workers=io_threads, depth=4 * io_threads)
    else:
        loaded = map(_load_row, gen_rows())

    batch, ids = [], []
    for row, audio in loaded:
        batch.append(audio)
        ids.append(row["id"])
        if len(batch) == batch_size:
            yield (batch, ids) if output_ids else batch
            batch, ids = [], []
    if batch:
        yield (batch, ids) if output_ids else batch


# --- manifests ------------------------------------------------------------------------


def kaldi_folder_to_manifest(
    path,
    min_duration: float = None,
    max_duration: float = None,
    max_text_length: int = None,
    max_data: int = None,
    choose_data_with_max_duration: bool = False,
    shuffle: bool = False,
    sort_by_len: int = 0,
    weights: float = 1.0,
    seed: int = 69,
    use_cache: bool = False,
):
    """Load one Kaldi dir, a list file of "<dir> [weight]" lines, or a list
    of dirs. sort_by_len: 0 none, 1 ascending, -1 descending. max_data caps
    the utterance count: a seeded random subset, or the longest utterances
    with choose_data_with_max_duration. use_cache: reuse a JSONL manifest
    keyed on the Kaldi files' (mtime, size) and these arguments, written on
    a miss. Returns (meta, rows)."""
    if use_cache:
        key = _manifest_cache_key(
            path, min_duration=min_duration, max_duration=max_duration,
            max_text_length=max_text_length, max_data=max_data,
            choose_data_with_max_duration=choose_data_with_max_duration,
            shuffle=shuffle, sort_by_len=sort_by_len, weights=weights, seed=seed,
        )
        cached = _manifest_cache_path(key)
        if os.path.exists(cached):
            rows = load_manifest(cached)
            logger.info(f"manifest cache hit: {cached} ({len(rows)} rows)")
            return _manifest_meta(rows), rows
    rows = []
    if isinstance(path, str) and os.path.isfile(path):
        with open(path, encoding="utf-8") as f:
            entries = []
            for line in f:
                parts = line.split()
                if parts:
                    entries.append((os.path.expandvars(parts[0]), float(parts[1]) if len(parts) > 1 else 1.0))
        for d, w in entries:
            _meta, sub = kaldi_folder_to_manifest(d, weights=w, seed=seed)
            _extend_unique(rows, sub)
    elif isinstance(path, (list, tuple)):
        for d in path:
            _meta, sub = kaldi_folder_to_manifest(d, seed=seed)
            _extend_unique(rows, sub)
    else:
        rows = _load_one_kaldi_dir(os.path.expandvars(path))
        rows = _apply_weight(rows, weights, seed=seed)

    n_before = len(rows)
    if min_duration is not None:
        rows = [r for r in rows if r["duration"] is None or r["duration"] >= min_duration]
    if max_duration is not None:
        rows = [r for r in rows if r["duration"] is None or r["duration"] <= max_duration]
    if max_text_length is not None:
        rows = [r for r in rows if len(r.get("text") or "") <= max_text_length]
    if len(rows) != n_before:
        logger.info(f"filtered {n_before - len(rows)}/{n_before} utterances (duration/text-length)")

    if max_data and max_data < len(rows):
        if choose_data_with_max_duration:
            rows.sort(key=lambda r: (r["duration"] or 0.0, len(r.get("text") or "")))
            rows = rows[-max_data:]
        else:
            rows = random.Random(seed).sample(rows, max_data)

    if shuffle:
        random.Random(seed).shuffle(rows)
    elif sort_by_len:
        rows.sort(key=lambda r: (r["duration"] or 0.0), reverse=sort_by_len < 0)

    if use_cache:
        cache_manifest(rows, key)
    return _manifest_meta(rows), rows


def _manifest_meta(rows):
    return {"samples": len(rows), "h duration": round(sum(r["duration"] or 0.0 for r in rows) / 3600.0, 6)}


def _extend_unique(rows, sub):
    """Merge corpora keeping utterance ids unique (colliding ids get _dupN)."""
    seen = {r["id"] for r in rows}
    for r in sub:
        rid = r["id"]
        if rid in seen:
            n = 1
            while f"{rid}_dup{n}" in seen:
                n += 1
            r = {**r, "id": f"{rid}_dup{n}"}
        seen.add(r["id"])
        rows.append(r)


def _load_one_kaldi_dir(path):
    d = K.load_kaldi_dir(path)
    if "wav.scp" not in d:
        raise FileNotFoundError(f"{path}: not a Kaldi data dir (no wav.scp)")
    wavscp = d["wav.scp"]
    text = d.get("text", {})
    utt2spk = d.get("utt2spk", {})
    spk2gender = d.get("spk2gender", {})
    utt2dur = {k: float(v) for k, v in d.get("utt2dur", {}).items()}
    rows = []
    if "segments" in d:
        for utt, (rec, start, end) in d["segments"].items():
            if rec not in wavscp:
                continue
            spk = utt2spk.get(utt)
            rows.append({"id": utt, "audio": wavscp[rec], "start": start, "end": end,
                         "duration": utt2dur.get(utt, end - start), "text": text.get(utt), "speaker": spk,
                         "gender": spk2gender.get(spk)})
    else:
        for utt in text or wavscp:
            if utt not in wavscp:
                continue
            spk = utt2spk.get(utt)
            rows.append({"id": utt, "audio": wavscp[utt], "start": None, "end": None,
                         "duration": utt2dur.get(utt), "text": text.get(utt), "speaker": spk,
                         "gender": spk2gender.get(spk)})
    rows.sort(key=lambda r: r["id"])
    return rows


def _apply_weight(rows, weight: float, seed: int = 69):
    """Upsample by `weight`: full copies get _copyN id suffixes, the
    fractional part is a seeded random subset."""
    if weight == 1.0 or not rows:
        return rows
    out = list(rows)
    full = int(weight)
    frac = weight - full
    for c in range(1, full):
        out.extend({**r, "id": f"{r['id']}_copy{c}"} for r in rows)
    if frac > 0:
        rng = random.Random(seed)
        picked = rng.sample(range(len(rows)), int(round(frac * len(rows))))
        out.extend({**rows[i], "id": f"{rows[i]['id']}_copy{full}"} for i in sorted(picked))
    return out


# --- the manifest cache ---------------------------------------------------------------

_KALDI_FILES = ("wav.scp", "text", "segments", "utt2spk", "utt2dur", "spk2gender")


def _dir_fingerprint(path):
    """(abspath, ((name, mtime_ns, size), ...)) over the standard Kaldi files."""
    fp = []
    for fn in _KALDI_FILES:
        p = os.path.join(path, fn)
        if os.path.exists(p):
            st = os.stat(p)
            fp.append((fn, st.st_mtime_ns, st.st_size))
    return (os.path.abspath(path), tuple(fp))


def _manifest_cache_key(path, **opts):
    if isinstance(path, str) and os.path.isfile(path):
        st = os.stat(path)
        with open(path, encoding="utf-8") as f:
            dirs = [os.path.expandvars(line.split()[0]) for line in f if line.split()]
        src = ("listfile", os.path.abspath(path), st.st_mtime_ns, st.st_size,
               tuple(_dir_fingerprint(d) for d in dirs if os.path.isdir(d)))
    elif isinstance(path, (list, tuple)):
        src = ("list", tuple(_dir_fingerprint(os.path.expandvars(p)) for p in path))
    else:
        src = ("dir", _dir_fingerprint(os.path.expandvars(path)))
    return (src, tuple(sorted(opts.items())))


def _manifest_cache_path(key_obj) -> str:
    cache = os.path.join(get_cache_dir(), "manifests")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, hashmd5(key_obj) + ".jsonl")


def cache_manifest(rows, key_obj) -> str:
    """Write rows to the JSONL cache file of `key_obj` (once); return its path."""
    path = _manifest_cache_path(key_obj)
    if not os.path.exists(path):
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for r in rows:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
        os.replace(tmp, path)
    return path


def load_manifest(path) -> list:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


# --- bucketed batching ----------------------------------------------------------------

DEFAULT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 15.0, 30.0)


def duration_buckets(rows, buckets=DEFAULT_BUCKETS):
    """bucket seconds -> rows whose duration fits it (the smallest bucket >=
    duration; a missing duration counts as 0, longer rows go to the largest)."""
    out = {b: [] for b in buckets}
    top = buckets[-1]
    for r in rows:
        d = r.get("duration") or 0.0
        for b in buckets:
            if d <= b:
                out[b].append(r)
                break
        else:
            out[top].append(r)
    return {b: rs for b, rs in out.items() if rs}


def padded_batch(audios, pad_to: int):
    """Stack 1-D float32 arrays into (B, pad_to) + lengths (B,)."""
    B = len(audios)
    x = np.zeros((B, pad_to), dtype=np.float32)
    lens = np.zeros((B,), dtype=np.int32)
    for i, a in enumerate(audios):
        n = min(len(a), pad_to)
        x[i, :n] = a[:n]
        lens[i] = n
    return x, lens


def bucketed_audio_batches(rows, batch_size: int, sample_rate: int = 16000, buckets=DEFAULT_BUCKETS,
                           output_rows: bool = False, seed: int = None):
    """Yield (audio (B, T_bucket), lengths (B,)[, rows]) with T fixed per
    bucket and B = batch_size always (short batches are topped up with
    one-zero-sample dummy rows, whose row entry is None)."""
    from ssak_tpu_torch.audio import load_audio

    order = list(duration_buckets(rows, buckets).items())
    if seed is not None:
        rng = random.Random(seed)
        for _b, rs in order:
            rng.shuffle(rs)
    for b, rs in order:
        pad_to = int(round(b * sample_rate))
        for i in range(0, len(rs), batch_size):
            chunk = rs[i : i + batch_size]
            audios = [load_audio(r["audio"], start=r.get("start"), end=r.get("end"), sample_rate=sample_rate) for r in chunk]
            while len(audios) < batch_size:
                audios.append(np.zeros(1, dtype=np.float32))
                chunk = chunk + [None]
            x, lens = padded_batch(audios, pad_to)
            if output_rows:
                yield x, lens, chunk
            else:
                yield x, lens
