"""Audio batching: `to_audio_batches` (counterpart of
ssak_tpu.data.dataset.to_audio_batches).

Sources: a np.ndarray, a list of arrays and/or audio paths, a single audio
path, a list file of audio paths or Kaldi dirs, or a Kaldi dir whose
wav.scp holds plain file paths. The full Kaldi manifest (segments, command
pipes, filters, weights) is a later slice of the port.
"""

import os

import numpy as np


def _kaldi_rows(path):
    """Rows of a Kaldi dir with a plain-path wav.scp, sorted by id (the
    order ssak_tpu's manifest gives)."""
    if os.path.exists(os.path.join(path, "segments")):
        raise NotImplementedError(f"{path}: Kaldi 'segments' files are not ported yet")
    scp = os.path.join(path, "wav.scp")
    if not os.path.exists(scp):
        raise FileNotFoundError(f"{path}: not a Kaldi data dir (no wav.scp)")
    rows = []
    with open(scp, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) < 2:
                continue
            utt, src = parts
            if src.rstrip().endswith("|"):
                raise NotImplementedError(f"{path}: command-pipe wav.scp entries are not ported yet")
            rows.append({"id": utt, "audio": os.path.expandvars(src)})
    rows.sort(key=lambda r: r["id"])
    return rows


def to_audio_batches(
    source,
    batch_size: int = 1,
    sample_rate: int = 16000,
    output_ids: bool = False,
    io_threads: int = 0,
):
    """Universal input adapter: yields batches (lists) of float32 audio
    arrays, or (batch, ids) pairs with output_ids=True. io_threads>1
    decodes files in an ordered thread pool (prefetch.prefetch_map)."""
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
                yield from _kaldi_rows(source)
                return
            yield from _file_rows(source)
            return
        raise ValueError(f"unsupported audio source: {type(source)}")

    def _file_rows(item):
        path = str(item)
        ext = os.path.splitext(path)[1].lower()
        if ext in (".wav", ".mp3", ".flac"):
            yield {"id": os.path.splitext(os.path.basename(path))[0], "audio": path}
        elif os.path.isfile(path):
            # a list file of audio paths or Kaldi dirs
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = os.path.expandvars(line.strip())
                    if not line:
                        continue
                    if os.path.isdir(line.split()[0]):
                        yield from _kaldi_rows(line.split()[0])
                    else:
                        yield from _file_rows(line)
        else:
            raise FileNotFoundError(path)

    def _load_row(row):
        if "array" in row:
            return row, np.asarray(row["array"], dtype=np.float32)
        return row, load_audio(row["audio"], sample_rate=sample_rate)

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
