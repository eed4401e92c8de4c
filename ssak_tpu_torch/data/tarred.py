"""Tarred, bucketed, sharded audio datasets for large-scale training
(counterpart of ssak_tpu.data.tarred): utterances are bucketed by
duration, resampled/decoded ONCE to 16 kHz PCM wav, and packed into shard
tars with a JSONL manifest per bucket. Reading streams shards sequentially (tar = sequential I/O, the
point of the format) and yields static-shape padded batches ready for the
device — sox-pipe decoding cost is paid at dataset build time, not every
epoch.

Layout:
    out_dir/bucket_<seconds>/shard_00000.tar   (members: <utt_id>.wav)
    out_dir/bucket_<seconds>/manifest.jsonl    {"id", "shard", "duration", "text"}
    out_dir/metadata.json
"""

import io
import json
import os
import struct
import tarfile

import numpy as np

from ssak_tpu_torch.utils.monitoring import logger

DEFAULT_BUCKETS = (2.0, 4.0, 8.0, 15.0, 30.0)


def create_tarred_dataset(
    rows,
    out_dir: str,
    buckets=DEFAULT_BUCKETS,
    shard_size: int = 512,
    sample_rate: int = 16000,
):
    """rows: manifest rows (data/dataset.py). Returns metadata dict."""
    from ssak_tpu_torch.audio import load_audio
    from ssak_tpu_torch.data.dataset import duration_buckets

    os.makedirs(out_dir, exist_ok=True)
    by_bucket = duration_buckets(rows, buckets)
    meta = {"buckets": {}, "sample_rate": sample_rate, "shard_size": shard_size}
    for bucket, brows in by_bucket.items():
        bdir = os.path.join(out_dir, f"bucket_{bucket:g}")
        os.makedirs(bdir, exist_ok=True)
        manifest = []
        shard_idx = 0
        tar = None
        for i, r in enumerate(brows):
            if i % shard_size == 0:
                if tar:
                    tar.close()
                tar = tarfile.open(os.path.join(bdir, f"shard_{shard_idx:05d}.tar"), "w")
                shard_idx += 1
            audio = load_audio(r["audio"], start=r.get("start"), end=r.get("end"), sample_rate=sample_rate)
            buf = io.BytesIO()
            data = np.clip(np.round(audio * 32768.0), -32768, 32767).astype("<i2").tobytes()
            buf.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
            buf.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
            buf.write(b"data" + struct.pack("<I", len(data)) + data)
            payload = buf.getvalue()
            info = tarfile.TarInfo(name=f"{r['id']}.wav")
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
            manifest.append({"id": r["id"], "shard": shard_idx - 1, "duration": len(audio) / sample_rate, "text": r.get("text")})
        if tar:
            tar.close()
        with open(os.path.join(bdir, "manifest.jsonl"), "w", encoding="utf-8") as f:
            for m in manifest:
                f.write(json.dumps(m, ensure_ascii=False) + "\n")
        meta["buckets"][f"{bucket:g}"] = {"n_utts": len(manifest), "n_shards": shard_idx}
        logger.info(f"bucket {bucket:g}s: {len(manifest)} utts in {shard_idx} shards")
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def iterate_tarred_dataset(
    out_dir: str,
    batch_size: int,
    shard_shuffle_seed: int = None,
    process_index: int = 0,
    process_count: int = 1,
):
    """Yield (audio (B, T_bucket), lengths (B,), rows) batches, streaming
    shards sequentially. Shards are interleaved round-robin across hosts
    (process_index/process_count) for multi-host data parallelism."""
    import random

    from ssak_tpu_torch.audio.wav import read_wav_header, _decode_frames

    with open(os.path.join(out_dir, "metadata.json")) as f:
        meta = json.load(f)
    sr = meta["sample_rate"]
    bucket_names = sorted(meta["buckets"], key=float)
    if shard_shuffle_seed is not None:
        random.Random(shard_shuffle_seed).shuffle(bucket_names)
    for bname in bucket_names:
        bdir = os.path.join(out_dir, f"bucket_{bname}")
        pad_to = int(float(bname) * sr)
        with open(os.path.join(bdir, "manifest.jsonl"), encoding="utf-8") as f:
            manifest = [json.loads(l) for l in f]
        by_id = {m["id"]: m for m in manifest}
        shards = sorted(fn for fn in os.listdir(bdir) if fn.endswith(".tar"))
        if shard_shuffle_seed is not None:
            random.Random(shard_shuffle_seed + hash(bname) % 1000).shuffle(shards)
        shards = shards[process_index::process_count]
        batch_x, batch_len, batch_rows = [], [], []
        for shard in shards:
            with tarfile.open(os.path.join(bdir, shard)) as tar:
                for member in tar:
                    fobj = tar.extractfile(member)
                    fmt = read_wav_header(fobj)
                    raw = fobj.read(fmt.data_size)
                    audio = _decode_frames(raw, fmt)[:, 0]
                    rid = member.name[:-4]
                    batch_x.append(audio)
                    batch_len.append(len(audio))
                    batch_rows.append(by_id.get(rid, {"id": rid}))
                    if len(batch_x) == batch_size:
                        yield _pad(batch_x, batch_len, pad_to), np.asarray(batch_len, np.int32), batch_rows
                        batch_x, batch_len, batch_rows = [], [], []
        if batch_x:
            while len(batch_x) < batch_size:
                batch_x.append(np.zeros(1, np.float32))
                batch_len.append(1)
                batch_rows.append(None)
            yield _pad(batch_x, batch_len, pad_to), np.asarray(batch_len, np.int32), batch_rows


def _pad(audios, lens, pad_to):
    x = np.zeros((len(audios), pad_to), np.float32)
    for i, a in enumerate(audios):
        n = min(len(a), pad_to)
        x[i, :n] = a[:n]
    return x
