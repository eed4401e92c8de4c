"""Segment-level surgery on Kaldi datasets (counterpart of
ssak_tpu.data.segment_ops): detect segments that temporally overlap a
neighbouring segment of another speaker on the same recording, and glue
consecutive same-speaker segments (separated by at most ``max_silence``
seconds, capped at ``max_duration``) so that overlap-torn turns become
whole utterances again.

Works on :class:`ssak_tpu_torch.data.kaldi_dataset.KaldiDataset` rows;
recordings are identified by ``audio_path`` (robust even when
``audio_id`` was synthesised at load time).
"""

from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset, KaldiDatasetRow


def _recording_key(row: KaldiDatasetRow) -> str:
    return row.audio_path or row.audio_id or row.id


def find_overlapping_segments(dataset: KaldiDataset) -> set:
    """Ids of segments that overlap an adjacent segment on the same recording.

    A segment overlaps when it starts before the previous segment (in start
    order) has ended, or when the next segment of a *different* speaker
    starts before it ends.
    """
    rows = [r for r in dataset if r.start is not None and r.end is not None]
    rows.sort(key=lambda r: (_recording_key(r), r.start))
    overlapped = set()
    for i, r in enumerate(rows):
        prev = rows[i - 1] if i > 0 else None
        nxt = rows[i + 1] if i + 1 < len(rows) else None
        if prev is not None and _recording_key(prev) == _recording_key(r) and prev.end > r.start:
            overlapped.add(r.id)
            continue
        if (
            nxt is not None
            and _recording_key(nxt) == _recording_key(r)
            and nxt.speaker != r.speaker
            and r.end > nxt.start
        ):
            overlapped.add(r.id)
    return overlapped


def glue_overlapping_segments(
    dataset: KaldiDataset,
    max_silence: float = 0.5,
    max_duration: float = 15.0,
    mode: str = "overlap",
) -> KaldiDataset:
    """Glue consecutive same-speaker segments into longer utterances.

    mode="overlap" only glues pairs where at least one side was flagged by
    :func:`find_overlapping_segments`; mode="all" glues whenever the silence
    gap and the merged duration allow it.
    Texts are concatenated in time order; the earliest segment's id, speaker
    and gender are kept.
    """
    assert mode in ("overlap", "all")
    to_glue = None if mode == "all" else find_overlapping_segments(dataset)
    rows = [r for r in dataset if r.start is not None and r.end is not None]
    no_time = [r for r in dataset if r.start is None or r.end is None]
    rows.sort(key=lambda r: (_recording_key(r), r.start))

    out = []
    pending = {}  # speaker -> accumulated row (per current recording)
    pending_rec = None

    def flush(speakers=None):
        for spk in list(pending) if speakers is None else speakers:
            out.append(pending.pop(spk))

    for r in rows:
        rec = _recording_key(r)
        if rec != pending_rec:
            flush()
            pending_rec = rec
        acc = pending.get(r.speaker)
        can = (
            acc is not None
            and r.start - acc.end <= max_silence
            and r.end - acc.start <= max_duration
            and (to_glue is None or acc.id in to_glue or r.id in to_glue)
        )
        if can:
            acc.end = r.end
            acc.duration = acc.end - acc.start
            acc.text = f"{acc.text or ''} {r.text or ''}".strip()
        else:
            if acc is not None:
                out.append(pending.pop(r.speaker))
            pending[r.speaker] = KaldiDatasetRow(**dict(r.__dict__))
    flush()

    out.sort(key=lambda r: (_recording_key(r), r.start))
    return KaldiDataset(out + no_time, name=dataset.name)


def rename_ids(
    dataset: KaldiDataset,
    char: str,
    replacement: str,
    rename_utt_ids: bool = True,
    rename_audio_ids: bool = True,
    rename_speakers: bool = True,
) -> KaldiDataset:
    """Replace a character in utterance / audio / speaker ids.

    The dataset is transformed in place (and re-saved by the caller), so
    all files stay mutually consistent.
    """
    for r in dataset:
        if rename_utt_ids:
            r.id = r.id.replace(char, replacement)
        if rename_audio_ids and r.audio_id:
            r.audio_id = r.audio_id.replace(char, replacement)
        if rename_speakers and r.speaker:
            r.speaker = r.speaker.replace(char, replacement)
    return dataset
