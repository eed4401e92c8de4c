from ssak_tpu_torch.align.dtw import find_best_position_dtw, find_best_position_levenshtein
from ssak_tpu_torch.align.forced import Segment, align_audio_to_transcript, compute_alignment, merge_words
from ssak_tpu_torch.align.vad import convert_timestamps, get_vad_segments, remove_non_speech

__all__ = [
    "compute_alignment",
    "align_audio_to_transcript",
    "merge_words",
    "Segment",
    "find_best_position_dtw",
    "find_best_position_levenshtein",
    "get_vad_segments",
    "remove_non_speech",
    "convert_timestamps",
]
