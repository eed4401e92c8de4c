from ssak_tpu_torch.formats.diarization import import_rttm, json2rttm, to_diarization
from ssak_tpu_torch.formats.voicelab import augment_database, kaldi_to_voicelab, voicelab_to_kaldi
from ssak_tpu_torch.formats.transcription import (
    SpeechSegment,
    TranscriptionResult,
    Word,
    remove_hallucinations,
    shorten_transcription,
    to_transcription,
    transcription_to,
)

__all__ = [
    "to_transcription",
    "transcription_to",
    "TranscriptionResult",
    "SpeechSegment",
    "Word",
    "remove_hallucinations",
    "shorten_transcription",
    "import_rttm",
    "to_diarization",
    "json2rttm",
    "kaldi_to_voicelab",
    "voicelab_to_kaldi",
    "augment_database",
]
