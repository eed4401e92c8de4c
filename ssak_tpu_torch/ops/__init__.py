from ssak_tpu_torch.ops.ctc import ctc_alignment_trellis, ctc_greedy_decode, ctc_loss
from ssak_tpu_torch.ops.logmel import log_mel_spectrogram, pad_or_trim

__all__ = [
    "ctc_loss",
    "ctc_greedy_decode",
    "ctc_alignment_trellis",
    "log_mel_spectrogram",
    "pad_or_trim",
]
