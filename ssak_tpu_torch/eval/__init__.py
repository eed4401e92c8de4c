from ssak_tpu_torch.eval.wer import (
    align_tokens,
    compute_wer,
    compute_wer_differences,
    format_alignment,
    keyword_scores,
)

__all__ = [
    "compute_wer",
    "compute_wer_differences",
    "align_tokens",
    "format_alignment",
    "keyword_scores",
]
