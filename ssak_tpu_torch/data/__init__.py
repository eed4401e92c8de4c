from ssak_tpu_torch.data.dataset import (
    bucketed_audio_batches,
    kaldi_folder_to_manifest,
    to_audio_batches,
)
from ssak_tpu_torch.data.kaldi import check_kaldi_dir, load_kaldi_dir

__all__ = [
    "kaldi_folder_to_manifest",
    "to_audio_batches",
    "bucketed_audio_batches",
    "check_kaldi_dir",
    "load_kaldi_dir",
]
