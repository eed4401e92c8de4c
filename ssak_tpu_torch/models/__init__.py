from ssak_tpu_torch.models import whisper, wav2vec2
from ssak_tpu_torch.models.tokenizer import CTCTokenizer, WhisperTokenizer, train_bpe_tokenizer

__all__ = ["whisper", "wav2vec2", "CTCTokenizer", "WhisperTokenizer", "train_bpe_tokenizer"]
