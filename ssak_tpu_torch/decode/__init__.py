from ssak_tpu_torch.decode.ctc_beam import ctc_beam_search_device, ctc_prefix_beam_search
from ssak_tpu_torch.decode.lexicon import Lexicon
from ssak_tpu_torch.decode.lm import ArpaLM, char_lm_table, train_ngram_lm, word_lm_device_tables

__all__ = [
    "ctc_prefix_beam_search",
    "ctc_beam_search_device",
    "ArpaLM",
    "Lexicon",
    "train_ngram_lm",
    "char_lm_table",
    "word_lm_device_tables",
]
