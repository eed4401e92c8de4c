"""CTC character tokenizer (counterpart of ssak_tpu.models.tokenizer.CTCTokenizer).

HF wav2vec2-style vocab.json: token -> id; '|' is the word delimiter; the id
of '<pad>' is the CTC blank. The Whisper BPE tokenizer comes with the port
of checkpoint loading (ROADMAP.md slice 6).
"""

import json
import os


class CTCTokenizer:
    def __init__(self, vocab, word_delimiter: str = "|", blank_token: str = "<pad>", unk_token: str = "<unk>"):
        if isinstance(vocab, str):
            path = vocab if vocab.endswith(".json") else os.path.join(vocab, "vocab.json")
            with open(path, encoding="utf-8") as f:
                vocab = json.load(f)
        self.vocab = dict(vocab)
        self.id2tok = {v: k for k, v in self.vocab.items()}
        self.word_delimiter = word_delimiter
        self.blank_id = self.vocab.get(blank_token, 0)
        self.unk_id = self.vocab.get(unk_token, self.blank_id)
        self.special = {blank_token, unk_token, "<s>", "</s>"}

    def __len__(self):
        return len(self.vocab)

    @classmethod
    def from_corpus(cls, texts, extra_tokens=("<pad>", "<s>", "</s>", "<unk>")):
        """A char vocab from corpus text: the extra tokens first, then the
        sorted characters (spaces as the word delimiter)."""
        chars = sorted({c for t in texts for c in t.replace(" ", "|")})
        vocab = {}
        for t in extra_tokens:
            vocab[t] = len(vocab)
        for c in chars:
            if c not in vocab:
                vocab[c] = len(vocab)
        return cls(vocab)

    def encode(self, text: str):
        text = text.replace(" ", self.word_delimiter)
        return [self.vocab.get(c, self.unk_id) for c in text]

    def decode(self, ids):
        toks = [self.id2tok.get(int(i), "") for i in ids if int(i) >= 0]
        out = "".join(t for t in toks if t not in self.special)
        return out.replace(self.word_delimiter, " ").strip()

    def save(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False, indent=1)
