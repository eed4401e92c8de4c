"""The port's plain-Python BPE trainer (models/tokenizer.train_bpe_tokenizer)
against ssak_tpu's, which runs the `tokenizers` BpeTrainer: the saved
tokenizer.json (special tokens, alphabet, vocab ids, merges in rank order)
must parse to the same JSON, on corpora with many equal pair counts,
non-ASCII letters, punctuation, digits and marks, and at vocab sizes below
the alphabet, at it, and past what the corpus can merge."""

import json

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")

from ssak_tpu.models.tokenizer import train_bpe_tokenizer as j_train  # noqa: E402
from ssak_tpu_torch.models.tokenizer import BpeTokenizer, train_bpe_tokenizer  # noqa: E402


def _random_corpus(seed, n_lines, alphabet):
    rng = np.random.RandomState(seed)
    return [" ".join("".join(rng.choice(list(alphabet), size=rng.randint(1, 9))) for _ in range(rng.randint(1, 30)))
            for _ in range(n_lines)]


CORPORA = {
    # every pair count ties: merges go to the smaller (left id, right id)
    "ties": ["ab ab cd cd ef ef gh gh", "abcd efgh", "ba dc", "hg fe"],
    "french": ["Le chat dort, bien !", "été ça ok le chat", "L'élève a mangé 12 pommes… «oui» — non ?",
               "<unk> spécial_token x_y 3.14", "C'est l'œuvre d'un maître ; à bientôt."],
    "random_latin": _random_corpus(0, 60, "abcdéèàçœ'-.,!?ñß0123"),
    "random_tiny_alphabet": _random_corpus(1, 40, "ab"),
    # circled letters, join controls, marks, other scripts, whitespace kinds
    "unicode": ["Ⓐⓑ ‿x áb 𝟘𝟙 ٣٤ Ⅻ x‍y ½ \x1c ok", "日本語のテキスト です。", "tab\there\nnew line nbsp",
                "été café", "Привет, мир! Ελληνικά", ""],
}


def _saved(tk_save, path):
    tk_save(str(path))
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("vocab_size", [3, 20, 60, 200, 1000])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_bpe_trainer_matches_tokenizers(tmp_path, corpus, vocab_size):
    texts = CORPORA[corpus]
    ref = j_train(texts, vocab_size=vocab_size, save_path=str(tmp_path / "ref.json"))
    got = train_bpe_tokenizer(texts, vocab_size=vocab_size, save_path=str(tmp_path / "got.json"))
    with open(tmp_path / "ref.json", encoding="utf-8") as f:
        want = json.load(f)
    with open(tmp_path / "got.json", encoding="utf-8") as f:
        assert json.load(f) == want
    assert got.get_vocab_size() == ref.get_vocab_size()
    assert got.get_vocab() == ref.get_vocab()
    specials = ["<pad>", "<s>", "</s>", "<unk>"]
    assert [got.vocab[t] for t in specials] == [0, 1, 2, 3]


def test_special_tokens_and_save_round_trip(tmp_path):
    """Other special tokens come first in their order; the saved file loads
    in the `tokenizers` runtime, and encodes as ssak_tpu's trained one."""
    texts = CORPORA["french"] * 3
    sp = ("[BLANK]", "<unk>", "|")
    got = train_bpe_tokenizer(texts, vocab_size=80, special_tokens=sp)
    ref = j_train(texts, vocab_size=80, special_tokens=sp)
    assert isinstance(got, BpeTokenizer) and [got.vocab[t] for t in sp] == [0, 1, 2]
    got.save(str(tmp_path / "t.json"))
    loaded = tokenizers.Tokenizer.from_file(str(tmp_path / "t.json"))
    for t in texts + ["inconnu ☃ mot"]:
        assert loaded.encode(t).ids == ref.encode(t).ids
