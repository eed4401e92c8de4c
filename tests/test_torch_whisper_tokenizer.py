"""The port's plain-Python WhisperTokenizer against ssak_tpu's, which runs on
the `tokenizers` runtime. The tokenizer is built here with `tokenizers`:
a byte-level BPE trained on text of this repository, its vocabulary filled
to 50,257 tokens with seeded merges of existing tokens, then Whisper
large-v3's specials (<|endoftext|> 50,257 ... <|notimestamps|> 50,364, the
100 languages from 50,259) as special added tokens and the 1,501 timestamps
<|0.00|> ... <|30.00|> as plain added tokens, 51,866 ids in all. It is saved
as tokenizer.json (merges as [a, b] pairs, and once as "a b" strings) and
as vocab.json + merges.txt + added_tokens.json. On every route, encode ids
and decode strings equal ssak_tpu's exactly: over fr/en/ar/ru text, digits,
², Ⅻ, combining marks, emoji, whitespace runs, contractions and specials
inside text; decode over every single id, seeded id runs that cut UTF-8
sequences, and ids outside the vocabulary; sot_sequence for each language,
task and timestamps setting."""

import json
import os

import numpy as np
import pytest

from ssak_tpu.models.tokenizer import WhisperTokenizer as JTok
from ssak_tpu_torch.models.tokenizer import WhisperTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LANGUAGES = ("en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu ta no th ur hr bg lt la "
             "mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
             "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha ba jw su yue").split()
SPECIALS = (["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{lang}|>" for lang in LANGUAGES]
            + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"])
SPECIALS_V2 = [t for t in SPECIALS if t != "<|yue|>"]  # large-v2: 99 languages, <|notimestamps|> at 50,363
TIMESTAMPS = [f"<|{i * 0.02:.2f}|>" for i in range(1501)]
N_BASE = 50257
N_VOCAB = N_BASE + len(SPECIALS) + len(TIMESTAMPS)

TEXTS = [
    "Le 9/02/2008 à 20h30 Autour des oeuvres de Paul Ladmirault .",
    "Chats de moins de 4 kg : 1 comprimé par jour .",
    "PET-PHOS® Félin, µg, œuvre, Tél. : 05 53 66 16 68 .",
    "It costs $5.50 on the 3rd of May, 1999.",
    "Dr. Smith's 21st birthday — 100% fun! I'm sure they're fine, it'll do, we've 'S 'T",
    "مرحبا ١٢ مَرْحَبًا ذهبت إلى السوق، واشتريت 3 تفاحات",
    "Привет, мир 42! Ёлка — 2021 году",
    "x\u00b2 + y\u00b3 = \u216b \u00bd \u2460 \u0663 \U0001D7D8 \u2167x",
    "combining: e\u0301 a\u0308 n\u0303 and \u200d joiner \u200b zero width \u0301 alone",
    "emoji \U0001F600\U0001F44D\U0001F3FD \U0001F468\u200d\U0001F469\u200d\U0001F467 ok \U0001F1EB\U0001F1F7",
    "   leading and    runs\n\n\ttabs \r\n end   ",
    "\x1c\x1d\x1e\x1f \x85 \xa0 \u2028 \u2003 \u3000 \u180e \u1680x\u202f",
    "specials <|endoftext|> inside<|fr|><|transcribe|>text <|0.00|>a<|1.50|> b <|30.00|>",
    "half <|endoftext| and <|0.0|> and <|notimestamps|><|notimestamps|>",
    "中文字符测试 日本語のテキスト 한국어",
    "",
    " ",
    "'s",
]


def _corpus():
    lines = []
    for name in ("tests/test_text.py", "README.md", "ROADMAP.md"):
        with open(os.path.join(REPO, name), encoding="utf-8") as f:
            lines += f.read().splitlines()
    return lines + TEXTS


def build_whisper_tokenizer(out_dir, merges_as_strings=False, vocab_files=False, large_v2=False):
    """Write a Whisper large-v3-shaped tokenizer to out_dir (see the module
    docstring), or large-v2-shaped (no <|yue|>, 51,865 ids); vocab_files=True
    writes vocab.json + merges.txt + added_tokens.json instead of
    tokenizer.json."""
    from tokenizers import ByteLevelBPETokenizer, Tokenizer

    os.makedirs(out_dir, exist_ok=True)
    base = ByteLevelBPETokenizer()
    base.train_from_iterator(_corpus(), vocab_size=3000, min_frequency=2)
    spec = json.loads(base._tokenizer.to_str())
    vocab, merges = spec["model"]["vocab"], [list(m) for m in spec["model"]["merges"]]
    tokens = sorted(vocab, key=vocab.get)
    rng = np.random.RandomState(0)
    while len(vocab) < N_BASE:  # fill with merges of existing tokens, each new token a new merge
        a, b = tokens[rng.randint(len(tokens))], tokens[rng.randint(len(tokens))]
        if a + b in vocab or len(a + b) > 12:
            continue
        vocab[a + b] = len(vocab)
        tokens.append(a + b)
        merges.append([a, b])
    spec["model"]["vocab"], spec["model"]["merges"] = vocab, merges
    tk = Tokenizer.from_str(json.dumps(spec))
    specials = SPECIALS_V2 if large_v2 else SPECIALS
    tk.add_special_tokens(specials)
    tk.add_tokens(TIMESTAMPS)
    no_ts = 50363 if large_v2 else 50364
    assert tk.token_to_id("<|endoftext|>") == N_BASE and tk.token_to_id("<|notimestamps|>") == no_ts
    assert tk.token_to_id("<|0.00|>") == no_ts + 1 and tk.get_vocab_size() == N_VOCAB - (1 if large_v2 else 0)
    if vocab_files:
        with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(vocab, f, ensure_ascii=False)
        with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
        with open(os.path.join(out_dir, "added_tokens.json"), "w", encoding="utf-8") as f:
            json.dump({t: tk.token_to_id(t) for t in specials + TIMESTAMPS}, f, ensure_ascii=False)
        return out_dir
    spec = json.loads(tk.to_str())
    if merges_as_strings:
        spec["model"]["merges"] = [f"{a} {b}" for a, b in spec["model"]["merges"]]
    with open(os.path.join(out_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    return out_dir


ROUTES = ["tokenizer_json", "tokenizer_json_string_merges", "vocab_merges"]


@pytest.fixture(scope="module", params=ROUTES)
def toks(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(request.param))
    build_whisper_tokenizer(d, merges_as_strings=request.param.endswith("string_merges"),
                            vocab_files=request.param == "vocab_merges")
    return WhisperTokenizer(d), JTok(d), request.param


def test_named_specials_and_sot_sequences(toks):
    mine, ref, _route = toks
    for name in ("sot", "eot", "no_timestamps", "sot_prev", "no_speech", "timestamp_begin"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert (mine.sot, mine.eot, mine.no_timestamps, mine.timestamp_begin) == (50258, 50257, 50364, 50365)
    assert mine._special == ref._special
    for lang in [None] + LANGUAGES:
        for task in ("transcribe", "translate"):
            for ts in (False, True):
                assert mine.sot_sequence(lang, task, ts) == ref.sot_sequence(lang, task, ts)
    assert mine.sot_sequence("fr", "translate") == [50258, 50259 + LANGUAGES.index("fr"), 50359, 50364]
    for tok in SPECIALS + TIMESTAMPS[:5] + ["<|nocaptions|>", "nothing", "Ġthe"]:
        assert mine.token_id(tok) == ref.token_id(tok), tok
    with pytest.raises(ValueError):
        mine.language_token("xx")


def test_encode_matches_jax(toks):
    mine, ref, route = toks
    for text in TEXTS + _corpus()[:400]:
        assert mine.encode(text) == ref.encode(text), (route, text)


def test_decode_every_single_id(toks):
    mine, ref, _route = toks
    for i in range(N_VOCAB + 3):
        for skip in (True, False):
            assert mine.decode([i], skip_special=skip) == ref.decode([i], skip_special=skip), (i, skip)


def test_decode_seeded_runs_and_absent_ids(toks):
    """Runs of ids drawn from byte tokens (cutting UTF-8 sequences inside a
    character), the whole vocabulary and ids past it, with and without
    skip_special; and round trips of encoded text."""
    mine, ref, _route = toks
    rng = np.random.RandomState(1)
    byte_ids = [mine.tk.vocab[c] for c in mine.tk.vocab if len(c) == 1]
    for k in range(1500):
        pool = byte_ids if k % 2 else range(N_VOCAB + 40)
        ids = [int(pool[j]) for j in rng.randint(0, len(pool), size=rng.randint(0, 16))]
        for skip in (True, False):
            assert mine.decode(ids, skip_special=skip) == ref.decode(ids, skip_special=skip), (ids, skip)
    for text in TEXTS:
        ids = ref.encode(text)
        assert mine.decode(ids) == ref.decode(ids) and mine.decode(ids, False) == ref.decode(ids, False)
        for cut in range(1, len(ids)):
            assert mine.decode(ids[:cut]) == ref.decode(ids[:cut])


@pytest.mark.parametrize("field,value", [("pre_tokenizer.add_prefix_space", True), ("pre_tokenizer.use_regex", False),
                                         ("model.ignore_merges", True), ("normalizer", {"type": "NFC"})])
def test_options_whisper_does_not_set_are_refused(tmp_path, field, value):
    d = build_whisper_tokenizer(str(tmp_path / "tk"))
    path = os.path.join(d, "tokenizer.json")
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    node, _, key = field.rpartition(".")
    (spec[node] if node else spec)[key] = value
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f)
    with pytest.raises(NotImplementedError):
        WhisperTokenizer(d)
