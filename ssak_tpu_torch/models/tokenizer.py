"""Tokenizers (counterpart of ssak_tpu.models.tokenizer): Whisper's
byte-level BPE and the CTC character vocabulary.

`WhisperTokenizer` reads a Whisper checkpoint's tokenizer in plain Python,
with no `tokenizers` runtime, and gives the ids and strings that ssak_tpu's
gives through that runtime:
  - from tokenizer.json (model.vocab, model.merges as "a b" strings or
    [a, b] pairs, added_tokens), or from vocab.json + merges.txt, with
    added_tokens.json on top in either case;
  - encode: added tokens are matched first (leftmost-longest; those with
    normalized=false before the others, tokenizer.json only), then GPT-2's
    pre-tokenizer regex splits the rest, each piece's UTF-8 bytes are
    mapped to characters by GPT-2's bytes_to_unicode table, and BPE merges
    them lowest rank first (leftmost on ties);
  - decode: each id's token (added tokens first), special tokens dropped
    by content, ids outside the vocabulary dropped, the characters mapped
    back to bytes (a token with a character outside the table keeps its
    own UTF-8 bytes) and decoded with U+FFFD for invalid UTF-8.
The regex's \\p{L} and \\p{N} classes are built from `unicodedata` at the
first encode; \\s is Unicode's White_Space set.

`CTCTokenizer`: HF wav2vec2-style vocab.json, token -> id; '|' is the word
delimiter; the id of '<pad>' is the CTC blank.
"""

import heapq
import json
import os
import re
import sys
import unicodedata

WHISPER_SPECIALS = ("<|startoftranscript|>", "<|endoftext|>", "<|transcribe|>", "<|translate|>", "<|notimestamps|>",
                    "<|nospeech|>", "<|startofprev|>", "<|nocaptions|>")

# Unicode's White_Space property: what \s matches in the runtime's regex engine
_WHITE_SPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"  # a class body


def bytes_to_unicode() -> dict:
    """GPT-2's reversible map of the 256 byte values to printable characters."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_CHAR = bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}
_PRETOKENIZE = None


def _class_of(keep) -> str:
    """A regex class body, as ranges, of every code point cp for which
    keep(cp, its general category) holds."""
    out, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if keep(cp, unicodedata.category(chr(cp))):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            out.append((start, prev))
            start = None
    if start is not None:
        out.append((start, prev))
    return "".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}" for a, b in out)


def _category_class(prefix: str) -> str:
    """A regex class body of every code point whose general category starts
    with `prefix`, as ranges."""
    return _class_of(lambda _cp, cat: cat.startswith(prefix))


def _pretokenizer():
    """GPT-2's split: 's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+ (compiled once, at first use)."""
    global _PRETOKENIZE
    if _PRETOKENIZE is None:
        letters, numbers, ws = _category_class("L"), _category_class("N"), _WHITE_SPACE
        _PRETOKENIZE = re.compile(
            rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+| ?[^{ws}{letters}{numbers}]+"
            rf"|[{ws}]+(?![^{ws}])|[{ws}]+"
        )
    return _PRETOKENIZE


class _ByteLevelBPE:
    """The runtime's Tokenizer for a byte-level BPE model: vocab, merges,
    added tokens, the ByteLevel pre-tokenizer and decoder."""

    def __init__(self, vocab, merges, added=()):
        self.vocab = dict(vocab)
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.ranks = {}
        for rank, (a, b) in enumerate(merges):
            if a not in self.vocab or b not in self.vocab or a + b not in self.vocab:
                raise ValueError(f"merge {a!r} {b!r} (rank {rank}) leaves the vocabulary")
            self.ranks[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.added = {}  # content -> id
        self.added_r = {}  # id -> content
        self.special = set()
        by_norm = {True: [], False: []}
        for t in added:
            if t.get("single_word") or t.get("lstrip") or t.get("rstrip"):
                raise NotImplementedError(f"added token {t['content']!r}: single_word / lstrip / rstrip are not supported")
            self.added[t["content"]] = t["id"]
            self.added_r[t["id"]] = t["content"]
            if t.get("special"):
                self.special.add(t["content"])
            by_norm[bool(t.get("normalized", not t.get("special")))].append(t["content"])
        # literal alternations, longest first: Python's leftmost-first match is then leftmost-longest
        self.split_res = [re.compile("|".join(re.escape(c) for c in sorted(set(by_norm[n]), key=len, reverse=True)))
                          if by_norm[n] else None for n in (False, True)]

    def token_to_id(self, token):
        return self.added.get(token, self.vocab.get(token))

    def _split_added(self, text):
        pieces = [(text, None)]
        for rx in self.split_res:
            if rx is None:
                continue
            out = []
            for piece, tid in pieces:
                if tid is not None:
                    out.append((piece, tid))
                    continue
                pos = 0
                for m in rx.finditer(piece):
                    if m.start() > pos:
                        out.append((piece[pos:m.start()], None))
                    out.append((m.group(0), self.added[m.group(0)]))
                    pos = m.end()
                if pos < len(piece) or not piece:
                    out.append((piece[pos:], None))
            pieces = out
        return pieces

    def _bpe(self, word):
        ids = [self.vocab[c] for c in word if c in self.vocab]  # characters outside the vocabulary are dropped
        n = len(ids)
        nxt, prv, alive = list(range(1, n + 1)), list(range(-1, n - 1)), [True] * n
        heap = []
        for i in range(n - 1):
            hit = self.ranks.get((ids[i], ids[i + 1]))
            if hit is not None:
                heap.append((hit[0], i, hit[1]))  # (rank, left position, merged id): lowest rank, then leftmost
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            hit = self.ranks.get((ids[pos], ids[right]))
            if hit is None or hit[1] != new:
                continue  # an expired entry
            ids[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0:
                hit = self.ranks.get((ids[prv[pos]], ids[pos]))
                if hit is not None:
                    heapq.heappush(heap, (hit[0], prv[pos], hit[1]))
            if nxt[pos] < n:
                hit = self.ranks.get((ids[pos], ids[nxt[pos]]))
                if hit is not None:
                    heapq.heappush(heap, (hit[0], pos, hit[1]))
        return [t for t, a in zip(ids, alive) if a]

    def encode(self, text):
        out = []
        for piece, tid in self._split_added(text):
            if tid is not None:
                out.append(tid)
                continue
            for w in _pretokenizer().findall(piece):
                out += self._bpe("".join(_BYTE_CHAR[b] for b in w.encode("utf-8")))
        return out

    def decode(self, ids, skip_special_tokens=True):
        data = bytearray()
        for i in ids:
            tok = self.added_r.get(i, self.vocab_r.get(i))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            if all(c in _CHAR_BYTE for c in tok):
                data.extend(_CHAR_BYTE[c] for c in tok)
            else:
                data.extend(tok.encode("utf-8"))
        return data.decode("utf-8", errors="replace")


def _merge_pair(m, where):
    if isinstance(m, str):
        parts = m.split(" ")
    else:
        parts = list(m)
    if len(parts) != 2:
        raise ValueError(f"{where}: bad merge {m!r}")
    return parts[0], parts[1]


def _from_tokenizer_json(path):
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    model = spec["model"]
    pre, dec = spec.get("pre_tokenizer") or {}, spec.get("decoder") or {}
    if model.get("type") != "BPE" or pre.get("type") != "ByteLevel" or dec.get("type") != "ByteLevel" or spec.get("normalizer"):
        raise NotImplementedError(f"{path}: only byte-level BPE tokenizers without a normalizer are read "
                                  f"(model {model.get('type')}, pre_tokenizer {pre.get('type')}, decoder {dec.get('type')})")
    unsupported = [k for k in ("continuing_subword_prefix", "end_of_word_suffix", "byte_fallback", "dropout",
                               "ignore_merges") if model.get(k)]
    unsupported += [k for k, default in (("add_prefix_space", False), ("use_regex", True)) if pre.get(k, default) != default]
    if unsupported:
        raise NotImplementedError(f"{path}: {', '.join(unsupported)} set; Whisper's byte-level BPE sets none of them")
    return _ByteLevelBPE(model["vocab"], [_merge_pair(m, path) for m in model["merges"]], spec.get("added_tokens") or ())


def _from_vocab_merges(vocab_path, merges_path):
    with open(vocab_path, encoding="utf-8") as f:
        vocab = json.load(f)
    with open(merges_path, encoding="utf-8") as f:
        lines = [ln for ln in f.read().split("\n") if not ln.startswith("#version")]
    if lines and lines[-1] == "":
        lines.pop()
    return _ByteLevelBPE(vocab, [_merge_pair(ln, merges_path) for ln in lines])


class WhisperTokenizer:
    """Byte-level BPE tokenizer of an HF Whisper checkpoint directory."""

    def __init__(self, model_dir: str):
        tk_json = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(tk_json):
            self.tk = _from_tokenizer_json(tk_json)
        else:
            self.tk = _from_vocab_merges(os.path.join(model_dir, "vocab.json"), os.path.join(model_dir, "merges.txt"))
        self._special = {}
        added = os.path.join(model_dir, "added_tokens.json")
        if os.path.exists(added):
            with open(added, encoding="utf-8") as f:
                self._special.update(json.load(f))
        # the named specials as the tokenizer itself has them
        for tok in WHISPER_SPECIALS:
            tid = self.tk.token_to_id(tok)
            if tid is not None:
                self._special[tok] = tid

    def token_id(self, token: str):
        return self._special.get(token, self.tk.token_to_id(token))

    @property
    def sot(self):
        return self.token_id("<|startoftranscript|>")

    @property
    def eot(self):
        return self.token_id("<|endoftext|>")

    @property
    def no_timestamps(self):
        return self.token_id("<|notimestamps|>")

    @property
    def sot_prev(self):
        return self.token_id("<|startofprev|>")

    @property
    def no_speech(self):
        # large-v3-era checkpoints call it <|nospeech|>, older ones <|nocaptions|>
        return self.token_id("<|nospeech|>") or self.token_id("<|nocaptions|>")

    @property
    def timestamp_begin(self):
        # the first timestamp token <|0.00|> follows <|notimestamps|>
        tid = self.token_id("<|0.00|>")
        return tid if tid is not None else (self.no_timestamps + 1)

    def language_token(self, language: str):
        tid = self.token_id(f"<|{language}|>")
        if tid is None:
            raise ValueError(f"unknown language token: {language}")
        return tid

    def sot_sequence(self, language: str = None, task: str = "transcribe", timestamps: bool = False):
        seq = [self.sot]
        if language:
            seq.append(self.language_token(language))
            seq.append(self.token_id(f"<|{task}|>"))
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq

    def encode(self, text: str):
        return self.tk.encode(text)

    def decode(self, ids, skip_special: bool = True):
        """Text of `ids`. skip_special drops the named and added specials and
        every id from eot up; special added tokens are dropped either way,
        as the runtime's decode does by default."""
        ids = [int(i) for i in ids]
        if skip_special:
            specials = set(self._special.values())
            ids = [i for i in ids if i not in specials and i < (self.eot or 10**9)]
        return self.tk.decode(ids)


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


# --- the BPE trainer ------------------------------------------------------------------

# Unicode's Other_Alphabetic code points of category So (circled and squared
# Latin letters) and the two join controls: word characters in the runtime's
# \w besides categories L, M, Nd, Nl and Pc
_WORD_EXTRA = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189), (0x200C, 0x200D))
_WHITESPACE_SPLIT = None


def _whitespace_pretokenizer():
    """The runtime's `Whitespace` pre-tokenizer, \\w+|[^\\w\\s]+, with its
    regex engine's Unicode classes: \\w is categories L, M, Nd, Nl, Pc and
    _WORD_EXTRA, \\s the White_Space property. Built from `unicodedata` at
    first use: code points assigned after this Python's Unicode version are
    not word characters here."""
    global _WHITESPACE_SPLIT
    if _WHITESPACE_SPLIT is None:
        word = _class_of(lambda cp, cat: cat[0] in "LM" or cat in ("Nd", "Nl", "Pc")
                         or any(a <= cp <= b for a, b in _WORD_EXTRA))
        _WHITESPACE_SPLIT = re.compile(rf"[{word}]+|[^{word}{_WHITE_SPACE}]+")
    return _WHITESPACE_SPLIT


class BpeTokenizer:
    """What `train_bpe_tokenizer` returns: a BPE model (vocab, merges in
    rank order, <unk>), its special tokens, and the Whitespace
    pre-tokenizer; `save` writes the runtime's tokenizer.json."""

    def __init__(self, vocab: dict, merges: list, special_tokens=(), unk_token: str = "<unk>"):
        self.vocab = dict(vocab)
        self.merges = [tuple(m) for m in merges]
        self.special_tokens = list(special_tokens)
        self.unk_token = unk_token

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    def get_vocab(self) -> dict:
        return dict(self.vocab)

    def save(self, path: str):
        """The runtime's tokenizer.json for this model."""
        added = [{"id": self.vocab[t], "content": t, "single_word": False, "lstrip": False, "rstrip": False,
                  "normalized": False, "special": True} for t in self.special_tokens]
        model = {"type": "BPE", "dropout": None, "unk_token": self.unk_token, "continuing_subword_prefix": None,
                 "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                 "vocab": dict(sorted(self.vocab.items(), key=lambda kv: kv[1])),
                 "merges": [list(m) for m in self.merges]}
        out = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added, "normalizer": None,
               "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None, "decoder": None, "model": model}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(out, f, ensure_ascii=False, indent=2)


def _merge_word(sym: list, c1: int, c2: int, rep: int) -> list:
    """Merge every (c1, c2) of one word in place, left to right; return the
    pair-count changes as the runtime's Word::merge gives them (the merged
    pair itself is not among them)."""
    changes = []
    i = 0
    while i < len(sym):
        if sym[i] == c1 and i + 1 < len(sym) and sym[i + 1] == c2:
            second = sym[i + 1]
            if i > 0:
                changes.append(((sym[i - 1], c1), -1))
                changes.append(((sym[i - 1], rep), 1))
            sym[i : i + 2] = [rep]
            if i < len(sym) - 1:
                changes.append(((second, sym[i + 1]), -1))
                changes.append(((rep, sym[i + 1]), 1))
        i += 1
    return changes


def train_bpe_tokenizer(texts, vocab_size: int = 1000, save_path: str = None,
                        special_tokens=("<pad>", "<s>", "</s>", "<unk>")):
    """Train a BPE subword tokenizer on corpus text, in plain Python: the
    vocab and merges that ssak_tpu's `tokenizers` BpeTrainer gives (checked
    against tokenizers 0.22). Words come from the Whitespace pre-tokenizer.
    The vocab is the special tokens in order, then every character seen,
    sorted by code point, then one token per merge while it is smaller than
    vocab_size. Each merge takes the pair of the highest count over all
    words (ties to the smaller (left id, right id)), from a heap whose stale
    counts are refreshed when they are popped, and is applied in the words
    the pair was recorded in, as the runtime does."""
    split = _whitespace_pretokenizer()
    word_counts = {}
    for t in texts:
        for w in split.findall(t):
            word_counts[w] = word_counts.get(w, 0) + 1
    w2id, id2w = {}, []
    for tok in list(special_tokens) + sorted({c for w in word_counts for c in w}):
        if tok not in w2id:
            w2id[tok] = len(id2w)
            id2w.append(tok)
    words = [[w2id[c] for c in w] for w in word_counts]
    counts = list(word_counts.values())

    pair_counts, where = {}, {}
    for i, sym in enumerate(words):
        for pair in zip(sym, sym[1:]):
            pair_counts[pair] = pair_counts.get(pair, 0) + counts[i]
            where.setdefault(pair, set()).add(i)
    heap, seq = [], 0

    def push(pair, count, pos):
        nonlocal seq
        heapq.heappush(heap, (-count, pair, seq, pos))
        seq += 1

    def drain():
        for pair, pos in where.items():
            if pair_counts[pair] > 0:
                push(pair, pair_counts[pair], pos)
        where.clear()

    drain()
    merges = []
    while len(w2id) < vocab_size and heap:
        neg, pair, _seq, pos = heapq.heappop(heap)
        if -neg != pair_counts[pair]:
            push(pair, pair_counts[pair], pos)
            continue
        if -neg < 1:
            break
        new_token = id2w[pair[0]] + id2w[pair[1]]
        if new_token not in w2id:
            w2id[new_token] = len(id2w)
            id2w.append(new_token)
        new_id = w2id[new_token]
        merges.append((pair, new_id))
        for i in pos:
            for p, change in _merge_word(words[i], pair[0], pair[1], new_id):
                pair_counts[p] = pair_counts.get(p, 0) + change * counts[i]
                if change > 0:
                    where.setdefault(p, set()).add(i)
        drain()

    rank = {}  # a pair merged twice keeps its last rank, as the runtime's merge map does
    for r, (pair, _new_id) in enumerate(merges):
        rank[pair] = r
    ordered = sorted(rank, key=rank.get)
    tk = BpeTokenizer(w2id, [(id2w[a], id2w[b]) for a, b in ordered], special_tokens)
    if save_path:
        tk.save(save_path)
    return tk
