"""N-gram language models for shallow fusion (counterpart of
ssak_tpu.decode.lm; the port keeps its own copy of this host module).

An ARPA reader with a backoff scorer (KenLM state semantics: <s> context,
backoff on miss), a dense char-level LM table for the device beam, hashed
word n-gram tables for word-LM fusion inside the device beam, and a small
n-gram trainer with an ARPA writer. The host beam scores with the C++
scorer of `native_lm` where its caller loads the LM through
`native_lm.load_lm`, as ssak_tpu's does.
"""

import gzip
import math
from collections import defaultdict

LOG10 = math.log(10.0)


class ArpaLM:
    """Backoff n-gram LM from an ARPA file. Scores are log10 (KenLM
    convention); query via score(word, context_tuple)."""

    def __init__(self, path=None):
        self.order = 0
        # ngram tuple -> (logprob, backoff)
        self.table = {}
        self.vocab = set()
        if path:
            self.load(path)

    def load(self, path):
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            section = None
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\data\\"):
                    section = "data"
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:].split("-")[0])
                    self.order = max(self.order, section)
                    continue
                if line.startswith("\\end\\"):
                    break
                if section == "data":
                    continue
                if isinstance(section, int):
                    parts = line.split("\t")
                    if len(parts) < 2:
                        parts = line.split()
                        if len(parts) < section + 1:
                            continue
                        logp = float(parts[0])
                        words = tuple(parts[1 : 1 + section])
                        backoff = float(parts[1 + section]) if len(parts) > 1 + section else 0.0
                    else:
                        logp = float(parts[0])
                        words = tuple(parts[1].split())
                        backoff = float(parts[2]) if len(parts) > 2 else 0.0
                    self.table[words] = (logp, backoff)
                    if section == 1:
                        self.vocab.add(words[0])
        return self

    def score(self, word, context=()):
        """log10 P(word | context) with backoff. context: tuple of
        preceding words, most recent last."""
        context = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        return self._score(word, context)

    def _score(self, word, context):
        ngram = context + (word,)
        if ngram in self.table:
            return self.table[ngram][0]
        if not context:
            if (word,) in self.table:
                return self.table[(word,)][0]
            unk = self.table.get(("<unk>",))
            return unk[0] if unk else -10.0
        backoff = self.table.get(context, (0.0, 0.0))[1]
        return backoff + self._score(word, context[1:])

    def sentence_logprob(self, words, bos=True, eos=True):
        context = ("<s>",) if bos else ()
        total = 0.0
        for w in words:
            total += self.score(w, context)
            context = (context + (w,))[-(self.order - 1):] if self.order > 1 else ()
        if eos:
            total += self.score("</s>", context)
        return total


def char_lm_table(lm: ArpaLM, vocab: list, order: int = None):
    """Export a char-level ARPA LM as a dense numpy table for on-device
    fusion: table[c1, ..., c_{k-1}, c_k] = log10 P(c_k | history).

    Only feasible for char LMs with small vocab (V^order floats); returns
    (table, order). For V=40, order=3: 64k entries — trivially
    device-resident, turning per-step LM lookups into a gather (no host
    callback, unlike the reference's CPU pyctcdecode path)."""
    import numpy as np

    order = order or min(lm.order, 3)
    V = len(vocab)
    shape = (V,) * order
    table = np.zeros(shape, dtype=np.float32)
    idx = {c: i for i, c in enumerate(vocab)}

    def fill(context):
        for w in vocab:
            table[tuple(idx[c] for c in context) + (idx[w],)] = lm.score(w, context)

    def rec(context, depth):
        if depth == order - 1:
            fill(context)
            return
        for c in vocab:
            rec(context + (c,), depth + 1)

    rec((), 0)
    return table, order


# --- on-device WORD n-gram tables (hashed) ---------------------------------
#
# The device CTC beam (decode/ctc_beam.ctc_beam_search_device) scores word
# completions at lexicon accept-node -> root transitions without leaving
# the card. A dense (W, W) bigram matrix is too large at real vocabulary
# sizes (12k words -> 576 MB f32), so n-grams live in open-addressing hash
# tables: per slot a 32-bit fingerprint + f32 value, probed linearly with a
# host-computed worst-case probe bound. The same murmur3-style mix runs in
# numpy here at build time and in int64 torch ops masked to 32 bits at
# lookup time (decode/ctc_beam._ngram_mix_torch). Fingerprints are 32-bit,
# so a false hit needs a same-bucket 2^-32 collision.


def _ngram_mix(ids, seed, xp):
    """Murmur3-ish sequence hash over uint32 word ids; elementwise over
    arbitrary-shaped arrays. xp = numpy."""
    u = lambda v: xp.uint32(v)
    h = None
    for x in ids:
        x = xp.asarray(x).astype(xp.uint32) * u(0xCC9E2D51)
        x = ((x << u(15)) | (x >> u(17))) * u(0x1B873593)
        h = (seed if h is None else h) ^ x
        h = ((h << u(13)) | (h >> u(19))) * u(5) + u(0xE6546B64)
    h = h ^ (h >> u(16))
    h = h * u(0x85EBCA6B)
    h = h ^ (h >> u(13))
    h = h * u(0xC2B2AE35)
    return h ^ (h >> u(16))


_H_SEED1, _H_SEED2 = 0x12345678, 0x87654321


class HashedNgrams:
    """Open-addressing n-gram table: fingerprint (uint32, 0 = empty) + f32
    value per slot. Built on host; probed on device by ctc_beam.

    Robin Hood insertion (displace entries closer to home): the WORST-CASE
    probe distance is what the beam unrolls per frame
    (decode/ctc_beam._hashed_lookup — every probe is a table gather), so
    minimizing displacement variance shortens each frame. With load <= 0.25,
    max_probe stays ~3-4 where plain linear probing spikes to 8+."""

    def __init__(self, items: dict):
        import numpy as np

        n = max(1, len(items))
        self.size = 1 << max(3, (4 * n - 1).bit_length())  # load <= 0.25
        self.fp = np.zeros(self.size, np.uint32)
        self.val = np.zeros(self.size, np.float32)
        disp = np.full(self.size, -1, np.int32)  # -1 = empty
        mask = self.size - 1
        with np.errstate(over="ignore"):  # uint32 wraparound is the hash
            for key_ids, v in items.items():
                ids = tuple(np.uint32(i) for i in key_ids)
                h1 = int(_ngram_mix(ids, np.uint32(_H_SEED1), np))
                h2 = int(_ngram_mix(ids, np.uint32(_H_SEED2), np)) or 1
                j, d = h1 & mask, 0
                while True:
                    if disp[j] < 0:
                        self.fp[j], self.val[j], disp[j] = h2, v, d
                        break
                    if self.fp[j] == h2:  # duplicate/fingerprint collision
                        self.val[j] = v
                        break
                    if disp[j] < d:  # rob the rich: swap with closer-to-home
                        h2, self.fp[j] = int(self.fp[j]), h2
                        v, self.val[j] = float(self.val[j]), v
                        d, disp[j] = int(disp[j]), d
                    j, d = (j + 1) & mask, d + 1
        self.max_probe = int(disp.max()) + 1 if n else 1

    @classmethod
    def from_arrays(cls, fp, val, max_probe: int):
        """Reconstruct from serialized (fp, val, max_probe) — the disk
        cache path (decode/table_cache.py); skips Robin Hood insertion."""
        obj = cls.__new__(cls)
        obj.fp = fp
        obj.val = val
        obj.size = len(fp)
        obj.max_probe = int(max_probe)
        return obj


def arpa_order(path: str) -> int:
    """Highest n-gram order declared in an ARPA file's \\data\\ header —
    reads only the header, no full parse (the table-cache fast path needs
    the order gate before deciding whether to parse at all)."""
    order = 0
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if line.startswith("ngram "):
                try:
                    order = max(order, int(line.split()[1].split("=")[0]))
                except (IndexError, ValueError):
                    pass
            elif "-grams:" in line:  # body starts; header fully read
                break
    return order


def word_lm_device_tables(lm: ArpaLM, words, max_order: int = 3):
    """Export an ARPA WORD LM against a word-id space (the lexicon's sorted
    word list) as device tables for on-device shallow fusion.

    Returns a dict: order; dense unigram logp/backoff arrays indexed by
    word id (rows W=<s> and W+1=<pad> appended — <pad> fills unused context
    slots and matches nothing, which reproduces ArpaLM's shorter-context
    startup scoring exactly); HashedNgrams for bigrams (+ bigram backoffs
    and trigrams at order 3). Values are raw log10 (KenLM convention) —
    the beam scales by alpha*ln10 and adds beta per word. Orders above 3
    stay on the host beam (context state on device is order-1 word ids)."""
    import numpy as np

    order = min(lm.order, max_order)
    words = list(words)
    W = len(words)
    wid = {w: i for i, w in enumerate(words)}
    BOS, PAD = W, W + 1
    unk = lm.table.get(("<unk>",))
    unk_val = unk[0] if unk else -10.0
    uni = np.full(W + 2, unk_val, np.float32)
    uni_backoff = np.zeros(W + 2, np.float32)
    for i, w in enumerate(words):
        e = lm.table.get((w,))
        if e:
            uni[i], uni_backoff[i] = e
    e = lm.table.get(("<s>",))
    if e:
        uni_backoff[BOS] = e[1]
    uni[BOS] = uni[PAD] = -99.0  # never scored as words
    out = {"order": order, "uni": uni, "uni_backoff": uni_backoff, "bos": BOS, "pad": PAD, "n_words": W}

    def ids_of(ngram):
        r = []
        for w in ngram:
            i = BOS if w == "<s>" else wid.get(w)
            if i is None:
                return None
            r.append(i)
        return tuple(r)

    if order >= 2:
        bi, bi_backoff, tri = {}, {}, {}
        for ngram, (logp, backoff) in lm.table.items():
            ids = ids_of(ngram)
            if ids is None:
                continue
            if len(ngram) == 2:
                bi[ids] = logp
                if backoff:
                    bi_backoff[ids] = backoff
            elif len(ngram) == 3 and order >= 3:
                tri[ids] = logp
        out["bi"] = HashedNgrams(bi)
        if order >= 3:
            out["bi_backoff"] = HashedNgrams(bi_backoff)
            out["tri"] = HashedNgrams(tri)
    return out


def train_ngram_lm(texts, order: int = 3, output_arpa: str = None, char_level: bool = False):
    """Train a simple interpolated Katz-style n-gram LM from corpus text and
    optionally write ARPA. Provides the 'build an LM for decoding'
    capability without KenLM's lmplz."""
    counts = [defaultdict(int) for _ in range(order + 1)]
    for text in texts:
        units = list(text.replace(" ", "|")) if char_level else text.split()
        units = ["<s>"] + units + ["</s>"]
        for n in range(1, order + 1):
            for i in range(len(units) - n + 1):
                counts[n][tuple(units[i : i + n])] += 1
    lm = ArpaLM()
    lm.order = order
    vocab = sorted({w for (w,) in counts[1]})
    V = len(vocab) + 1
    # add-k smoothed conditional probabilities with fixed backoff weights
    for n in range(1, order + 1):
        for ngram, c in counts[n].items():
            if n == 1:
                total = sum(counts[1].values())
                logp = math.log10((c + 0.5) / (total + 0.5 * V))
            else:
                parent = counts[n - 1].get(ngram[:-1], 0)
                if parent == 0:
                    continue
                logp = math.log10((c + 0.5) / (parent + 0.5 * V))
            backoff = -0.3 if n < order else 0.0
            lm.table[ngram] = (logp, backoff)
    lm.vocab = set(vocab)
    if output_arpa:
        write_arpa(lm, output_arpa)
    return lm


def write_arpa(lm: ArpaLM, path: str):
    by_order = defaultdict(list)
    for ngram, (logp, backoff) in lm.table.items():
        by_order[len(ngram)].append((ngram, logp, backoff))
    with open(path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        for n in range(1, lm.order + 1):
            f.write(f"ngram {n}={len(by_order[n])}\n")
        for n in range(1, lm.order + 1):
            f.write(f"\n\\{n}-grams:\n")
            for ngram, logp, backoff in sorted(by_order[n]):
                line = f"{logp:.6f}\t{' '.join(ngram)}"
                if n < lm.order and backoff:
                    line += f"\t{backoff:.6f}"
                f.write(line + "\n")
        f.write("\n\\end\\\n")

