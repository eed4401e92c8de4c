"""Word-lexicon constraint for CTC beam decoding (counterpart of
ssak_tpu.decode.lexicon; the port keeps its own copy of this host module).

A character trie over a word list: the host prefix beam
(decode/ctc_beam.ctc_prefix_beam_search) lets a hypothesis grow only along
valid word prefixes, emit a word delimiter only on a complete word, and end
only on a complete word; the device beam gathers the same constraint from
dense trie tables (`device_tables`). Stacks with n-gram shallow fusion.
"""

__all__ = ["Lexicon"]


class Lexicon:
    """Character-trie membership over a word list, stored as two hash sets
    (all prefixes + complete words): O(1) per beam extension, no pointer
    chasing, and small enough for million-word lexicons (a few hundred MB
    of Python strings at Vosk-model scale, same order as Vosk's HCLG)."""

    def __init__(self, words):
        self.words = set()
        self.prefixes = set()
        for w in words:
            w = w.strip()
            if not w:
                continue
            self.words.add(w)
            for i in range(1, len(w) + 1):
                self.prefixes.add(w[:i])

    def __len__(self):
        return len(self.words)

    @classmethod
    def from_file(cls, path: str):
        """One word per line, or Kaldi lexicon.txt ('word phone phone ...'
        — first column taken, the pronunciation is the WFST's business,
        not the CTC beam's)."""
        words = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                cols = line.split()
                if cols:
                    words.append(cols[0])
        return cls(words)

    def has_word(self, w: str) -> bool:
        return w in self.words

    def has_prefix(self, p: str) -> bool:
        return p in self.prefixes

    def device_tables(self, vocab, word_delimiter: str = "|"):
        """Dense trie tables for the ON-DEVICE beam (decode/ctc_beam
        ctc_beam_search_device): the WFST's L component as two HBM arrays
        gathered per beam step instead of pointer-chased on host.

        vocab: id -> token list. Returns (trans (N, V) int32, accept (N,)
        bool): trans[n, c] = child node after consuming token c at node n,
        -1 = forbidden; node 0 = word boundary (root). The delimiter column
        returns to root exactly from accepting nodes (and is a no-op at
        root), which is the same constraint the host beam applies. Node
        count N = #distinct prefixes + 1; a million-word lexicon is a few
        hundred MB — resident-HBM territory, amortized over the whole batch.
        """
        import numpy as np

        V = len(vocab)
        tok2id = {t: i for i, t in enumerate(vocab) if t}
        # node ids: root=0, then every prefix in insertion-stable order
        node_of = {"": 0}
        for p in sorted(self.prefixes):
            node_of.setdefault(p, len(node_of))
        N = len(node_of)
        trans = np.full((N, V), -1, np.int32)
        accept = np.zeros((N,), bool)
        for p, n in node_of.items():
            if p in self.words:
                accept[n] = True
            for t, i in tok2id.items():
                if t in (word_delimiter, " "):
                    continue
                child = node_of.get(p + t)
                if child is not None:
                    trans[n, i] = child
        for delim in (word_delimiter, " "):
            i = tok2id.get(delim)
            if i is not None:
                trans[accept, i] = 0
                trans[0, i] = 0  # consecutive delimiters are a no-op
        return trans, accept

    def word_list(self):
        """Word-id space for on-device word-LM fusion: sorted words; ids are
        shared between node_word_ids() and lm.word_lm_device_tables()."""
        return sorted(self.words)

    def node_word_ids(self):
        """(N,) int32: the word completed at each ACCEPTING trie node (index
        into word_list()), -1 elsewhere. Node numbering matches
        device_tables(). This is what lets the device beam score a word
        n-gram exactly at the accept-node -> root (delimiter) transition."""
        import numpy as np

        words = self.word_list()
        wid = {w: i for i, w in enumerate(words)}
        node_of = {"": 0}
        for p in sorted(self.prefixes):
            node_of.setdefault(p, len(node_of))
        node_word = np.full(len(node_of), -1, np.int32)
        for p, n in node_of.items():
            if p in self.words:
                node_word[n] = wid[p]
        return node_word
