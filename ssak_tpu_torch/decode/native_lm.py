"""The C++ n-gram scorer (counterpart of ssak_tpu.decode.native_lm; the port
keeps its own copy of the source, decode/native/ngram.cpp).

A backoff n-gram LM with ArpaLM's surface (`order`, `score(word,
context)`, `sentence_logprob`, `vocab`) for the host prefix beam, plus
`score_batch` (one FFI call for a beam step's candidates) and a flat binary
image for fast reload (`save_binary`; `ngram_load` tells the two formats
apart). Scores are log10 in f32, as the library returns them; ArpaLM scores
the same n-grams in Python floats.

The library is built with g++ at first use into `build/ssak_tpu_torch/`
(ops/_build.host_library, keyed on the source's digest). A failed build
raises: `load_lm` takes ArpaLM only for a `.gz` file or when asked to
(`prefer_native=False`), never because the build failed.
"""

import ctypes
import os

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "ngram.cpp")

_LIB = None


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    from ssak_tpu_torch.ops._build import host_library

    lib = host_library(SOURCE)
    lib.ngram_load.restype = ctypes.c_void_p
    lib.ngram_load.argtypes = [ctypes.c_char_p]
    lib.ngram_save.restype = ctypes.c_int
    lib.ngram_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ngram_free.argtypes = [ctypes.c_void_p]
    lib.ngram_order.restype = ctypes.c_int
    lib.ngram_order.argtypes = [ctypes.c_void_p]
    lib.ngram_size.restype = ctypes.c_int64
    lib.ngram_size.argtypes = [ctypes.c_void_p]
    lib.ngram_vocab_size.restype = ctypes.c_int
    lib.ngram_vocab_size.argtypes = [ctypes.c_void_p]
    lib.ngram_word_id.restype = ctypes.c_int32
    lib.ngram_word_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ngram_word.restype = ctypes.c_char_p
    lib.ngram_word.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ngram_score_ids.restype = ctypes.c_float
    lib.ngram_score_ids.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32]
    lib.ngram_score_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                                      ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.POINTER(ctypes.c_float)]
    _LIB = lib
    return lib


def native_available() -> bool:
    """True when the C++ scorer builds (g++ at first use) and loads on this
    host; a failed build is reported here as False, and raises where the
    scorer is used."""
    try:
        _load_lib()
    except (RuntimeError, OSError):
        return False
    return True


class NativeNgramLM:
    """Backoff n-gram LM scored by the C++ core, from an ARPA file or a
    binary image of save_binary. Scores are log10."""

    def __init__(self, path):
        self._lib = _load_lib()
        self._h = self._lib.ngram_load(os.fspath(path).encode())
        if not self._h:
            raise IOError(f"cannot load LM from {path}")
        self.order = self._lib.ngram_order(self._h)
        self._ids = {}  # word -> id (-1: out of the vocabulary)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ngram_free(self._h)
            self._h = None

    def __len__(self):
        return int(self._lib.ngram_size(self._h))

    @property
    def vocab(self):
        n = self._lib.ngram_vocab_size(self._h)
        return {self._lib.ngram_word(self._h, i).decode("utf-8", "replace") for i in range(n)}

    def save_binary(self, path):
        """Write the binary image (the counterpart of KenLM's .klm)."""
        if self._lib.ngram_save(self._h, os.fspath(path).encode()) != 0:
            raise IOError(f"cannot write {path}")

    def _id(self, word) -> int:
        wid = self._ids.get(word)
        if wid is None:
            wid = self._lib.ngram_word_id(self._h, word.encode("utf-8"))
            self._ids[word] = wid
        return wid

    def score(self, word, context=()) -> float:
        """log10 P(word | context), the context most recent last."""
        ctx = [self._id(w) for w in context]
        arr = (ctypes.c_int32 * len(ctx))(*ctx)
        return self._lib.ngram_score_ids(self._h, arr, len(ctx), self._id(word))

    def score_batch(self, contexts, words) -> np.ndarray:
        """log10 scores (n,) f32 of words[i] after contexts[i] (tuples of
        words), in one call into the library."""
        n = len(words)
        width = max(max((len(c) for c in contexts), default=0), 1)
        ctxs = np.full((n, width), -1, np.int32)
        for i, c in enumerate(contexts):
            for j, w in enumerate(c):
                ctxs[i, width - len(c) + j] = self._id(w)
        wids = np.asarray([self._id(w) for w in words], np.int32)
        out = np.empty(n, np.float32)
        self._lib.ngram_score_batch(self._h, ctxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), width,
                                    wids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def sentence_logprob(self, words, bos=True, eos=True) -> float:
        context = ("<s>",) if bos else ()
        total = 0.0
        for w in words:
            total += self.score(w, context)
            context = (context + (w,))[-(self.order - 1):] if self.order > 1 else ()
        if eos:
            total += self.score("</s>", context)
        return float(total)


def load_lm(path, prefer_native: bool = True):
    """An n-gram LM from `path`: the C++ scorer, or ArpaLM for a `.gz` file
    (the library reads plain files) or with prefer_native=False. A scorer
    that cannot be built raises."""
    if prefer_native and not str(path).endswith(".gz"):
        return NativeNgramLM(path)
    from ssak_tpu_torch.decode.lm import ArpaLM

    return ArpaLM(path)
