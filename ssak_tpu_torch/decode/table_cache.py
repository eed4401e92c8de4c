"""Disk cache for the device beam's decode tables (counterpart of
ssak_tpu.decode.table_cache).

ctc_infer builds two sets of dense tables at start: the lexicon trie
(`Lexicon.device_tables` + `node_word_ids`) and the hashed word-LM tables
(`word_lm_device_tables`, after the ARPA parse). Both are pure functions of
their input files, so they round-trip through an npz keyed on the source
file digests, the vocabulary and a format version: a changed file misses
the cache. An unreadable cache file is rebuilt; writes go through a
temporary file and an atomic rename.

The cache lives in the checkout's git-ignored build directory
(`CACHE_DIR`), beside the kernels' libraries, not in a per-user directory
as ssak_tpu's does.
"""

import hashlib
import os
import tempfile
import zipfile

import numpy as np

from ssak_tpu_torch.ops._build import BUILD_DIR
from ssak_tpu_torch.utils.misc import hashmd5
from ssak_tpu_torch.utils.monitoring import logger

FORMAT_VERSION = 1
CACHE_DIR = os.path.join(BUILD_DIR, "decode_tables")
_UNREADABLE = (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile)  # a corrupt or partial npz


def _file_digest(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _cache_path(kind: str, key_parts) -> str:
    os.makedirs(CACHE_DIR, exist_ok=True)
    return os.path.join(CACHE_DIR, f"{kind}-{hashmd5([FORMAT_VERSION, *key_parts])}.npz")


def _atomic_savez(path: str, **arrays):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def lexicon_tables_cached(lexicon, lexicon_path: str, vocab, word_delimiter: str = "|"):
    """(trans, accept, node_word_ids) for `lexicon` (the loaded Lexicon of
    `lexicon_path`), cached keyed by the file digest, vocab and delimiter."""
    path = _cache_path("lexicon", [_file_digest(lexicon_path), list(vocab), word_delimiter])
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return z["trans"], z["accept"], z["node_word_ids"]
        except _UNREADABLE as e:
            logger.warning(f"decode-table cache unreadable ({e}); rebuilding {path}")
    trans, accept = lexicon.device_tables(vocab, word_delimiter=word_delimiter)
    nw = lexicon.node_word_ids()
    _atomic_savez(path, trans=np.asarray(trans), accept=np.asarray(accept), node_word_ids=np.asarray(nw))
    return trans, accept, nw


def word_lm_tables_cached(arpa, arpa_path: str, word_list):
    """word_lm_device_tables(arpa, word_list), cached keyed by the ARPA file
    digest and the word-id space. `arpa` may be a zero-argument callable
    returning the parsed ArpaLM: on a hit it is not called, so the parse is
    skipped too. HashedNgrams round-trip as (fp, val, max_probe)."""
    from ssak_tpu_torch.decode.lm import HashedNgrams, word_lm_device_tables

    path = _cache_path("wordlm", [_file_digest(arpa_path), hashmd5(list(word_list))])
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                out = {k: int(z[k]) for k in ("order", "bos", "pad", "n_words")}
                out["uni"], out["uni_backoff"] = z["uni"], z["uni_backoff"]
                for name in ("bi", "bi_backoff", "tri"):
                    if f"{name}_fp" in z:
                        out[name] = HashedNgrams.from_arrays(z[f"{name}_fp"], z[f"{name}_val"],
                                                             int(z[f"{name}_max_probe"]))
                return out
        except _UNREADABLE as e:
            logger.warning(f"decode-table cache unreadable ({e}); rebuilding {path}")
    out = word_lm_device_tables(arpa() if callable(arpa) else arpa, word_list)
    arrays = {k: np.asarray(out[k]) for k in ("order", "uni", "uni_backoff", "bos", "pad", "n_words")}
    for name in ("bi", "bi_backoff", "tri"):
        if name in out:
            h = out[name]
            arrays[f"{name}_fp"] = h.fp
            arrays[f"{name}_val"] = h.val
            arrays[f"{name}_max_probe"] = np.asarray(h.max_probe)
    _atomic_savez(path, **arrays)
    return out
