"""Locate a sub-transcript inside a larger reference text (counterpart of
ssak_tpu.align.dtw; host numpy).

Both searches are DPs over word distance matrices: a subsequence DTW with
free start and end in the reference, and a sliding Levenshtein over
reference word windows.
"""

import numpy as np


def word_distance_matrix(words_a, words_b):
    """(len_a, len_b) 0/1 word mismatch matrix with partial credit for
    shared prefixes (a cheap proxy for a character distance)."""
    D = np.ones((len(words_a), len(words_b)), np.float32)
    index = {}
    for j, w in enumerate(words_b):
        index.setdefault(w, []).append(j)
    for i, w in enumerate(words_a):
        for j in index.get(w, ()):
            D[i, j] = 0.0
    for i, wa in enumerate(words_a):
        for j, wb in enumerate(words_b):
            if D[i, j] > 0 and wa and wb and wa[0] == wb[0]:
                common = len(_common_prefix(wa, wb))
                D[i, j] = 1.0 - common / max(len(wa), len(wb))
    return D


def _common_prefix(a, b):
    i = 0
    while i < min(len(a), len(b)) and a[i] == b[i]:
        i += 1
    return a[:i]


def find_best_position_dtw(query: str, reference: str):
    """(start_word, end_word, cost) of the span of `reference` that best
    matches `query` by subsequence DTW (free start and end in the reference)."""
    qw = query.split()
    rw = reference.split()
    if not qw or not rw:
        return 0, 0, float("inf")
    D = word_distance_matrix(qw, rw)
    n, m = D.shape
    acc = np.full((n, m), np.inf, np.float32)
    acc[0, :] = D[0, :]
    for i in range(1, n):
        for j in range(m):
            best_prev = acc[i - 1, j]
            if j > 0:
                best_prev = min(best_prev, acc[i - 1, j - 1], acc[i, j - 1])
            acc[i, j] = D[i, j] + best_prev
    end = int(np.argmin(acc[n - 1]))
    i, j = n - 1, end
    while i > 0:
        choices = [(acc[i - 1, j], i - 1, j)]
        if j > 0:
            choices += [(acc[i - 1, j - 1], i - 1, j - 1), (acc[i, j - 1], i, j - 1)]
        _c, i, j = min(choices)
    return j, end + 1, float(acc[n - 1, end])


def find_best_position_levenshtein(query: str, reference: str):
    """Sliding word Levenshtein over windows of len(query) - 3 .. + 3 words
    of `reference`; returns (start_word, end_word, distance)."""
    qw = query.split()
    rw = reference.split()
    if not qw or not rw:
        return 0, 0, float("inf")
    n = len(qw)
    best = (0, 0, float("inf"))
    for w in range(max(1, n - 3), n + 4):
        for s in range(0, max(1, len(rw) - w + 1)):
            window = rw[s : s + w]
            d = _lev(qw, window)
            if d < best[2]:
                best = (s, s + w, d)
    return best


def _lev(a, b):
    prev = list(range(len(b) + 1))
    for i, wa in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, wb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (wa != wb))
        prev = cur
    return prev[-1]
