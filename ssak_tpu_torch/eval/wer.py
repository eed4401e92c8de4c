"""WER/CER evaluation (counterpart of ssak_tpu.eval.wer).

Levenshtein alignment with numpy row sweeps (no jiwer); references and
predictions as '<id> <text>' files, dicts {id: text} (scored on the id
intersection) or lists; per-language normalization (normalization="fr",
with "+" / "++" for stronger modes); the empty-reference rule; CER;
alignment rendering; percentile bootstrap intervals drawn with the same
numpy generator calls, so a seed gives the same interval; two-system
diffs and keyword scores.
"""

import re

import numpy as np

from ssak_tpu_torch.text.basic import collapse_whitespace

_DEFAULT_REPLACEMENT = "<empty>"


def _normalize_for_wer(text: str, normalization: str) -> str:
    """normalization: None | language code | language+'+' (also remove
    apostrophes/hyphens) | language+'++' (also transliterate accents)."""
    if not normalization:
        return collapse_whitespace(text)
    strong = 0
    lang = normalization
    while lang.endswith("+"):
        strong += 1
        lang = lang[:-1]
    if lang:
        from ssak_tpu_torch.text import format_text

        text = format_text(text, lang, extract_parenthesized=False, safety_checks=False).replace("\n", " ")
    if strong >= 1:
        text = re.sub(r"[-']", " ", text)
    if strong >= 2:
        from ssak_tpu_torch.text.basic import transliterate

        text = transliterate(text)
    return collapse_whitespace(text)


def ensure_not_empty_reference(refs, preds, replacement=_DEFAULT_REPLACEMENT):
    """Empty refs break WER ratios; substitute a token in ref AND pred
    (reference wer.py:459 workaround)."""
    out_r, out_p = [], []
    for r, p in zip(refs, preds):
        if not r.strip():
            r = replacement
            p = (replacement + " " + p).strip()
        out_r.append(r)
        out_p.append(p)
    return out_r, out_p


def align_tokens(ref, hyp):
    """Levenshtein alignment. Returns (distance, ops) where ops is a list of
    (op, i, j) with op in {'=','S','D','I'} referring to ref[i], hyp[j].

    Fully vectorized row sweep: the left-to-right insertion relaxation
    row[j] = min_k<=j (tmp[k] + (j-k)) is a prefix-min of tmp[k]-k, so each
    DP row is one np.minimum.accumulate — no Python inner loop (corpus-scale
    scoring, the reference's compute_wer handles millions of utterances)."""
    n, m = len(ref), len(hyp)
    # intern tokens as ints: integer array compares beat object-dtype string
    # compares by ~an order of magnitude
    vocab = {}
    r_ids = np.fromiter((vocab.setdefault(t, len(vocab)) for t in ref), np.int32, count=n)
    h_ids = np.fromiter((vocab.setdefault(t, len(vocab)) for t in hyp), np.int32, count=m)
    D = np.zeros((n + 1, m + 1), dtype=np.int32)
    D[0, :] = np.arange(m + 1)
    D[:, 0] = np.arange(n + 1)
    cols = np.arange(m + 1, dtype=np.int32)
    tmp = np.empty(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        prev = D[i - 1]
        tmp[0] = i
        np.minimum(prev[:-1] + (h_ids != r_ids[i - 1]), prev[1:] + 1, out=tmp[1:])
        np.subtract(tmp, cols, out=tmp)
        np.minimum.accumulate(tmp, out=tmp)
        np.add(tmp, cols, out=D[i])
    # backtrace
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and D[i, j] == D[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            ops.append(("=" if ref[i - 1] == hyp[j - 1] else "S", i - 1, j - 1))
            i, j = i - 1, j - 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            ops.append(("D", i - 1, j))
            i -= 1
        else:
            ops.append(("I", i, j - 1))
            j -= 1
    ops.reverse()
    return int(D[n, m]), ops


def _counts(ref_tokens, hyp_tokens):
    _dist, ops = align_tokens(ref_tokens, hyp_tokens)
    sub = sum(1 for op, _i, _j in ops if op == "S")
    dele = sum(1 for op, _i, _j in ops if op == "D")
    ins = sum(1 for op, _i, _j in ops if op == "I")
    hits = sum(1 for op, _i, _j in ops if op == "=")
    return {"sub": sub, "del": dele, "ins": ins, "hits": hits, "count": len(ref_tokens), "ops": ops}


def _as_id_dict(x, prefix="utt"):
    """Accept file path, dict {id: text}, or list of texts."""
    if isinstance(x, dict):
        return {str(k): v for k, v in x.items()}
    if isinstance(x, str):
        from ssak_tpu_torch.data.kaldi import read_keyed_file

        return read_keyed_file(x)
    return {f"{prefix}{i:08d}": t for i, t in enumerate(x)}


def compute_wer(
    refs,
    preds,
    normalization=None,
    character_level: bool = False,
    use_ids: bool = None,
    bootstrap_ci: bool = False,
    n_bootstrap: int = 1000,
    seed: int = 1234,
    details: bool = False,
    replacements_ref=None,
    replacements_pred=None,
    words_blacklist=None,
):
    """Compute WER (or CER with character_level=True).

    refs/preds: files ('<id> <text>' lines), dicts {id: text}, or lists.
    When both sides carry ids, scoring is restricted to the id intersection
    (reference wer.py:74-91). Returns a dict with wer/del/ins/sub/hits/count
    (rates relative to reference length), plus 'ci' when bootstrap_ci and
    'alignments' when details.
    """
    refs_d = _as_id_dict(refs)
    preds_d = _as_id_dict(preds)
    if use_ids is None:
        use_ids = isinstance(refs, (str, dict)) and isinstance(preds, (str, dict))
    if use_ids:
        common = sorted(set(refs_d) & set(preds_d))
        if not common:
            raise ValueError("no common utterance ids between references and predictions")
        ref_list = [refs_d[k] for k in common]
        pred_list = [preds_d[k] for k in common]
        ids = common
    else:
        ref_list = list(refs_d.values())
        pred_list = list(preds_d.values())
        if len(ref_list) != len(pred_list):
            raise ValueError(f"length mismatch: {len(ref_list)} refs vs {len(pred_list)} preds")
        ids = list(refs_d.keys())

    ref_list = [_apply_replacements(_normalize_for_wer(r, normalization), replacements_ref) for r in ref_list]
    pred_list = [_apply_replacements(_normalize_for_wer(p, normalization), replacements_pred) for p in pred_list]
    if words_blacklist:
        bl = set(words_blacklist)
        ref_list = [" ".join(w for w in r.split() if w not in bl) for r in ref_list]
        pred_list = [" ".join(w for w in p.split() if w not in bl) for p in pred_list]
    ref_list, pred_list = ensure_not_empty_reference(ref_list, pred_list)

    def tokens(t):
        return list(t.replace(" ", "")) if character_level else t.split()

    per_utt = []
    for r, p in zip(ref_list, pred_list):
        per_utt.append(_counts(tokens(r), tokens(p)))

    tot = {k: sum(u[k] for u in per_utt) for k in ("sub", "del", "ins", "hits", "count")}
    count = max(1, tot["count"])
    result = {
        "wer": (tot["sub"] + tot["del"] + tot["ins"]) / count,
        "del": tot["del"] / count,
        "ins": tot["ins"] / count,
        "sub": tot["sub"] / count,
        "hits": tot["hits"],
        "count": tot["count"],
    }
    if bootstrap_ci:
        errs = np.array([u["sub"] + u["del"] + u["ins"] for u in per_utt], dtype=np.float64)
        lens = np.array([u["count"] for u in per_utt], dtype=np.float64)
        result["ci"] = bootstrap_confidence_interval(errs, lens, n=n_bootstrap, seed=seed)
    if details:
        result["alignments"] = [
            {
                "id": ids[k],
                "ref": ref_list[k],
                "pred": pred_list[k],
                "wer": (per_utt[k]["sub"] + per_utt[k]["del"] + per_utt[k]["ins"]) / max(1, per_utt[k]["count"]),
                "viz": format_alignment(tokens(ref_list[k]), tokens(pred_list[k]), per_utt[k]["ops"]),
            }
            for k in range(len(ids))
        ]
    return result


def _apply_replacements(text, replacements):
    if not replacements:
        return text
    for a, b in (replacements.items() if isinstance(replacements, dict) else replacements):
        text = re.sub(rf"\b{re.escape(a)}\b", b, text)
    return collapse_whitespace(text)


def bootstrap_confidence_interval(errs, lens, n: int = 1000, seed: int = 1234, alpha: float = 0.05):
    """Percentile bootstrap CI over utterances for the WER ratio
    (reference wer.py list_to_confidence_intervals:486)."""
    rng = np.random.RandomState(seed)
    N = len(errs)
    idx = rng.randint(0, N, size=(n, N))
    wers = errs[idx].sum(axis=1) / np.maximum(1, lens[idx].sum(axis=1))
    lo, hi = np.percentile(wers, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return {"mean": float(wers.mean()), "low": float(lo), "high": float(hi), "alpha": alpha}


def format_alignment(ref_tokens, hyp_tokens, ops) -> str:
    """Three-line visualization: REF / HYP / op tags, column aligned."""
    r_line, h_line, o_line = [], [], []
    for op, i, j in ops:
        r = ref_tokens[i] if op in ("=", "S", "D") else "*"
        h = hyp_tokens[j] if op in ("=", "S", "I") else "*"
        w = max(len(r), len(h), 1)
        r_line.append(r.ljust(w))
        h_line.append(h.ljust(w))
        o_line.append(("" if op == "=" else op).ljust(w))
    return "REF: " + " ".join(r_line) + "\nHYP: " + " ".join(h_line) + "\nOPS: " + " ".join(o_line)


def compute_wer_differences(refs, preds1, preds2, normalization=None, **kwargs):
    """Compare two systems on the same references (reference wer.py:377).

    Returns {wer1, wer2, diff, better, worse, same} where better/worse count
    utterances where system2 improves/regresses vs system1.
    """
    r1 = compute_wer(refs, preds1, normalization=normalization, details=True, **kwargs)
    r2 = compute_wer(refs, preds2, normalization=normalization, details=True, **kwargs)
    a1 = {a["id"]: a["wer"] for a in r1["alignments"]}
    a2 = {a["id"]: a["wer"] for a in r2["alignments"]}
    common = set(a1) & set(a2)
    better = sum(1 for k in common if a2[k] < a1[k])
    worse = sum(1 for k in common if a2[k] > a1[k])
    return {
        "wer1": r1["wer"],
        "wer2": r2["wer"],
        "diff": r2["wer"] - r1["wer"],
        "better": better,
        "worse": worse,
        "same": len(common) - better - worse,
    }


def keyword_scores(refs, preds, keywords, normalization=None):
    """Per-keyword precision/recall/F1 over the corpus (reference
    wer.py:244-325)."""
    refs_d = _as_id_dict(refs)
    preds_d = _as_id_dict(preds)
    common = sorted(set(refs_d) & set(preds_d)) or sorted(refs_d)
    out = {}
    for kw in keywords:
        kw_n = _normalize_for_wer(kw, normalization)
        tp = fp = fn = 0
        for k in common:
            r = _normalize_for_wer(refs_d[k], normalization).split().count(kw_n)
            p = _normalize_for_wer(preds_d.get(k, ""), normalization).split().count(kw_n)
            tp += min(r, p)
            fp += max(0, p - r)
            fn += max(0, r - p)
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        out[kw] = {"precision": prec, "recall": rec, "f1": f1, "tp": tp, "fp": fp, "fn": fn}
    return out
