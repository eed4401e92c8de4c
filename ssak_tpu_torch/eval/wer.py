"""WER scoring (counterpart of ssak_tpu.eval.wer: `compute_wer` with its
default options, `align_tokens`, the empty-reference rule).

Levenshtein alignment with numpy row sweeps; references and predictions as
dicts {id: text} (scored on the id intersection), '<id> <text>' files, or
lists. Text normalization options, CER, bootstrap intervals, alignment
rendering and two-system diffs come with the port of the eval CLI.
"""

import numpy as np

from ssak_tpu_torch.data.kaldi import read_keyed_file
from ssak_tpu_torch.text.basic import collapse_whitespace

_DEFAULT_REPLACEMENT = "<empty>"


def ensure_not_empty_reference(refs, preds, replacement=_DEFAULT_REPLACEMENT):
    """Empty references break WER ratios: substitute a token in the
    reference AND the prediction."""
    out_r, out_p = [], []
    for r, p in zip(refs, preds):
        if not r.strip():
            r = replacement
            p = (replacement + " " + p).strip()
        out_r.append(r)
        out_p.append(p)
    return out_r, out_p


def align_tokens(ref, hyp):
    """Levenshtein alignment. Returns (distance, ops), ops a list of
    (op, i, j) with op in {'=', 'S', 'D', 'I'} referring to ref[i], hyp[j].
    Each DP row is one sweep: the insertion relaxation
    row[j] = min_{k<=j} (tmp[k] + (j - k)) is a prefix-min of tmp[k] - k."""
    n, m = len(ref), len(hyp)
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
    tally = {"S": 0, "D": 0, "I": 0, "=": 0}
    for op, _i, _j in ops:
        tally[op] += 1
    return {"sub": tally["S"], "del": tally["D"], "ins": tally["I"], "hits": tally["="], "count": len(ref_tokens)}


def _as_id_dict(x, prefix="utt"):
    """Accept a file path, a dict {id: text} or a list of texts."""
    if isinstance(x, dict):
        return {str(k): v for k, v in x.items()}
    if isinstance(x, str):
        return read_keyed_file(x)
    return {f"{prefix}{i:08d}": t for i, t in enumerate(x)}


def compute_wer(refs, preds):
    """WER as ssak_tpu computes it by default: {wer, del, ins, sub (rates
    over the reference length), hits, count}; scored on the common ids when
    both sides carry ids (dicts or files), pairwise for lists."""
    refs_d = _as_id_dict(refs)
    preds_d = _as_id_dict(preds)
    if isinstance(refs, (str, dict)) and isinstance(preds, (str, dict)):
        common = sorted(set(refs_d) & set(preds_d))
        if not common:
            raise ValueError("no common utterance ids between references and predictions")
        ref_list = [refs_d[k] for k in common]
        pred_list = [preds_d[k] for k in common]
    else:
        ref_list = list(refs_d.values())
        pred_list = list(preds_d.values())
        if len(ref_list) != len(pred_list):
            raise ValueError(f"length mismatch: {len(ref_list)} refs vs {len(pred_list)} preds")
    ref_list, pred_list = ensure_not_empty_reference([collapse_whitespace(r) for r in ref_list],
                                                     [collapse_whitespace(p) for p in pred_list])
    per_utt = [_counts(r.split(), p.split()) for r, p in zip(ref_list, pred_list)]
    tot = {k: sum(u[k] for u in per_utt) for k in ("sub", "del", "ins", "hits", "count")}
    count = max(1, tot["count"])
    return {
        "wer": (tot["sub"] + tot["del"] + tot["ins"]) / count,
        "del": tot["del"] / count,
        "ins": tot["ins"] / count,
        "sub": tot["sub"] / count,
        "hits": tot["hits"],
        "count": tot["count"],
    }
