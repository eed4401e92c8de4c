"""CTC beam search with optional n-gram LM shallow fusion (counterpart of
ssak_tpu.decode.ctc_beam).

Two engines with one semantics:

* `ctc_prefix_beam_search` — the exact host prefix beam (word-level LM
  scored at word boundaries with alpha/beta weights, optional lexicon).

* `ctc_beam_search_device` — the batched beam on the device, a loop over
  frames in PyTorch with no host sync inside it (on a card, one captured
  CUDA graph of the step, replayed per frame). Beams carry (prefix
  rolling hash, last token, log p_blank, log p_nonblank, char-LM context,
  lexicon trie node, word-LM context); stay-vs-extend duplicates merge by
  exact hash equality + logsumexp; one top-K over the K + K*V candidates
  (a stable sort: ties to the lower index, as jax.lax.top_k); char-LM
  fusion is a dense-table gather, the lexicon a trie-table gather, and the
  word n-gram a hashed-table backoff lookup at word boundaries.
  Backpointers are fetched to the host and traced back there (`_backtrace`).

ssak_tpu's uint32 arithmetic (prefix hashes, n-gram hashes) runs here in
int64 masked to 32 bits, multiplications split in 16-bit halves so no
product leaves int64.
"""

import math
from collections import OrderedDict

import numpy as np
import torch

from ssak_tpu_torch.decode.lm import _H_SEED1, _H_SEED2
from ssak_tpu_torch.models.whisper import _top_k

LOG0 = -1e30
LOG10 = math.log(10.0)
HASH_P = 1000003
_M32 = 0xFFFFFFFF


def _logsumexp2(a, b):
    m = max(a, b)
    if m <= LOG0 / 2:
        return LOG0
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def ctc_prefix_beam_search(
    log_probs,
    vocab,
    blank_id: int = 0,
    beam_width: int = 25,
    lm=None,
    alpha: float = 0.5,
    beta: float = 1.5,
    word_delimiter: str = "|",
    prune_logp: float = -10.0,
    lexicon=None,
):
    """Exact CTC prefix beam search over one utterance.

    log_probs: (T, V) natural-log probabilities (numpy). vocab: id->token
    list. lm: ArpaLM over WORDS (scored when a word completes), fused as
    alpha * ln10 * log10(P_lm) + beta per word (pyctcdecode semantics).
    lexicon: optional decode.lexicon.Lexicon — hypotheses are constrained
    to in-lexicon words (the Vosk/WFST capability, ref kaldi_infer.py:119);
    composes with lm.
    Returns list of (text, score) best-first.
    """
    T, V = log_probs.shape
    # beams: prefix tuple -> (p_b, p_nb, lm_state)
    # lm_state: (context_words_tuple, partial_word)
    init_ctx = ("<s>",) if lm is not None else ()
    beams = {(): (0.0, LOG0, (init_ctx, ""))}

    for t in range(T):
        frame = log_probs[t]
        candidates = np.where(frame >= frame.max() + prune_logp)[0]
        new_beams = {}

        def add(prefix, p_b, p_nb, state):
            if prefix in new_beams:
                ob, onb, ostate = new_beams[prefix]
                new_beams[prefix] = (_logsumexp2(ob, p_b), _logsumexp2(onb, p_nb), ostate)
            else:
                new_beams[prefix] = (p_b, p_nb, state)

        for prefix, (p_b, p_nb, state) in beams.items():
            p_tot = _logsumexp2(p_b, p_nb)
            last = prefix[-1] if prefix else None
            for c in candidates:
                p = float(frame[c])
                if c == blank_id:
                    add(prefix, p_tot + p, LOG0, state)
                elif c == last:
                    # repeat collapses into same prefix (from p_nb)...
                    add(prefix, LOG0, p_nb + p, state)
                    # ...or extends after a blank (new symbol occurrence)
                    ext = _extend_state(state, vocab[c], lm, alpha, beta, word_delimiter, lexicon)
                    if ext is not None:
                        add(prefix + (c,), LOG0, p_b + p + ext[0], ext[1])
                else:
                    ext = _extend_state(state, vocab[c], lm, alpha, beta, word_delimiter, lexicon)
                    if ext is not None:
                        add(prefix + (c,), LOG0, p_tot + p + ext[0], ext[1])

        scored = sorted(new_beams.items(), key=lambda kv: -_logsumexp2(kv[1][0], kv[1][1]))
        beams = dict(scored[:beam_width])

    results = []
    for prefix, (p_b, p_nb, state) in beams.items():
        # a trailing partial that is not a complete lexicon word cannot end
        # the utterance (the WFST would have no final state there)
        if lexicon is not None and state[1] and not lexicon.has_word(state[1]):
            continue
        score = _logsumexp2(p_b, p_nb)
        # score the trailing partial word at end of sequence
        if lm is not None and state[1]:
            score += alpha * LOG10 * lm.score(state[1], state[0]) + beta
        text = "".join(vocab[c] for c in prefix).replace(word_delimiter, " ").strip()
        results.append((text, score))
    results.sort(key=lambda x: -x[1])
    return results or [("", LOG0)]


def _extend_state(state, token, lm, alpha, beta, word_delimiter, lexicon=None):
    """Returns (lm_score_increment, new_state) for appending `token`, or
    None when the extension is lexicon-forbidden (hypothesis killed)."""
    if lm is None and lexicon is None:
        return 0.0, state
    ctx, partial = state
    if token == word_delimiter or token == " ":
        if partial:
            if lexicon is not None and not lexicon.has_word(partial):
                return None
            inc = 0.0
            if lm is not None:
                inc = alpha * LOG10 * lm.score(partial, ctx) + beta
                ctx = (ctx + (partial,))[-(lm.order - 1):] if lm.order > 1 else ()
            return inc, (ctx, "")
        return 0.0, state
    if lexicon is not None and not lexicon.has_prefix(partial + token):
        return None
    return 0.0, (ctx, partial + token)


# --- batched beam on the device ------------------------------------------------


def _f32(x: float) -> float:
    """x rounded to float32 (ssak_tpu holds these weights as f32 scalars)."""
    return float(np.float32(x))


def _mul32(a, b: int):
    """(a * b) mod 2**32 for int64 tensors a in [0, 2**32) and a constant b."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def _rotl32(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def _ngram_mix_torch(ids, seed: int):
    """decode.lm._ngram_mix on int64 tensors holding uint32 values."""
    h = None
    for x in ids:
        x = _mul32(_rotl32(_mul32(x & _M32, 0xCC9E2D51), 15), 0x1B873593)
        h = (seed if h is None else h) ^ x
        h = (_mul32(_rotl32(h, 13), 5) + 0xE6546B64) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hashed_lookup(table, ids, scale, probes: int):
    """Probe a decode.lm.HashedNgrams table on the device ({"fp": int64,
    "val": f32}). ids: tuple of integer tensors (broadcastable, the n-gram
    most-recent-last); probes: the table's worst-case probe count. Returns
    (value * scale, hit) shaped like ids[0]."""
    fp_tab, val_tab = table["fp"], table["val"]
    M = fp_tab.shape[0]
    h1 = _ngram_mix_torch(ids, _H_SEED1)
    h2 = _ngram_mix_torch(ids, _H_SEED2)
    h2 = torch.where(h2 == 0, 1, h2)
    idx = h1 & (M - 1)
    val = torch.zeros(h1.shape, dtype=torch.float32, device=h1.device)
    hit = torch.zeros(h1.shape, dtype=torch.bool, device=h1.device)
    stop = torch.zeros(h1.shape, dtype=torch.bool, device=h1.device)
    for i in range(probes):
        j = (idx + i) & (M - 1)
        f = fp_tab[j]
        now = (f == h2) & ~stop
        val = torch.where(now, val_tab[j], val)
        hit = hit | now
        stop = stop | now | (f == 0)
    return val * scale, hit


def _word_lm_score(wlm, ctx, w, scale, order: int, probes):
    """Backoff word n-gram score on the device, ArpaLM._score's recursion
    unrolled for order <= 3. ctx: (..., order-1) word ids most-recent-last
    (a <pad> slot matches no n-gram and its backoff is 0, which reproduces
    the host beam's shorter startup context); w: (...,) valid word ids.
    Returns scale * log10 P(w | ctx)."""
    uni_w = wlm["uni"][w] * scale
    if order == 1:
        return uni_w
    c2 = ctx[..., -1]
    v2, hit2 = _hashed_lookup(wlm["bi"], (c2, w), scale, probes["bi"])
    s2 = torch.where(hit2, v2, wlm["uni_backoff"][c2] * scale + uni_w)
    if order == 2:
        return s2
    c1 = ctx[..., -2]
    v3, hit3 = _hashed_lookup(wlm["tri"], (c1, c2, w), scale, probes["tri"])
    bo2, _ = _hashed_lookup(wlm["bi_backoff"], (c1, c2), scale, probes["bi_backoff"])
    return torch.where(hit3, v3, bo2 + s2)


def _gather_beams(x, src):
    """x (B, K, ...) -> x[b, src[b, k], ...]."""
    idx = src.reshape(*src.shape, *([1] * (x.ndim - 2))).expand(*src.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


def _beam_loop(log_probs, frame_lengths, K: int, blank_id: int, aux, word_cfg, n_frames: int = None,
               graph: bool = None):
    """ssak_tpu's `_device_beam_program` scan body, frame by frame, over the
    first n_frames frames (default T): past every row's length a frame
    changes no state, so the caller bounds the loop by the longest row.
    On a CUDA tensor (graph=None) the first frame runs eagerly and the
    step is captured once as a CUDA graph that is replayed for the rest:
    the step is a few hundred small kernels, launched from the host one
    by one otherwise. Returns (best (B,), srcs (n, B, K), toks (n, B, K))
    on the device, and the graph (None without one), which must outlive
    its replays."""
    B, T, V = log_probs.shape
    n = T if n_frames is None else max(0, min(T, int(n_frames)))
    dev = log_probs.device
    graph = dev.type == "cuda" if graph is None else graph
    lm_tab = aux.get("char_lm")
    order = lm_tab.ndim if lm_tab is not None else 1
    use_lexicon = "lex_trans" in aux
    word_order = word_cfg["order"] if word_cfg else 0
    probes = dict(word_cfg["probes"]) if word_cfg else {}
    wlm = aux.get("word_lm")
    beta, alpha_scale = aux.get("word_beta", 0.0), aux.get("word_alpha_scale", 1.0)
    vocab_ids = torch.arange(V, device=dev)
    kidx = torch.arange(K, device=dev)

    # the beam state, updated in place by each step (a captured graph reads and writes these tensors)
    st = {"hashes": ((_mul32(kidx, 2654435761) + 1) & _M32).expand(B, K).contiguous(),
          "last": torch.full((B, K), -1, dtype=torch.int64, device=dev),
          "p_b": torch.full((B, K), LOG0, dtype=torch.float32, device=dev),
          "p_nb": torch.full((B, K), LOG0, dtype=torch.float32, device=dev),
          "ctx": torch.zeros((B, K, max(1, order - 1)), dtype=torch.int64, device=dev),
          "node": torch.zeros((B, K), dtype=torch.int64, device=dev)}
    st["p_b"][:, 0] = 0.0
    if word_order:
        # [<pad>, ..., <s>]: pad never matches an n-gram (host beam's 1-word startup context)
        st["wctx"] = torch.full((B, K, max(1, word_order - 1)), word_cfg["pad"], dtype=torch.int64, device=dev)
        st["wctx"][..., -1] = word_cfg["bos"]
    else:
        st["wctx"] = torch.zeros((B, K, 1), dtype=torch.int64, device=dev)
    srcs = torch.empty((n, B, K), dtype=torch.int32, device=dev)
    toks = torch.empty((n, B, K), dtype=torch.int32, device=dev)
    lengths = frame_lengths.to(dev).reshape(B, 1)
    t = torch.zeros((1,), dtype=torch.int64, device=dev)  # the frame index, on the device

    def step():
        hashes, last, p_b, p_nb = st["hashes"], st["last"], st["p_b"], st["p_nb"]
        ctx, node, wctx = st["ctx"], st["node"], st["wctx"]
        frame = log_probs.index_select(1, t)[:, 0]  # (B, V)
        active = t < lengths  # (B, 1)
        p_tot = torch.logaddexp(p_b, p_nb)

        # extension candidates (B, K, V); the same token only from p_b
        ext_scores = torch.where(vocab_ids == last[..., None], p_b[..., None], p_tot[..., None]) + frame[:, None, :]
        if lm_tab is not None:
            lm_row = lm_tab[tuple(ctx[..., i] for i in range(order - 1))]  # (B, K, V_lm)
            V_lm = lm_row.shape[-1]
            lm_row = torch.nn.functional.pad(lm_row, (0, V - V_lm)) if V > V_lm else lm_row[..., :V]
            ext_scores = ext_scores + lm_row
        ext_scores = torch.where(vocab_ids == blank_id, LOG0, ext_scores)
        if use_lexicon:
            nxt = aux["lex_trans"][node]  # (B, K, V) trie rows
            ext_scores = torch.where(nxt >= 0, ext_scores, LOG0)
            if word_order:
                # a word completes on a transition into the root from an accepting node
                accept_node = aux["lex_accept"][node]
                w_safe = aux["node_word"][node].clamp(0, wlm["uni"].shape[0] - 1)
                w_inc = _word_lm_score(wlm, wctx, w_safe, alpha_scale, word_order, probes) + beta
                completing = (nxt == 0) & accept_node[..., None]
                ext_scores = ext_scores + torch.where(completing, w_inc[..., None], 0.0)
        ext_hash = ((hashes * HASH_P)[..., None] + vocab_ids) & _M32

        # stay candidates: blank from anywhere, repeat from p_nb
        stay_b = p_tot + frame[:, blank_id, None]
        rep = torch.gather(frame, 1, last.clamp(0, V - 1))
        stay_nb = p_nb + torch.where(last >= 0, rep, LOG0)

        # exact stay-vs-extend merge: an extension recreating a live stay's
        # prefix folds into its nonblank mass and is removed
        eq = ext_hash[..., None] == hashes[:, None, None, :]  # (B, K, V, K)
        eq = eq & (torch.logaddexp(stay_b, stay_nb) > LOG0 / 2)[:, None, None, :]
        merged_in = torch.where(eq, ext_scores[..., None], LOG0).amax(dim=(1, 2))
        stay_nb = torch.logaddexp(stay_nb, merged_in)
        ext_scores = torch.where(eq.any(dim=3), LOG0, ext_scores)

        # K stays then K*V extensions; one top-K
        cand = torch.cat([torch.logaddexp(stay_b, stay_nb), ext_scores.reshape(B, K * V)], dim=1)
        top_scores, flat_idx = _top_k(cand, K)
        is_stay = flat_idx < K
        src_beam = torch.where(is_stay, flat_idx, (flat_idx - K) // V)
        tok = torch.where(is_stay, -1, (flat_idx - K) % V)

        old_hash = torch.gather(hashes, 1, src_beam)
        new_hash = torch.where(is_stay, old_hash, (old_hash * HASH_P + tok) & _M32)
        new_last = torch.where(is_stay, torch.gather(last, 1, src_beam), tok)
        new_pb = torch.where(is_stay, torch.gather(stay_b, 1, src_beam), LOG0)
        new_pnb = torch.where(is_stay, torch.gather(stay_nb, 1, src_beam), top_scores)
        if lm_tab is not None:
            old_ctx = _gather_beams(ctx, src_beam)
            shifted = torch.cat([old_ctx[..., 1:], new_last.clamp(0, lm_tab.shape[0] - 1)[..., None]], dim=-1)
            ctx.copy_(torch.where(is_stay[..., None], old_ctx, shifted))
        if use_lexicon:
            nxt_tok = torch.gather(_gather_beams(nxt, src_beam), 2, tok.clamp(0, V - 1)[..., None])[..., 0]
            new_node = torch.where(is_stay, torch.gather(node, 1, src_beam), nxt_tok.long())
            new_node = torch.where(active, new_node, node)
            if word_order:
                # the chosen extension completes a word iff it lands on the
                # root from an accepting source node
                comp_sel = (new_node == 0) & torch.gather(accept_node, 1, src_beam) & ~is_stay
                old_wctx = _gather_beams(wctx, src_beam)
                shifted_w = torch.cat([old_wctx[..., 1:], torch.gather(w_safe, 1, src_beam)[..., None]], dim=-1)
                new_wctx = torch.where(comp_sel[..., None], shifted_w, old_wctx)
                wctx.copy_(torch.where(active[..., None], new_wctx, wctx))
            node.copy_(new_node)

        # finished rows keep their state
        toks.index_copy_(0, t, torch.where(active & ~is_stay, tok, -1).to(torch.int32)[None])
        srcs.index_copy_(0, t, torch.where(active, src_beam, kidx).to(torch.int32)[None])
        hashes.copy_(torch.where(active, new_hash, hashes))
        last.copy_(torch.where(active, new_last, last))
        p_b.copy_(torch.where(active, new_pb, p_b))
        p_nb.copy_(torch.where(active, new_pnb, p_nb))
        t.add_(1)

    g = None
    if graph and n > 1:
        step()  # frame 0, eagerly: it also warms up what the capture needs
        g, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            g.capture_begin(capture_error_mode="thread_local")
            step()
            g.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        for _ in range(n - 1):
            g.replay()
    else:
        for _ in range(n):
            step()

    node, wctx = st["node"], st["wctx"]
    final = torch.logaddexp(st["p_b"], st["p_nb"])
    if use_lexicon:
        # a mid-word ending is not a final state
        accept_node = aux["lex_accept"][node]
        final = torch.where((node == 0) | accept_node, final, LOG0)
        if word_order:
            w_safe = aux["node_word"][node].clamp(0, wlm["uni"].shape[0] - 1)
            tail = _word_lm_score(wlm, wctx, w_safe, alpha_scale, word_order, probes) + beta
            final = final + torch.where(accept_node, tail, 0.0)
    return torch.argmax(final, dim=1), srcs, toks, g


# host tables -> device tensors, converted once per table object: the
# lexicon and word-LM tables live for the whole run (built once per model in
# ctc_infer). Entries hold a strong reference to every keyed host object, so
# an id() cannot be reused while the entry lives; a small LRU bounds them.
_DEVICE_TABLE_CACHE = OrderedDict()
_DEVICE_TABLE_CACHE_MAX = 8


def _cached_device(objs, extra_key, build):
    """objs: the host objects the device value is built from (keyed by
    identity, strongly referenced); extra_key: hashable scalars."""
    key = (tuple(id(o) for o in objs), extra_key)
    ent = _DEVICE_TABLE_CACHE.get(key)
    if ent is None or any(a is not b for a, b in zip(ent[0], objs)):
        ent = (objs, build())
        _DEVICE_TABLE_CACHE[key] = ent
        while len(_DEVICE_TABLE_CACHE) > _DEVICE_TABLE_CACHE_MAX:
            _DEVICE_TABLE_CACHE.popitem(last=False)
    else:
        _DEVICE_TABLE_CACHE.move_to_end(key)
    return ent[1]


def _word_lm_aux(word_lm, lexicon_tables, lm_alpha, lm_beta, device):
    """Device tensors for word n-gram fusion (word_lm from
    decode.lm.word_lm_device_tables; lexicon_tables with node_word ids)."""

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    def hashed(tab):
        return {"fp": t(tab.fp.astype(np.int64)), "val": t(tab.val)}

    wlm = {"uni": t(word_lm["uni"]), "uni_backoff": t(word_lm["uni_backoff"])}
    if word_lm["order"] >= 2:
        wlm["bi"] = hashed(word_lm["bi"])
    if word_lm["order"] >= 3:
        wlm["bi_backoff"] = hashed(word_lm["bi_backoff"])
        wlm["tri"] = hashed(word_lm["tri"])
    return {"word_lm": wlm, "node_word": t(np.asarray(lexicon_tables[2], np.int64)),
            "word_alpha_scale": _f32(lm_alpha * LOG10), "word_beta": _f32(lm_beta)}


def ctc_beam_search_device(log_probs, frame_lengths, beam_width: int = 16, blank_id: int = 0, lm_table=None,
                           lm_alpha: float = 0.5, lexicon_tables=None, word_lm=None, lm_beta: float = 1.5,
                           return_async: bool = False):
    """Batched beam search on the device of `log_probs`.

    log_probs: (B, T, V) log-softmax outputs (tensor; numpy runs on the
    CPU); frame_lengths: (B,) valid frames. lm_table: optional dense char-LM
    (V_lm,)*order table in log10 (decode.lm.char_lm_table), fused per
    extension with weight lm_alpha. lexicon_tables: optional (trans, accept[,
    node_word]) from decode.lexicon (device_tables, node_word_ids):
    hypotheses stay in-lexicon. word_lm: optional
    decode.lm.word_lm_device_tables dict, scored at word boundaries with
    weights (lm_alpha, lm_beta); needs lexicon_tables with node_word.

    Returns (tokens (B, T) int32 padded -1, lengths (B,)) of the best beam,
    traced back on the host; return_async=True returns a handle whose
    .result() does the fetch and backtrace, so the caller can enqueue the
    next batch's work first."""
    if word_lm is not None and (lexicon_tables is None or len(lexicon_tables) < 3):
        raise ValueError("word_lm requires lexicon_tables with node_word_ids")
    log_probs = torch.as_tensor(log_probs)
    dev = log_probs.device
    frame_lengths = torch.as_tensor(frame_lengths)
    n_frames = int(frame_lengths.max()) if frame_lengths.numel() else 0  # the loop stops at the longest row
    frame_lengths = frame_lengths.to(dev)
    aux = {}
    if lm_table is not None:
        aux["char_lm"] = _cached_device(
            (lm_table,), ("char", float(lm_alpha), str(dev)),
            lambda: torch.as_tensor(np.asarray(lm_table), device=dev) * _f32(LOG10) * _f32(lm_alpha))
    if lexicon_tables is not None:
        aux.update(_cached_device(
            (lexicon_tables,), ("lex", str(dev)),
            lambda: {"lex_trans": torch.as_tensor(np.asarray(lexicon_tables[0], np.int64), device=dev),
                     "lex_accept": torch.as_tensor(np.asarray(lexicon_tables[1], bool), device=dev)}))
    word_cfg = None
    if word_lm is not None:
        word_cfg = {"order": word_lm["order"], "bos": word_lm["bos"], "pad": word_lm["pad"],
                    "probes": tuple(sorted((k, v.max_probe) for k, v in word_lm.items() if hasattr(v, "max_probe")))}
        aux.update(_cached_device(
            (word_lm, lexicon_tables), ("wlm", float(lm_alpha), float(lm_beta), str(dev)),
            lambda: _word_lm_aux(word_lm, lexicon_tables, lm_alpha, lm_beta, dev)))
    with torch.no_grad():
        best, srcs, toks, graph = _beam_loop(log_probs.to(torch.float32), frame_lengths, beam_width, blank_id, aux,
                                             word_cfg, n_frames=n_frames)
    handle = _AsyncBeamResult(best, srcs, toks, frame_lengths, log_probs.shape[1], graph)
    return handle if return_async else handle.result()


class _AsyncBeamResult:
    """Deferred beam result: holds device tensors (and the beam's CUDA
    graph, until its replays are done); .result() fetches them and traces
    back on the host."""

    def __init__(self, best, srcs, toks, frame_lengths, T: int, graph=None):
        self._args, self._T, self._graph = (best, srcs, toks, frame_lengths), T, graph

    def result(self):
        out = _backtrace(*(a.cpu().numpy() for a in self._args), T=self._T)
        self._graph = None
        return out


def _backtrace(best, srcs, toks, lengths, T: int):
    """Vectorized host backtrace through (n, B, K) parent pointers (n <= T
    frames looped): one numpy step per frame over the whole batch (the
    per-(b, t) Python loop was ~16k iterations per 32x10s batch). Returns
    tokens padded to (B, T)."""
    n, B, K = srcs.shape
    bidx = np.arange(B)
    k = best.astype(np.int64)
    emitted = np.full((B, n), -1, np.int32)
    for t in range(n - 1, -1, -1):
        valid = t < lengths
        emitted[:, t] = np.where(valid, toks[t, bidx, k], -1)
        k = np.where(valid, srcs[t, bidx, k], k)
    out = np.full((B, T), -1, np.int32)
    out_lens = np.zeros((B,), np.int32)
    for b in range(B):
        seq = emitted[b][emitted[b] >= 0]
        out[b, : len(seq)] = seq
        out_lens[b] = len(seq)
    return out, out_lens
