"""The port's host-beam worker pool (ssak_tpu_torch.decode.pool, through
ctc_infer(num_workers=...)) against its in-process host beam and against
ssak_tpu's pooled run, on the CPU.

A tiny wav2vec2 in f32 takes ssak_tpu's seeded parameters, converted (as
in tests/test_torch_ctc_infer.py, whose tolerance reasoning holds: f32
log-probs agree to 5e-5, so transcripts are compared for equality). The
LM is a word 4-gram: order > 3 sends every file to the host beam, in
process or over the pool; both packages' workers score with their native
library."""

import os

import numpy as np
import pytest
import torch

import jax

import ssak_tpu.infer.ctc_infer as JCI
import ssak_tpu.infer.general as JG
import ssak_tpu_torch.infer.ctc_infer as TCI
import ssak_tpu_torch.infer.general as TG
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu.models.tokenizer import CTCTokenizer as JTokenizer
from ssak_tpu_torch.audio import save_audio
from ssak_tpu_torch.decode.ctc_beam import ctc_prefix_beam_search
from ssak_tpu_torch.decode.lm import train_ngram_lm
from ssak_tpu_torch.decode.native_lm import NativeNgramLM
from ssak_tpu_torch.decode.pool import HostBeamPool
from ssak_tpu_torch.models import wav2vec2 as TW

SMALL_CHUNK = 32000
SMALL_BUCKETS = (4000, 8000, 16000, SMALL_CHUNK)
LENGTHS = (3000, 12000, 7000, SMALL_CHUNK, 20000, 41000)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' load_model return f32 copies of one seeded tiny
    wav2vec2; buckets shrunk so a chunked file stays cheap; decode-table
    caches in a temporary directory."""
    from ssak_tpu_torch.decode import table_cache

    jcfg = JW.make_config("tiny_test", dtype="float32")
    params = JW.init_params(jax.random.PRNGKey(0), jcfg)
    tok = TG.seeded_ctc_tokenizer(jcfg.vocab_size)
    jm = JG.LoadedModel(JG.ModelType.WAV2VEC2_CTC, params, jcfg, JTokenizer(dict(tok.vocab)))
    tm = TG.from_tree(jax.tree_util.tree_map(np.asarray, params), TW.make_config("tiny_test", dtype="float32"),
                      device="cpu")
    mp = pytest.MonkeyPatch()
    cache = tmp_path_factory.mktemp("caches")
    mp.setenv("SSAK_TPU_CACHE", str(cache / "jax"))
    mp.setattr(table_cache, "CACHE_DIR", str(cache / "torch"))
    mp.setattr(JG, "load_model", lambda *a, **k: jm)
    mp.setattr(TG, "load_model", lambda *a, **k: tm)
    for mod in (JCI, TCI):
        mp.setattr(mod, "MAX_CHUNK_SAMPLES", SMALL_CHUNK)
        mp.setattr(mod, "_BUCKETS_SAMPLES", SMALL_BUCKETS)
    yield jm, tm
    mp.undo()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, served):
    """A Kaldi dir of seeded wavs, a lexicon of the words greedy decoding
    finds plus a few, and a word 4-gram ARPA over them."""
    root = tmp_path_factory.mktemp("pool")
    rng = np.random.RandomState(1)
    scp = []
    for i, n in enumerate(LENGTHS):
        t = np.arange(n) / 16000.0
        audio = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t) + 0.05 * rng.randn(n)
        path = str(root / f"utt{i:02d}.wav")
        save_audio(path, audio.astype(np.float32), 16000)
        scp.append(f"utt{i:02d} {path}")
    (root / "wav.scp").write_text("\n".join(scp) + "\n")
    greedy = [t for _, t in TCI.ctc_infer("m", str(root), output_ids=True, device="cpu")]
    words = sorted({w for t in greedy for w in t.split()} | {"ab", "cd", "ef"})
    (root / "lexicon.txt").write_text("\n".join(words) + "\n")
    sentences = [" ".join(rng.choice(words, size=rng.randint(2, 7))) for _ in range(300)]
    train_ngram_lm(sentences, order=4, output_arpa=str(root / "lm4.arpa"))
    return str(root)


ROUTES = {"word 4-gram": {}, "lexicon, word 4-gram, width 8": dict(lexicon=True, beam_width=8)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_pooled_equals_in_process_and_jax_pooled(served, corpus, route):
    opts = ROUTES[route]
    kw = dict(output_ids=True, lm_path=os.path.join(corpus, "lm4.arpa"), lm_alpha=0.5, lm_beta=1.0,
              beam_width=opts.get("beam_width", 0))
    if opts.get("lexicon"):
        kw["lexicon_path"] = os.path.join(corpus, "lexicon.txt")
    in_process = list(TCI.ctc_infer("m", corpus, device="cpu", **kw))
    pooled = list(TCI.ctc_infer("m", corpus, device="cpu", num_workers=2, **kw))
    jax_pooled = list(JCI.ctc_infer("m", corpus, num_workers=2, **kw))
    assert pooled == in_process == jax_pooled
    assert len(pooled) == len(LENGTHS) and sum(bool(t) for _, t in pooled) >= len(LENGTHS) // 2


def test_pool_decode_matches_the_in_process_beam_and_workers_keep_off_cuda(corpus):
    """decode and decode_async give the in-process beam's texts; after them,
    each worker, read once, scores with the native library, hides the card
    and has not initialised CUDA."""
    arpa = os.path.join(corpus, "lm4.arpa")
    vocab = TG.seeded_ctc_tokenizer(32)
    vocab = [vocab.id2tok.get(i, "") for i in range(32)]
    rng = np.random.RandomState(2)
    rows = []
    for n in (30, 45, 20):
        logits = rng.randn(n, len(vocab)).astype(np.float32) * 3
        rows.append(logits - np.log(np.exp(logits).sum(-1, keepdims=True)))
    lm = NativeNgramLM(arpa)
    want = [ctc_prefix_beam_search(r, vocab, blank_id=0, beam_width=8, lm=lm, alpha=0.5, beta=1.0)[0][0] for r in rows]
    with HostBeamPool(2, lm_path=arpa, vocab=vocab, blank_id=0, beam_width=8, alpha=0.5, beta=1.0) as pool:
        assert pool.decode(rows) == want
        assert pool.decode_async(rows).get(timeout=120) == want
        states = pool.worker_states()
    assert len({s["pid"] for s in states}) == len(states) == 2, states
    assert all(s["lm"] == "NativeNgramLM" and s["cuda_initialized"] is False
                          and s["cuda_visible_devices"] == "" and s["pid"] != os.getpid() for s in states), states
    assert not torch.cuda.is_initialized()
