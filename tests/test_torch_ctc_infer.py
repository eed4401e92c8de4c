"""The port's CTC serving path (ssak_tpu_torch.infer.ctc_infer and the CTC
half of infer.general) against ssak_tpu's on the CPU. A tiny wav2vec2
(tiny_test widths, 20 ms frames) takes its parameters from ssak_tpu's
seeded tree, converted; both packages' `load_model` are replaced by the
test so each serves its own copy. The model runs in f32: transcripts are
greedy or beam argmaxes, which bf16 rounding at other places in the two
packages could flip on a near tie; in f32 the log-probs agree to 5e-5.
Buckets and the 140 s chunk are shrunk in both packages (monkeypatch) so a
chunked file stays cheap; the JAX files are not edited."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssak_tpu.infer.ctc_infer as JCI
import ssak_tpu.infer.general as JG
import ssak_tpu_torch.infer.ctc_infer as TCI
import ssak_tpu_torch.infer.general as TG
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu.models.tokenizer import CTCTokenizer as JTokenizer
from ssak_tpu_torch.audio import save_audio
from ssak_tpu_torch.audio.wire import encode_rows
from ssak_tpu_torch.models import wav2vec2 as TW

SMALL_CHUNK = 32000  # 2 s: 99 frames of the tiny model
SMALL_BUCKETS = (4000, 8000, 16000, SMALL_CHUNK)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: one intra-op thread keeps the file's time beside
    other test workers (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(ssak_tpu LoadedModel, port LoadedModel on the CPU), same f32 weights."""
    jcfg = JW.make_config("tiny_test", dtype="float32")
    params = JW.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tok = TG.seeded_ctc_tokenizer(jcfg.vocab_size)
    jm = JG.LoadedModel(JG.ModelType.WAV2VEC2_CTC, params, jcfg, JTokenizer(dict(tok.vocab)))
    tm = TG.from_tree(tree, TW.make_config("tiny_test", dtype="float32"), device="cpu")
    return jm, tm


@pytest.fixture
def served(models, monkeypatch, tmp_path):
    """Both packages' load_model return the test's models; buckets shrunk;
    decode-table caches in tmp_path."""
    jm, tm = models
    monkeypatch.setattr(JG, "load_model", lambda *a, **k: jm)
    monkeypatch.setattr(TG, "load_model", lambda *a, **k: tm)
    for mod in (JCI, TCI):
        monkeypatch.setattr(mod, "MAX_CHUNK_SAMPLES", SMALL_CHUNK)
        monkeypatch.setattr(mod, "_BUCKETS_SAMPLES", SMALL_BUCKETS)
    monkeypatch.setenv("SSAK_TPU_CACHE", str(tmp_path / "jax_cache"))
    from ssak_tpu_torch.decode import table_cache

    monkeypatch.setattr(table_cache, "CACHE_DIR", str(tmp_path / "torch_cache"))
    return jm, tm


def _kaldi_dir(root, lengths, seed=0):
    """wav files of the given sample counts (tones + noise) as a Kaldi dir
    with utt2dur; ids in a different order than the lengths."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    scp, dur = [], []
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        audio = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t) + 0.05 * rng.randn(n)
        utt = f"utt{(7 * i) % len(lengths):02d}"
        path = os.path.join(root, f"{utt}.wav")
        save_audio(path, audio.astype(np.float32), 16000)
        scp.append(f"{utt} {path}")
        dur.append(f"{utt} {n / 16000.0:.6f}")
    for name, lines in (("wav.scp", scp), ("utt2dur", dur)):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return str(root)


# every bucket, a row of exactly one chunk, and two chunked files (3 and 2 chunks)
LENGTHS = (3000, 7000, 12000, 15000, 20000, SMALL_CHUNK, 70000, 9000, 41000, 2000)


def test_seeded_vocabulary_matches_jax():
    jm = JG._seeded_model("wav2vec2")
    tok = TG.seeded_ctc_tokenizer(jm.cfg.vocab_size)
    assert tok.vocab == jm.tokenizer.vocab
    assert jm.vocab() == TG.LoadedModel(TG.ModelType.WAV2VEC2_CTC, None, jm.cfg, "cpu", tok).vocab()
    big = TG.seeded_ctc_tokenizer(48)
    assert len(big) == 48 and big.vocab["|"] == 4 and big.id2tok[47] == "4"


def test_compute_log_probas_on_int16_wire_matches_jax(models):
    jm, tm = models
    rng = np.random.RandomState(0)
    rows = [(rng.randn(n) * 0.1).astype(np.float32) for n in (8000, 5000)]
    lens = [8000, 5000, 0]  # the last row is batch padding (negative frame count)
    x = encode_rows(rows, 3, 8000)
    assert x.dtype == np.int16
    ref, ref_fl = JG.compute_log_probas(jm, jnp.asarray(x), jnp.asarray(lens, np.int32))
    got, fl = TG.compute_log_probas(tm, x, lens)
    np.testing.assert_array_equal(fl.numpy(), np.asarray(ref_fl))
    assert fl.tolist()[:2] == [24, 15] and fl.tolist()[2] < 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5)
    np.testing.assert_allclose(TG.compute_log_probas(tm, torch.from_numpy(x), lens)[0].numpy(), got.numpy())
    assert TG.decode_log_probas(tm, got, fl) == JG.decode_log_probas(jm, ref, ref_fl)


@pytest.mark.parametrize("batch_size", [0, 8, 3])
def test_packing_and_padded_shapes_match_jax(batch_size):
    rng = np.random.RandomState(batch_size)
    for _ in range(20):
        lens = rng.choice([1, 15000, 150000, 400000, 1000000, 2240400, 2240401, 5000000], size=rng.randint(1, 40))
        rows = [(range(n), i) for i, n in enumerate(lens)]
        want = [([len(a) for a in b], ids) for b, ids in JCI.auto_pack_batches(iter(rows))]
        got = [([len(a) for a in b], ids) for b, ids in TCI.auto_pack_batches(iter(rows))]
        assert got == want
        for b, _ids in got:
            assert TCI.padded_batch_shape(b, batch_size) == JCI.padded_batch_shape(b, batch_size)
        n = int(rng.choice(lens))
        assert sum(TCI.chunk_lengths(n)) == n and all(0 < c <= TCI.MAX_CHUNK_SAMPLES for c in TCI.chunk_lengths(n))


@pytest.mark.parametrize("sort_by_len", [False, True])
def test_ctc_infer_greedy_matches_jax(served, tmp_path, sort_by_len):
    d = _kaldi_dir(tmp_path / "data", LENGTHS)
    want = list(JCI.ctc_infer("m", d, output_ids=True, sort_by_len=sort_by_len))
    got = list(TCI.ctc_infer("m", d, output_ids=True, sort_by_len=sort_by_len, device="cpu"))
    assert got == want
    assert len(got) == len(LENGTHS) and any(t for _, t in got)
    ids = [i for i, _ in got]
    assert ids == (sorted(ids) if not sort_by_len else ids) and len(set(ids)) == len(ids)


ROUTES = {
    "device beam, lexicon, word 3-gram": dict(beam_width=8, lexicon=True, lm=True),
    "device beam": dict(beam_width=8),
    "device beam, lexicon": dict(beam_width=8, lexicon=True),
    "host beam, lexicon": dict(lexicon=True),
    "host beam, word 3-gram": dict(lm=True),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_ctc_infer_decode_routes_match_jax(served, tmp_path, route):
    """Each decode route of ctc_infer's submit over short files and a
    chunked one (whose LM / lexicon / beam decode is one host prefix beam
    over the concatenated chunks): the same transcripts as ssak_tpu."""
    from ssak_tpu_torch.decode.lm import train_ngram_lm

    opts = ROUTES[route]
    lengths = (3000, 12000, SMALL_CHUNK, 41000) if len(opts) < 3 else LENGTHS
    d = _kaldi_dir(tmp_path / "data", lengths, seed=1)
    greedy = [t for _, t in TCI.ctc_infer("m", d, output_ids=True, device="cpu")]
    words = sorted({w for t in greedy for w in t.split()} | {"ab", "cd", "ef"})
    kw = dict(output_ids=True, beam_width=opts.get("beam_width", 0), lm_alpha=0.5, lm_beta=1.0)
    if opts.get("lexicon"):
        kw["lexicon_path"] = str(tmp_path / "lexicon.txt")
        (tmp_path / "lexicon.txt").write_text("\n".join(words) + "\n")
    if opts.get("lm"):
        rng = np.random.RandomState(3)
        sentences = [" ".join(rng.choice(words, size=rng.randint(2, 6))) for _ in range(200)]
        kw["lm_path"] = str(tmp_path / "lm.arpa")
        train_ngram_lm(sentences, order=3, output_arpa=kw["lm_path"])
    want = list(JCI.ctc_infer("m", d, **kw))
    got = list(TCI.ctc_infer("m", d, device="cpu", **kw))
    assert got == want
    assert [i for i, _ in got] == sorted(i for i, _ in got) and sum(bool(t) for _, t in got) >= len(lengths) // 2


def test_batch_helpers_match_jax(served):
    """ctc_transcribe_batch (one chunked row), ctc_decode_with_lm (host
    beam, word 3-gram and lexicon) and ctc_decode_beam_device (lexicon
    tables) on one batch of arrays, against ssak_tpu's."""
    from ssak_tpu.decode.lexicon import Lexicon as JLexicon
    from ssak_tpu.decode.lm import train_ngram_lm as j_train
    from ssak_tpu_torch.decode.lexicon import Lexicon
    from ssak_tpu_torch.decode.lm import train_ngram_lm

    jm, tm = served
    rng = np.random.RandomState(4)
    batch = [(0.3 * np.sin(np.arange(n) / rng.uniform(3, 30)) + 0.05 * rng.randn(n)).astype(np.float32)
             for n in (5000, 14000, 9000)]
    long = batch + [(0.1 * rng.randn(45000)).astype(np.float32)]
    assert TCI.ctc_transcribe_batch(tm, long) == JCI.ctc_transcribe_batch(jm, long)
    greedy = TCI.ctc_transcribe_batch(tm, batch)
    assert greedy == JCI.ctc_transcribe_batch(jm, batch)
    words = sorted({w for t in greedy for w in t.split()} | {"ab", "cd"})
    sentences = [" ".join(rng.choice(words, size=3)) for _ in range(100)]
    kw = dict(alpha=0.5, beta=1.0, beam_width=8)
    assert (TCI.ctc_decode_with_lm(tm, batch, train_ngram_lm(sentences), lexicon=Lexicon(words), **kw)
            == JCI.ctc_decode_with_lm(jm, batch, j_train(sentences), lexicon=JLexicon(words), **kw))
    tables = Lexicon(words).device_tables(tm.vocab())
    assert (TCI.ctc_decode_beam_device(tm, batch, beam_width=8, lexicon_tables=tables)
            == JCI.ctc_decode_beam_device(jm, batch, beam_width=8, lexicon_tables=JLexicon(words).device_tables(jm.vocab())))
