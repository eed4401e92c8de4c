"""The port's CTC decoding (ssak_tpu_torch.decode: ctc_beam, lm, lexicon,
table_cache) against ssak_tpu's on the CPU, on seeded numpy log-probs:
the host prefix beam and the device beam in four modes each, token for
token; the host modules' tables array for array; and the guards of the
CTC entry points (cuda by default, raise without a card, the CLI on the CPU
when asked). Scores are the same f32 (device) or Python-float (host)
arithmetic in both packages, so results are compared exactly."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssak_tpu.decode import ctc_beam as JB
from ssak_tpu.decode import lexicon as JLx
from ssak_tpu.decode import lm as JLM
from ssak_tpu.decode import table_cache as JTC
from ssak_tpu_torch.decode import ctc_beam as TB
from ssak_tpu_torch.decode import lexicon as TLx
from ssak_tpu_torch.decode import lm as TLM
from ssak_tpu_torch.decode import table_cache as TTC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHABET = "abcdefghijklmnopqrstuvwxyz"
VOCAB = ["<pad>", "|"] + list(ALPHABET) + ["'", "-", "1", "2"]  # V = 32
B, T, K = 3, 60, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Seeded log-probs (B, T, V) with frame lengths (a full row, a shorter
    one, a batch-pad row of -1 frames), a 40-word lexicon, a word 3-gram and
    a char 2-gram trained on seeded sentences, each package's own copy."""
    rng = np.random.RandomState(0)
    lp = (rng.randn(B, T, len(VOCAB)) * 3).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    fl = np.array([T, 45, -1], np.int32)
    words = sorted({"".join(ALPHABET[i] for i in rng.randint(0, 26, rng.randint(2, 5))) for _ in range(40)})
    sentences = [" ".join(rng.choice(words, size=rng.randint(2, 6))) for _ in range(200)]
    out = {"lp": lp, "fl": fl, "words": words, "sentences": sentences}
    for tag, LM, Lx in (("jax", JLM, JLx), ("torch", TLM, TLx)):
        lex = Lx.Lexicon(words)
        wlm = LM.train_ngram_lm(sentences, order=3)
        clm = LM.train_ngram_lm(sentences, order=2, char_level=True)
        out[tag] = dict(
            lex=lex, wlm=wlm, tables=(*lex.device_tables(VOCAB), lex.node_word_ids()),
            word_tables=LM.word_lm_device_tables(wlm, lex.word_list()),
            char_table=LM.char_lm_table(clm, ["|"] + list(ALPHABET), order=2)[0],
        )
    return out


DEVICE_MODES = ("plain", "char_lm", "lexicon", "lexicon_word_lm")


def _device_kw(s, mode):
    if mode == "char_lm":
        return dict(lm_table=s["char_table"], lm_alpha=0.5)
    if mode == "lexicon":
        return dict(lexicon_tables=s["tables"][:2])
    if mode == "lexicon_word_lm":
        return dict(lexicon_tables=s["tables"], word_lm=s["word_tables"], lm_alpha=0.8, lm_beta=1.2)
    return {}


@pytest.mark.parametrize("mode", DEVICE_MODES)
def test_device_beam_matches_jax(setup, mode):
    lp, fl = setup["lp"], setup["fl"]
    want_t, want_l = JB.ctc_beam_search_device(jnp.asarray(lp), jnp.asarray(fl), beam_width=K,
                                               **_device_kw(setup["jax"], mode))
    handle = TB.ctc_beam_search_device(torch.from_numpy(lp), torch.from_numpy(fl), beam_width=K, return_async=True,
                                       **_device_kw(setup["torch"], mode))
    got_t, got_l = handle.result()
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_t, want_t)
    assert got_l[2] == 0 and got_l[0] > 0  # the batch-pad row emits nothing


@pytest.mark.parametrize("mode", DEVICE_MODES)
def test_device_beam_stops_at_longest_row(setup, mode):
    """The port's loop runs only to the longest row (40 of T = 60 frames
    here); ssak_tpu's scan runs over all T. The frames past every row's
    length change nothing: the same tokens, padded to T."""
    lp, fl = setup["lp"], np.array([40, 31, -1], np.int32)
    want_t, want_l = JB.ctc_beam_search_device(jnp.asarray(lp), jnp.asarray(fl), beam_width=K,
                                               **_device_kw(setup["jax"], mode))
    got_t, got_l = TB.ctc_beam_search_device(torch.from_numpy(lp), torch.from_numpy(fl), beam_width=K,
                                             **_device_kw(setup["torch"], mode))
    assert got_t.shape == (B, T)
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_t, want_t)


HOST_MODES = ("plain", "word_lm", "lexicon", "lexicon_word_lm")


@pytest.mark.parametrize("mode", HOST_MODES)
def test_host_prefix_beam_matches_jax(setup, mode):
    for b in range(2):
        row = setup["lp"][b, : setup["fl"][b]]
        res = {}
        for tag, fn in (("jax", JB.ctc_prefix_beam_search), ("torch", TB.ctc_prefix_beam_search)):
            s = setup[tag]
            kw = {}
            if "word_lm" in mode:
                kw.update(lm=s["wlm"], alpha=0.8, beta=1.2)
            if "lexicon" in mode:
                kw["lexicon"] = s["lex"]
            res[tag] = fn(row, VOCAB, beam_width=K, prune_logp=-20.0, **kw)
        assert res["torch"] == res["jax"]
        assert res["torch"][0][0] or mode == "lexicon"


def test_hashed_lookup_and_mix_match_numpy_and_jax():
    """The device beam's int64 emulation of the uint32 n-gram hash equals
    the numpy hash the tables are built with; every stored n-gram is found
    with its value, absent ones miss."""
    rng = np.random.RandomState(0)
    items = {(int(a), int(b)): float(rng.randn()) for a, b in rng.randint(0, 5000, (3000, 2))}
    tab = TLM.HashedNgrams(items)
    jtab = JLM.HashedNgrams(items)
    np.testing.assert_array_equal(tab.fp, jtab.fp)
    np.testing.assert_array_equal(tab.val, jtab.val)
    assert tab.max_probe == jtab.max_probe
    ids = (rng.randint(-5, 1 << 31, 500), rng.randint(0, 1 << 31, 500), rng.randint(0, 70000, 500))
    with np.errstate(over="ignore"):
        want = TLM._ngram_mix(tuple(np.uint32(i & 0xFFFFFFFF) for i in ids), np.uint32(TLM._H_SEED1), np)
    got = TB._ngram_mix_torch(tuple(torch.from_numpy(i.astype(np.int64)) for i in ids), TLM._H_SEED1)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    keys = list(items)
    dev = {"fp": torch.from_numpy(tab.fp.astype(np.int64)), "val": torch.from_numpy(tab.val)}
    a = torch.tensor([k[0] for k in keys])
    b = torch.tensor([k[1] for k in keys])
    val, hit = TB._hashed_lookup(dev, (a, b), 1.0, tab.max_probe)
    assert bool(hit.all())
    np.testing.assert_array_equal(val.numpy(), np.array([items[k] for k in keys], np.float32))
    _, miss = TB._hashed_lookup(dev, (torch.tensor([9999, 12345]), torch.tensor([9999, 54321])), 1.0, tab.max_probe)
    assert not bool(miss.any())


def test_lexicon_and_lm_tables_match_jax(setup, tmp_path):
    js, ts = setup["jax"], setup["torch"]
    for a, b in zip(ts["tables"], js["tables"]):
        np.testing.assert_array_equal(a, b)
    assert ts["lex"].word_list() == js["lex"].word_list() and len(ts["lex"]) == len(js["lex"])
    np.testing.assert_array_equal(ts["char_table"], js["char_table"])
    assert ts["wlm"].table == js["wlm"].table and ts["wlm"].order == js["wlm"].order
    for k in ("order", "bos", "pad", "n_words"):
        assert ts["word_tables"][k] == js["word_tables"][k]
    for k in ("uni", "uni_backoff"):
        np.testing.assert_array_equal(ts["word_tables"][k], js["word_tables"][k])
    for k in ("bi", "bi_backoff", "tri"):
        np.testing.assert_array_equal(ts["word_tables"][k].fp, js["word_tables"][k].fp)
        np.testing.assert_array_equal(ts["word_tables"][k].val, js["word_tables"][k].val)
        assert ts["word_tables"][k].max_probe == js["word_tables"][k].max_probe
    # ARPA files written by both packages, and read back by both
    pj, pt = tmp_path / "j.arpa", tmp_path / "t.arpa"
    JLM.write_arpa(js["wlm"], str(pj))
    TLM.write_arpa(ts["wlm"], str(pt))
    assert pt.read_text() == pj.read_text()
    assert TLM.ArpaLM(str(pt)).table == JLM.ArpaLM(str(pj)).table
    assert TLM.arpa_order(str(pt)) == JLM.arpa_order(str(pj)) == 3
    ctx = ("<s>", setup["words"][0])
    assert TLM.ArpaLM(str(pt)).sentence_logprob(setup["words"][:4]) == JLM.ArpaLM(str(pj)).sentence_logprob(setup["words"][:4])
    assert TLM.ArpaLM(str(pt)).score("zzz", ctx) == JLM.ArpaLM(str(pj)).score("zzz", ctx)
    lx = tmp_path / "lexicon.txt"
    lx.write_text("\n".join(f"{w} {' '.join(w)}" for w in setup["words"]) + "\n")  # Kaldi lexicon.txt columns
    assert TLx.Lexicon.from_file(str(lx)).words == JLx.Lexicon.from_file(str(lx)).words


def test_table_cache_matches_jax_and_hits(setup, tmp_path, monkeypatch):
    monkeypatch.setenv("SSAK_TPU_CACHE", str(tmp_path / "jax"))
    monkeypatch.setattr(TTC, "CACHE_DIR", str(tmp_path / "torch"))
    lx, arpa = tmp_path / "lexicon.txt", tmp_path / "lm.arpa"
    lx.write_text("\n".join(setup["words"]) + "\n")
    TLM.write_arpa(setup["torch"]["wlm"], str(arpa))
    jl, tl = JLx.Lexicon.from_file(str(lx)), TLx.Lexicon.from_file(str(lx))
    want = JTC.lexicon_tables_cached(jl, str(lx), VOCAB)
    for _ in range(2):  # miss (build + write), then hit (read back)
        got = TTC.lexicon_tables_cached(tl, str(lx), VOCAB)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    wj = JTC.word_lm_tables_cached(lambda: JLM.ArpaLM(str(arpa)), str(arpa), jl.word_list())
    for parse in (lambda: TLM.ArpaLM(str(arpa)), lambda: pytest.fail("cache miss on identical inputs")):
        wt = TTC.word_lm_tables_cached(parse, str(arpa), tl.word_list())
        for k in ("order", "bos", "pad", "n_words"):
            assert wt[k] == wj[k]
        for k in ("bi", "bi_backoff", "tri"):
            np.testing.assert_array_equal(wt[k].fp, wj[k].fp)
            np.testing.assert_array_equal(wt[k].val, wj[k].val)
            assert wt[k].max_probe == wj[k].max_probe
    assert len(os.listdir(tmp_path / "torch")) == 2
    bad = os.path.join(tmp_path / "torch", sorted(os.listdir(tmp_path / "torch"))[0])
    with open(bad, "wb") as f:
        f.write(b"PK\x03\x04 not an npz")
    TTC.lexicon_tables_cached(tl, str(lx), VOCAB)  # an unreadable cache file is rebuilt
    TTC.word_lm_tables_cached(lambda: TLM.ArpaLM(str(arpa)), str(arpa), tl.word_list())


def _need_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")


def _kaldi(tmp_path, lengths=(12000, 40000, 20000)):
    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(1)
    with open(tmp_path / "wav.scp", "w") as f:
        for i, n in enumerate(lengths):
            p = tmp_path / f"utt{i}.wav"
            save_audio(str(p), (rng.randn(n) * 0.1).astype(np.float32), 16000)
            f.write(f"utt{i} {p}\n")
    return str(tmp_path)


def test_ctc_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    _need_gpu_less_host()
    from ssak_tpu_torch.infer.ctc_infer import ctc_infer
    from ssak_tpu_torch.infer.general import load_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(None, seeded_test_config="wav2vec2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctc_infer(None, [np.zeros(1600, np.float32)], seeded_test_config="wav2vec2")  # raises at the call
    with pytest.raises(ValueError, match="torchrun"):  # tensor parallelism needs a process group of 2 ranks
        ctc_infer(None, [np.zeros(1600, np.float32)], seeded_test_config="wav2vec2", tensor_parallel=2, device="cpu")
    # the pool (a greedy run takes none) and quantized models are ported: they run when the CPU is asked for
    for kw in (dict(num_workers=2), dict(quantize_bits=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctc_infer(None, [np.zeros(1600, np.float32)], seeded_test_config="wav2vec2", **kw)
        assert len(list(ctc_infer(None, [np.zeros(1600, np.float32)], seeded_test_config="wav2vec2", device="cpu",
                                  **kw))) == 1


def test_ctc_cli_on_cpu_when_asked_and_refused_without_a_card(tmp_path):
    """One line per file on --device cpu (the seeded tiny wav2vec2, greedy);
    without --device it refuses to start. One intra-op thread: beside other
    test workers torch's thread pool oversubscribes the host's cores."""
    _need_gpu_less_host()
    d = _kaldi(tmp_path)
    cmd = [sys.executable, "-m", "ssak_tpu_torch.infer.ctc_infer", d, "none", "--seeded_test_config", "wav2vec2"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert [ln.split()[0] for ln in out.stdout.strip().splitlines()] == ["utt0", "utt1", "utt2"]
    refused = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert refused.returncode != 0 and "no CUDA device" in refused.stderr and not refused.stdout.strip()
