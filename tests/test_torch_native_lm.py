"""The port's C++ n-gram scorer (ssak_tpu_torch.decode.native_lm, its own
copy of ngram.cpp, built by g++ into build/ssak_tpu_torch/) against
ssak_tpu's native scorer and ArpaLM on the CPU.

Tolerances: bit for bit against ssak_tpu's NativeNgramLM (the same source,
compiler and flags, f32 scores); 1e-5 against ArpaLM, which sums the same
log10 terms in Python floats where the library sums f32 (ssak_tpu pins
the same 1e-5, tests/test_native_lm.py); beams identical with either
scorer."""

import os
import shutil

import numpy as np
import pytest

from ssak_tpu.decode import native_lm as JN
from ssak_tpu.decode.ctc_beam import ctc_prefix_beam_search as j_beam
from ssak_tpu_torch.decode import native_lm as TN
from ssak_tpu_torch.decode.ctc_beam import ctc_prefix_beam_search
from ssak_tpu_torch.decode.lm import ArpaLM, train_ngram_lm
from ssak_tpu_torch.ops import _build

if not JN.native_available():
    pytest.skip("ssak_tpu's native LM library is not buildable on this host", allow_module_level=True)


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    """A word 4-gram over a seeded 60-word vocabulary (order > 3: the host
    beam's route in ctc_infer)."""
    rng = np.random.RandomState(5)
    words = sorted({"".join(rng.choice(list("abcdefghij"), size=rng.randint(2, 6))) for _ in range(60)})
    texts = [" ".join(rng.choice(words, size=rng.randint(3, 10))) for _ in range(400)]
    path = str(tmp_path_factory.mktemp("lm") / "lm4.arpa")
    train_ngram_lm(texts, order=4, output_arpa=path)
    return path


def _queries(py):
    """Every n-gram of the ARPA as (word, context), each with an
    out-of-vocabulary word in front, and backoff queries over unseen
    contexts and an unknown word."""
    words = sorted(py.vocab) + ["zzz_oov"]
    qs = []
    for ngram in py.table:
        qs.append((ngram[-1], ngram[:-1]))
        qs.append((ngram[-1], ("oov_ctx",) + ngram[:-1]))
    rng = np.random.RandomState(0)
    for _ in range(3000):
        ctx = tuple(rng.choice(words, size=rng.randint(0, 5)))
        qs.append((str(rng.choice(words)), ctx))
    return qs


def test_scores_match_ssak_tpu_native_bit_for_bit_and_arpa_lm(arpa):
    py, port, ref = ArpaLM(arpa), TN.NativeNgramLM(arpa), JN.NativeNgramLM(arpa)
    assert port.order == ref.order == py.order == 4
    assert len(port) == len(ref) == len(py.table) and port.vocab == ref.vocab == py.vocab
    qs = _queries(py)
    got = np.asarray([port.score(w, c) for w, c in qs], np.float32)
    np.testing.assert_array_equal(got, np.asarray([ref.score(w, c) for w, c in qs], np.float32))
    np.testing.assert_allclose(got, [py.score(w, c) for w, c in qs], atol=1e-5, rtol=0)
    for s in ("a b", "abc", ""):
        words = [w for w in sorted(py.vocab)[:4]] + s.split()
        assert port.sentence_logprob(words) == ref.sentence_logprob(words)
        assert port.sentence_logprob(words) == pytest.approx(py.sentence_logprob(words), abs=1e-4)


def test_score_batch_equals_score(arpa):
    port = TN.NativeNgramLM(arpa)
    qs = _queries(ArpaLM(arpa))[::3]
    batch = port.score_batch([c for _, c in qs], [w for w, _ in qs])
    assert batch.dtype == np.float32
    np.testing.assert_array_equal(batch, np.asarray([port.score(w, c) for w, c in qs], np.float32))
    np.testing.assert_array_equal(batch, JN.NativeNgramLM(arpa).score_batch([c for _, c in qs], [w for w, _ in qs]))


def test_binary_image_round_trip(arpa, tmp_path):
    """save_binary and reload: the same scores; ssak_tpu's library reads
    the port's image and the port's reads ssak_tpu's."""
    port = TN.NativeNgramLM(arpa)
    mine, theirs = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    port.save_binary(mine)
    JN.NativeNgramLM(arpa).save_binary(theirs)
    qs = _queries(ArpaLM(arpa))[::5]
    want = [port.score(w, c) for w, c in qs]
    for lm in (TN.NativeNgramLM(mine), TN.NativeNgramLM(theirs), JN.NativeNgramLM(mine)):
        assert lm.order == 4 and len(lm) == len(port)
        assert [lm.score(w, c) for w, c in qs] == want
    with pytest.raises(IOError):
        TN.NativeNgramLM(str(tmp_path / "missing.arpa"))


def test_prefix_beam_identical_with_either_scorer(arpa):
    """ctc_prefix_beam_search over seeded log-probs: the port's beam with
    its native scorer gives ssak_tpu's beam with ssak_tpu's scorer, and
    the same as the port's beam with ArpaLM."""
    py = ArpaLM(arpa)
    letters = sorted({ch for w in py.vocab if w.isalpha() for ch in w})
    vocab = ["<pad>", "|"] + letters
    rng = np.random.RandomState(9)
    for trial in range(4):
        logits = rng.randn(60, len(vocab)).astype(np.float32) * 3
        logits[::3, 0] += 4  # blanks between letters
        lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        kw = dict(blank_id=0, beam_width=8, alpha=0.8, beta=1.0)
        native = ctc_prefix_beam_search(lp, vocab, lm=TN.NativeNgramLM(arpa), **kw)
        assert native == j_beam(lp, vocab, lm=JN.NativeNgramLM(arpa), **kw)
        assert [t for t, _ in native] == [t for t, _ in ctc_prefix_beam_search(lp, vocab, lm=py, **kw)]
        assert native and native[0][0]


def test_load_lm_routes(arpa, tmp_path):
    import gzip

    assert isinstance(TN.load_lm(arpa), TN.NativeNgramLM)
    assert isinstance(TN.load_lm(arpa, prefer_native=False), ArpaLM)
    gz = str(tmp_path / "lm.arpa.gz")
    with open(arpa, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    lm = TN.load_lm(gz)
    assert isinstance(lm, ArpaLM) and lm.order == 4


def test_library_is_built_from_the_port_source_into_build_dir():
    lib = TN._load_lib()
    path = lib._name
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.basename(path).startswith("libngram-")
    assert TN.SOURCE.startswith(os.path.dirname(TN.__file__)) and os.path.exists(TN.SOURCE)


def test_a_broken_source_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """A source g++ rejects makes load_lm raise; nothing falls back to
    ArpaLM (the library cache is emptied for the test and restored)."""
    bad = tmp_path / "ngram.cpp"
    shutil.copy(TN.SOURCE, bad)
    with open(bad, "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(TN, "SOURCE", str(bad))
    monkeypatch.setattr(TN, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TN.load_lm(__file__)
    assert not os.path.exists(tmp_path / "build") or not any(f.endswith(".so") for f in os.listdir(tmp_path / "build"))
