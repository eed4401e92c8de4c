"""The port's utils/gender and utils/language against ssak_tpu's on the CPU.

Exact (the same NumPy and Python code): the F0 estimate, predict_gender's
labels and probabilities from the pitch heuristic, predict_gender_kaldi_dir's
votes and spk2gender file, detect_language / check_language /
is_hate_speech over one list of sentences, and translate_language against a
local LibreTranslate-style stub (the same answers and the same requests;
without an endpoint both raise by name). classify_speech runs a 2-layer f32
wav2vec2 with a classifier head, one seeded tree in both packages: the
probabilities agree to 1e-5 (f32 sums in another order), and the
classifier leaf crosses models/convert both ways unchanged."""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

import jax

import ssak_tpu.utils.gender as JG
import ssak_tpu.utils.language as JL
import ssak_tpu_torch.utils.gender as TG
import ssak_tpu_torch.utils.language as TL
from ssak_tpu.infer.general import LoadedModel as JLoaded
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu_torch.audio import save_audio
from ssak_tpu_torch.infer.general import LoadedModel as TLoaded
from ssak_tpu_torch.infer.general import ModelType
from ssak_tpu_torch.models import wav2vec2 as TW
from ssak_tpu_torch.models.convert import wav2vec2_from_tree, wav2vec2_to_tree

SR = 16000


def voice(f0, seconds, seed, noise=0.01):
    """Harmonics of f0 with a slow vibrato and a little noise (a voiced
    vowel's pitch for the autocorrelation), or noise alone at f0 = 0."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = noise * rng.randn(len(t))
    if f0:
        phase = 2 * np.pi * f0 * (t + 0.002 * np.sin(2 * np.pi * 3 * t))
        x += sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
    return x.astype(np.float32)


VOICES = [(95.0, 1.0), (120.0, 0.7), (158.0, 1.2), (163.0, 0.9), (210.0, 1.0), (255.0, 0.5), (0.0, 0.8), (180.0, 0.02)]


@pytest.mark.parametrize("i", range(len(VOICES)))
def test_predict_gender_heuristic_matches_jax(i):
    audio = voice(*VOICES[i], seed=i)
    assert TG.estimate_f0_autocorr(audio) == JG.estimate_f0_autocorr(audio)
    assert TG.predict_gender(audio) == JG.predict_gender(audio)
    assert TG.predict_gender(audio, return_proba=True) == JG.predict_gender(audio, return_proba=True)
    assert TG.predict_gender(audio, sample_rate=8000, return_proba=True) == JG.predict_gender(
        audio, sample_rate=8000, return_proba=True)


def test_heuristic_labels_by_pitch():
    assert TG.predict_gender(voice(110.0, 1.0, 0)) == "m" and TG.predict_gender(voice(230.0, 1.0, 1)) == "f"
    assert TG.predict_gender(voice(0.0, 1.0, 2), return_proba=True) == {"m": 0.5, "f": 0.5}


def _kaldi_dir(root):
    """Three speakers, one of them with a segments file's windows; ids out
    of order."""
    root.mkdir()
    wav, utt2spk, segs = [], [], []
    for i, (f0, secs) in enumerate([(100.0, 1.0), (110.0, 0.8), (220.0, 1.0), (240.0, 0.6), (150.0, 0.9)]):
        p = root / f"r{i}.wav"
        save_audio(str(p), voice(f0, secs, seed=10 + i), SR)
        wav.append(f"r{i} {p}")
    for i, spk in enumerate(["spkA", "spkA", "spkB", "spkB", "spkC"]):
        utt2spk.append(f"u{4 - i} {spk}")
        segs.append(f"u{4 - i} r{i} 0.05 0.45")
    (root / "wav.scp").write_text("\n".join(wav[::-1]) + "\n")
    (root / "utt2spk").write_text("\n".join(utt2spk) + "\n")
    (root / "segments").write_text("\n".join(segs) + "\n")
    return str(root)


def test_predict_gender_kaldi_dir_matches_jax(tmp_path):
    d = _kaldi_dir(tmp_path / "kaldi")
    got = TG.predict_gender_kaldi_dir(d, output_path=str(tmp_path / "t_spk2gender"))
    want = JG.predict_gender_kaldi_dir(d, output_path=str(tmp_path / "j_spk2gender"))
    assert got == want and got == {"spkA": "m", "spkB": "f", "spkC": "m"}
    assert (tmp_path / "t_spk2gender").read_bytes() == (tmp_path / "j_spk2gender").read_bytes()
    assert TG.predict_gender_kaldi_dir(d) == want  # no file asked for


SENTENCES = [
    "", "   ", "Bonjour à tous, c'est une belle journée pour aller à la plage avec des amis.",
    "The quick brown fox jumps over the lazy dog and this is what it was.",
    "El perro de mi vecino es más grande que el gato, pero está enfermo.",
    "Der Hund ist nicht im Haus, er ist auf der Straße mit dem Kind.",
    "Il cane è nella casa della nonna, ma non è felice con questo.",
    "Привет, как дела? Всё хорошо.", "مرحبا كيف حالك اليوم", "12345 !!! ???", "ok", "xyz qwv",
    "Je suis là, the end of the story est pas mal.", "C'est un connard, vraiment.", "what the fuck is this",
    "Salut les amis, la pute de ta mère", "a la",
]


@pytest.mark.parametrize("text", SENTENCES)
def test_language_functions_match_jax(text):
    assert TL.detect_language(text) == JL.detect_language(text)
    assert TL.detect_language(text, candidates=["fr", "en", "xx"]) == JL.detect_language(text, candidates=["fr", "en", "xx"])
    for lang in ("fr", "en", "es-ES", "de", "ru", "ar", "it", "pt"):
        for thr in (0.3, 0.05):
            assert TL.check_language(text, lang, thr) == JL.check_language(text, lang, thr)
    for lang in ("fr", "en", "fr-FR"):
        assert TL.is_hate_speech(text, lang) == JL.is_hate_speech(text, lang)


@pytest.fixture()
def translate_server():
    """A LibreTranslate-style stub of POST /translate that tags each text
    with its target and source, and records every request."""
    seen = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen.append((self.path, self.headers["Content-Type"], body))
            data = json.dumps({"translatedText": f"[{body['source']}>{body['target']}] {body['q'][::-1]}"}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}/translate", seen
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_translate_language_matches_jax(translate_server, monkeypatch):
    url, seen = translate_server
    outs = []
    for mod in (TL, JL):
        seen.clear()
        got = [mod.translate_language("bonjour à tous", "en", endpoint=url),
               mod.translate_language(["un", "deux trois"], "de", src="fr", endpoint=url)]
        monkeypatch.setenv("SSAK_TRANSLATE_ENDPOINT", url)
        got.append(mod.translate_language("salut", "es"))
        monkeypatch.delenv("SSAK_TRANSLATE_ENDPOINT")
        outs.append((got, list(seen)))
    assert outs[0] == outs[1]
    assert outs[0][0][0] == "[auto>en] suot à ruojnob" and outs[0][0][1] == ["[fr>de] nu", "[fr>de] siort xued"]
    for mod in (TL, JL):
        with pytest.raises(RuntimeError, match="SSAK_TRANSLATE_ENDPOINT"):
            mod.translate_language("x", "en")


def _classifier_tree(seed=0):
    cfg = JW.make_config("tiny_test", dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, JW.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    tree["classifier"] = {"kernel": (rng.randn(cfg.hidden_size, 2) * 0.5).astype(np.float32),
                          "bias": (rng.randn(2) * 0.1).astype(np.float32)}
    return tree, cfg


def test_classifier_leaf_crosses_convert_both_ways():
    tree, _ = _classifier_tree()
    module = wav2vec2_from_tree(tree)
    assert module.classifier is not None
    back = wav2vec2_to_tree(module)
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(back["classifier"][k], tree["classifier"][k])
    del tree["classifier"]
    assert wav2vec2_from_tree(tree).classifier is None and "classifier" not in wav2vec2_to_tree(wav2vec2_from_tree(tree))


@pytest.mark.parametrize("f0,seconds", [(110.0, 1.5), (220.0, 0.6), (0.0, 1.0)])
def test_classify_speech_matches_jax(f0, seconds):
    tree, jcfg = _classifier_tree(seed=1)
    jmodel = JLoaded("wav2vec2_ctc", tree, jcfg, None)
    tmodel = TLoaded(ModelType.WAV2VEC2_CTC, wav2vec2_from_tree(tree), TW.make_config("tiny_test", dtype="float32"), "cpu")
    audio = voice(f0, seconds, seed=int(f0))
    got, want = TG.classify_speech(tmodel, audio), JG.classify_speech(jmodel, audio)
    assert list(got) == list(want) == ["m", "f"]
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-5, (got, want)
    assert abs(sum(got.values()) - 1.0) <= 1e-6
    assert 0.01 < got["m"] < 0.99  # the seeded head does not saturate: the comparison means something
    labels = ("a", "b")
    assert list(TG.classify_speech(tmodel, audio, labels)) == list(labels)
    for mod, model in ((TG, tmodel), (JG, jmodel)):
        assert mod.predict_gender(audio, model=model) == ("f" if want["f"] >= want["m"] else "m")
    tp, jp = TG.predict_gender(audio, model=tmodel, return_proba=True), JG.predict_gender(audio, model=jmodel, return_proba=True)
    assert tp.keys() == jp.keys() and all(abs(tp[k] - jp[k]) <= 1e-5 for k in tp)


def test_classify_speech_needs_a_head():
    tree, _ = _classifier_tree()
    del tree["classifier"]
    model = TLoaded(ModelType.WAV2VEC2_CTC, wav2vec2_from_tree(tree), TW.make_config("tiny_test", dtype="float32"), "cpu")
    with pytest.raises(ValueError, match="classifier"):
        TG.classify_speech(model, np.zeros(8000, np.float32))
