"""The port's alignment slice (ssak_tpu_torch.ops.ctc.ctc_alignment_trellis,
align/{forced,dtw,vad,nn_vad} and the align_audio_transcript /
get_word_positions tools) against ssak_tpu's on the CPU, on numpy inputs
from a seed.

Tolerances: the trellis with use_max=True takes only max, add and gather,
so its values and path are bit for bit ssak_tpu's; with use_max=False the
log-sum-exp of three terms sums in another order (1e-6 relative, 1e-4
absolute; the path equal). Segment frames are equal and scores within 1e-6
(a mean of f32 probabilities). The NN VAD: its convolutions and products
sum in other orders, so probabilities and trained weights agree to 1e-5 /
1e-4. The tools run a tiny f32 wav2vec2 (tiny_test widths) whose weights
are ssak_tpu's seeded tree moved across; its log-probs agree to 5e-5, and
the cuts (frame boundaries times the frame ratio) are the same."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssak_tpu.infer.ctc_infer as JCI
import ssak_tpu.infer.general as JG
import ssak_tpu_torch.infer.ctc_infer as TCI
import ssak_tpu_torch.infer.general as TG
from ssak_tpu.align import dtw as JD
from ssak_tpu.align import forced as JF
from ssak_tpu.align import nn_vad as JN
from ssak_tpu.align import vad as JV
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu.models.tokenizer import CTCTokenizer as JTokenizer
from ssak_tpu.ops.ctc import ctc_alignment_trellis as jax_trellis
from ssak_tpu_torch.align import dtw as TD
from ssak_tpu_torch.align import forced as TF
from ssak_tpu_torch.align import nn_vad as TN
from ssak_tpu_torch.align import vad as TV
from ssak_tpu_torch.audio import save_audio
from ssak_tpu_torch.models import wav2vec2 as TW
from ssak_tpu_torch.ops.ctc import ctc_alignment_trellis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CHUNK = 48000  # 3 s: a 7 s recording is three chunks
SMALL_BUCKETS = (8000, 16000, SMALL_CHUNK)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Loops of small ops: one intra-op thread keeps the file's time beside
    other test workers (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _log_probs(rng, T, V, sharp=1.0):
    x = (rng.randn(T, V) * sharp).astype(np.float32)
    return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)


# --- the trellis ----------------------------------------------------------------------------

TRELLIS_CASES = {
    "generic": (50, [3, 1, 4, 1, 5, 2, 6, 2, 7], 8),
    "one_label": (40, [3], 5),
    "repeats": (60, [2, 2, 3, 3, 3, 1, 2, 2], 4),
    "t_equals_u": (12, [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3, 4], 5),
    "t_equals_2u_plus_1_repeats": (9, [1, 1, 2, 2], 3),
}


@pytest.mark.parametrize("use_max", [True, False])
@pytest.mark.parametrize("case", sorted(TRELLIS_CASES))
def test_trellis_matches_jax(case, use_max):
    T, tokens, V = TRELLIS_CASES[case]
    lp = _log_probs(np.random.RandomState(len(case)), T, V)
    tokens = np.asarray(tokens, np.int32)
    jt, jp = jax_trellis(jnp.asarray(lp), jnp.asarray(tokens), blank_id=0, use_max=use_max)
    tt, tp = ctc_alignment_trellis(torch.from_numpy(lp), tokens, blank_id=0, use_max=use_max)
    assert tt.shape == (T, 2 * len(tokens) + 1) and tt.dtype == torch.float32
    if use_max:
        assert np.array_equal(tt.numpy(), np.asarray(jt))
    else:
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-4)
    assert np.array_equal(tp.numpy(), np.asarray(jp))


def test_trellis_ties_take_the_first_maximum():
    """Equal log-probs everywhere: every step ties, and both packages keep
    [stay, prev1, prev2]'s first maximum and end on S - 1 on a tie."""
    lp = np.full((10, 4), np.log(0.25), np.float32)
    tokens = np.asarray([1, 2, 3], np.int32)
    jt, jp = jax_trellis(jnp.asarray(lp), jnp.asarray(tokens))
    tt, tp = ctc_alignment_trellis(torch.from_numpy(lp), tokens)
    assert np.array_equal(tt.numpy(), np.asarray(jt)) and np.array_equal(tp.numpy(), np.asarray(jp))


def test_trellis_blank_at_another_id():
    lp = _log_probs(np.random.RandomState(3), 30, 6)
    tokens = np.asarray([0, 1, 1, 2, 4], np.int32)
    jt, jp = jax_trellis(jnp.asarray(lp), jnp.asarray(tokens), blank_id=5)
    tt, tp = ctc_alignment_trellis(torch.from_numpy(lp), tokens, blank_id=5)
    assert np.array_equal(tt.numpy(), np.asarray(jt)) and np.array_equal(tp.numpy(), np.asarray(jp))


# --- forced alignment -----------------------------------------------------------------------

VOCAB = ["<pad>", "<s>", "</s>", "<unk>", "|"] + list("abcdefghijklmnopqrstuvwxyz'-éèàùâêîôûç")


def _same_segments(got, want, score_tol=1e-6):
    assert [(s.label, s.start, s.end) for s in got] == [(s.label, s.start, s.end) for s in want]
    np.testing.assert_allclose([s.score for s in got], [s.score for s in want], rtol=0, atol=score_tol)


@pytest.mark.parametrize("use_max", [True, False])
@pytest.mark.parametrize("sharp", [1.0, 4.0])
def test_compute_alignment_matches_jax(use_max, sharp):
    rng = np.random.RandomState(int(sharp))
    lp = _log_probs(rng, 160, len(VOCAB), sharp)
    text = "le chat mange une souris verte"
    jc, jw = JF.compute_alignment(lp, text, VOCAB, use_max=use_max)
    tc, tw = TF.compute_alignment(lp, text, VOCAB, use_max=use_max)
    _same_segments(tc, jc)
    _same_segments(tw, jw)
    assert [w.label for w in tw] == text.split()
    # a tensor in: the trellis runs on its device (here the CPU), the same segments
    tc2, tw2 = TF.compute_alignment(torch.from_numpy(lp), text, VOCAB, use_max=use_max)
    _same_segments(tc2, jc)
    # a numpy array and a device: the trellis there, the scores from the array
    tc3, tw3 = TF.compute_alignment(lp, text, VOCAB, use_max=use_max, device="cpu")
    _same_segments(tc3, jc)
    _same_segments(tw3, jw)


def test_compute_alignment_uniform_when_frames_are_fewer_than_labels():
    """T < U: ssak_tpu's uniform fallback (score 0), not the trellis."""
    lp = _log_probs(np.random.RandomState(4), 7, len(VOCAB))
    jc, jw = JF.compute_alignment(lp, "bonjour tout le monde", VOCAB)
    tc, tw = TF.compute_alignment(lp, "bonjour tout le monde", VOCAB)
    _same_segments(tc, jc)
    _same_segments(tw, jw)
    assert all(s.score == 0.0 for s in tc)
    assert TF.compute_alignment(lp, "", VOCAB) == JF.compute_alignment(lp, "", VOCAB) == ([], [])


def test_compute_alignment_skipped_labels():
    """Log-probs that push the Viterbi path past some labels: those get an
    empty segment at the previous end (score 0), in both packages."""
    rng = np.random.RandomState(5)
    lp = _log_probs(rng, 40, len(VOCAB), 6.0)
    lp[:, VOCAB.index("z")] = -60.0
    text = "zaza zozo"
    jc, jw = JF.compute_alignment(lp, text, VOCAB)
    tc, tw = TF.compute_alignment(lp, text, VOCAB)
    _same_segments(tc, jc)
    _same_segments(tw, jw)


@pytest.mark.parametrize("fallback", [None, "<unk>", "?"])
def test_tokenize_transcript_matches_jax(fallback):
    """Upper case, accents only the transliteration knows (ñ, Ö, œ), chars
    the vocabulary lacks, with and without a fallback char."""
    text = "Élan NOËL ñandú Ökonom œuvre 42 % x"
    ji, jc = JF.tokenize_transcript(text, VOCAB, fallback_char=fallback)
    ti, tc = TF.tokenize_transcript(text, VOCAB, fallback_char=fallback)
    assert ti.dtype == np.int32 and np.array_equal(ti, ji) and tc == jc


def test_merge_words_and_seconds_match_jax():
    segs = [("a", 0, 2, 0.5), ("b", 2, 2, 0.0), ("|", 2, 3, 0.9), (" ", 3, 3, 0.1), ("c", 3, 6, 0.25), ("|", 6, 7, 1.0)]
    jw = JF.merge_words([JF.Segment(*s) for s in segs])
    tw = TF.merge_words([TF.Segment(*s) for s in segs])
    _same_segments(tw, jw, 0.0)
    _same_segments([w.to_seconds(0.02) for w in tw], [w.to_seconds(0.02) for w in jw], 0.0)


# --- dtw and Levenshtein ------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_dtw_and_levenshtein_match_jax(seed):
    rng = np.random.RandomState(seed)
    words = ["le", "la", "les", "chat", "chien", "chats", "mange", "mangent", "une", "souris", "vite", "verte"]
    ref = " ".join(rng.choice(words, 30))
    r = ref.split()
    start = rng.randint(0, 20)
    query = r[start : start + rng.randint(3, 9)]
    if seed % 2:
        query = query + ["intrus"]
        query[0] = query[0][:-1] or "x"
    query = " ".join(query)
    assert TD.find_best_position_dtw(query, ref) == JD.find_best_position_dtw(query, ref)
    assert TD.find_best_position_levenshtein(query, ref) == JD.find_best_position_levenshtein(query, ref)
    assert np.array_equal(TD.word_distance_matrix(query.split(), r), JD.word_distance_matrix(query.split(), r))
    assert TD.find_best_position_dtw("", ref) == JD.find_best_position_dtw("", ref)


# --- VAD ----------------------------------------------------------------------------------

def _speechy(seed, seconds=3.0, sr=16000):
    """Bursts of tones between near-silences."""
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    x = 0.001 * rng.randn(n)
    t = np.arange(n) / sr
    for _ in range(4):
        a = rng.randint(0, n - sr // 2)
        b = a + rng.randint(sr // 10, sr // 2)
        x[a:b] += 0.3 * np.sin(2 * np.pi * rng.uniform(150, 600) * t[a:b])
    return x.astype(np.float32)


@pytest.mark.parametrize("sr", [16000, 8000])
def test_energy_vad_matches_jax(sr):
    audio = _speechy(sr, sr=sr)
    for kw in ({}, dict(min_silence_duration=0.05, dilatation=0.0), dict(energy_threshold_db=-20.0)):
        assert TV.get_vad_segments(audio, sr, **kw) == JV.get_vad_segments(audio, sr, **kw)
    ta, tm = TV.remove_non_speech(audio, sr)
    ja, jm = JV.remove_non_speech(audio, sr)
    assert np.array_equal(ta, ja) and tm == jm
    ts = [{"start": 0.1, "end": 0.4, "w": "a"}, {"start": 0.5, "end": 9.0}]
    assert TV.convert_timestamps(ts, tm) == JV.convert_timestamps(ts, jm)
    quiet = np.zeros(sr, np.float32)
    assert TV.remove_non_speech(quiet, sr)[1] == JV.remove_non_speech(quiet, sr)[1]
    with pytest.raises(NotImplementedError):
        TV.get_vad_segments(audio, sr, method="silero")


@pytest.fixture(scope="module")
def vad_trees():
    """ssak_tpu's seeded VAD params and the port's model of them on the CPU."""
    params = JN.init_params(jax.random.PRNGKey(0))
    return params, TN.vad_from_tree(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def test_nn_vad_probs_and_segments_match_jax(vad_trees):
    params, model = vad_trees
    for sr in (16000, 8000):
        audio = _speechy(7, 1.0, sr)
        got, want = TN.speech_probs(model, audio, sr), JN.speech_probs(params, audio, sr)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    audio = _speechy(8, 1.0)  # the shape above: ssak_tpu's jitted model compiles once
    thr = float(np.median(JN.speech_probs(params, audio)))  # a threshold that splits the seeded model's track
    kw = dict(method="nn", nn_threshold=thr, min_speech_duration=0.0, min_silence_duration=0.0, dilatation=0.0)
    assert TV.get_vad_segments(audio, nn_params=model, **kw) == JV.get_vad_segments(audio, nn_params=params, **kw)
    with pytest.raises(ValueError):
        TV.get_vad_segments(audio, method="nn")


def test_train_nn_vad_matches_jax():
    """2 Adam steps on energy-bootstrapped labels from ssak_tpu's seeded init
    (moved across): the same weights to 1e-4; and given labels."""
    audios = [_speechy(s, 0.6) for s in (1, 2)]
    want = JN.train_nn_vad(audios, steps=2, seed=0)
    init = TN.vad_from_tree(jax.tree_util.tree_map(np.asarray, JN.init_params(jax.random.PRNGKey(0), n_mels=40)),
                            device="cpu")
    got = TN.train_nn_vad(audios, steps=2, seed=0, device="cpu", params=init)
    _close_trees(TN.vad_to_tree(got), jax.tree_util.tree_map(np.asarray, want), 1e-4)
    labels = [np.arange(60) % 2, np.ones(40)]
    want = JN.train_nn_vad(audios, labels=labels, steps=2, seed=1)
    init = TN.vad_from_tree(jax.tree_util.tree_map(np.asarray, JN.init_params(jax.random.PRNGKey(1), n_mels=40)),
                            device="cpu")
    got = TN.train_nn_vad(audios, labels=labels, steps=2, seed=1, device="cpu", params=init)
    _close_trees(TN.vad_to_tree(got), jax.tree_util.tree_map(np.asarray, want), 1e-4)
    with pytest.raises(ValueError):
        TN.train_nn_vad(audios, bootstrap=False, steps=1, device="cpu")


def _close_trees(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _close_trees(got[k], want[k], tol)
        else:
            assert got[k].shape == np.shape(want[k]), k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def test_vad_npz_files_read_both_ways(vad_trees, tmp_path):
    params, model = vad_trees
    TN.save_vad(model, str(tmp_path / "t.npz"))
    back = JN.load_vad(str(tmp_path / "t.npz"))
    _close_trees(jax.tree_util.tree_map(np.asarray, back), jax.tree_util.tree_map(np.asarray, params), 0.0)
    with np.load(tmp_path / "t.npz") as z:
        assert sorted(z.files) == sorted("/".join(k) for k, _ in JN._flatten(params))
    JN.save_vad(params, str(tmp_path / "j.npz"))
    got = TN.load_vad(str(tmp_path / "j.npz"), device="cpu")
    _close_trees(TN.vad_to_tree(got), jax.tree_util.tree_map(np.asarray, params), 0.0)


# --- the tools ------------------------------------------------------------------------------

def _jax_tool(name):
    """tools/<name>.py, the JAX package's CLI, imported from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def models():
    """(ssak_tpu LoadedModel, port LoadedModel on the CPU), same f32 weights."""
    jcfg = JW.make_config("tiny_test", dtype="float32")
    params = JW.init_params(jax.random.PRNGKey(0), jcfg)
    tok = TG.seeded_ctc_tokenizer(jcfg.vocab_size)
    jm = JG.LoadedModel(JG.ModelType.WAV2VEC2_CTC, params, jcfg, JTokenizer(dict(tok.vocab)))
    tm = TG.from_tree(jax.tree_util.tree_map(np.asarray, params), TW.make_config("tiny_test", dtype="float32"),
                      device="cpu")
    return jm, tm


@pytest.fixture
def served(models, monkeypatch):
    jm, tm = models
    monkeypatch.setattr(JG, "load_model", lambda *a, **k: jm)
    monkeypatch.setattr(TG, "load_model", lambda *a, **k: tm)
    for mod in (JCI, TCI):
        monkeypatch.setattr(mod, "MAX_CHUNK_SAMPLES", SMALL_CHUNK)
        monkeypatch.setattr(mod, "_BUCKETS_SAMPLES", SMALL_BUCKETS)
    return jm, tm


WORDS = ["le", "chat", "dort", "sur", "la", "table", "verte", "une", "souris", "passe", "vite", "très"]


def _align_dir(root, seed=0):
    """Recordings of 7.0, 5.5 and 2.0 s (tones + noise) with French text,
    the 5.5 s one under a segments file of two utterances."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    scp, text, segs, spk = [], [], [], []
    for rec, secs in (("r0", 7.0), ("r1", 5.5), ("r2", 2.0)):
        n = int(secs * 16000)
        t = np.arange(n) / 16000.0
        audio = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t) + 0.05 * rng.randn(n)
        save_audio(os.path.join(root, f"{rec}.wav"), audio.astype(np.float32), 16000)
        scp.append(f"{rec} {root}/{rec}.wav")
    for utt, rec, s, e in (("u0", "r0", 0.0, 7.0), ("u1", "r1", 0.3, 4.8), ("u2", "r1", 4.8, 5.5), ("u3", "r2", 0.0, 2.0)):
        segs.append(f"{utt} {rec} {s:.2f} {e:.2f}")
        n_words = max(1, int((e - s) * 2.5))
        text.append(f"{utt} " + " ".join(rng.choice(WORDS, n_words)).capitalize() + ".")
        spk.append(f"{utt} spk{rec}")
    for name, lines in (("wav.scp", scp), ("text", text), ("segments", segs), ("utt2spk", spk)):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return str(root)


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), encoding="utf-8") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("max_duration", [2.0, 3.5])
def test_split_long_audio_kaldifolder_matches_jax(served, tmp_path, max_duration):
    """The cuts of ssak_tpu's tools/align_audio_transcript.py, file for
    file (the 7 s recording runs three 3 s chunks), and a Kaldi dir that
    check_kaldi_dir keeps whole."""
    src = _align_dir(tmp_path / "in")
    jtool = _jax_tool("align_audio_transcript")
    from ssak_tpu_torch.tools import align_audio_transcript as ttool

    jrep = jtool.split_long_audio_kaldifolder(src, str(tmp_path / "jax"), "m", max_duration=max_duration)
    trep = ttool.split_long_audio_kaldifolder(src, str(tmp_path / "port"), "m", max_duration=max_duration,
                                              device="cpu")
    assert trep == jrep and not trep["removed_utts"]
    jf, tf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert tf == jf
    cuts = [ln.split() for ln in tf["segments"].splitlines()]
    assert any("_cut" in c[0] for c in cuts)
    assert all(0.0 <= float(c[2]) < float(c[3]) <= 7.0 for c in cuts)


def test_get_word_positions_matches_jax(served, tmp_path):
    src = _align_dir(tmp_path / "in", seed=1)
    jtool = _jax_tool("get_word_positions")
    from ssak_tpu_torch.tools import get_word_positions as ttool

    jtool.main([src, "--model", "m", "--output", str(tmp_path / "jax.txt")])
    ttool.main([src, "--model", "m", "--output", str(tmp_path / "port.txt"), "--device", "cpu"])
    got, want = (tmp_path / "port.txt").read_text(), (tmp_path / "jax.txt").read_text()
    assert got == want and len(got.splitlines()) >= 8


def test_align_audio_to_transcript_seconds_match_jax(served):
    jm, tm = served
    rng = np.random.RandomState(9)
    audio = (0.2 * rng.randn(100000)).astype(np.float32)  # 6.25 s: three chunks
    text = "une souris passe très vite sur la table"
    want = JF.align_audio_to_transcript(jm, audio, text)
    got = TF.align_audio_to_transcript(tm, audio, text)
    assert [(w.label, w.start, w.end) for w in got] == [(w.label, w.start, w.end) for w in want]
    np.testing.assert_allclose([w.score for w in got], [w.score for w in want], rtol=0, atol=1e-5)


def test_align_cli_on_cpu_and_refused_without_a_card(tmp_path):
    """python -m ssak_tpu_torch.tools.align_audio_transcript on the seeded
    tiny wav2vec2 with --device cpu; without it, on a host without a card,
    it refuses before writing anything."""
    src = _align_dir(tmp_path / "in")
    cmd = [sys.executable, "-m", "ssak_tpu_torch.tools.align_audio_transcript", src, str(tmp_path / "out"),
           "--seeded_test_config", "wav2vec2", "--max_duration", "3"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    from ssak_tpu_torch.data.kaldi import check_kaldi_dir

    report = check_kaldi_dir(str(tmp_path / "out"), fix=False, compute_utt2dur=False)
    assert report["n_utts"] >= 2 and not report["removed_utts"]
    assert any("_cut" in u for u in (tmp_path / "out" / "text").read_text().split())
    if not torch.cuda.is_available():
        refused = subprocess.run(cmd[:4] + [str(tmp_path / "out2")] + cmd[5:], cwd=REPO, capture_output=True,
                                 text=True, timeout=300, env=env)
        assert refused.returncode != 0 and "no CUDA device" in refused.stderr
        assert not (tmp_path / "out2").exists()
