"""The port's CTC training path (ssak_tpu_torch.train and the data, text,
tokenizer and WER modules it runs) against ssak_tpu on the CPU: train and
eval steps, optimizers against optax, checkpoints read across packages,
`CTCTrainer` of both packages on one numpy-made Kaldi dir, the CLI.

Every comparison runs the tiny_test wav2vec2 in f32 with mask_time_prob=0
(jax.random bits are not reproduced) from one JAX-initialised parameter
tree, converted for the port."""

import json
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu.train import steps as JS
from ssak_tpu_torch.models import wav2vec2 as TW
from ssak_tpu_torch.models.convert import wav2vec2_from_tree, wav2vec2_to_tree
from ssak_tpu_torch.train import optim
from ssak_tpu_torch.train import steps as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD = 1e-3, 0.01


def _cfgs():
    return JW.make_config("tiny_test", dtype="float32"), TW.make_config("tiny_test", dtype="float32")


def _tree(seed=0):
    return jax.tree_util.tree_map(np.asarray, JW.init_params(jax.random.PRNGKey(seed), _cfgs()[0]))


def _batch(seed=0, B=4, n=6400):
    """Ragged audio, ragged labels and one batch-pad dummy row (1 sample,
    label length 0), audio as int16 wire words."""
    rng = np.random.RandomState(seed)
    audio = np.clip(rng.randn(B, n) * 0.1, -1, 1).astype(np.float32)
    lens = np.array([n, 5000, 4000, 1], np.int32)[:B]
    audio[np.arange(n)[None, :] >= lens[:, None]] = 0
    labels = rng.randint(4, 30, (B, 16)).astype(np.int32)
    lab = np.array([5, 7, 3, 0], np.int32)[:B]
    labels[np.arange(16)[None, :] >= lab[:, None]] = 0
    wire = np.rint(audio * 32768).clip(-32768, 32767).astype(np.int16)
    arrays = {"audio": wire, "audio_lengths": lens, "labels": labels, "label_lengths": lab}
    return ({k: jnp.asarray(v) for k, v in arrays.items()}, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()})


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(n_steps):
    cfg, tcfg = _cfgs()
    tree = _tree()
    jb, tb = _batch()
    jopt = JS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10, weight_decay=WD)
    topt = TS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10, weight_decay=WD)
    js, jstep = JS.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), jopt), JS.make_ctc_train_step(cfg, jopt)
    ts, tstep = TS.init_train_state(wav2vec2_from_tree(tree), topt), TS.make_ctc_train_step(tcfg, topt)
    for _ in range(n_steps):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        # f32 on both sides: the loss to f32 rounding of the sums, the norm
        # over ~100k gradient entries to 1e-5
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    assert ts["step"] == int(js["step"]) == n_steps
    ref, got = _leaves(js["params"]), _leaves(wav2vec2_to_tree(ts["model"]))
    # Adam divides each gradient entry by its own running magnitude, so an
    # entry whose gradient is tiny in both packages can move by up to lr
    # (1e-3) either way; hold every parameter to 0.3 lr and the bulk to 1e-6
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(ref, got)])
    assert diffs.max() < 3e-4 and np.median(diffs) < 1e-6
    # the frozen conv stack has zero gradients but still decays, in both
    conv0 = tree["feature_extractor"]["convs"][0]["conv"]["kernel"]
    j0 = np.asarray(js["params"]["feature_extractor"]["convs"][0]["conv"]["kernel"])
    t0 = wav2vec2_to_tree(ts["model"])["feature_extractor"]["convs"][0]["conv"]["kernel"]
    decay = np.prod([1 - LR * WD * (1 - (k - 1) / 9) for k in range(1, n_steps)])  # lr 0 at step 0, then linear decay
    np.testing.assert_allclose(t0, conv0 * decay, rtol=1e-6)
    np.testing.assert_allclose(t0, j0, rtol=1e-6)
    assert n_steps == 1 or not np.array_equal(t0, conv0)


def test_grad_accumulation_matches_jax():
    cfg, tcfg = _cfgs()
    tree = _tree()
    jb, tb = _batch(seed=1)
    jopt = JS.with_grad_accumulation(JS.make_optimizer(learning_rate=LR, warmup_steps=0, total_steps=10, schedule="constant"), 2)
    topt = TS.with_grad_accumulation(TS.make_optimizer(learning_rate=LR, warmup_steps=0, total_steps=10, schedule="constant"), 2)
    js, jstep = JS.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), jopt), JS.make_ctc_train_step(cfg, jopt)
    ts, tstep = TS.init_train_state(wav2vec2_from_tree(tree), topt), TS.make_ctc_train_step(tcfg, topt)
    halves = [({k: v[:2] for k, v in jb.items()}, {k: v[:2] for k, v in tb.items()}),
              ({k: v[2:] for k, v in jb.items()}, {k: v[2:] for k, v in tb.items()})]
    for i, (jh, th) in enumerate(halves):
        js, jm = jstep(js, jh)
        ts, tm = tstep(ts, th)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        got = _leaves(wav2vec2_to_tree(ts["model"]))
        if i == 0:  # no update after the first micro-step
            assert all(np.array_equal(a, b) for a, b in zip(_leaves(tree), got))
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(_leaves(js["params"]), got)])
    assert diffs.max() < 3e-4 and np.median(diffs) < 1e-6  # as in test_train_steps_match_jax
    assert ts["opt_state"]["mini_step"] == 0 and ts["opt_state"]["gradient_step"] == 1


def test_eval_step_matches_jax():
    cfg, tcfg = _cfgs()
    tree = _tree(seed=2)
    jb, tb = _batch(seed=2)
    ref = JS.make_ctc_eval_step(cfg)(jax.tree_util.tree_map(jnp.asarray, tree), jb)
    got = TS.make_ctc_eval_step(tcfg)(wav2vec2_from_tree(tree), tb)
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    np.testing.assert_array_equal(got["token_lengths"].numpy(), np.asarray(ref["token_lengths"]))


# --- optimizers against optax ---------------------------------------------------------


def _opt_case(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"lm_head": {"kernel": (6, 4), "bias": (4,)}, "trunk": {"w": (5, 3), "v": (7,)}}
    params = {g: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()} for g, d in shapes.items()}
    grads = [{g: {k: (rng.randn(*s) * 2).astype(np.float32) for k, s in d.items()} for g, d in shapes.items()}
             for _ in range(4)]
    return params, grads


def _flat(tree):
    return {f"{g}.{k}": torch.from_numpy(np.array(v)) for g, d in tree.items() for k, v in d.items()}


def _run_both(jopt, topt, n=4, lrs=None):
    params, grads = _opt_case()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _flat(params)
    ts = topt.init(tp)
    for i in range(n):
        if lrs is not None:
            js = JS.set_learning_rate(js, lrs[i])
            ts = TS.set_learning_rate(ts, lrs[i])
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads[i]), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(_flat(grads[i]), ts, tp)
        optim.apply_updates(tp, tu)
    for name, t in tp.items():
        g, k = name.split(".")
        # the same f32 arithmetic in another order: a few ulps of the updates
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[g][k]), rtol=1e-6, atol=1e-7, err_msg=name)
    return js, ts


@pytest.mark.parametrize("schedule", ["linear", "cosine", "constant"])
def test_make_optimizer_matches_optax(schedule):
    kw = dict(learning_rate=0.1, weight_decay=0.05, warmup_steps=2, total_steps=6, schedule=schedule, grad_clip=1.5)
    _run_both(JS.make_optimizer(**kw), TS.make_optimizer(**kw))


@pytest.mark.parametrize("schedule", ["linear", "cosine", "constant"])
def test_schedules_match_optax(schedule):
    """Including lr 0 at step 0 under warmup, as optax gives it."""
    for warmup in (0, 3) if schedule != "cosine" else (3,):
        ref = JS.make_optimizer(learning_rate=2e-3, warmup_steps=warmup, total_steps=12, schedule=schedule)
        sched = TS._schedule(schedule, 2e-3, warmup, 12)
        jsched = {"linear": lambda c: optax.join_schedules([optax.linear_schedule(0.0, 2e-3, warmup),
                                                             optax.linear_schedule(2e-3, 0.0, max(1, 12 - warmup))], [warmup])(c),
                  "cosine": optax.warmup_cosine_decay_schedule(0.0, 2e-3, warmup, 12),
                  "constant": optax.join_schedules([optax.linear_schedule(0.0, 2e-3, warmup), optax.constant_schedule(2e-3)],
                                                   [warmup])}[schedule]
        for c in range(15):
            np.testing.assert_allclose(float(sched(c)), float(jsched(jnp.asarray(c))), rtol=1e-6, atol=1e-12)
        assert ref is not None
        if warmup:
            assert float(sched(0)) == 0.0


@pytest.mark.parametrize("kind", ["adamw", "adadelta", "sb_dual"])
def test_newbob_optimizers_and_set_learning_rate_match_optax(kind):
    jopt = JS.make_newbob_optimizer(0.1, optimizer=kind, head_lr=0.5)
    topt = TS.make_newbob_optimizer(0.1, optimizer=kind, head_lr=0.5)
    js, ts = _run_both(jopt, topt, lrs=[0.1, 0.05, 0.05, 0.02])
    assert abs(TS.get_learning_rate(ts) - JS.get_learning_rate(js)) < 1e-9


def test_newbob_accumulated_set_learning_rate():
    jopt = JS.with_grad_accumulation(JS.make_newbob_optimizer(0.1), 2)
    topt = TS.with_grad_accumulation(TS.make_newbob_optimizer(0.1), 2)
    js, ts = _run_both(jopt, topt, lrs=[0.1, 0.1, 0.03, 0.03])
    assert abs(TS.get_learning_rate(ts) - 0.03) < 1e-9


def test_sb_dual_groups_match_optax():
    js, ts = _run_both(JS.make_sb_ctc_optimizer(pretrained_lr=1e-2, head_lr=1.0), TS.make_sb_ctc_optimizer(pretrained_lr=1e-2, head_lr=1.0))
    assert set(ts["1"]) == {"pretrained", "head"}
    assert set(ts["1"]["head"]["0"]["e_g"]) == {"lm_head.kernel", "lm_head.bias"}


def test_newbob_annealing_matches_jax():
    for patient in (0, 1):
        j = JS.NewBob(1.0, improvement_threshold=0.0025, annealing_factor=0.5, patient=patient)
        t = TS.NewBob(1.0, improvement_threshold=0.0025, annealing_factor=0.5, patient=patient)
        for metric in (100.0, 50.0, 49.9, 25.0, 25.0, 25.0, 10.0, 9.999):
            assert t(metric) == j(metric)


# --- checkpoints across packages ----------------------------------------------------------


def test_checkpoints_read_across_packages(tmp_path):
    from ssak_tpu.train import checkpoint as JC
    from ssak_tpu_torch.train import checkpoint as TC

    tree = _tree(seed=4)
    jstate = JS.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), JS.make_optimizer())
    jstate["step"] = jnp.asarray(7, jnp.int32)
    jpath = JC.save_checkpoint(str(tmp_path / "jax"), jstate, metadata={"note": "x"})
    state, meta = TC.load_checkpoint(jpath)
    assert meta["step"] == 7 and int(state["step"]) == 7
    m = TW.init_params(_cfgs()[1], seed=9)
    from ssak_tpu_torch.models.convert import load_wav2vec2_tree_

    load_wav2vec2_tree_(m, state["params"])
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(tree), _leaves(wav2vec2_to_tree(m))))

    tstate = TS.init_train_state(wav2vec2_from_tree(_tree(seed=5)), TS.make_optimizer())
    tstate["step"] = 11
    tpath = TC.save_checkpoint(str(tmp_path / "torch"), tstate, metadata={"note": "y"})
    jback, jmeta = JC.load_checkpoint(tpath)
    assert jmeta["step"] == 11 and int(jback["step"]) == 11
    ref = jax.tree_util.tree_map(np.asarray, JW.init_params(jax.random.PRNGKey(5), _cfgs()[0]))
    assert jax.tree_util.tree_structure(jback["params"]) == jax.tree_util.tree_structure(ref)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(ref), _leaves(jback["params"])))
    # the same npz keys for params and step
    with np.load(os.path.join(jpath, "state.npz")) as zj, np.load(os.path.join(tpath, "state.npz")) as zt:
        keys_j = {k for k in zj.files if not k.startswith("/opt_state")}
        keys_t = {k for k in zt.files if not k.startswith("/opt_state")}
    assert keys_j == keys_t and "/step" in keys_t


def test_checkpoint_rotation_and_optimizer_state_round_trip(tmp_path):
    from ssak_tpu_torch.train import checkpoint as TC

    cfg, tcfg = _cfgs()
    small = TS.init_train_state(TW.init_params(tcfg), TS.make_optimizer())
    for s in (1, 2, 3):
        small["step"] = s
        TC.save_checkpoint(str(tmp_path / "r"), small, save_total_limit=2)
    assert [os.path.basename(c) for c in TC.list_checkpoints(str(tmp_path / "r"))] == ["checkpoint-2", "checkpoint-3"]

    _, tb = _batch(seed=3)
    opt = TS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
    state = TS.init_train_state(wav2vec2_from_tree(_tree()), opt)
    step = TS.make_ctc_train_step(tcfg, opt)
    state, _ = step(state, tb)
    state, _ = step(state, tb)
    path = TC.save_checkpoint(str(tmp_path / "o"), state)
    tree, meta = TC.load_checkpoint(path)
    assert meta["opt_state_format"] == TC.OPT_STATE_FORMAT
    back = TC.opt_state_from_numpy(tree["opt_state"], "cpu")
    mu, mu_back = state["opt_state"]["1"]["0"]["mu"], back["1"]["0"]["mu"]
    assert back["1"]["0"]["count"] == 2 and back["1"]["2"]["count"] == 2 and back["0"] is None
    assert all(torch.equal(mu[k], mu_back[k]) for k in mu)


# --- data, text, tokenizer, WER ---------------------------------------------------------------

TEXTS = ["bonjour le monde", "oui", "ça va bien merci", "au revoir", "le chat dort", "il pleut"]


def _kaldi_dir(root, n=6, seed=0, segments=False):
    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    scp, text, dur, spk, segs = [], [], [], [], []
    for i in range(n):
        secs = 0.4 + 0.2 * i
        t = np.arange(int(secs * 16000)) / 16000
        audio = (0.2 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.02 * rng.randn(t.size)).astype(np.float32)
        path = os.path.join(root, f"u{i}.wav")
        save_audio(path, audio, 16000)
        scp.append(f"u{i} {path}")
        text.append(f"u{i} {TEXTS[i % len(TEXTS)]}")
        dur.append(f"u{i} {secs:.6f}")
        spk.append(f"u{i} spk{i % 2}")
        segs.append(f"u{i}_a u{i} 0.05 {secs - 0.05:.3f}")
    files = {"wav.scp": scp, "text": text, "utt2dur": dur, "utt2spk": spk}
    if segments:
        files = {"wav.scp": scp, "segments": segs, "text": [f"u{i}_a {TEXTS[i % 6]}" for i in range(n)]}
    for name, lines in files.items():
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return root


def test_manifest_and_bucketed_batches_match_jax(tmp_path):
    from ssak_tpu.data import dataset as JD
    from ssak_tpu_torch.data import dataset as TD

    a = _kaldi_dir(str(tmp_path / "a"))
    b = _kaldi_dir(str(tmp_path / "b"), n=4, seed=1, segments=True)
    lst = tmp_path / "list.txt"
    lst.write_text(f"{a} 1.5\n{b}\n")
    for src, kw in ((a, dict(min_duration=0.5, max_duration=1.2)), (str(lst), dict(max_data=7)), ([a, b], dict(shuffle=True)),
                    (a, dict(max_data=3, choose_data_with_max_duration=True)), (b, dict(sort_by_len=-1))):
        _, jrows = JD.kaldi_folder_to_manifest(src, **kw)
        _, trows = TD.kaldi_folder_to_manifest(src, **kw)
        assert trows == jrows
    _, rows = TD.kaldi_folder_to_manifest(str(lst))
    jb = list(JD.bucketed_audio_batches(rows, 3, buckets=(1.0, 2.0), output_rows=True, seed=4))
    tb = list(TD.bucketed_audio_batches(rows, 3, buckets=(1.0, 2.0), output_rows=True, seed=4))
    assert len(jb) == len(tb) > 2
    for (jx, jl, jc), (tx, tl, tc) in zip(jb, tb):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tl, jl)
        assert [r and r["id"] for r in tc] == [r and r["id"] for r in jc]
    assert any(r is None for _, _, c in tb for r in c) and min(l.min() for _, l, _ in tb) == 1  # dummies: one sample
    pipe = tmp_path / "pipe"
    pipe.mkdir()
    (pipe / "wav.scp").write_text("x sox a.mp3 -t wav - |\n")
    with pytest.raises(NotImplementedError, match="command-pipe"):
        TD.kaldi_folder_to_manifest(str(pipe))


def test_wire_tokenizer_and_wer_match_jax():
    from ssak_tpu.audio.wire import encode_array as j_encode
    from ssak_tpu.eval.wer import align_tokens as j_align
    from ssak_tpu.eval.wer import compute_wer as j_wer
    from ssak_tpu.models.tokenizer import CTCTokenizer as JTok
    from ssak_tpu_torch.audio.wire import encode_array
    from ssak_tpu_torch.eval.wer import align_tokens, compute_wer
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer

    rng = np.random.RandomState(0)
    for x in (np.clip(rng.randn(3, 50), -1, 1).astype(np.float32), (rng.randn(3, 50) * 2).astype(np.float32)):
        a, b = encode_array(x), j_encode(x)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tok, jtok = CTCTokenizer.from_corpus(TEXTS), JTok.from_corpus(TEXTS)
    assert tok.vocab == jtok.vocab and tok.blank_id == jtok.blank_id == 0
    ids = tok.encode("le chat zzz")
    assert ids == jtok.encode("le chat zzz") and tok.decode(ids + [-1, 0]) == jtok.decode(ids + [-1, 0])
    refs = {"a": "le chat dort", "b": "il pleut", "c": "", "d": "bonjour le monde"}
    hyps = {"a": "le chien dort bien", "b": "il", "c": "x", "d": "bonjour monde", "e": "ignored"}
    assert compute_wer(refs, hyps) == {k: v for k, v in j_wer(refs, hyps).items()}
    assert compute_wer(list(refs.values()), list(hyps.values())[:4]) == j_wer(list(refs.values()), list(hyps.values())[:4])
    assert align_tokens("a b c d".split(), "a x c".split()) == j_align("a b c d".split(), "a x c".split())


FORMAT_TEXT_INPUTS = [
    "Le 9/02/2008 à 20h30 Autour des oeuvres de Paul Ladmirault .",
    "Chats de moins de 4 kg : 1 comprimé par jour .",
    "plus de 80 % ,",
    "Tél. : 05 53 66 16 68 .",
    "elle compte 707 790 salariés au 31 décembre 2000",
    "le 01 Aout 2007",
    "la demande du 1er janvier 2004 au XIXème siècle",
    "après le 31.12.2003 ,",
    "Vitamine B6 : 0,6 mg",
    "Biotine : 12,5 µg",
    "Vitamines A : 50,0 U.I.",
    "Abonnez -vous pour 2 ans !",
    "PET-PHOS® Félin",
    "Dim : 39 x31x30cm.Polyester 600 deniers",
    "Vitamine B5 ( acide pantothénique ) : 0,5 mg",
    "http://example.fr/ ici",
    "bonjour <noise> toi",
]
FORMAT_TEXT_EN = ["It costs $5.50 on the 3rd of May, 1999.", "Dr. Smith's 21st birthday — 100% fun!", "I have 2 cats & 3 dogs."]


@pytest.mark.parametrize("lang", ["fr", "en"])
def test_format_text_matches_jax(lang):
    """The port's own copy of the Latin normalizers against ssak_tpu's, on the
    inputs tests/test_text.py pins (the golden corpus it names lies outside
    this repository)."""
    from ssak_tpu.text import format_text as j_format
    from ssak_tpu_torch.text import format_text

    for raw in FORMAT_TEXT_INPUTS + FORMAT_TEXT_EN:
        assert format_text(raw, lang) == j_format(raw, lang), raw
        kw = dict(extract_parenthesized=False, safety_checks=False)
        assert format_text(raw, lang, **kw) == j_format(raw, lang, **kw), raw
    with pytest.raises(NotImplementedError):
        format_text("hallo", "zz")  # ar and ru are ported too (tests/test_torch_text_ar_ru.py)


# --- the trainer and the CLI ------------------------------------------------------------------


def test_ctc_trainer_matches_jax(tmp_path):
    """Both trainers on one Kaldi dir from the same initial params: the same
    logged losses (to their 4 logged decimals, +-2e-4) and the same WER."""
    from ssak_tpu.data.dataset import kaldi_folder_to_manifest as j_manifest
    from ssak_tpu.models.tokenizer import CTCTokenizer as JTok
    from ssak_tpu.train.loop import CTCTrainer as JTrainer
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer
    from ssak_tpu_torch.train.loop import CTCTrainer

    d = _kaldi_dir(str(tmp_path / "data"))
    cfg, tcfg = _cfgs()
    tree = _tree(seed=6)
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=4, batch_size=4, eval_steps=2, mask_time_prob=0.0, seed=3)
    _, jrows = j_manifest(d)
    _, trows = kaldi_folder_to_manifest(d)
    jt = JTrainer(cfg, jax.tree_util.tree_map(jnp.asarray, tree), JTok.from_corpus(TEXTS), str(tmp_path / "j"), **kw)
    tt = CTCTrainer(tcfg, wav2vec2_from_tree(tree), CTCTokenizer.from_corpus(TEXTS), str(tmp_path / "t"), device="cpu", **kw)
    jh = jt.train(jrows, jrows, max_steps=4, log_interval=1)
    th = tt.train(trows, trows, max_steps=4, log_interval=1)
    assert [sorted(h) for h in th] == [sorted(h) for h in jh]
    train_j = [h for h in jh if "loss" in h]
    train_t = [h for h in th if "loss" in h]
    assert [h["step"] for h in train_t] == [h["step"] for h in train_j] == [1, 2, 3, 4]
    for a, b in zip(train_t, train_j):
        assert abs(a["loss"] - b["loss"]) <= 2e-4 and abs(a["grad_norm"] - b["grad_norm"]) <= 2e-3 * b["grad_norm"] + 2e-4
    evals_j = [h for h in jh if "eval_wer" in h]
    evals_t = [h for h in th if "eval_wer" in h]
    assert [h["eval_wer"] for h in evals_t] == [h["eval_wer"] for h in evals_j] and len(evals_t) == 3
    for a, b in zip(evals_t, evals_j):
        assert abs(a["eval_loss"] - b["eval_loss"]) <= 1e-4 * abs(b["eval_loss"])
    assert tt.best_step == jt.best_step and tt.best_wer == jt.best_wer
    # resume: a fresh trainer picks up the last checkpoint's step, params and optimizer state
    t2 = CTCTrainer(tcfg, TW.init_params(tcfg, seed=1), CTCTokenizer.from_corpus(TEXTS), str(tmp_path / "t"), device="cpu", **kw)
    assert t2.resume() and t2.state["step"] == 4
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(wav2vec2_to_tree(tt.state["model"])), _leaves(wav2vec2_to_tree(t2.state["model"]))))
    assert t2.state["opt_state"]["1"]["0"]["count"] == 4
    with open(tmp_path / "t" / "trainer_state.json") as f:
        assert json.load(f)["global_step"] == 4


def test_trainer_batches_ship_int16_with_dummies(tmp_path):
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer
    from ssak_tpu_torch.train.loop import CTCTrainer
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest

    d = _kaldi_dir(str(tmp_path / "data"), n=5)
    _, rows = kaldi_folder_to_manifest(d)
    tcfg = _cfgs()[1]
    tr = CTCTrainer(tcfg, TW.init_params(tcfg), CTCTokenizer.from_corpus(TEXTS), str(tmp_path / "run"), batch_size=4,
                    device="cpu", buckets=(1.0, 2.0))
    batches = list(tr._batches(rows))
    assert all(b["audio"].dtype == torch.int16 for b, _, _ in batches)
    last, real, audio_s = batches[-1]
    assert last["audio"].shape[0] == 4 and len(real) < 4
    assert last["label_lengths"][len(real):].eq(0).all() and last["audio_lengths"][len(real):].eq(1).all()
    assert all(b["labels"].shape[1] == 16 for b, _, _ in batches)  # power-of-two width, floor 16
    with pytest.raises(NotImplementedError):
        CTCTrainer(tcfg, TW.init_params(tcfg), CTCTokenizer.from_corpus(TEXTS), str(tmp_path / "x"), device="cpu",
                   augmenter=object())


def test_train_cli_on_cpu(tmp_path):
    d = _kaldi_dir(str(tmp_path / "data"))
    cmd = [sys.executable, "-m", "ssak_tpu_torch.train.cli", d, d, "--output_dir", str(tmp_path / "runs"),
           "--batch_size", "4", "--max_steps", "3", "--eval_steps", "2", "--warmup_steps", "1", "--max_duration", "21"]
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    run_dir = json.loads(out.stdout.strip().splitlines()[-1])["run_dir"]
    for name in ("trainer_state.json", "README.txt", "vocab.json", "ssak_config.json"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    assert os.path.isdir(os.path.join(run_dir, "src", "ssak_tpu_torch"))
    with open(os.path.join(run_dir, "trainer_state.json")) as f:
        ts = json.load(f)
    assert ts["global_step"] == 3 and any("eval_wer" in e for e in ts["log_history"])
    from ssak_tpu_torch.train.checkpoint import list_checkpoints

    assert 1 <= len(list_checkpoints(run_dir)) <= 3


@pytest.mark.parametrize("flags", [["--config", "c.yaml"], ["--set", "a=1"], ["--data_augment"], ["--use_manifest_cache"]])
def test_train_cli_refuses_unported_options_at_start(tmp_path, flags):
    """What still needs a later slice: YAML configs, waveform augmentation and
    the manifest cache (slice 8). A NeMo --base_model is ported
    (tests/test_torch_nemo.py)."""
    from ssak_tpu_torch.train import cli

    with pytest.raises(NotImplementedError):
        cli.main([str(tmp_path / "none"), str(tmp_path / "none"), "--output_dir", str(tmp_path / "runs"), "--device", "cpu"] + flags)
    assert not (tmp_path / "runs").exists()
