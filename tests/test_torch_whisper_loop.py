"""The port's Whisper fine-tuning loop (ssak_tpu_torch.train.whisper_loop:
WhisperBatcher, train_whisper, evaluate_whisper, the CLI; train.checkpoint
for a Whisper state) against ssak_tpu on the CPU, on the tiny_test config
and synthetic Kaldi dirs of tones made from numpy seeds. Parameters cross
to the port through whisper_from_tree."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssak_tpu.eval.wer as JWER
import ssak_tpu.train.whisper_loop as JLOOP
import ssak_tpu_torch.eval.wer as TWER
import ssak_tpu_torch.train.whisper_loop as TLOOP
from ssak_tpu.models import lora as JLoRA
from ssak_tpu.models import whisper as JW
from ssak_tpu.train import checkpoint as JCK
from ssak_tpu.train import steps as JS
from ssak_tpu_torch.models import whisper as W
from ssak_tpu_torch.models.convert import whisper_from_tree, whisper_to_tree
from ssak_tpu_torch.train import steps as TS
from test_torch_lora import assert_same_tree
from test_torch_whisper_train import LR, _cfgs, _jax_tree, _np_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- checkpoints ------------------------------------------------------------------


def _kaldi(root, texts, seconds=1.0, seed=0):
    """A Kaldi dir of tone wavs with transcripts."""
    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    scp, txt, u2s = [], [], []
    for i, text in enumerate(texts):
        n = int(seconds * 16000 * (0.6 + 0.4 * rng.rand()))
        t = np.arange(n) / 16000.0
        f0 = 200 + 60 * i
        audio = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.randn(n)).astype(np.float32)
        path = os.path.join(root, f"u{i}.wav")
        save_audio(path, audio, 16000)
        scp.append(f"u{i} {path}")
        txt.append(f"u{i} {text}")
        u2s.append(f"u{i} s{i}")
    for name, lines in (("wav.scp", scp), ("text", txt), ("utt2spk", u2s)):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return root


TEXTS = ["bonjour", "merci beaucoup", "au revoir", "oui", "non merci", "salut"]


def test_whisper_checkpoint_resume_and_cross_package(tmp_path):
    """A full fine-tune through train_whisper (an evaluation between steps:
    the next backward still runs) writes checkpoints that ssak_tpu reads
    (params and step); resume=True continues from the last one to the
    same bits as the uninterrupted state; an ssak_tpu checkpoint resumes
    into the port with its params and step."""
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest

    cfg, tcfg = _cfgs()
    tree = _jax_tree(cfg, seed=5)
    _, rows = kaldi_folder_to_manifest(_kaldi(str(tmp_path / "data"), TEXTS))
    run = str(tmp_path / "run")
    kw = dict(learning_rate=LR, warmup_steps=1, batch_size=2, seed=3, device="cpu", log_interval=1)
    state, hist = TLOOP.train_whisper(whisper_from_tree(tree), tcfg, None, rows, rows[:2], run, max_steps=2,
                                      eval_steps=1, max_eval_samples=2, **kw)
    assert [h["step"] for h in hist if "eval_wer" in h] == [1, 2]
    with open(os.path.join(run, "trainer_state.json")) as f:
        assert json.load(f)["global_step"] == 2
    jstate, meta = JCK.load_checkpoint(JCK.get_last_checkpoint(run))
    assert int(jstate["step"]) == 2 and meta["step"] == 2
    assert_same_tree(jstate["params"], whisper_to_tree(state["model"]))
    # one more step from the state in memory, on the batch a resumed run takes first
    batcher = TLOOP.WhisperBatcher(tcfg, None, batch_size=2)
    first = next(iter(batcher.batches(rows, seed=3)))[0]
    # (the resumed run's schedule: total_steps = its max_steps, 3)
    step = TS.make_whisper_train_step(tcfg, TS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=3))
    state, _ = step(state, first)
    resumed, _ = TLOOP.train_whisper(whisper_from_tree(_jax_tree(cfg, seed=6)), tcfg, None, rows, [], run, max_steps=3,
                                     eval_steps=0, resume=True, **kw)
    assert resumed["step"] == 3
    assert_same_tree(whisper_to_tree(resumed["model"]), whisper_to_tree(state["model"]))
    # ssak_tpu's checkpoint: params and step resume, the moments start afresh
    jopt = JS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=3)
    js = JS.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), jopt)
    js["step"] = jnp.asarray(7, jnp.int32)
    JCK.save_checkpoint(str(tmp_path / "jrun"), js)
    tstate = TS.init_train_state(whisper_from_tree(_jax_tree(cfg, seed=6)), TS.make_optimizer())
    TLOOP._resume(tstate, str(tmp_path / "jrun"), "cpu")
    assert tstate["step"] == 7
    assert_same_tree(whisper_to_tree(tstate["model"]), tree)


# --- the loop -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    from test_torch_whisper_tokenizer import build_whisper_tokenizer

    return build_whisper_tokenizer(str(tmp_path_factory.mktemp("whisper_tok")))


@pytest.mark.parametrize("with_tokenizer", [False, True])
def test_whisper_batcher_matches_jax(tmp_path, tokenizer_dir, with_tokenizer):
    """The same rows give the same mel (1e-5 of max), token arrays and mask
    in both packages, shuffled by the same seed: the prompt from
    sot_sequence(language), or [sot, no_timestamps] with byte pseudo-tokens
    without a tokenizer; U = max_tokens + len(prompt) + 1."""
    from ssak_tpu.data.dataset import kaldi_folder_to_manifest as jmanifest
    from ssak_tpu.models.tokenizer import WhisperTokenizer as JTok
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.models.tokenizer import WhisperTokenizer

    cfg, tcfg = _cfgs()
    d = _kaldi(str(tmp_path / "data"), TEXTS + ["a longer transcript than the budget of tokens allows here"])
    _, jrows = jmanifest(d)
    _, rows = kaldi_folder_to_manifest(d)
    jtok, ttok = (JTok(tokenizer_dir), WhisperTokenizer(tokenizer_dir)) if with_tokenizer else (None, None)
    lang = "en" if with_tokenizer else None
    jbat = JLOOP.WhisperBatcher(cfg, jtok, language=lang, batch_size=3, max_tokens=10)
    tbat = TLOOP.WhisperBatcher(tcfg, ttok, language=lang, batch_size=3, max_tokens=10)
    assert tbat.prompt == jbat.prompt and len(tbat.prompt) == (4 if with_tokenizer else 2)
    jout, tout = list(jbat.batches(jrows, seed=11)), list(tbat.batches(rows, seed=11))
    assert len(jout) == len(tout) == 3
    for (jb, jc), (tb, tc) in zip(jout, tout):
        assert [r["id"] for r in jc] == [r["id"] for r in tc]
        U = 10 + len(tbat.prompt) + 1
        assert tuple(tb["tokens_in"].shape) == (len(tc), U) and tb["mel"].shape == (len(tc), 80, 200)
        for k in ("tokens_in", "tokens_out", "token_mask"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
        ref = np.asarray(jb["mel"])
        np.testing.assert_allclose(tb["mel"].numpy(), ref, atol=1e-4, rtol=0)  # the log-mel tolerance of test_torch_layers


def test_evaluate_whisper_matches_jax(tmp_path, monkeypatch):
    """The same greedy hypotheses and WER from both packages' evaluation on
    one LoRA-carrying tree (f32), max_samples taking the head of the rows."""
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest

    cfg, tcfg = _cfgs()
    tree = _jax_tree(cfg, rank=4, lora_b=0.05)
    _, rows = kaldi_folder_to_manifest(_kaldi(str(tmp_path / "data"), TEXTS))
    seen = {}

    def spy(tag, orig):
        def compute_wer(refs, hyps, *a, **kw):
            seen[tag] = (dict(refs), dict(hyps))
            return orig(refs, hyps, *a, **kw)
        return compute_wer

    monkeypatch.setattr(JWER, "compute_wer", spy("jax", JWER.compute_wer))
    monkeypatch.setattr(TWER, "compute_wer", spy("port", TWER.compute_wer))
    ref = JLOOP.evaluate_whisper(jax.tree_util.tree_map(jnp.asarray, tree), cfg, None, rows,
                                 JLOOP.WhisperBatcher(cfg, None, batch_size=2), max_samples=5)
    got = TLOOP.evaluate_whisper(whisper_from_tree(tree), tcfg, None, rows, TLOOP.WhisperBatcher(tcfg, None, batch_size=2),
                                 max_samples=5)
    assert seen["port"] == seen["jax"] and len(seen["port"][1]) == 5
    assert all(h for h in seen["port"][1].values())
    assert got == ref


class CharTok:
    """A character tokenizer over ids 10.. (ssak_tpu's TestEvalWerGolden)."""

    CHARS = " abcdefghijklmnopqrstuvwxyz'"

    def __init__(self, cfg):
        self.cfg = cfg
        self.eot, self.sot_prev = cfg.eot, cfg.sot_prev
        self.timestamp_begin = cfg.timestamp_begin

    def sot_sequence(self, language=None, task=None, timestamps=False):
        return [self.cfg.sot] + ([] if timestamps else [self.cfg.no_timestamps])

    def encode(self, text):
        return [10 + self.CHARS.index(c) for c in text.lower() if c in self.CHARS]

    def decode(self, ids, skip_special=True):
        return "".join(self.CHARS[i - 10] for i in ids if 10 <= i < 10 + len(self.CHARS)).strip()


def test_overfit_reaches_wer_zero(tmp_path):
    """ssak_tpu's decode canary on a synthetic tone in place of a speech
    file: a tiny Whisper (bf16 compute, as the preset) overfits one
    utterance through the port's train step and evaluate_whisper gives
    WER 0, also with max_samples."""
    cfg = W.make_config("tiny_test")
    tok = CharTok(cfg)
    with torch.no_grad():
        model = W.init_params(torch.Generator().manual_seed(0), cfg)
    opt = TS.make_optimizer(learning_rate=3e-3, warmup_steps=3, total_steps=300, schedule="constant")
    state = TS.init_train_state(model, opt)
    step_fn = TS.make_whisper_train_step(cfg, opt)
    root = _kaldi(str(tmp_path / "data"), ["bonjour"])
    rows = [{"id": "u1", "audio": os.path.join(root, "u0.wav"), "text": "bonjour", "duration": 1.0}]
    batcher = TLOOP.WhisperBatcher(cfg, tok, batch_size=1)
    [(batch, _)] = list(batcher.batches(rows))
    loss = None
    for _ in range(250):
        state, m = step_fn(state, batch)
        loss = m["loss"].item()
        if loss < 0.01:
            break
    assert loss < 0.05, f"failed to overfit: loss={loss}"
    assert TLOOP.evaluate_whisper(state["model"], cfg, tok, rows, batcher)["eval_wer"] == 0.0
    assert TLOOP.evaluate_whisper(state["model"], cfg, tok, rows, batcher, max_samples=1)["eval_wer"] == 0.0


def test_whisper_loop_cli_on_cpu(tmp_path):
    """python -m ssak_tpu_torch.train.whisper_loop on a synthetic Kaldi dir
    with --device cpu: 4 LoRA steps of the seeded tiny_test Whisper,
    evaluations at steps 2 and 4 (the steps after an evaluation still
    train), trainer_state.json, adapters-2.npz, adapters-4.npz and
    adapters.npz with ssak_tpu's adapter paths."""
    data = _kaldi(str(tmp_path / "data"), TEXTS, seconds=1.5)
    out = tmp_path / "wrun"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m", "ssak_tpu_torch.train.whisper_loop", data, data, "--output_dir", str(out),
                          "--batch_size", "2", "--max_steps", "4", "--eval_steps", "2", "--lora", "4",
                          "--max_duration", "11", "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {"output_dir": str(out), "steps": 4}
    with open(out / "trainer_state.json") as f:
        ts = json.load(f)
    assert ts["global_step"] == 4 and [e["step"] for e in ts["log_history"] if "eval_wer" in e] == [2, 4]
    assert (out / "adapters-2.npz").exists() and (out / "adapters-4.npz").exists()
    cfg = JW.make_config("tiny_test")
    jkeys = sorted(JLoRA.extract_lora(JLoRA.add_lora(_np_tree(JW.init_params(jax.random.PRNGKey(0), cfg)), rank=4)))
    with np.load(out / "adapters.npz") as z:
        assert sorted(z.files) == jkeys
        assert any(z[k].any() for k in z.files if k.endswith("lora_B"))  # the adapters trained


def test_whisper_loop_cli_with_base_model_on_cpu(tmp_path):
    """--base_model: an HF Whisper directory with its tokenizer (d 64, 2+2
    layers, large-v3's 51,866 ids, 30 s windows), --language en, --lora 2
    --load_in_8bit --remat: 2 steps and one evaluation, the adapters of
    every attention query / value written."""
    from test_torch_hf_loader import hf_whisper_dir
    from test_torch_whisper_tokenizer import build_whisper_tokenizer

    model_dir = str(tmp_path / "hf")
    hf_whisper_dir(model_dir, vocab_size=51866, n_audio_ctx=1500, n_text_ctx=64, sot=50258, eot=50257)
    build_whisper_tokenizer(model_dir)
    data = _kaldi(str(tmp_path / "data"), TEXTS[:4], seconds=2.0)
    out = tmp_path / "wrun"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m", "ssak_tpu_torch.train.whisper_loop", data, data, "--base_model", model_dir,
                          "--output_dir", str(out), "--language", "en", "--lora", "2", "--load_in_8bit", "--remat",
                          "--batch_size", "2", "--max_steps", "2", "--eval_steps", "2", "--max_eval_samples", "2",
                          "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out / "trainer_state.json") as f:
        ts = json.load(f)
    assert ts["global_step"] == 2 and [e["step"] for e in ts["log_history"] if "eval_wer" in e] == [2]
    with np.load(out / "adapters.npz") as z:
        assert len(z.files) == 3 * 2 * (2 + 2 * 2) and all(z[k].dtype == np.float32 for k in z.files)
