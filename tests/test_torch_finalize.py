"""Exports across the two packages (train.finalize) and --base_model.

- A port train/cli run of 2 steps on a synthetic Kaldi dir, exported by the
  port's finalize_run: ssak_tpu's load_exported reads it, and its log-probs
  equal the port's on the same audio in f32 (1e-5).
- The other way: ssak_tpu's export_model of a Whisper tree (its config
  carries `remat`, which the port drops) and of a wav2vec2 tree load in the
  port with equal outputs (Whisper logits 1e-4 of the largest, wav2vec2
  log-probs 1e-5, f32).
- --base_model on an HF wav2vec2 directory starts from ssak_tpu's
  load_wav2vec2 tree bit for bit, with the directory's vocabulary; a
  checkpoint without a CTC head gets a fresh one of the right shape.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.models import wav2vec2 as JW2V
from ssak_tpu.models import whisper as JW
from ssak_tpu.train import finalize as JF
from ssak_tpu_torch.infer import general as G
from ssak_tpu_torch.models import wav2vec2 as W2V
from ssak_tpu_torch.models import whisper as W
from ssak_tpu_torch.models.convert import wav2vec2_to_tree
from ssak_tpu_torch.train import finalize as F
from test_torch_hf_loader import W2V_VOCAB, assert_same_tree, hf_wav2vec2_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["bonjour le monde", "oui", "ça va bien merci", "au revoir", "le chat dort", "il pleut"]


def _kaldi_dir(root, n=6, seed=0):
    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    files = {"wav.scp": [], "text": [], "utt2dur": []}
    for i in range(n):
        secs = 0.4 + 0.2 * i
        t = np.arange(int(secs * 16000)) / 16000
        path = os.path.join(root, f"u{i}.wav")
        save_audio(path, (0.2 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.02 * rng.randn(t.size)).astype(np.float32), 16000)
        files["wav.scp"].append(f"u{i} {path}")
        files["text"].append(f"u{i} {TEXTS[i % len(TEXTS)]}")
        files["utt2dur"].append(f"u{i} {secs:.6f}")
    for name, lines in files.items():
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return root


def _audio(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 4000) * 0.1).astype(np.float32), np.array([4000, 3100], np.int32)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _log_probs_agree(jparams, jcfg, module, cfg, tol=1e-5):
    x, lens = _audio()
    ref, _ = JW2V.ctc_log_probs(jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(x), _f32(jcfg), jnp.asarray(lens))
    with torch.no_grad():
        got, _ = W2V.ctc_log_probs(module, torch.from_numpy(x), _f32(cfg), torch.from_numpy(lens))
    err = float(np.abs(got.numpy() - np.asarray(ref)).max())
    assert err <= tol, err


def _train(tmp_path, *extra):
    from ssak_tpu_torch.train import cli

    d = _kaldi_dir(str(tmp_path / "data"))
    out = tmp_path / "runs"
    cli.main([d, d, "--output_dir", str(out), "--batch_size", "4", "--max_steps", "2", "--eval_steps", "1",
              "--warmup_steps", "1", "--device", "cpu", *extra])
    (run,) = os.listdir(out)
    return str(out / run)


def test_port_run_exports_for_jax(tmp_path):
    run = _train(tmp_path)
    final = F.finalize_run(run)
    assert sorted(os.listdir(final)) == ["finalize_info.json", "ssak_config.json", "vocab.json", "weights.npz"]
    jtype, jparams, jcfg, jtok = JF.load_exported(final)
    ptype, pparams, pcfg, ptok = F.load_exported(final)
    assert jtype == ptype == "wav2vec2_ctc" and dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    assert jtok.vocab == ptok.vocab
    assert_same_tree(pparams, jparams)
    m = G.load_model(final, device="cpu")
    assert m.type == "wav2vec2_ctc" and m.tokenizer.vocab == jtok.vocab
    _log_probs_agree(jparams, jcfg, m.module, m.cfg)
    # ssak_tpu's finalize_run on the same run picks the same checkpoint and writes the same tree
    jfinal = JF.finalize_run(run, str(tmp_path / "jax_final"))
    for name in ("finalize_info.json", "ssak_config.json", "vocab.json"):
        with open(os.path.join(final, name)) as a, open(os.path.join(jfinal, name)) as b:
            assert json.load(a) == json.load(b), name
    assert_same_tree(F.load_exported(jfinal)[1], pparams)
    # the CLI on --device cpu: exports and prints the directory, which ssak_tpu reads
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "ssak_tpu_torch.train.finalize", run, "--output_dir",
                          str(tmp_path / "final2"), "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path / "final2")
    assert_same_tree(JF.load_exported(str(tmp_path / "final2"))[1], pparams)


def test_jax_exports_load_in_the_port(tmp_path):
    wcfg = JW.make_config("tiny_test", dtype="float32", remat=True)
    wtree = jax.tree_util.tree_map(np.asarray, JW.init_params(jax.random.PRNGKey(3), wcfg))
    wdir = JF.export_model(wtree, wcfg, str(tmp_path / "whisper"), model_type="whisper")
    with open(os.path.join(wdir, "ssak_config.json")) as f:
        assert json.load(f)["config"]["remat"] is True
    m = G.load_model(wdir, device="cpu")
    assert m.type == "whisper" and m.tokenizer is None and m.cfg.n_vocab == wcfg.n_vocab
    assert m.cfg.remat is True  # the training switch is carried over
    rng = np.random.RandomState(0)
    mel = (rng.randn(2, wcfg.n_mels, 2 * wcfg.n_audio_ctx) * 0.5).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, wtree)
    af = JW.encode(jp, jnp.asarray(mel), wcfg)
    jkv, jc = JW.precompute_cross_kv(jp, af, wcfg), JW.init_cache(wcfg, 2)
    with torch.no_grad():
        tkv, tc = W.precompute_cross_kv(m.module, torch.from_numpy(np.array(af)), m.cfg), W.init_cache(m.cfg, 2)
        for pos, tok in enumerate([wcfg.sot, wcfg.no_timestamps, 17, 60]):
            ref, jc = JW._decode_step(jp, jnp.full((2, 1), tok, jnp.int32), pos, jc, jkv, wcfg)
            got, tc = W._decode_step(m.module, torch.full((2, 1), tok, dtype=torch.int64), pos, tc, tkv, m.cfg)
            ref = np.asarray(ref)
            assert float(np.abs(got.numpy() - ref).max()) <= 1e-4 * float(np.abs(ref).max())

    from ssak_tpu.models.tokenizer import CTCTokenizer as JTok

    ccfg = JW2V.make_config("tiny_test", dtype="float32")
    ctree = jax.tree_util.tree_map(np.asarray, JW2V.init_params(jax.random.PRNGKey(4), ccfg))
    cdir = JF.export_model(ctree, ccfg, str(tmp_path / "ctc"), tokenizer=JTok.from_corpus(TEXTS))
    m = G.load_model(cdir, device="cpu")
    assert m.tokenizer.vocab == JTok.from_corpus(TEXTS).vocab
    assert_same_tree(wav2vec2_to_tree(m.module), ctree)
    _log_probs_agree(ctree, ccfg, m.module, m.cfg)


def test_conformer_exports_are_refused(tmp_path):
    """A Conformer export is read since slice 7 (both ways in
    tests/test_torch_nemo.py); what is refused is an export whose config
    names a field that ConformerConfig lacks, or that has no weights."""
    from ssak_tpu.models import conformer as JC
    from ssak_tpu.models.tokenizer import CTCTokenizer as JTok

    cfg = JC.make_config("tiny_test", dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, JC.init_params(jax.random.PRNGKey(3), cfg))
    d = JF.export_model(tree, cfg, str(tmp_path / "conf"), model_type="conformer_ctc", tokenizer=JTok.from_corpus(TEXTS))
    assert G.load_model(d, device="cpu").type == G.ModelType.CONFORMER_CTC
    meta = json.loads((tmp_path / "conf" / "ssak_config.json").read_text())
    (tmp_path / "conf" / "ssak_config.json").write_text(json.dumps({**meta, "config": {**meta["config"], "depth": 3}}))
    with pytest.raises(TypeError, match="depth"):
        G.load_model(d, device="cpu")
    bad = tmp_path / "no_weights"
    bad.mkdir()
    (bad / "ssak_config.json").write_text(json.dumps(meta))
    with pytest.raises(FileNotFoundError):
        G.load_model(str(bad), device="cpu")


@pytest.mark.parametrize("head", [True, False], ids=["ctc_head", "no_head"])
def test_base_model_starts_from_the_jax_tree(tmp_path, head):
    from ssak_tpu.models.hf_loader import load_wav2vec2 as j_load
    from ssak_tpu_torch.train.cli import base_model

    d = hf_wav2vec2_dir(str(tmp_path / "base"), stable=True, head=head, seed=5)
    module, cfg, tok = base_model(d, seed=69, device="cpu")
    jparams, jcfg = j_load(d)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert tok.vocab == {t: i for i, t in enumerate(W2V_VOCAB)}
    mine = wav2vec2_to_tree(module)
    if head:
        assert_same_tree(mine, jparams)
    else:
        assert "lm_head" not in jparams
        head_tree = mine.pop("lm_head")
        assert_same_tree(mine, jparams)
        assert head_tree["kernel"].shape == (cfg.hidden_size, cfg.vocab_size) and not head_tree["bias"].any()
        again, _, _ = base_model(d, seed=69, device="cpu")
        assert torch.equal(again.lm_head.weight, module.lm_head.weight)  # seeded


def test_base_model_cli_run(tmp_path):
    base = hf_wav2vec2_dir(str(tmp_path / "base"), seed=6)
    run = _train(tmp_path, "--base_model", base, "--language", "ru")
    with open(os.path.join(run, "vocab.json"), encoding="utf-8") as f:
        assert json.load(f) == {t: i for i, t in enumerate(W2V_VOCAB)}
    with open(os.path.join(run, "ssak_config.json"), encoding="utf-8") as f:
        conf = json.load(f)["config"]
    assert conf["hidden_size"] == 64 and conf["vocab_size"] == len(W2V_VOCAB)
    final = F.finalize_run(run)
    assert G.load_model(final, device="cpu").cfg.hidden_size == 64
