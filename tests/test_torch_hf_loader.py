"""The port's HF checkpoint loader against ssak_tpu.models.hf_loader, on tiny
models that `transformers` saves here: Whisper; wav2vec2 with group norm
and with stable layer norm; f32 and f16 safetensors; *.bin; the
positional conv's weight_g / weight_v keys and torch's parametrizations
form; a checkpoint without a CTC head; MMS adapters (adapter_attn_dim > 0,
an adapter.fr.safetensors written with safetensors.numpy, a vocab.json
nested by language). The port's parameter trees equal ssak_tpu's bit for
bit, leaf by leaf; forward outputs in f32 compute on the leaves as loaded
(f16 ones too): wav2vec2 log-probs within 1e-5, Whisper teacher-forced
logits within 1e-4 of the largest |logit|;
load_adapter gives ssak_tpu's log-probs (1e-5), vocab_size and
vocabulary, and returns False without an adapter file. The port's own
safetensors reader gives safetensors.numpy's arrays for every dtype that
package reads, and refuses BF16 by name (safetensors.numpy reads BF16 only
where ml_dtypes has given numpy a bfloat16, as importing JAX does)."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.infer import general as JG
from ssak_tpu.models import hf_loader as JH
from ssak_tpu.models import wav2vec2 as JW2V
from ssak_tpu.models import whisper as JW
from ssak_tpu_torch.infer import general as G
from ssak_tpu_torch.models import hf_loader as H
from ssak_tpu_torch.models import wav2vec2 as W2V
from ssak_tpu_torch.models import whisper as W

W2V_VOCAB = ["<pad>", "<s>", "</s>", "<unk>", "|"] + list("abcdefghijklmnopqrstuvwxyz'")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def assert_same_tree(mine, ref):
    """Same paths, dtypes, shapes and bits at every leaf."""
    a, b = dict(_leaves(mine)), dict(_leaves(ref))
    assert sorted(a) == sorted(b), sorted(set(a) ^ set(b))[:8]
    for k in a:
        x, y = np.ascontiguousarray(a[k]), np.ascontiguousarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), k
    return len(a)


def _save(model, d, dtype="f32", fmt="safetensors"):
    if dtype == "f16":
        model = model.half()
    model.save_pretrained(str(d), safe_serialization=fmt == "safetensors")
    return str(d)


def hf_whisper_dir(d, vocab_size=128, n_audio_ctx=100, n_text_ctx=32, dtype="f32", fmt="safetensors", seed=0,
                   sot=1, eot=2):
    """A tiny WhisperForConditionalGeneration saved to d (d=64, 2+2 layers)."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    cfg = WhisperConfig(vocab_size=vocab_size, num_mel_bins=80, d_model=64, encoder_layers=2, decoder_layers=2,
                        encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=128, decoder_ffn_dim=128,
                        max_source_positions=n_audio_ctx, max_target_positions=n_text_ctx, dropout=0.0,
                        attention_dropout=0.0, activation_dropout=0.0, decoder_start_token_id=sot, eos_token_id=eot,
                        pad_token_id=eot, bos_token_id=eot)
    torch.manual_seed(seed)
    model = WhisperForConditionalGeneration(cfg).eval()
    with torch.no_grad():  # biases and norms away from their 0 / 1 init, so that a mix-up shows
        for name, p in model.named_parameters():
            if name.endswith("bias") or "layer_norm" in name:
                p.add_(0.05 * torch.randn_like(p))
    return _save(model, d, dtype, fmt)


def hf_wav2vec2_dir(d, stable=False, dtype="f32", fmt="safetensors", head=True, adapter_dim=0, seed=0,
                    legacy_weight_norm=False):
    """A tiny wav2vec2 (Wav2Vec2ForCTC, or Wav2Vec2Model with head=False)
    saved to d with a flat vocab.json of W2V_VOCAB; legacy_weight_norm
    rewrites the positional conv as weight_g / weight_v keys."""
    from transformers import Wav2Vec2Config, Wav2Vec2ForCTC, Wav2Vec2Model

    cfg = Wav2Vec2Config(
        vocab_size=len(W2V_VOCAB), hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
        conv_dim=(32, 32, 32), conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8), num_feat_extract_layers=3,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2, do_stable_layer_norm=stable, conv_bias=stable,
        feat_extract_norm="layer" if stable else "group", adapter_attn_dim=adapter_dim or None,
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
        final_dropout=0.0, apply_spec_augment=False, pad_token_id=0,
    )
    torch.manual_seed(seed)
    model = (Wav2Vec2ForCTC if head else Wav2Vec2Model)(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "layer_norm" in name:
                p.add_(0.05 * torch.randn_like(p))
    os.makedirs(d, exist_ok=True)
    _save(model, d, dtype, fmt)
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(W2V_VOCAB)}, f)
    if legacy_weight_norm:
        from safetensors.numpy import load_file, save_file

        path = os.path.join(d, "model.safetensors")
        sd = dict(load_file(path))
        for k in [k for k in sd if ".parametrizations.weight.original" in k]:
            sd[k.replace("parametrizations.weight.original0", "weight_g").replace("parametrizations.weight.original1",
                                                                                  "weight_v")] = sd.pop(k)
        save_file(sd, path)
    return str(d)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _w2v_log_probs_match(jparams, jcfg, model, cfg, seed=0, tol=1e-5):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 3200) * 0.1).astype(np.float32)
    lens = np.array([3200, 2400], np.int32)
    ref, rfl = JW2V.ctc_log_probs(jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(x), _f32(jcfg),
                                  jnp.asarray(lens))
    with torch.no_grad():
        got, gfl = W2V.ctc_log_probs(model, torch.from_numpy(x), _f32(cfg), torch.from_numpy(lens))
    np.testing.assert_array_equal(gfl.numpy(), np.asarray(rfl))
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= tol, err
    return err


W2V_CASES = {
    "group_norm_f32": dict(),
    "stable_f32": dict(stable=True),
    "group_norm_f16": dict(dtype="f16"),
    "stable_f16_bin": dict(stable=True, dtype="f16", fmt="bin"),
    "group_norm_bin": dict(fmt="bin"),
    "weight_g_v_keys": dict(legacy_weight_norm=True),
    "no_lm_head": dict(head=False),
    "mms_adapters": dict(stable=True, adapter_dim=16),
}


@pytest.mark.parametrize("case", list(W2V_CASES))
def test_wav2vec2_tree_is_bit_identical_and_forward_matches(tmp_path, case):
    d = hf_wav2vec2_dir(str(tmp_path / case), **W2V_CASES[case])
    mine, cfg = H.load_wav2vec2(d)
    ref, jcfg = JH.load_wav2vec2(d)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert assert_same_tree(mine, ref) > 20
    assert ("lm_head" in mine) == (case != "no_lm_head")
    assert any(".bin" in f for f in os.listdir(d)) == ("bin" in case)
    if case == "no_lm_head":
        with pytest.raises(ValueError, match="lm_head"):
            G.load_model(d, device="cpu")
        return
    m = G.load_model(d, device="cpu")
    assert m.type == G.ModelType.WAV2VEC2_CTC and m.tokenizer.vocab == JG.load_model(d).tokenizer.vocab
    if "f16" in case:  # both packages keep the checkpoint's f16 leaves
        assert {p.dtype for p in m.module.parameters()} == {torch.float16}
    _w2v_log_probs_match(mine, jcfg, m.module, m.cfg)


@pytest.mark.parametrize("dtype,fmt", [("f32", "safetensors"), ("f16", "safetensors"), ("f32", "bin")])
def test_whisper_tree_is_bit_identical_and_logits_match(tmp_path, dtype, fmt):
    d = hf_whisper_dir(str(tmp_path / "w"), dtype=dtype, fmt=fmt)
    mine, cfg = H.load_whisper(d)
    ref, jcfg = JH.load_whisper(d)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)  # remat included, in both packages since slice 8a
    assert assert_same_tree(mine, ref) > 40
    from ssak_tpu_torch.models.convert import whisper_from_tree

    cfg32, jcfg32 = _f32(cfg), _f32(jcfg)
    jp, tm = jax.tree_util.tree_map(jnp.asarray, mine), whisper_from_tree(mine)
    rng = np.random.RandomState(0)
    mel = (rng.randn(2, cfg.n_mels, 2 * cfg.n_audio_ctx) * 0.5).astype(np.float32)
    af = JW.encode(jp, jnp.asarray(mel), jcfg32)
    jkv, jc = JW.precompute_cross_kv(jp, af, jcfg32), JW.init_cache(jcfg32, 2)
    with torch.no_grad():
        taf = W.encode(tm, torch.from_numpy(mel), cfg32)
        scale = float(np.abs(np.asarray(af)).max())
        assert float(np.abs(taf.numpy() - np.asarray(af)).max()) <= 1e-4 * scale
        tkv, tc = W.precompute_cross_kv(tm, torch.from_numpy(np.array(af)), cfg32), W.init_cache(cfg32, 2)
        for pos, tok in enumerate([cfg.sot, 3, 50, 7, 99, cfg.eot]):
            ref_l, jc = JW._decode_step(jp, jnp.full((2, 1), tok, jnp.int32), pos, jc, jkv, jcfg32)
            got_l, tc = W._decode_step(tm, torch.full((2, 1), tok, dtype=torch.int64), pos, tc, tkv, cfg32)
            ref_l = np.asarray(ref_l, np.float32)
            assert float(np.abs(got_l.float().numpy() - ref_l).max()) <= 1e-4 * float(np.abs(ref_l).max()), pos


def _adapter_dir(src, dst, vocab_fr=40, seed=3):
    """Copy of `src` with adapter.fr.safetensors (every layer's adapter and a
    vocab_fr-wide lm_head) and a vocab.json nested by language."""
    from safetensors.numpy import save_file

    shutil.copytree(src, dst)
    rng = np.random.RandomState(seed)
    sd = {}
    for i in range(2):
        pfx = f"wav2vec2.encoder.layers.{i}.adapter_layer"
        sd[f"{pfx}.norm.weight"] = (1 + 0.1 * rng.randn(64)).astype(np.float32)
        sd[f"{pfx}.norm.bias"] = (0.1 * rng.randn(64)).astype(np.float32)
        sd[f"{pfx}.linear_1.weight"] = (rng.randn(16, 64) / 8).astype(np.float32)
        sd[f"{pfx}.linear_1.bias"] = (0.1 * rng.randn(16)).astype(np.float32)
        sd[f"{pfx}.linear_2.weight"] = (rng.randn(64, 16) / 4).astype(np.float32)
        sd[f"{pfx}.linear_2.bias"] = (0.1 * rng.randn(64)).astype(np.float32)
    sd["lm_head.weight"] = (rng.randn(vocab_fr, 64) / 8).astype(np.float32)
    sd["lm_head.bias"] = (0.1 * rng.randn(vocab_fr)).astype(np.float32)
    save_file(sd, os.path.join(dst, "adapter.fr.safetensors"))
    fr = {t: i for i, t in enumerate(W2V_VOCAB + list("éèàùâêîôûç€çœ")[: vocab_fr - len(W2V_VOCAB)])}
    with open(os.path.join(dst, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({"en": {t: i for i, t in enumerate(W2V_VOCAB)}, "fr": fr}, f, ensure_ascii=False)
    return dst


def test_load_adapter_matches_jax(tmp_path):
    base = hf_wav2vec2_dir(str(tmp_path / "mms"), stable=True, adapter_dim=16)
    adir = _adapter_dir(base, str(tmp_path / "mms_fr"))
    jm, m = JG.load_model(base), G.load_model(base, device="cpu")
    assert not G.load_adapter(m, adir, "de") and not JG.load_adapter(jm, adir, "de")
    assert m.cfg.vocab_size == len(W2V_VOCAB)
    assert JG.load_adapter(jm, adir, "fr") and G.load_adapter(m, adir, "fr")
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(jm.cfg)
    assert m.cfg.vocab_size == jm.cfg.vocab_size == 40
    assert m.tokenizer.vocab == jm.tokenizer.vocab and len(m.tokenizer) == 40
    assert m.vocab() == jm.vocab()
    ref_tree = H.load_wav2vec2_adapter(H.load_wav2vec2(base)[0], adir, "fr")
    assert_same_tree(ref_tree, jm.params)
    _w2v_log_probs_match(jm.params, jm.cfg, m.module, m.cfg)
    jtree = jax.tree_util.tree_map(np.asarray, JW.init_params(jax.random.PRNGKey(0), JW.make_config("tiny_test")))
    whisper = G.from_tree(jtree, W.make_config("tiny_test"), device="cpu")
    assert not G.load_adapter(whisper, adir, "fr")


def test_safetensors_reader_matches_safetensors_numpy(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.RandomState(0)
    arrays = {f"t_{np.dtype(dt).name}": (rng.randn(3, 5) * 100).astype(dt) for dt in H.SAFETENSORS_DTYPES.values()}
    arrays["scalar"] = np.asarray(3.5, np.float32)
    arrays["empty"] = np.zeros((0, 4), np.float16)
    arrays["odd"] = np.arange(7, dtype=np.int8)  # leaves the next tensor off its natural alignment
    arrays["after_odd"] = rng.randn(3).astype(np.float64)
    path = str(tmp_path / "all.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    mine, ref = H.read_safetensors(path), load_file(path)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype and mine[k].shape == ref[k].shape
        assert np.array_equal(np.ascontiguousarray(mine[k]).view(np.uint8), np.ascontiguousarray(ref[k]).view(np.uint8)), k


def test_bf16_and_missing_weights_are_refused(tmp_path):
    from safetensors.torch import save_file

    path = str(tmp_path / "bf16.safetensors")
    save_file({"w": torch.ones(2, 2, dtype=torch.bfloat16)}, path)
    with pytest.raises(ValueError, match="BF16"):
        H.read_safetensors(path)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        H._load_state_dict(str(tmp_path / "empty"))
