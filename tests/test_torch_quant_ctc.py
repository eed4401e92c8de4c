"""Quantized CTC models in the port (load_model(quantize_bits=8|4) on
wav2vec2 and Conformer models, ctc_infer(quantize_bits=...)) against
ssak_tpu on the CPU.

The set of quantized layers is ssak_tpu's (every 2-D `/kernel` leaf of at
least 64 x 64 values) and each payload is ssak_tpu's bit for bit. Log-probs
are compared in f32: both packages dequantize the same payloads to the
same f32 weights, so the log-probs agree as the unquantized f32 models do
(5e-5 for wav2vec2, tests/test_torch_ctc_infer.py; 1e-4 for the NeMo
Conformer, tests/test_torch_nemo.py), and greedy transcripts are equal."""

import dataclasses
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
from ssak_tpu.models import conformer as JC
from ssak_tpu.models import quant as JQ
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu.models.tokenizer import CTCTokenizer as JTokenizer
from ssak_tpu_torch.audio import save_audio
from ssak_tpu_torch.models import conformer as TC
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import quant as TQ
from ssak_tpu_torch.models import wav2vec2 as TW
from ssak_tpu_torch.models.convert import conformer_from_tree, wav2vec2_from_tree
from test_nemo_parity import _f32_cfg
from test_torch_nemo import CHAR_VOCAB, build_nemo_archive


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_quantized_paths(qtree):
    """Paths of the kernel leaves ssak_tpu's quantize_params replaced, with
    their payload dicts."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            if "scale" in node and ("q8" in node or "q4" in node):
                out[path] = node
                return
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")

    walk(qtree, "")
    return out


def _port_quantized_paths(module):
    return {"/" + name.replace(".", "/") + "/kernel": sub for name, sub in module.named_modules()
            if isinstance(sub, L.QuantLinear)}


@pytest.fixture(scope="module")
def nemo_archive(tmp_path_factory):
    """A NeMo char Conformer archive at d_model 64 (its FFN, projections,
    linear_pos and pointwise convs reach 64 x 64 values)."""
    return build_nemo_archive(str(tmp_path_factory.mktemp("nemo") / "q.nemo"), CHAR_VOCAB, d=64, heads=4, seed=3)


def _trees(kind, nemo_archive):
    """(ssak_tpu tree with numpy leaves, the function that builds the
    port's module); the seeded heads have 64 x 64 values, the archive's
    fewer."""
    if kind == "wav2vec2":
        cfg = JW.make_config("tiny_test", vocab_size=64)
        return _np(JW.init_params(jax.random.PRNGKey(0), cfg)), wav2vec2_from_tree
    if kind == "nemo":
        from ssak_tpu.models.hf_loader import load_nemo_conformer

        return _np(load_nemo_conformer(nemo_archive)[0]), conformer_from_tree
    cfg = JC.make_config("tiny_test", vocab_size=64) if kind == "conformer_rope" else _f32_cfg(vocab_size=65,
                                                                                                 blank_id=64)
    return _np(JC.init_params(jax.random.PRNGKey(1), cfg)), conformer_from_tree


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kind", ["wav2vec2", "conformer_rope", "conformer_relpos", "nemo"])
def test_quantized_layers_and_payloads_are_jax_s(kind, bits, nemo_archive):
    """The same layers quantized (lm_head, the feature projection, the
    Conformer's linear_pos, pointwise convs and subsampling projection; no
    conv kernel), each payload and scale bit for bit."""
    tree, build = _trees(kind, nemo_archive)
    want = _jax_quantized_paths(JQ.quantize_params(tree, bits=bits))
    module = TQ.quantize_params(build(tree, "cpu"), bits=bits)
    got = _port_quantized_paths(module)
    assert set(got) == set(want) and len(got) >= 4
    assert ("/lm_head/kernel" in got) == (kind != "nemo")  # 64 x 30 values in the archive: below MIN_SIZE
    assert not any("conv/kernel" in p or "convs" in p or "conv1" in p or "conv2" in p for p in got)
    if kind != "wav2vec2":
        assert any(p.endswith("pointwise1/kernel") for p in got) and "/subsampling/proj/kernel" in got
    if kind in ("conformer_relpos", "nemo"):
        assert any(p.endswith("linear_pos/kernel") for p in got)
    for path, q in want.items():
        layer = got[path]
        assert layer.bits == (4 if "q4" in q else 8)
        np.testing.assert_array_equal(layer.payload.numpy(), np.asarray(q["q4" if "q4" in q else "q8"]))
        np.testing.assert_array_equal(layer.scale.numpy(), np.asarray(q["scale"]))
    dense_left = {"/" + n.replace(".", "/") + "/kernel" for n, s in module.named_modules() if isinstance(s, L.Linear)}
    assert not dense_left & set(want)


def _audio(seed=0):
    rng = np.random.RandomState(seed)
    audio = (0.1 * rng.randn(3, 24000)).astype(np.float32)
    lens = np.array([24000, 16000, 9000], np.int32)
    audio[np.arange(24000)[None, :] >= lens[:, None]] = 0
    return audio, lens


def _f32(model):
    model.cfg = dataclasses.replace(model.cfg, dtype="float32")
    return model


@pytest.fixture
def w2v_loaders(monkeypatch):
    """Both packages' directory loaders return f32 copies of one seeded tiny
    wav2vec2 (a fresh module for each port load: quantization replaces its
    layers in place), so load_model's own quantization runs in each."""
    jcfg = JW.make_config("tiny_test", dtype="float32")
    params = JW.init_params(jax.random.PRNGKey(0), jcfg)
    tok = TG.seeded_ctc_tokenizer(jcfg.vocab_size)
    monkeypatch.setattr(JG, "_load_model", lambda *a, **k: JG.LoadedModel(
        JG.ModelType.WAV2VEC2_CTC, params, jcfg, JTokenizer(dict(tok.vocab))))
    tcfg = TW.make_config("tiny_test", dtype="float32")
    monkeypatch.setattr(TG, "_load_dir", lambda model_dir, dev: TG.from_tree(_np(params), tcfg, device=dev))
    return jcfg


@pytest.mark.parametrize("bits", [8, 4])
def test_wav2vec2_log_probs_match_jax(w2v_loaders, bits):
    jm, tm = JG.load_model("m", quantize_bits=bits), TG.load_model("m", quantize_bits=bits, device="cpu")
    assert tm.cfg == TW.make_config("tiny_test", dtype="float32")  # no int8 K/V caches on a CTC model
    audio, lens = _audio()
    want, wfl = JG.compute_log_probas(jm, jnp.asarray(audio), jnp.asarray(lens))
    got, gfl = TG.compute_log_probas(tm, audio, lens)
    np.testing.assert_array_equal(gfl.numpy(), np.asarray(wfl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    plain, _ = TG.compute_log_probas(TG.load_model("m", device="cpu"), audio, lens)
    assert np.abs(plain.numpy() - got.numpy()).max() > 1e-3  # the weights really are quantized


@pytest.mark.parametrize("bits", [8, 4])
def test_nemo_archive_log_probs_match_jax(nemo_archive, bits):
    """load_model(archive, quantize_bits) in both packages, then f32
    log-probs of ragged rows and their greedy texts."""
    jm = JG.load_model(nemo_archive, quantize_bits=bits)
    tm = TG.load_model(nemo_archive, quantize_bits=bits, device="cpu")
    assert isinstance(tm.module, TC.ConformerModel) and isinstance(tm.module.blocks[0].attn.linear_pos, L.QuantLinear)
    jm.cfg = dataclasses.replace(jm.cfg, dtype="float32")
    audio, lens = _audio(1)
    want, wfl = JG.compute_log_probas(jm, jnp.asarray(audio), jnp.asarray(lens))
    got, gfl = TG.compute_log_probas(_f32(tm), audio, lens)
    np.testing.assert_array_equal(gfl.numpy(), np.asarray(wfl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    texts = TG.decode_log_probas(tm, got, gfl)
    assert texts == JG.decode_log_probas(jm, want, wfl)


@pytest.mark.parametrize("bits", [8, 4])
def test_ctc_infer_quantized_matches_jax(w2v_loaders, tmp_path, bits):
    """ctc_infer(quantize_bits=...) over a seeded Kaldi dir: ssak_tpu's
    transcripts."""
    rng = np.random.RandomState(bits)
    scp = []
    for i, n in enumerate((9000, 16000, 30000, 4000)):
        t = np.arange(n) / 16000.0
        audio = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t) + 0.05 * rng.randn(n)
        path = str(tmp_path / f"utt{i}.wav")
        save_audio(path, audio.astype(np.float32), 16000)
        scp.append(f"utt{i} {path}")
    (tmp_path / "wav.scp").write_text("\n".join(scp) + "\n")
    want = list(JCI.ctc_infer("m", str(tmp_path), output_ids=True, quantize_bits=bits))
    got = list(TCI.ctc_infer("m", str(tmp_path), output_ids=True, quantize_bits=bits, device="cpu"))
    assert got == want and len(got) == 4 and any(t for _, t in got)


def test_quantized_ctc_cli_runs_on_the_cpu(tmp_path):
    """python -m ssak_tpu_torch.infer.ctc_infer DIR m --seeded_test_config
    wav2vec2 --load_in_8bit / --load_in_4bit --device cpu: one line per
    file."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.RandomState(0)
    with open(tmp_path / "wav.scp", "w") as f:
        for i in range(2):
            p = tmp_path / f"utt{i}.wav"
            save_audio(str(p), (0.1 * rng.randn(12000)).astype(np.float32), 16000)
            f.write(f"utt{i} {p}\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for flag in ("--load_in_8bit", "--load_in_4bit"):
        out = subprocess.run([sys.executable, "-m", "ssak_tpu_torch.infer.ctc_infer", str(tmp_path), "m",
                              "--seeded_test_config", "wav2vec2", flag, "--device", "cpu"], cwd=repo,
                             capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stderr
        assert [ln.split()[0] for ln in out.stdout.strip().splitlines()] == ["utt0", "utt1"]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("family", ["wav2vec2", "conformer"])
def test_finalize_exports_quantize_like_jax(tmp_path, family, bits):
    """load_model(EXPORT, quantize_bits) on a `sak-finalize` export (f32
    config) in both packages: the same quantized layers and payloads, and
    f32 log-probs within the unquantized models' tolerance."""
    from ssak_tpu.models.tokenizer import CTCTokenizer as JTok
    from ssak_tpu.train import finalize as JF

    tok = JTok(dict(TG.seeded_ctc_tokenizer(64).vocab))
    if family == "wav2vec2":
        cfg = JW.make_config("tiny_test", dtype="float32", vocab_size=64)
        tree = _np(JW.init_params(jax.random.PRNGKey(5), cfg))
        d = JF.export_model(tree, cfg, str(tmp_path / "w2v"), tokenizer=tok)
    else:
        cfg = JC.make_config("tiny_test", dtype="float32", vocab_size=64)
        tree = _np(JC.init_params(jax.random.PRNGKey(6), cfg))
        d = JF.export_model(tree, cfg, str(tmp_path / "conf"), model_type="conformer_ctc", tokenizer=tok)
    jm, tm = JG.load_model(d, quantize_bits=bits), TG.load_model(d, quantize_bits=bits, device="cpu")
    want, got = _jax_quantized_paths(jm.params), _port_quantized_paths(tm.module)
    assert set(got) == set(want) and "/lm_head/kernel" in got
    for path, q in want.items():
        np.testing.assert_array_equal(got[path].payload.numpy(), np.asarray(q["q4" if "q4" in q else "q8"]))
    audio, lens = _audio(2)
    ref, rfl = JG.compute_log_probas(jm, jnp.asarray(audio), jnp.asarray(lens))
    out, ofl = TG.compute_log_probas(tm, audio, lens)
    np.testing.assert_array_equal(ofl.numpy(), np.asarray(rfl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5 if family == "wav2vec2" else 1e-4)
