"""The port's Whisper slice against ssak_tpu on the CPU: the tiny_test
model in f32 with the same weights (ssak_tpu's seeded tree, converted by
ssak_tpu_torch.models.convert). Logits agree to 1e-4 of their largest
value (f32, sums in another order), greedy tokens and transcripts exactly.
With int8 K/V caches both packages also quantize q and the probabilities
to int8 on the CPU path; a value that the two sum orders put on either
side of a rounding boundary lands one int8 step apart, so those logits
are held to 2e-3 of their largest value (one step is 1/127 of a share)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.infer.general import LoadedModel as JLoadedModel, ModelType as JModelType
from ssak_tpu.infer.whisper_infer import whisper_transcribe_batch as jax_transcribe_batch
from ssak_tpu.models import quant as JQ
from ssak_tpu.models import whisper as JW
from ssak_tpu.ops.logmel import log_mel_spectrogram as jax_log_mel
from ssak_tpu_torch.infer.general import from_tree
from ssak_tpu_torch.infer.whisper_infer import whisper_transcribe_batch
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import quant as Q
from ssak_tpu_torch.models import whisper as W
from ssak_tpu_torch.models.convert import whisper_from_tree


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _port_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(W.WhisperConfig)}
    return W.WhisperConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})


@pytest.fixture(scope="module")
def tiny():
    """(JAX f32 config, numpy parameter tree, mel batch (3, 80, 200))."""
    cfg = JW.make_config("tiny_test", dtype="float32")
    params = _np_tree(JW.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(0)
    audio = (rng.randn(3, cfg.n_audio_ctx * 320) * 0.1).astype(np.float32)
    mel = np.array(jax_log_mel(jnp.asarray(audio), n_mels=cfg.n_mels))
    return cfg, params, mel


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def test_convert_float_tree(tiny):
    _cfg, params, _ = tiny
    m = whisper_from_tree(params)
    blk = params["decoder"]["blocks"][1]
    np.testing.assert_array_equal(m.decoder.blocks[1].attn.query.weight.numpy(), blk["attn"]["query"]["kernel"].T)
    np.testing.assert_array_equal(m.decoder.blocks[1].cross_attn.out.bias.numpy(), blk["cross_attn"]["out"]["bias"])
    assert m.decoder.blocks[1].attn.key.bias is None
    conv = params["encoder"]["conv2"]["kernel"]  # (K, Cin, Cout) -> (Cout, Cin, K)
    np.testing.assert_array_equal(m.encoder.conv2.weight.numpy(), conv.transpose(2, 1, 0))
    np.testing.assert_array_equal(m.decoder.token_embedding.numpy(), params["decoder"]["token_embedding"])
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in m.parameters()) == n_jax


def test_convert_int8_tree_and_quantize_params(tiny):
    """A JAX-quantized tree converts leaf for leaf, and the port's own
    quantize_params on the float model gives the same int8 values."""
    _cfg, params, _ = tiny
    qtree = JQ.quantize_params(params, bits=8)
    mq = whisper_from_tree(qtree)
    mine = Q.quantize_params(whisper_from_tree(params), bits=8)
    n_quant = 0
    for (name, a), (name2, b) in zip(mq.named_modules(), mine.named_modules()):
        assert name == name2 and type(a) is type(b)
        if isinstance(a, L.QuantLinear):
            n_quant += 1
            assert torch.equal(a.q8, b.q8) and torch.equal(a.scale, b.scale)
    blk = qtree["decoder"]["blocks"][0]["mlp"]["fc1"]
    fc1 = mq.decoder.blocks[0].mlp.fc1
    np.testing.assert_array_equal(fc1.q8.numpy(), blk["kernel"]["q8"])
    np.testing.assert_array_equal(fc1.bias.numpy(), blk["bias"])
    n_jax = sum(1 for p, _ in JQ._walk(qtree) if p.endswith("/q8"))
    assert n_quant == n_jax > 0
    assert isinstance(mq.encoder.conv1, L.Conv1d)  # 3-D conv kernels stay float


def test_encode(tiny):
    cfg, params, mel = tiny
    ref = JW.encode(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(mel), cfg)
    got = W.encode(whisper_from_tree(params), torch.from_numpy(mel), _port_cfg(cfg))
    assert tuple(got.shape) == (3, cfg.n_audio_ctx, cfg.n_audio_state)
    _close(got, ref)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_kv", "int8_kv"])
def test_decode_step_teacher_forced(tiny, kv_int8):
    cfg, params, mel = tiny
    cfg = dataclasses.replace(cfg, kv_int8=kv_int8)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tm, tcfg = whisper_from_tree(params), _port_cfg(cfg)
    af = JW.encode(jp, jnp.asarray(mel), cfg)
    jkv, jc = JW.precompute_cross_kv(jp, af, cfg), JW.init_cache(cfg, 3)
    taf = torch.from_numpy(np.array(af))  # the same features on both sides
    tkv, tc = W.precompute_cross_kv(tm, taf, tcfg), W.init_cache(tcfg, 3)
    for pos, tok in enumerate([1, 3, 50, 7, 99]):
        jtok = jnp.full((3, 1), tok, jnp.int32)
        ref, jc = JW._decode_step(jp, jtok, pos, jc, jkv, cfg)
        got, tc = W._decode_step(tm, torch.full((3, 1), tok, dtype=torch.int64), pos, tc, tkv, tcfg)
        _close(got, ref, rel=2e-3 if kv_int8 else 1e-4)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_kv", "int8_kv"])
def test_greedy_decode_tokens(tiny, kv_int8):
    cfg, params, mel = tiny
    cfg = dataclasses.replace(cfg, kv_int8=kv_int8)
    prompt = [cfg.sot, cfg.no_timestamps]
    rt, rl = JW.greedy_decode(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(mel), cfg, prompt, max_tokens=10)
    gt, gl = W.greedy_decode(whisper_from_tree(params), torch.from_numpy(mel), _port_cfg(cfg), prompt, max_tokens=10)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))


def test_fused_qkv_decode_matches_split(tiny):
    cfg, params, mel = tiny
    tcfg = _port_cfg(cfg)
    prompt = [cfg.sot, cfg.no_timestamps]
    mel_t = torch.from_numpy(mel)
    split = W.greedy_decode(whisper_from_tree(params), mel_t, tcfg, prompt, max_tokens=6)
    fused = W.greedy_decode(W.fuse_decode_qkv(whisper_from_tree(params)), mel_t, tcfg, prompt, max_tokens=6)
    assert torch.equal(split[0], fused[0])


def test_transcribe_batch_from_wav_files(tiny, tmp_path):
    """Both packages transcribe the same wav files (written and read back
    as int16 PCM) with the same f32 weights: identical transcripts."""
    from ssak_tpu_torch.audio import load_audio, save_audio

    cfg, params, _ = tiny
    rng = np.random.RandomState(1)
    batch = []
    for i, n in enumerate((32000, 20000, 9000)):
        path = tmp_path / f"u{i}.wav"
        save_audio(str(path), (rng.randn(n) * 0.1).astype(np.float32), 16000)
        batch.append(load_audio(str(path)))
    jm = JLoadedModel(JModelType.WHISPER, jax.tree_util.tree_map(jnp.asarray, params), cfg, None)
    ref = jax_transcribe_batch(jm, batch, max_tokens=12)
    got = whisper_transcribe_batch(from_tree(params, _port_cfg(cfg), device="cpu"), batch, max_tokens=12)
    assert got == ref and len(got) == 3 and all(got)


def test_transcribe_batch_not_ported_paths_raise(tiny, tmp_path):
    """What still needs a later slice raises at the call: tensor-parallel
    Whisper decode (8h); a quantized CTC model (slice 8b) loads. NeMo checkpoints are read
    (slice 7): an archive that is not there, or a directory without its
    weights, raises FileNotFoundError. A model without a tokenizer ignores
    language= and task=, as ssak_tpu's does. Long-form audio and the
    accurate chain run."""
    from ssak_tpu_torch.infer.general import load_model, shard_model
    from ssak_tpu_torch.infer.whisper_infer import transcribe_longform_batch, whisper_infer

    cfg, params, _ = tiny
    m = from_tree(params, _port_cfg(cfg), device="cpu")
    long_audio = np.zeros(cfg.n_audio_ctx * 320 + 1, np.float32)
    (tmp_path / "nemo").mkdir()
    (tmp_path / "nemo" / "model_config.yaml").write_text("name: ConformerCTC\n")
    with pytest.raises(FileNotFoundError):
        load_model("some/model.nemo", device="cpu")
    with pytest.raises(FileNotFoundError, match="model_weights.ckpt"):
        whisper_infer(str(tmp_path / "nemo"), [long_audio], device="cpu")
    q = load_model(None, seeded_test_config="wav2vec2", quantize_bits=8, device="cpu")
    assert q.module.encoder.blocks[0].mlp.fc1.bits == 8 and not hasattr(q.cfg, "kv_int8")
    with pytest.raises(NotImplementedError, match="8h"):
        shard_model(m)
    short = long_audio[:3000]
    assert whisper_transcribe_batch(m, [short], language="fr", max_tokens=3) == whisper_transcribe_batch(m, [short], max_tokens=3)
    assert len(whisper_transcribe_batch(m, [short], task="translate", beam_size=5, max_tokens=3)) == 1
    assert len(transcribe_longform_batch(m, [long_audio], language="en", max_tokens=3)) == 1
    # longform=False cuts windows instead, as in ssak_tpu; long-form and beam run
    assert len(whisper_transcribe_batch(m, [long_audio], longform=False, max_tokens=3)) == 1
    assert len(whisper_transcribe_batch(m, [long_audio, long_audio[:100]], beam_size=2, max_tokens=3)) == 2


def test_seeded_model_is_deterministic_and_quantizes():
    from ssak_tpu_torch.infer.general import load_model

    a = load_model(None, seeded_test_config="whisper", device="cpu")
    b = load_model(None, seeded_test_config="whisper", quantize_bits=8, device="cpu")
    assert a.cfg.kv_int8 is False and b.cfg.kv_int8 is True
    fc1a, fc1b = a.module.decoder.blocks[0].mlp.fc1, b.module.decoder.blocks[0].mlp.fc1
    q8, scale = Q.quantize_kernel(fc1a.weight.t())
    assert torch.equal(fc1b.q8, q8) and torch.equal(fc1b.scale, scale)
    assert b.module.decoder.token_embedding.dtype == torch.float32  # not a /kernel leaf
