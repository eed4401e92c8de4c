"""The port's LoRA and the layers it touches (ssak_tpu_torch.models.lora,
layers.dense / mha / causal_mask / fuse_qkv_params, quant.quantize_params /
partition_trainable, convert.whisper_from_tree / whisper_to_tree) against
ssak_tpu on the CPU.

Adapters drawn by JAX cross to the port through whisper_from_tree or
load_lora (the two packages' generators give different bits). f32 cases
are held to 1e-5 of the largest output (sums in other orders); bf16 cases
to 2^-8 of it, one bf16 step of an output below half the largest: both
dense layers keep the base product in f32, add the adapter term and the
bias, and round once, so only an f32 sum of another order that lands at a
rounding boundary can differ (none does at these shapes)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.models import layers as JL
from ssak_tpu.models import lora as JLoRA
from ssak_tpu.models import quant as JQ
from ssak_tpu.models import whisper as JW
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import lora as TLoRA
from ssak_tpu_torch.models import quant as TQ
from ssak_tpu_torch.models import whisper as W
from ssak_tpu_torch.models.convert import linear_from_tree, whisper_from_tree, whisper_to_tree

F32, BF16 = torch.float32, torch.bfloat16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dense_tree(rng, d_in=128, d_out=256, rank=4, bits=0):
    """A dense dict with bias and a LoRA adapter whose B is nonzero (a
    fresh B = 0 would hide the adapter term), quantized by ssak_tpu."""
    p = {"kernel": (rng.randn(d_in, d_out) / np.sqrt(d_in)).astype(np.float32),
         "bias": (0.1 * rng.randn(d_out)).astype(np.float32),
         "lora_A": (rng.randn(d_in, rank) / np.sqrt(d_in)).astype(np.float32),
         "lora_B": (0.2 * rng.randn(rank, d_out)).astype(np.float32),
         "lora_scale": np.asarray(16.0 / rank, np.float32)}
    if bits:
        p["kernel"] = JQ.quantize_kernel(p["kernel"], bits=bits)
    return p


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [(3, 7), (5, 1)])
def test_dense_with_lora_matches_jax(bits, dtype, rows):
    """LoRA over a float, int8 or int4 base, in f32 and bf16, on
    multi-token and decode-shaped activations (the CPU takes the
    dequantize path in both packages)."""
    rng = np.random.RandomState(bits + len(dtype))
    p = _dense_tree(rng, bits=bits)
    x = rng.randn(*rows, 128).astype(np.float32)
    jdt, tdt = (jnp.float32, F32) if dtype == "float32" else (jnp.bfloat16, BF16)
    ref = np.asarray(JL.dense(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), jdt).astype(jnp.float32))
    layer = linear_from_tree(p, "cpu")
    assert isinstance(layer, L.QuantLinear if bits else L.Linear) and layer.lora_A is not None
    got = L.dense(torch.from_numpy(x), layer, tdt)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol * np.abs(ref).max(), rtol=0)
    # without its adapter the layer is the base alone: the adapter term is really there
    del p["lora_A"], p["lora_B"], p["lora_scale"]
    base = np.asarray(JL.dense(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), jdt).astype(jnp.float32))
    assert np.abs(base - ref).max() > 10 * tol * np.abs(ref).max()


@pytest.mark.parametrize("offset", [0, 3])
def test_causal_mask_matches_jax(offset):
    got = L.causal_mask(5, 9, offset)
    assert got.dtype == torch.bool and tuple(got.shape) == (1, 1, 5, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JL.causal_mask(5, 9, offset)))


@pytest.mark.parametrize("lora", [False, True])
def test_mha_cross_attention_matches_jax(lora):
    """mha(kv_x=): queries from x, keys and values from the audio features,
    with and without adapters on query / value (f32)."""
    rng = np.random.RandomState(1)
    D, H = 64, 4
    p = {n: {"kernel": (rng.randn(D, D) / 8).astype(np.float32), "bias": (0.1 * rng.randn(D)).astype(np.float32)}
         for n in ("query", "key", "value", "out")}
    del p["key"]["bias"]
    if lora:
        for n in ("query", "value"):
            p[n].update(lora_A=(rng.randn(D, 2) / 8).astype(np.float32), lora_B=(0.3 * rng.randn(2, D)).astype(np.float32),
                        lora_scale=np.asarray(8.0, np.float32))
    x = rng.randn(2, 6, D).astype(np.float32)
    kv = rng.randn(2, 11, D).astype(np.float32)
    ref, _ = JL.mha(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), H, kv_x=jnp.asarray(kv), dtype=jnp.float32)
    attn = L.MultiHeadAttention(**{n: linear_from_tree(p[n], "cpu") for n in ("out", "query", "key", "value")})
    got, cache = L.mha(torch.from_numpy(x), attn, H, kv_x=torch.from_numpy(kv), dtype=F32)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5 * np.abs(np.asarray(ref)).max(), rtol=0)
    # a causal self-attention mask too
    mask = L.causal_mask(6, 6)
    ref, _ = JL.mha(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), H, mask=JL.causal_mask(6, 6), dtype=jnp.float32)
    got, _ = L.mha(torch.from_numpy(x), attn, H, mask=mask, dtype=F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5 * np.abs(np.asarray(ref)).max(), rtol=0)


def _tiny_tree(seed=0, rank=0, dtype="float32"):
    cfg = JW.make_config("tiny_test", dtype=dtype)
    tree = JW.init_params(jax.random.PRNGKey(seed), cfg)
    if rank:
        tree = JLoRA.add_lora(tree, rank=rank, key=jax.random.PRNGKey(seed + 1))
    return _np_tree(tree), cfg


def test_fuse_qkv_params_skips_lora_projections():
    """As ssak_tpu's fuse_decode_qkv: a LoRA-carrying self-attention stays
    split (and decodes as before); one without adapters is fused."""
    tree, cfg = _tiny_tree(rank=2)
    tcfg = W.make_config("tiny_test", dtype="float32")
    model = whisper_from_tree(tree)
    mel = torch.from_numpy(np.random.RandomState(9).randn(2, cfg.n_mels, 200).astype(np.float32) * 0.1)
    prompt = [cfg.sot, cfg.no_timestamps]
    t0, _ = W.greedy_decode(model, mel, tcfg, prompt, max_tokens=6)
    W.fuse_decode_qkv(model)
    assert all(not hasattr(b.attn, "qkv") and b.attn.query.lora_A is not None for b in model.decoder.blocks)
    t1, _ = W.greedy_decode(model, mel, tcfg, prompt, max_tokens=6)
    assert torch.equal(t0, t1)
    jfused = JW.fuse_decode_qkv(tree)
    assert "qkv" not in jfused["decoder"]["blocks"][0]["attn"]
    plain = whisper_from_tree(_tiny_tree()[0])
    W.fuse_decode_qkv(plain)
    assert all(hasattr(b.attn, "qkv") for b in plain.decoder.blocks)


def test_add_lora_targets_shapes_and_identity():
    """Adapters on the attention query / value projections of both stacks
    (self and cross), A (in, r) ~ N(0, 1/d_in), B = 0, scale alpha / r, as
    ssak_tpu places them; fresh adapters leave the forward unchanged."""
    tree, cfg = _tiny_tree()
    tcfg = W.make_config("tiny_test", dtype="float32")
    model = whisper_from_tree(tree)
    mel = torch.from_numpy(np.random.RandomState(0).randn(1, cfg.n_mels, 200).astype(np.float32) * 0.1)
    with torch.no_grad():
        e1 = W.encode(model, mel, tcfg)
    TLoRA.add_lora(model, rank=4, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        e2 = W.encode(model, mel, tcfg)
    assert torch.equal(e1, e2)
    jkeys = sorted(JLoRA.extract_lora(JLoRA.add_lora(tree, rank=4)))
    got = TLoRA.extract_lora(model)
    assert sorted(got) == jkeys and len(jkeys) == 3 * 2 * (2 + 2 * 2)  # leaves x (q, v) x attention sites
    for k, v in got.items():
        if k.endswith("lora_A"):
            assert v.shape == (64, 4) and v.dtype == np.float32 and 0.05 < v.std() < 0.25
        elif k.endswith("lora_B"):
            assert v.shape == (4, 64) and not v.any()
        else:
            assert v == np.float32(4.0)
    names = dict(model.named_parameters())
    assert "decoder.blocks.0.cross_attn.value.lora_B" in names and "encoder.blocks.1.attn.query.lora_A" in names


def test_lora_grad_mask_and_partition():
    tree, _ = _tiny_tree(rank=4)
    model = whisper_from_tree(tree)
    grads = {k: torch.ones_like(p) for k, p in model.named_parameters()}
    masked = TLoRA.lora_grad_mask(grads)
    for k, g in masked.items():
        assert bool(g.all()) == (k.endswith("lora_A") or k.endswith("lora_B")), k
    trainable, frozen = TQ.partition_trainable(model)
    assert sorted(trainable) == sorted(k for k in grads if "lora_" in k)
    assert all(k.endswith("lora_scale") or "lora_" not in k for k in frozen)
    assert TQ.merge_partition(trainable, frozen).keys() == {**dict(model.named_parameters()),
                                                            **dict(model.named_buffers())}.keys()
    # without adapters every float parameter trains; integer payloads never do
    q = whisper_from_tree(_np_tree(JQ.quantize_params(_tiny_tree()[0], bits=8)))
    trainable, frozen = TQ.partition_trainable(q)
    assert sorted(trainable) == sorted(dict(q.named_parameters())) and any(k.endswith(".q8") for k in frozen)
    jt, jf = JQ.partition_trainable(_np_tree(JQ.quantize_params(_tiny_tree()[0], bits=8)))
    assert len([x for x in jax.tree_util.tree_leaves(jt)]) == len(trainable)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_keeps_lora(bits):
    """QLoRA order (add_lora, then quantize_params): the adapters stay on
    the quantized layers, as in ssak_tpu's tree."""
    tree, _ = _tiny_tree(rank=4)
    jq = _np_tree(JQ.quantize_params(tree, bits=bits))
    model = whisper_from_tree(tree)
    TQ.quantize_params(model, bits=bits)
    q = model.decoder.blocks[0].attn.query
    assert isinstance(q, L.QuantLinear) and q.lora_A is not None
    assert_same_tree(whisper_to_tree(model), jq)


def assert_same_tree(got, ref, path=""):
    """Same keys, dtypes, shapes and values, bit for bit."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), (path, sorted(got), sorted(ref))
        for k in ref:
            assert_same_tree(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_same_tree(a, b, f"{path}/{i}")
    else:
        a, b = np.asarray(got), np.asarray(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("case", ["f32", "f16", "lora", "int8_lora", "int4"])
def test_whisper_to_tree_inverts_whisper_from_tree(case):
    tree, _ = _tiny_tree(rank=4 if "lora" in case else 0)
    if case == "f16":
        tree = jax.tree_util.tree_map(lambda a: a.astype(np.float16), tree)
    elif case.startswith("int"):
        tree = _np_tree(JQ.quantize_params(tree, bits=int(case[3])))
    assert_same_tree(whisper_to_tree(whisper_from_tree(tree)), tree)


def _forward(model_or_tree, cfg, mel, tokens):
    """Teacher-forced logits of the port's module or of an ssak_tpu tree."""
    if isinstance(model_or_tree, dict):
        jp = jax.tree_util.tree_map(jnp.asarray, model_or_tree)
        af = JW.encode(jp, jnp.asarray(mel), cfg)
        return np.asarray(JW.decode_train(jp, jnp.asarray(tokens), af, cfg))
    with torch.no_grad():
        af = W.encode(model_or_tree, torch.from_numpy(mel), cfg)
        return W.decode_train(model_or_tree, torch.from_numpy(tokens), af, cfg).numpy()


def test_adapters_npz_load_both_ways(tmp_path):
    """An adapters.npz written by either package loads into the other with
    load_lora; the merged models (merge_lora) and the unmerged ones give
    the same logits as the writer's (f32, 1e-5 of max)."""
    base, cfg = _tiny_tree(seed=2)
    tcfg = W.make_config("tiny_test", dtype="float32")
    rng = np.random.RandomState(4)
    mel = (rng.randn(2, cfg.n_mels, 200) * 0.3).astype(np.float32)
    tokens = rng.randint(10, 120, (2, 9)).astype(np.int32)

    def close(a, b):
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(), rtol=0)

    # ssak_tpu writes: adapters with a nonzero B (trained-like), loaded by the port
    jl = JLoRA.add_lora(base, rank=4, key=jax.random.PRNGKey(7))
    jl = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + 0.1 * rng.randn(*np.shape(x)).astype(np.float32)
        if str(p[-1]).find("lora_B") >= 0 else np.asarray(x), jl)
    np.savez(tmp_path / "jax.npz", **JLoRA.extract_lora(jl))
    with np.load(tmp_path / "jax.npz") as z:
        port = TLoRA.load_lora(whisper_from_tree(base), {k: z[k] for k in z.files})
    ref = _forward(jl, cfg, mel, tokens)
    close(_forward(port, tcfg, mel, tokens), ref)
    close(_forward(TLoRA.merge_lora(port), tcfg, mel, tokens), _forward(_np_tree(JLoRA.merge_lora(jl)), cfg, mel, tokens))
    assert not TLoRA.extract_lora(port)

    # the port writes, ssak_tpu loads
    model = TLoRA.add_lora(whisper_from_tree(base), rank=4, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_B"):
                p.copy_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))))
    np.savez(tmp_path / "port.npz", **TLoRA.extract_lora(model))
    with np.load(tmp_path / "port.npz") as z:
        jtree = _np_tree(JLoRA.load_lora(base, {k: z[k] for k in z.files}))
    close(_forward(jtree, cfg, mel, tokens), _forward(model, tcfg, mel, tokens))
    close(_forward(_np_tree(JLoRA.merge_lora(jtree)), cfg, mel, tokens), _forward(TLoRA.merge_lora(model), tcfg, mel, tokens))


def test_merge_lora_refuses_a_quantized_kernel():
    tree, _ = _tiny_tree(rank=2)
    model = TQ.quantize_params(whisper_from_tree(tree), bits=8)
    with pytest.raises(TypeError, match="int8"):
        TLoRA.merge_lora(model)
