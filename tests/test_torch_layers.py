"""ssak_tpu_torch.models.layers / models.quant / ops.logmel against their
ssak_tpu counterparts on the same numpy inputs (CPU). Layers are compared
in f32, where both sides compute the same sums in another order: 1e-5
relative to the output's largest value unless a test says otherwise.
Quantization is compared bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssak_tpu.models import layers as JL
from ssak_tpu.models import quant as JQ
from ssak_tpu.ops import logmel as JM
from ssak_tpu_torch.models import convert as C
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import quant as Q
from ssak_tpu_torch.ops import logmel as M

F32 = torch.float32


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, rel=1e-5):
    ref = _np(ref)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0, atol=rel * float(np.abs(ref).max()) + 1e-7)


def _lin(rng, d_in, d_out, bias=True):
    p = {"kernel": (rng.randn(d_in, d_out) / np.sqrt(d_in)).astype(np.float32)}
    if bias:
        p["bias"] = (rng.randn(d_out) * 0.1).astype(np.float32)
    return p


def _attn_tree(rng, d):
    return {"query": _lin(rng, d, d), "key": _lin(rng, d, d, bias=False), "value": _lin(rng, d, d), "out": _lin(rng, d, d)}


def _jtree(p):
    if isinstance(p, dict):
        return {k: _jtree(v) for k, v in p.items()}
    return jnp.asarray(p)


def test_layer_norm_gelu_mlp():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 32).astype(np.float32)
    ln = {"scale": rng.rand(32).astype(np.float32) + 0.5, "bias": rng.randn(32).astype(np.float32)}
    _close(L.layer_norm(torch.from_numpy(x), C.ln_from_tree(ln, "cpu")), JL.layer_norm(jnp.asarray(x), _jtree(ln)))
    _close(L.gelu(torch.from_numpy(x)), JL.gelu(jnp.asarray(x)))
    mp = {"fc1": _lin(rng, 32, 64), "fc2": _lin(rng, 64, 32)}
    tm = L.MLP(C.linear_from_tree(mp["fc1"], "cpu"), C.linear_from_tree(mp["fc2"], "cpu"))
    _close(L.mlp(torch.from_numpy(x), tm, dtype=F32), JL.mlp(jnp.asarray(x), _jtree(mp), dtype=jnp.float32))


def test_layer_norm_keeps_bf16_stream():
    x = torch.randn(2, 3, 16).to(torch.bfloat16)
    ln = L.LayerNorm(torch.ones(16), torch.zeros(16))
    assert L.layer_norm(x, ln).dtype == torch.bfloat16


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_dense(quantized):
    rng = np.random.RandomState(1)
    p = _lin(rng, 128, 256)
    if quantized:
        p = {"kernel": JQ.quantize_kernel(p["kernel"]), "bias": p["bias"]}
    x = rng.randn(3, 4, 128).astype(np.float32)
    got = L.dense(torch.from_numpy(x), C.linear_from_tree(p, "cpu"), dtype=F32)
    _close(got, JL.dense(jnp.asarray(x), _jtree(p), dtype=jnp.float32))


def test_dense_bf16_dtype_order():
    """bf16 in -> bf16 out with the f32 bias added to the product (loose:
    the port's bf16 GEMM rounds its product to bf16 before the bias)."""
    rng = np.random.RandomState(2)
    p = _lin(rng, 64, 32)
    x = rng.randn(2, 64).astype(np.float32)
    got = L.dense(torch.from_numpy(x), C.linear_from_tree(p, "cpu"), dtype=torch.bfloat16)
    ref = JL.dense(jnp.asarray(x), _jtree(p), dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, ref, rel=2e-2)


def test_conv1d():
    rng = np.random.RandomState(3)
    p = {"kernel": rng.randn(3, 8, 16).astype(np.float32) * 0.3, "bias": rng.randn(16).astype(np.float32)}
    x = rng.randn(2, 21, 8).astype(np.float32)
    for stride, pad in ((1, (1, 1)), (2, (1, 1)), (2, (0, 2))):
        got = L.conv1d(torch.from_numpy(x), C.conv_from_tree(p, "cpu"), stride=stride, padding=pad, dtype=F32)
        _close(got, JL.conv1d(jnp.asarray(x), _jtree(p), stride=stride, padding=pad, dtype=jnp.float32))


def test_sinusoid_position_embedding():
    np.testing.assert_array_equal(L.sinusoid_position_embedding(50, 32), JL.sinusoid_position_embedding(50, 32))


def test_mha_encoder_with_lengths():
    rng = np.random.RandomState(4)
    p = _attn_tree(rng, 32)
    x = rng.randn(2, 9, 32).astype(np.float32)
    lengths = np.array([9, 5], np.int32)
    got, _ = L.mha(torch.from_numpy(x), C.attn_from_tree(p, "cpu"), 4, dtype=F32, lengths=torch.from_numpy(lengths))
    ref, _ = JL.mha(jnp.asarray(x), _jtree(p), 4, dtype=jnp.float32, lengths=jnp.asarray(lengths))
    _close(got, ref)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused_qkv"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16_cache", "int8_cache"])
def test_mha_decode_steps(kv_int8, fused):
    """Three cached decode steps through mha with attn_bounds (on the CPU:
    the mask paths), the cache written in place by the port."""
    rng = np.random.RandomState(5)
    B, H, D, Lc = 2, 4, 32, 8
    p = _attn_tree(rng, D)
    jp = _jtree(p)
    tp = C.attn_from_tree(p, "cpu")
    if fused:
        jp = JL.fuse_qkv_params(jp)
        L.fuse_qkv_params(tp)
        assert hasattr(tp, "qkv") and not hasattr(tp, "query")
    if kv_int8:
        jc = JL.init_int8_cache(B, H, D // H, Lc)
        tc = L.init_int8_cache(B, H, D // H, Lc)
    else:
        jc = {"k": jnp.zeros((B, H, D // H, Lc), jnp.float32), "v": jnp.zeros((B, H, D // H, Lc), jnp.float32)}
        tc = {"k": torch.zeros(B, H, D // H, Lc), "v": torch.zeros(B, H, D // H, Lc)}
    for pos in range(3):
        x = rng.randn(B, 1, D).astype(np.float32)
        ref, jc = JL.mha(jnp.asarray(x), jp, H, cache=jc, cache_index=pos, attn_bounds=(0, pos), dtype=jnp.float32)
        got, tc2 = L.mha(torch.from_numpy(x), tp, H, cache=tc, cache_index=pos, attn_bounds=(0, pos), dtype=F32)
        assert tc2 is tc  # updated in place
        _close(got, ref, rel=1e-4 if kv_int8 else 1e-5)
    for k in tc:
        np.testing.assert_allclose(tc[k].float().numpy(), _np(jc[k]), atol=1e-6)
    with pytest.raises(ValueError, match="attn_bounds"):  # a cache is for bounded decode steps only
        L.mha(torch.from_numpy(x), tp, H, cache=tc, cache_index=3, dtype=F32)


def test_decode_attention_bounded_cpu_paths():
    """On the CPU decode_attention_bounded takes ssak_tpu's mask paths:
    decode_attention (float cache) and self_attention_int8 (int8 dict)."""
    rng = np.random.RandomState(6)
    B, H, Dh, T = 3, 2, 16, 24
    q = rng.randn(B, 1, H, Dh).astype(np.float32)
    kT = rng.randn(B, H, Dh, T).astype(np.float32)
    vT = rng.randn(B, H, Dh, T).astype(np.float32)
    lo, hi = np.array([0, 3, 10], np.int32), np.array([T - 1, 15, 12], np.int32)
    ref = JL.decode_attention_bounded(jnp.asarray(q), {"k": jnp.asarray(kT), "v": jnp.asarray(vT)}, jnp.asarray(lo), jnp.asarray(hi), dtype=jnp.float32)
    got = L.decode_attention_bounded(torch.from_numpy(q), {"k": torch.from_numpy(kT), "v": torch.from_numpy(vT)},
                                     torch.from_numpy(lo), torch.from_numpy(hi), dtype=F32)
    _close(got, ref)
    jkv8 = JL.quantize_decode_kv(jnp.asarray(kT), jnp.asarray(vT))
    tkv8 = L.quantize_decode_kv(torch.from_numpy(kT), torch.from_numpy(vT))
    for k in ("k8", "v8"):  # same f32 division and half-to-even rounding
        np.testing.assert_array_equal(tkv8[k].numpy(), np.asarray(jkv8[k]))
    for k in ("ks", "vs"):
        np.testing.assert_array_equal(tkv8[k].float().numpy(), _np(jkv8[k]))
    ref8 = JL.decode_attention_bounded(jnp.asarray(q), jkv8, jnp.asarray(lo), jnp.asarray(hi), dtype=jnp.float32)
    got8 = L.decode_attention_bounded(torch.from_numpy(q), tkv8, torch.from_numpy(lo), torch.from_numpy(hi), dtype=F32)
    _close(got8, ref8, rel=1e-4)
    # and the int8 path is self_attention_int8 with the range mask
    t = torch.arange(T)
    mask = ((t[None, :] >= torch.from_numpy(lo)[:, None]) & (t[None, :] <= torch.from_numpy(hi)[:, None]))[:, None, None, :]
    torch.testing.assert_close(L.self_attention_int8(torch.from_numpy(q), tkv8, mask=mask, dtype=F32), got8)


def test_quantize_kernel_bit_exact():
    rng = np.random.RandomState(7)
    w = (rng.randn(96, 200) * 0.07).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes scale 1
    ref = JQ.quantize_kernel(w)
    q8, scale = Q.quantize_kernel(torch.from_numpy(w))
    assert q8.dtype == torch.int8 and q8.is_contiguous() and tuple(scale.shape) == (1, 200)
    np.testing.assert_array_equal(q8.numpy(), ref["q8"])
    np.testing.assert_array_equal(scale.numpy(), ref["scale"])
    deq = Q.dequantize_kernel(L.QuantLinear(q8, scale), F32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(JQ.dequantize_kernel(_jtree(ref), jnp.float32)))


def test_log_mel_spectrogram():
    rng = np.random.RandomState(8)
    audio = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    for n_mels in (80, 128):
        ref = JM.log_mel_spectrogram(jnp.asarray(audio), n_mels=n_mels)
        got = M.log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels)
        assert tuple(got.shape) == (2, n_mels, 100)
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4)


def test_pad_or_trim():
    a = torch.arange(10.0).reshape(2, 5)
    np.testing.assert_array_equal(M.pad_or_trim(a, 8).numpy(), np.asarray(JM.pad_or_trim(jnp.asarray(a.numpy()), 8)))
    np.testing.assert_array_equal(M.pad_or_trim(a, 3).numpy(), np.asarray(JM.pad_or_trim(jnp.asarray(a.numpy()), 3)))
    np.testing.assert_array_equal(M.pad_or_trim(a, 4, axis=0).numpy(), np.asarray(JM.pad_or_trim(jnp.asarray(a.numpy()), 4, axis=0)))
