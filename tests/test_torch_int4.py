"""The port's int4 half against ssak_tpu on the CPU: quantization (bit for
bit), the plain version of kernel K3 against JAX's dequantize path and the
Pallas kernel in interpret mode, the int4 `dense`, tree conversion and the
seeded int4 load. On CPU tensors `matmul_int4` takes its plain version;
the CUDA kernel is held against the same plain version on the card by
chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.models import layers as JL
from ssak_tpu.models import quant as JQ
from ssak_tpu.models import whisper as JW
from ssak_tpu.ops.int8_matmul import int4_dense_supported as jax_int4_supported
from ssak_tpu.ops.int8_matmul import matmul_int4 as jax_matmul_int4
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import quant as Q
from ssak_tpu_torch.models import whisper as W
from ssak_tpu_torch.models.convert import whisper_from_tree
from ssak_tpu_torch.ops import int8_matmul as IM

K3_SHAPES = [(24, 256, 256), (4, 1280, 640), (17, 512, 300)]  # tests/test_ops_pallas.py's int4 cases


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many small ops. With several test workers on one
    host, torch's intra-op thread pool oversubscribes the cores and its
    threads spin at every op; one thread keeps the file's time what it is
    alone. Restored afterwards for the worker's next file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jleaf(qd):
    return {k: jnp.asarray(v) for k, v in qd.items()}


# (d_in, d_out): block 64; halved to 32, 16 and 2; odd d_in (int8 fallback)
@pytest.mark.parametrize("d_in,d_out", [(256, 128), (96, 64), (80, 48), (6, 40), (7, 64), (1280, 640)])
def test_quantize_kernel_int4_bit_identical(d_in, d_out):
    rng = np.random.RandomState(d_in + d_out)
    w = (rng.randn(d_in, d_out) * 0.05).astype(np.float32)
    w[:, 1] = 0.0  # an all-zero column: its scales become 1
    ref = JQ.quantize_kernel(w, bits=4)
    q, scale = Q.quantize_kernel(torch.from_numpy(w), bits=4)
    kind = "q4" if "q4" in ref else "q8"
    assert kind == ("q8" if d_in % 2 else "q4")
    assert q.dtype == torch.int8 and q.is_contiguous()
    np.testing.assert_array_equal(q.numpy(), ref[kind])
    np.testing.assert_array_equal(scale.numpy(), ref["scale"])
    lin = L.QuantLinear(q, scale)
    assert lin.bits == (4 if kind == "q4" else 8) and lin.payload is getattr(lin, kind)
    # dequantized values: the same f32 products, rounded once to each dtype
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(JQ.dequantize_kernel(_jleaf(ref), jdt).astype(jnp.float32))
        np.testing.assert_array_equal(Q.dequantize_kernel(lin, tdt).float().numpy(), want)


def test_unpack_int4_covers_every_nibble():
    """Every byte value unpacks to the two sign-extended nibbles JAX's
    dequantize_kernel gives (scale 1)."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    want = np.asarray(JQ.dequantize_kernel({"q4": jnp.asarray(packed), "scale": jnp.ones((1, 1, 256))}, jnp.float32))
    np.testing.assert_array_equal(Q.unpack_int4(torch.from_numpy(packed)).numpy(), want.astype(np.int32))


@pytest.mark.parametrize("M,K,N", K3_SHAPES)
def test_matmul_int4_plain_matches_jax(M, K, N):
    """Against JAX's dequantize_kernel(bf16) + matmul (what dense computes
    off the TPU, and what the TPU kernel computes): both round x and the
    scaled weights to bf16, whose products are exact in f32, so only the
    order of the f32 sums differs: 1e-5 of max|y|. Against the Pallas
    kernel in interpret mode, which multiplies in f32 without the bf16
    roundings: the JAX test's own 2e-2 of max|y|."""
    rng = np.random.RandomState(M + K + N)
    qd = JQ.quantize_kernel((rng.randn(K, N) * 0.05).astype(np.float32), bits=4)
    x = (rng.randn(M, K) * 0.3).astype(np.float32)
    wq = JQ.dequantize_kernel(_jleaf(qd), jnp.bfloat16)
    ref = np.asarray(jnp.matmul(jnp.asarray(x).astype(jnp.bfloat16), wq, preferred_element_type=jnp.float32))
    interp = np.asarray(jax_matmul_int4(jnp.asarray(x), jnp.asarray(qd["q4"]), jnp.asarray(qd["scale"]), interpret=True))
    before = dict(IM.LAUNCHES)
    got = IM.matmul_int4(torch.from_numpy(x), torch.from_numpy(qd["q4"]), torch.from_numpy(qd["scale"]))
    assert IM.LAUNCHES == before, "a CPU tensor must take the plain version, not count a launch"
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    top = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * top)
    np.testing.assert_allclose(got.numpy(), interp, rtol=0, atol=2e-2 * float(np.abs(interp).max()))
    # a (nb, N) scale is the same function as (nb, 1, N)
    flat = IM.matmul_int4_reference(torch.from_numpy(x), torch.from_numpy(qd["q4"]), torch.from_numpy(qd["scale"][:, 0]))
    assert torch.equal(flat, got)


@pytest.mark.parametrize("x_shape", [(3, 1, 64), (5, 64)], ids=["decode", "rows"])
def test_dense_int4_matches_jax(x_shape):
    """dense on an int4 layer: the CPU takes the dequantize path in the
    compute dtype, as JAX's dense does off the TPU. f32: 1e-5 of max (sum
    order); bf16: both round the product once to bf16, so one bf16 step."""
    rng = np.random.RandomState(7)
    w = (rng.randn(64, 256) * 0.1).astype(np.float32)
    bias = (rng.randn(256) * 0.1).astype(np.float32)
    qd = JQ.quantize_kernel(w, bits=4)
    x = (rng.randn(*x_shape)).astype(np.float32)
    lin = L.QuantLinear(torch.from_numpy(qd["q4"]), torch.from_numpy(qd["scale"]), torch.from_numpy(bias))
    assert not IM.int4_dense_supported(torch.from_numpy(x), lin.q4, lin.scale)
    assert not jax_int4_supported(jnp.asarray(x), jnp.asarray(qd["q4"]))  # JAX off the TPU: dequantize too
    for jdt, tdt, rel in ((jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 8e-3)):
        ref = np.asarray(JL.dense(jnp.asarray(x), {"kernel": _jleaf(qd), "bias": jnp.asarray(bias)}, jdt).astype(jnp.float32))
        got = L.dense(torch.from_numpy(x), lin, tdt)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def tiny_int4():
    """(JAX f32 tiny_test config, float tree, JAX int4 tree) with numpy leaves."""
    cfg = JW.make_config("tiny_test", dtype="float32")
    params = jax.tree_util.tree_map(np.array, JW.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, params, JQ.quantize_params(params, bits=4)


def test_convert_int4_tree_and_quantize_params(tiny_int4):
    """A JAX int4 tree converts leaf for leaf, the port's quantize_params
    (bits=4) on the float model gives the same payloads, q/k/v stay unfused,
    and quantized_bytes counts what JAX's counts."""
    _cfg, params, qtree = tiny_int4
    mq = whisper_from_tree(qtree)
    mine = Q.quantize_params(whisper_from_tree(params), bits=4)
    n_quant = 0
    for (name, a), (name2, b) in zip(mq.named_modules(), mine.named_modules()):
        assert name == name2 and type(a) is type(b)
        if isinstance(a, L.QuantLinear):
            n_quant += 1
            assert a.bits == b.bits == 4
            assert torch.equal(a.q4, b.q4) and torch.equal(a.scale, b.scale)
    fc2 = qtree["decoder"]["blocks"][1]["mlp"]["fc2"]
    np.testing.assert_array_equal(mq.decoder.blocks[1].mlp.fc2.q4.numpy(), fc2["kernel"]["q4"])
    np.testing.assert_array_equal(mq.decoder.blocks[1].mlp.fc2.scale.numpy(), fc2["kernel"]["scale"])
    assert n_quant == sum(1 for p, _ in JQ._walk(qtree) if p.endswith("/q4")) > 0
    assert Q.quantized_bytes(mq) == JQ.quantized_bytes(qtree)
    W.fuse_decode_qkv(mq)
    assert not hasattr(mq.decoder.blocks[0].attn, "qkv")  # quantized projections are not fused


def test_int4_decode_step_matches_jax(tiny_int4):
    """Teacher-forced decode steps on the int4 tree with int8 K/V caches,
    as --load_in_4bit runs: the same tolerance as the int8 case in
    test_torch_whisper.py (2e-3 of max: both packages quantize q and the
    probabilities on the CPU, and a sum-order difference can move one value
    by an int8 step)."""
    cfg, _params, qtree = tiny_int4
    cfg = dataclasses.replace(cfg, kv_int8=True)
    fields = {f.name for f in dataclasses.fields(W.WhisperConfig)}
    tcfg = W.WhisperConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})
    jp = jax.tree_util.tree_map(jnp.asarray, qtree)
    tm = whisper_from_tree(qtree)
    mel = (np.random.RandomState(0).randn(2, cfg.n_mels, 200) * 0.3).astype(np.float32)
    af = JW.encode(jp, jnp.asarray(mel), cfg)
    taf = W.encode(tm, torch.from_numpy(mel), tcfg)
    np.testing.assert_allclose(taf.numpy(), np.asarray(af), rtol=0, atol=1e-4 * float(np.abs(np.asarray(af)).max()))
    jkv, jc = JW.precompute_cross_kv(jp, af, cfg), JW.init_cache(cfg, 2)
    tkv, tc = W.precompute_cross_kv(tm, torch.from_numpy(np.array(af)), tcfg), W.init_cache(tcfg, 2)
    for pos, tok in enumerate([1, 3, 50, 7]):
        ref, jc = JW._decode_step(jp, jnp.full((2, 1), tok, jnp.int32), pos, jc, jkv, cfg)
        got, tc = W._decode_step(tm, torch.full((2, 1), tok, dtype=torch.int64), pos, tc, tkv, tcfg)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-3 * float(np.abs(ref).max()))


def test_load_model_int4_sets_kv_int8():
    from ssak_tpu_torch.infer.general import load_model

    a = load_model(None, seeded_test_config="whisper", device="cpu")
    m = load_model(None, seeded_test_config="whisper", quantize_bits=4, device="cpu")
    assert m.cfg.kv_int8 is True
    fc1 = m.module.decoder.blocks[0].mlp.fc1
    q4, scale = Q.quantize_kernel(a.module.decoder.blocks[0].mlp.fc1.weight.t(), bits=4)
    assert fc1.bits == 4 and torch.equal(fc1.q4, q4) and torch.equal(fc1.scale, scale)
    assert isinstance(m.module.encoder.conv1, L.Conv1d)  # 3-D conv kernels stay float
    with pytest.raises(ValueError):
        load_model(None, seeded_test_config="whisper", quantize_bits=3, device="cpu")
