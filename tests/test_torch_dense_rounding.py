"""The port's bf16 dense rounds once, after the bias, as ssak_tpu's does
(ssak_tpu.models.layers.dense: the product kept in f32 by
preferred_element_type, the LoRA term and the bias added, then one
rounding), on the CPU.

Tolerance: at least 99.9% of the outputs equal ssak_tpu's bit for bit and
the rest one bf16 step apart. The two packages sum the f32 products in
different orders, so an f32 sum that lands within an ulp of a bf16
rounding boundary can round the other way. The step is taken at |y|, but
at no less than 2^-12 of the largest |y|: an output near zero is a
cancelled sum whose last f32 bits (1.5e-6 at the first test's shapes)
span several of its own bf16 steps. A product rounded to bf16 before the
bias (two roundings) is one step off in about 29% of the outputs at these
shapes (the first test shows that form fails the bar)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.models import layers as JL
from ssak_tpu.models import quant as JQ
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models.convert import linear_from_tree

BF16 = torch.bfloat16


def _bf16_steps(got, ref):
    """|got - ref| in units of one bf16 step at ref, at no less than 2^-12
    of the largest |ref| (both bf16 values as f32)."""
    ref = np.asarray(ref, np.float32)
    exp = np.floor(np.log2(np.maximum(np.abs(ref), 2.0**-12 * np.abs(ref).max())))
    return np.abs(np.asarray(got, np.float32) - ref) / np.exp2(exp - 7)


def _holds(got, ref):
    steps = _bf16_steps(got, ref)
    equal = float(np.mean(steps == 0))
    assert equal >= 0.999, f"only {equal:.4%} of the outputs equal ssak_tpu's"
    assert steps.max() <= 1.0, f"an output {steps.max()} bf16 steps from ssak_tpu's"
    return equal


def _reanchor_input(seed=0, d=1280):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 64, d).astype(np.float32)
    p = {"kernel": (rng.randn(d, d) / np.sqrt(d)).astype(np.float32),
         "bias": (0.5 * rng.randn(d)).astype(np.float32)}
    return x, p


def _jax_dense(x, p, dtype=jnp.bfloat16):
    y = JL.dense(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), dtype)
    return np.asarray(y.astype(jnp.float32))


def test_biased_bf16_dense_rounds_once_like_jax():
    """x (4, 64, 1280) N(0, 1), kernel N(0, 1/1280), bias N(0, 0.25), bf16:
    the input on which the double rounding was found."""
    x, p = _reanchor_input()
    ref = _jax_dense(x, p)
    got = L.dense(torch.from_numpy(x), linear_from_tree(p, "cpu"), BF16)
    assert got.dtype == BF16
    _holds(got.float().numpy(), ref)
    # the parent's form, the bf16 product rounded before the bias, fails the same bar
    xb, wb = torch.from_numpy(x).to(BF16), torch.from_numpy(p["kernel"]).to(BF16)
    twice = (torch.matmul(xb, wb).float() + torch.from_numpy(p["bias"])).to(BF16)
    assert np.mean(_bf16_steps(twice.float().numpy(), ref) == 0) < 0.9


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_bf16_dense_with_lora_rounds_once_like_jax(bits):
    """A LoRA adapter over a float, int8 or int4 base (the quantized CTC
    dense dequantizes to bf16 and takes the same product): the base
    product, the f32 adapter term and the bias, then one rounding."""
    x, p = _reanchor_input(seed=1 + bits, d=512)
    rng = np.random.RandomState(7)
    p.update(lora_A=(rng.randn(512, 8) / np.sqrt(512)).astype(np.float32),
             lora_B=(0.2 * rng.randn(8, 512)).astype(np.float32), lora_scale=np.asarray(2.0, np.float32))
    if bits:
        p["kernel"] = JQ.quantize_kernel(p["kernel"], bits=bits)
    ref = _jax_dense(x, p)
    got = L.dense(torch.from_numpy(x), linear_from_tree(p, "cpu"), BF16)
    _holds(got.float().numpy(), ref)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_bf16_dense_rounds_once_like_jax(bits):
    """A quantized dense with a bias at encoder shapes (rows > 64: the
    dequantize path of both packages)."""
    x, p = _reanchor_input(seed=5 + bits, d=512)
    p["kernel"] = JQ.quantize_kernel(p["kernel"], bits=bits)
    _holds(L.dense(torch.from_numpy(x), linear_from_tree(p, "cpu"), BF16).float().numpy(), _jax_dense(x, p))


def test_matmul_f32_keeps_the_product_in_f32():
    """bf16 operands: the f32 result of exact products (within f32 sum
    order of the f64 product), the bias then added and rounded in one pass
    exactly as the sum and the cast; f32 operands: torch.matmul itself."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 5, 96).astype(np.float32))
    w = torch.from_numpy(rng.randn(96, 40).astype(np.float32))
    y = L.matmul_f32(x.to(BF16), w.to(BF16))
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, 5, 40)
    exact = x.to(BF16).double() @ w.to(BF16).double()
    np.testing.assert_allclose(y.double().numpy(), exact.numpy(), atol=1e-5, rtol=0)
    assert not torch.equal(y, y.to(BF16).float())  # not rounded to bf16
    b = torch.from_numpy(rng.randn(40).astype(np.float32))
    fused = L._add_rounded(y, b, BF16)  # one pass that rounds the f32 sum on its store
    assert fused.dtype == BF16 and torch.equal(fused, (y + b).to(BF16))
    torch.testing.assert_close(L.matmul_f32(x, w), torch.matmul(x, w), rtol=0, atol=0)


def test_half_matmul_gradients_are_the_bf16_products():
    """Under autograd the gradients are the products torch.matmul's
    backward forms in bf16 (the f32 cotangent rounded to bf16): the
    train-step parity tests hold those."""
    rng = np.random.RandomState(4)
    x0 = torch.from_numpy(rng.randn(3, 7, 64).astype(np.float32)).to(BF16)
    w0 = torch.from_numpy((rng.randn(64, 32) / 8).astype(np.float32)).to(BF16)
    r = torch.from_numpy(rng.randn(3, 7, 32).astype(np.float32))
    x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    (L.matmul_f32(x, w) * r).sum().backward()
    xr, wr = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    (torch.matmul(xr, wr).float() * r).sum().backward()
    assert x.grad.dtype == BF16 and w.grad.dtype == BF16
    torch.testing.assert_close(x.grad, xr.grad, rtol=0, atol=0)
    torch.testing.assert_close(w.grad, wr.grad, rtol=0, atol=0)
