"""The port's kernel modules (ssak_tpu_torch.ops) against the JAX Pallas
kernels run in interpret mode on the CPU. On CPU tensors the port's
wrappers take their plain PyTorch versions, which follow the Pallas kernel
bodies step by step; the CUDA kernels themselves are compared with the same
plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssak_tpu.models import layers as JL
from ssak_tpu.models.quant import quantize_kernel as np_quantize_kernel
from ssak_tpu.ops.flash_decode import flash_decode_attention as jax_flash_decode
from ssak_tpu.ops.int8_matmul import matmul_int8 as jax_matmul_int8
from ssak_tpu_torch.ops import flash_decode as FD
from ssak_tpu_torch.ops import int8_matmul as IM


def _t(a, dtype=None):
    """JAX/numpy array -> torch tensor (bf16 arrays go through f32, exactly)."""
    a = np.asarray(a)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy())
    t = torch.from_numpy(a.astype(np.float32))
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("M,K,N", [(5, 256, 384), (40, 1280, 256)])
def test_matmul_int8_plain_matches_pallas(M, K, N):
    rng = np.random.RandomState(M)
    x = rng.randn(M, K).astype(np.float32)
    qd = np_quantize_kernel(rng.randn(K, N).astype(np.float32) * 0.05)
    ref = np.asarray(jax_matmul_int8(jnp.asarray(x), jnp.asarray(qd["q8"]), jnp.asarray(qd["scale"]), interpret=True))
    before = dict(IM.LAUNCHES)
    got = IM.matmul_int8(torch.from_numpy(x), torch.from_numpy(qd["q8"]), torch.from_numpy(qd["scale"]))
    assert IM.LAUNCHES == before, "a CPU tensor must take the plain version, not count a launch"
    # both sides round x and q8 to bf16, whose products are exact in f32, and
    # sum in f32: only the order of the sums differs
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [100, 160])
def test_flash_decode_plain_matches_pallas(T, int8):
    rng = np.random.RandomState(T + int8)
    B, H, Dh = 3, 2, 64
    q = jnp.asarray(rng.randn(B, H, Dh).astype(np.float32) * 0.5)
    kT = jnp.asarray(rng.randn(B, H, Dh, T).astype(np.float32) * 0.5)
    vT = jnp.asarray(rng.randn(B, H, Dh, T).astype(np.float32) * 0.5)
    lo = np.array([0, 7, 30], np.int32)
    hi = np.array([T - 1, T // 2, 40], np.int32)  # ragged ranges
    qs = q.astype(jnp.bfloat16) * jnp.bfloat16(Dh**-0.5)
    bf = torch.bfloat16
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    before = dict(FD.LAUNCHES)
    if int8:
        kv8 = JL.quantize_decode_kv(kT, vT)
        ref = jax_flash_decode(qs, kv8["k8"], kv8["v8"], jnp.asarray(lo), jnp.asarray(hi), kv8["ks"], kv8["vs"], interpret=True)
        got = FD.flash_decode_attention(_t(qs, bf), _t(kv8["k8"]), _t(kv8["v8"]), lo_t, hi_t, _t(kv8["ks"], bf), _t(kv8["vs"], bf))
    else:
        kb, vb = kT.astype(jnp.bfloat16), vT.astype(jnp.bfloat16)
        ref = jax_flash_decode(qs, kb, vb, jnp.asarray(lo), jnp.asarray(hi), interpret=True)
        got = FD.flash_decode_attention(_t(qs, bf), _t(kb, bf), _t(vb, bf), lo_t, hi_t)
    assert FD.LAUNCHES == before
    # tolerance of tests/test_flash_decode.py: bf16 probabilities may round
    # the other way where the two sum orders straddle a bf16 boundary
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-2)


def test_flash_decode_plain_masks_outside_range():
    """Keys outside [lo, hi] get no weight: a row attending to one key
    returns that key's value exactly (bf16 values)."""
    rng = np.random.RandomState(3)
    B, H, Dh, T = 2, 2, 8, 20
    v = torch.from_numpy(rng.randn(B, H, Dh, T).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.randn(B, H, Dh, T).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.randn(B, H, Dh).astype(np.float32)).to(torch.bfloat16)
    lo = torch.tensor([5, 11], dtype=torch.int32)
    out = FD.flash_decode_reference(q, k, v, lo, lo)
    assert torch.equal(out, torch.stack([v[0, :, :, 5], v[1, :, :, 11]]).to(torch.float32))


def test_wrappers_check_shapes():
    x = torch.zeros(4, 64)
    q8 = torch.zeros(32, 128, dtype=torch.int8)
    with pytest.raises(ValueError):
        IM.matmul_int8(x, q8, torch.ones(1, 128))
    with pytest.raises(TypeError):
        IM.matmul_int8(torch.zeros(4, 32), q8.to(torch.int16), torch.ones(1, 128))
    q = torch.zeros(2, 2, 8, dtype=torch.bfloat16)
    k = torch.zeros(2, 2, 8, 10, dtype=torch.bfloat16)
    lo = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        FD.flash_decode_attention(q, k, k[..., :9], lo, lo)
    with pytest.raises(ValueError):
        FD.flash_decode_attention(q, k, k, lo, lo, k_scales=torch.zeros(2, 2, 1, 10))


def test_non_cpu_tensors_never_reach_the_plain_versions():
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel (CUDA) or raises — never a silent fallback."""
    x = torch.zeros(4, 32, device="meta")
    q8 = torch.zeros(32, 128, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        IM.matmul_int8(x, q8, torch.ones(1, 128, device="meta"))
    q = torch.zeros(2, 2, 8, dtype=torch.bfloat16, device="meta")
    k = torch.zeros(2, 2, 8, 10, dtype=torch.bfloat16, device="meta")
    lo = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        FD.flash_decode_attention(q, k, k, lo, lo)
    with pytest.raises(ValueError, match="different devices"):
        IM.matmul_int8(torch.zeros(4, 32), q8, torch.ones(1, 128))


def test_kernel_routing_gates_need_cuda():
    """The layers route to the kernels only for CUDA tensors; CPU tensors
    take the JAX package's CPU paths (dequantize, mask attention)."""
    q8 = torch.zeros(1280, 1280, dtype=torch.int8)
    assert not IM.int8_dense_supported(torch.zeros(8, 1, 1280), q8)
    assert not FD.flash_decode_supported(torch.zeros(2, 1, 20, 64), 64, 448)
    q4, s4 = torch.zeros(640, 1280, dtype=torch.int8), torch.ones(20, 1, 1280)
    assert not IM.int4_dense_supported(torch.zeros(8, 1, 1280), q4, s4)


def test_int4_wrapper_checks_and_never_reaches_plain_off_cpu():
    """matmul_int4 checks shapes and types, raises for a device that is
    neither CPU nor CUDA (a CUDA tensor never reaches
    matmul_int4_reference: it launches the kernel or raises), and its gate
    follows the JAX one: decode-shaped rows, K/2 and N lane-aligned, one
    scale block per 32 packed rows."""
    q4, s4 = torch.zeros(64, 128, dtype=torch.int8), torch.ones(2, 1, 128)
    with pytest.raises(ValueError):
        IM.matmul_int4(torch.zeros(4, 64), q4, s4)  # K != 2 * K/2
    with pytest.raises(ValueError):
        IM.matmul_int4(torch.zeros(4, 128), q4, torch.ones(2, 1, 64))
    with pytest.raises(TypeError):
        IM.matmul_int4(torch.zeros(4, 128), q4.to(torch.int16), s4)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        IM.matmul_int4(torch.zeros(4, 128, **meta), torch.zeros(64, 128, dtype=torch.int8, **meta),
                       torch.ones(2, 1, 128, **meta))
    with pytest.raises(ValueError, match="different devices"):
        IM.matmul_int4(torch.zeros(4, 128), torch.zeros(64, 128, dtype=torch.int8, **meta), s4)
    before = dict(IM.LAUNCHES)
    assert tuple(IM.matmul_int4(torch.zeros(4, 128), q4, s4).shape) == (4, 128)
    assert IM.LAUNCHES == before

    class _CudaLike:  # what the gate reads of a tensor
        is_cuda = True

        def __init__(self, *shape):
            self.shape, self.ndim = shape, len(shape)

    big, s = torch.zeros(640, 1280, dtype=torch.int8), torch.ones(20, 1, 1280)
    assert IM.int4_dense_supported(_CudaLike(64, 1, 1280), big, s)
    assert IM.int4_dense_supported(_CudaLike(20, 1280), big, s)
    assert not IM.int4_dense_supported(_CudaLike(65, 1, 1280), big, s)  # more than 64 rows
    assert not IM.int4_dense_supported(_CudaLike(8, 1500, 1280), big, s)  # encoder-shaped
    assert not IM.int4_dense_supported(_CudaLike(8, 1, 1280), big, torch.ones(40, 1, 1280))  # 16 rows per block
    assert not IM.int4_dense_supported(_CudaLike(8, 1, 1280), big[:, :1000], s[..., :1000])  # N % 128
