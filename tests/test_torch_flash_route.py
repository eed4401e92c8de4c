"""The route to L1 (flash self-attention): the port's predicate
`layers._can_flash` against ssak_tpu's, on the CPU. ssak_tpu routes on its
backend (a TPU), the compute dtype, the head width and the sequence length;
the port reads "TPU backend" as "CUDA tensor" and must agree everywhere
else, whatever dtype q itself has."""

import types

import jax
import jax.numpy as jnp
import pytest
import torch

from ssak_tpu.models import layers as JL
from ssak_tpu_torch.models import layers as L

DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32), (torch.float16, jnp.float16)]


@pytest.mark.parametrize("Dh", [32, 64, 128, 256])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["bf16", "f32", "f16"])
def test_can_flash_agrees_with_ssak_tpu(monkeypatch, dtypes, Dh):
    torch_dtype, jax_dtype = dtypes
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for T in (4095, 4096, 7001):
        shape = (2, T, 16, Dh)
        want = JL._can_flash(types.SimpleNamespace(shape=shape), jax_dtype)
        for q_dtype in (torch.bfloat16, torch.float32):
            q = types.SimpleNamespace(is_cuda=True, shape=shape, dtype=q_dtype)
            assert L._can_flash(q, torch_dtype) == want, (torch_dtype, q_dtype, T, Dh)
            # off the card the port never routes to L1, as ssak_tpu off the TPU
            assert not L._can_flash(types.SimpleNamespace(is_cuda=False, shape=shape, dtype=q_dtype), torch_dtype)
    assert JL._can_flash(types.SimpleNamespace(shape=(2, 4096, 16, 64)), jnp.bfloat16)  # the patch took
