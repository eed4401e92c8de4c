"""L1, the port's segment-masked flash self-attention
(ssak_tpu_torch.ops.flash_attention), against ssak_tpu's
`layers.flash_self_attention` run through JAX's library Pallas kernel in
TPU interpret mode on the CPU; the routing rule (`layers._can_flash`) against
ssak_tpu's predicate; and the wav2vec2 encoder's two block variants
reaching that route.

On the CPU the wrapper takes its plain version (the masked softmax over the
padded length in f32, p rounded to bf16 against the global row max); the
library kernel rounds p against a running row max per 128-key block and
sums in another order. Both give bf16 outputs: held to 1e-2 absolute on
every row, pad rows included (outputs are O(1); one bf16 step is 2**-8
relative)."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ssak_tpu.models import layers as JL
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import wav2vec2 as TW
from ssak_tpu_torch.ops import flash_attention as L1

ATOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, T, H, Dh, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, Dh).astype(np.float32) for _ in range(3)]


def _jax_flash(q, k, v, lengths):
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        out = JL.flash_self_attention(*args, lengths=lens)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("B,T,H,Dh,lengths", [
    (2, 300, 2, 64, [300, 170]),   # padded to 384; a partly padded row
    (1, 256, 2, 64, None),         # T % 128 == 0, no lengths: no mask at all
    (2, 200, 2, 64, [0, 200]),     # a batch-pad row of length 0: all pad, finite
    (1, 130, 2, 128, [100]),       # Dh = 128
])
def test_matches_jax_library_kernel_in_interpret_mode(B, T, H, Dh, lengths):
    q, k, v = _qkv(B, T, H, Dh, seed=T + Dh)
    ref = _jax_flash(q, k, v, lengths)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    n0 = L1.LAUNCHES["flash_attention"]
    got = L1.flash_self_attention(tq, tk, tv, lens)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, Dh)
    assert L1.LAUNCHES["flash_attention"] == n0  # the CPU takes the plain version: no launch
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_valid_rows_equal_unfused_attention_and_pad_rows_see_pad_keys():
    """Valid queries attend over valid keys only (the unfused masked
    attention); a pad query attends over the pad keys of [len, Tp), the zero
    keys past T included (logit 0, value 0)."""
    B, T, H, Dh = 1, 200, 2, 64
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(B, T, H, Dh, seed=5))
    lens = torch.tensor([150])
    out = L1.flash_self_attention_reference(q, k, v, lens).float()
    mask = (torch.arange(T)[None, :] < lens[:, None])[:, None, None, :]
    unfused = L.attention(q, k, v, mask=mask, dtype=torch.bfloat16).float()
    torch.testing.assert_close(out[:, :150], unfused[:, :150], atol=ATOL, rtol=0)
    Tp = L1.padded_len(T)
    f32 = torch.float32
    s = torch.einsum("qhd,khd->hqk", q[0, 150:].to(f32), k[0, 150:].to(f32)) * Dh**-0.5
    s = torch.cat([s, torch.zeros(H, T - 150, Tp - T)], dim=-1)  # the zero keys past T
    p = torch.softmax(s, dim=-1)
    pad = torch.einsum("hqk,khd->qhd", p[..., : T - 150], v[0, 150:].to(f32))
    torch.testing.assert_close(out[0, 150:], pad, atol=ATOL, rtol=0)


def test_backward_raises_and_inputs_are_checked():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 64, 2, 64, seed=1))
    q.requires_grad_(True)
    out = L1.flash_self_attention(q, k, v, torch.tensor([40]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.float().sum().backward()
    with pytest.raises(ValueError, match="shape"):
        L1.flash_self_attention(q.detach(), k[:, :32], v)
    with pytest.raises(ValueError, match="one entry per row"):
        L1.flash_self_attention(q.detach(), k, v, torch.tensor([40, 30]))


def _stand_in(T, Dh, dtype=torch.bfloat16, is_cuda=True, requires_grad=False):
    """What _can_flash reads of a tensor, for shapes and devices this host cannot allocate."""
    return types.SimpleNamespace(shape=(2, T, 4, Dh), dtype=dtype, is_cuda=is_cuda, requires_grad=requires_grad)


def test_can_flash_mirrors_the_jax_predicate(monkeypatch):
    """On the card the predicate is ssak_tpu's with the TPU backend replaced
    by: a CUDA tensor that needs no gradient; the threshold is the same."""
    assert L.FLASH_MIN_SEQ == JL.FLASH_MIN_SEQ == 4096
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        for Dh in (32, 64, 96, 128, 256):
            for T in (1499, 4095, 4096, 7001):
                want = JL._can_flash(types.SimpleNamespace(shape=(2, T, 4, Dh)), jdt)
                assert L._can_flash(_stand_in(T, Dh, tdt), tdt) == want, (jdt, Dh, T)
    assert L._can_flash(_stand_in(7001, 64), torch.bfloat16)
    assert not L._can_flash(_stand_in(7001, 64, is_cuda=False), torch.bfloat16)
    assert not L._can_flash(torch.zeros(1, 4096, 1, 64, dtype=torch.bfloat16), torch.bfloat16)  # a CPU tensor
    assert not L._can_flash(_stand_in(7001, 64, requires_grad=True), torch.bfloat16)  # training keeps unfused
    with torch.no_grad():
        assert L._can_flash(_stand_in(7001, 64, requires_grad=True), torch.bfloat16)


@pytest.mark.parametrize("stable", [False, True])
def test_both_wav2vec2_block_variants_reach_the_route(monkeypatch, stable):
    """With the predicate forced on (it never holds on the CPU), every block
    of both variants sends its self-attention to flash_self_attention with
    the frame lengths and no mask; its plain version then agrees with the
    unfused route on the valid frames."""
    cfg = TW.make_config("tiny_test", do_stable_layer_norm=stable, conv_bias=stable)
    model = TW.init_params(cfg, seed=2)
    rng = np.random.RandomState(0)
    audio = torch.from_numpy((rng.randn(2, 9600) * 0.1).astype(np.float32))
    lens = torch.tensor([9600, 6000])
    with torch.no_grad():
        ref, fl = TW.ctc_log_probs(model, audio, cfg, lens)
        calls = []
        real = L.flash_self_attention

        def spy(q, k, v, lengths=None, scale=None):
            calls.append((tuple(q.shape), lengths.tolist()))
            return real(q, k, v, lengths=lengths, scale=scale)

        monkeypatch.setattr(L, "_can_flash", lambda q, dtype: True)
        monkeypatch.setattr(L, "flash_self_attention", spy)
        got, _ = TW.ctc_log_probs(model, audio, cfg, lens)
    assert calls == [((2, 29, 2, 32), fl.tolist())] * cfg.num_layers
    for b, n in enumerate(fl.tolist()):
        np.testing.assert_allclose(got[b, :n].numpy(), ref[b, :n].numpy(), atol=0.1)
        assert np.corrcoef(got[b, :n].numpy().ravel(), ref[b, :n].numpy().ravel())[0, 1] > 0.999
