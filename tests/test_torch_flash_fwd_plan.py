"""L1's forward kernel (csrc/flash_attention.cu) on the CPU: its plan
(ssak_tpu_torch.ops.flash_attention.flash_fwd_plan) and an emulation of its
tile walk.

The emulation walks the plan's tiles as the kernel does: each consumer
warpgroup's 64 query rows against each key tile of [0, Tp), classed by
flash_fwd_tile_class (skipped across segments, unmasked within one, masked
where a tile straddles the length; -inf logits across segments); per tile
the row max of the unscaled logits, p = exp2(s * scale * log2(e) - m *
scale * log2(e)), the rescale of the row sum and of O by exp2((m_old -
m_new) * scale * log2(e)) only where the max moved, p rounded to bf16 for
P.V in f32; O / l at the end, m written as the row max times scale. It is
held bit for bit against itself without the skip, against the plain version
(`flash_self_attention_reference`: exp, the mask value, the whole row at
once) to 1e-2 absolute in o (outputs are O(1); one bf16 step at 1 is 2**-8,
and the per-tile bf16 rounding of p against a running max may put p on the
other neighbour, as in tests/test_torch_flash_attention.py) and 1e-5
relative in m and l (f32 sums in another order, exp2 against exp), and
against JAX's library kernel in interpret mode to the same 1e-2."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ssak_tpu.models import layers as JL
from ssak_tpu_torch.ops import flash_attention as L1

ATOL = 1e-2
LOG2E = 1.4426950408889634
FLT_MAX = float(torch.finfo(torch.float32).max)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("T", [1, 127, 128, 1499, 4096, 6999, 7001])
@pytest.mark.parametrize("B", [1, 4, 6, 32])
@pytest.mark.parametrize("Dh", L1.HEAD_DIMS)
def test_plan_tiles_cover_rows_and_keys_and_fit(B, T, Dh):
    """Query tiles cover [0, T) with no tile wholly past it, key tiles cover
    [0, Tp) exactly, the grid is one CTA per query tile x H x B, and the
    shared bytes fit one block on the H100."""
    H = 16
    k = L1.flash_fwd_plan(B, T, H, Dh)
    assert (k["rows"], k["bn"]) == (L1.FLASH_FWD_ROWS[Dh], L1.FLASH_FWD_BN[Dh])
    assert k["rows"] == k["warpgroups"] * L1.FLASH_FWD_WG_ROWS and k["threads"] == 128 * (k["warpgroups"] + 1)
    assert (k["tiles"] - 1) * k["rows"] < T <= k["tiles"] * k["rows"]
    assert k["key_tiles"] * k["bn"] == L1.padded_len(T)
    assert k["grid"] == (k["tiles"], H, B)
    assert k["smem"] == L1._fwd_smem(Dh, k["rows"], k["bn"], k["stages"]) <= L1.SMEM_PER_BLOCK
    assert 2 <= k["stages"] <= L1.FLASH_FWD_MAX_STAGES


def test_plan_overrides_and_refusals():
    k = L1.flash_fwd_plan(4, 6999, 16, 64, stages=2)
    assert (k["rows"], k["bn"], k["stages"], k["warpgroups"], k["threads"]) == (192, 128, 2, 3, 512)
    assert k["tiles"] == 37 and k["key_tiles"] == 55
    assert L1.flash_fwd_plan(1, 7001, 16, 64)["grid"] == (37, 16, 1)  # 592 CTAs, 4.48 waves of 132
    assert (L1.flash_fwd_plan(1, 300, 2, 128)["rows"], L1.flash_fwd_plan(1, 300, 2, 256)["key_tiles"]) == (128, 6)
    with pytest.raises(ValueError):
        L1.flash_fwd_plan(1, 100, 2, 256, stages=3)  # 3 stages of 64-key tiles exceed the block's shared memory
    with pytest.raises(ValueError):
        L1.flash_fwd_plan(1, 100, 2, 64, stages=1)
    with pytest.raises(ValueError):
        L1.flash_fwd_plan(1, 100, 2, 96)
    with pytest.raises(ValueError):
        L1.flash_fwd_plan(0, 100, 2, 64)


@pytest.mark.parametrize("T", [1000, 7001])
def test_no_cross_tiles_at_length_zero_or_full(T):
    """A row of length 0 or T has no cross-segment tile: only warpgroups
    whose rows all lie past T are skipped. A full row masks only the key
    tiles that reach past T (the zero keys are across for valid queries);
    a row of length 0 masks nothing (every query and key is pad)."""
    Tp = L1.padded_len(T)
    for length in (0, T):
        for r0 in range(0, Tp, 64):
            for c0 in range(0, Tp, 128):
                cls = L1.flash_fwd_tile_class(r0, c0, 128, length, T)
                assert (cls == L1.FWD_SKIP) == (r0 >= T)
                if length == 0 and r0 < T:
                    assert cls == L1.FWD_WITHIN
                if length == T and r0 < T:
                    assert (cls == L1.FWD_MASKED) == (c0 + 128 > T)


def _inputs(B, T, H, Dh, lengths, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, Dh).astype(np.float32)).to(torch.bfloat16) for _ in range(3))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    return q, k, v, lens


def emulate(q, k, v, lengths, scale, plan, skip=True):
    """(o bf16 (B, T, H, Dh), m and l f32 (B, H, T)) by the kernel's tile
    walk, and {(b, r0, c0): class} of every (warpgroup, key tile) pair with
    rows below T. Without `skip`, cross tiles are computed, masked."""
    B, T, H, Dh = q.shape
    Tp = L1.padded_len(T)
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, H, Tp, Dh): rows past T are zero, as TMA delivers them
    qf, kf, vf = (torch.nn.functional.pad(a.to(f32), (0, 0, 0, 0, 0, Tp - T)).permute(0, 2, 1, 3) for a in (q, k, v))
    sl2, bn, W = scale * LOG2E, plan["bn"], L1.FLASH_FWD_WG_ROWS
    o, m, l = torch.zeros(B, H, Tp, Dh), torch.full((B, H, Tp), -FLT_MAX), torch.zeros(B, H, Tp)
    classes = {}
    for b in range(B):
        length = T if lengths is None else int(lengths[b])
        for t in range(plan["tiles"]):
            for w in range(plan["warpgroups"]):
                r0 = t * plan["rows"] + w * W
                if r0 >= T:
                    continue
                rows = torch.arange(r0, r0 + W)[:, None] < length
                om, mm, lm = o[b, :, r0:r0 + W], m[b, :, r0:r0 + W], l[b, :, r0:r0 + W]
                for c in range(plan["key_tiles"]):
                    c0 = c * bn
                    cls = classes[(b, r0, c0)] = L1.flash_fwd_tile_class(r0, c0, bn, length, T)
                    if cls == L1.FWD_SKIP:
                        if skip:
                            continue
                        cls = L1.FWD_MASKED
                    s = qf[b, :, r0:r0 + W] @ kf[b, :, c0:c0 + bn].transpose(1, 2)  # (H, 64, bn)
                    if cls == L1.FWD_MASKED:
                        cols = torch.arange(c0, c0 + bn)[None, :] < length
                        s = torch.where(rows == cols, s, torch.tensor(-float("inf")))
                    mn = torch.maximum(mm, s.amax(-1))
                    alpha = torch.where(mn == mm, torch.ones(()), torch.exp2((mm - mn) * sl2))
                    p = torch.exp2(s * sl2 - (mn * sl2)[..., None])
                    lm = lm * alpha + p.sum(-1)
                    om = om * alpha[..., None] + p.to(bf16).to(f32) @ vf[b, :, c0:c0 + bn]
                    mm = mn
                o[b, :, r0:r0 + W], m[b, :, r0:r0 + W], l[b, :, r0:r0 + W] = om, mm, lm
    out = (o / l[..., None])[:, :, :T].permute(0, 2, 1, 3).to(bf16)
    return out, (m * scale)[:, :, :T], l[:, :, :T], classes


def _plain_p(q, k, lengths, scale):
    """p (B, H, T, Tp) of flash_self_attention_reference: exp(s - max), s
    with the mask value across segments, zero keys past T."""
    B, T = q.shape[:2]
    Tp = L1.padded_len(T)
    qf, kf = (torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0, Tp - T)) for a in (q, k))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    seg = L1._segments(B, T, Tp, lengths, q.device)
    s = s + torch.where(seg[:, None, :, None] == seg[:, None, None, :], 0.0, L1.MASK_VALUE)
    return torch.exp(s - s.amax(dim=-1, keepdim=True))[:, :, :T]


CASES = [
    (3, 700, 2, 64, [700, 0, 333]),  # full, empty, a length off the tile edges; pad queries, T < Tp
    (2, 333, 2, 64, [333, 64]),      # a length on a tile edge
    (2, 512, 2, 64, None),           # T % 128 == 0, no lengths: no mask at all
    (2, 450, 2, 128, [450, 200]),
    (2, 300, 2, 256, [129, 300]),
    (2, 260, 2, 256, [256, 260]),    # a length on the 128 edge; key tiles wholly past T
]


@pytest.mark.parametrize("B,T,H,Dh,lengths", CASES)
def test_tile_walk_skips_only_zero_tiles_and_matches_plain(B, T, H, Dh, lengths):
    q, k, v, lens = _inputs(B, T, H, Dh, lengths, seed=T + Dh)
    scale = Dh**-0.5
    plan = L1.flash_fwd_plan(B, T, H, Dh)
    got, gm, gl, classes = emulate(q, k, v, lens, scale, plan)
    # the skipped tiles are exactly those whose block of the plain p (rows below T) is all zero
    p = _plain_p(q, k, lens, scale)
    n = {"skip": 0, "within": 0, "masked": 0}
    for (b, r0, c0), cls in classes.items():
        block = p[b, :, r0:min(r0 + L1.FLASH_FWD_WG_ROWS, T), c0:c0 + plan["bn"]]
        assert (cls == L1.FWD_SKIP) == bool((block == 0).all()), (b, r0, c0, cls)
        n[("skip", "within", "masked")[cls]] += H
    assert (n["skip"] > 0) == (lengths is not None and any(0 < x < T for x in lengths))
    assert (n["masked"] > 0) == (lengths is not None or T % 128 != 0)
    counts = L1.flash_fwd_tile_counts(plan, T, H, lengths)
    assert (counts["within"], counts["masked"]) == (n["within"], n["masked"])
    # skipping them changes no bit
    full, fm, fl, _ = emulate(q, k, v, lens, scale, plan, skip=False)
    assert torch.equal(got.view(torch.int16), full.view(torch.int16))
    assert torch.equal(gm, fm) and torch.equal(gl, fl)
    # and the walk computes the plain version's output and statistics
    ref, rm, rl = L1.flash_self_attention_reference(q, k, v, lens, scale, return_stats=True)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=ATOL, rtol=0)
    torch.testing.assert_close(gm, rm, atol=0, rtol=1e-5)
    torch.testing.assert_close(gl, rl, atol=0, rtol=1e-5)


@pytest.mark.parametrize("B,T,H,Dh,lengths", [CASES[1], CASES[3]])
def test_tile_walk_matches_jax_library_kernel_in_interpret_mode(B, T, H, Dh, lengths):
    """The emulated walk against ssak_tpu's flash_self_attention (the
    library's Pallas kernel in TPU interpret mode) on every row, pad rows
    included."""
    q, k, v, lens = _inputs(B, T, H, Dh, lengths, seed=3 * T + Dh)
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (q, k, v)]
    jlens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JL.flash_self_attention(*jargs, lengths=jlens).astype(jnp.float32))
    got, _, _, _ = emulate(q, k, v, lens, Dh**-0.5, L1.flash_fwd_plan(B, T, H, Dh))
    assert np.isfinite(got.float().numpy()).all()
    np.testing.assert_allclose(got.float().numpy(), ref, atol=ATOL, rtol=0)
