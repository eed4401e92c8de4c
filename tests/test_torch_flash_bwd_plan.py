"""L1's backward kernels (csrc/flash_attention_bwd.cu) on the CPU: their
plan (ssak_tpu_torch.ops.flash_attention.flash_bwd_plan) and an emulation
of their tile walk.

The emulation walks the plan's tiles as the kernels do: each consumer
warpgroup's 64 own rows against each walked tile, classed by
flash_bwd_tile_class (skipped across segments, unmasked within one,
masked where a tile straddles the length or runs past T); p = exp2(s *
scale * log2(e) - m * log2(e)) * (1 / l), dV from p rounded to bf16, ds =
((dp - di) * p) * scale rounded to bf16 for dK and dQ, each tile's product
added to f32 sums in the kernels' tile order, one bf16 rounding at the end.
It is held bit for bit against itself without the skip, and against the
plain version (`_backward_plain`: exp instead of exp2, the whole (T, T)
tile at once) and JAX's library VJP in interpret mode to 1e-2 absolute: the
gradients are O(1) here, one bf16 step at 1 is 2**-8, and the two sum
orders and exp / exp2 may put p or ds on the other bf16 neighbour, as in
tests/test_torch_flash_attention_bwd.py."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ssak_tpu.models import layers as JL
from ssak_tpu_torch.ops import flash_attention as L1

ATOL = 1e-2
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("B,T", [(1, 6999), (4, 6999), (32, 1499), (2, 1000), (3, 333)])
@pytest.mark.parametrize("Dh", L1.HEAD_DIMS)
def test_plan_tiles_cover_rows_and_fit(B, T, Dh):
    """Own tiles and walked tiles cover [0, T) with no tile wholly past it,
    the grid is one CTA per own tile (two at Dh = 256 for dK/dV) x H x B,
    and the shared bytes fit one block on the H100."""
    H = 16
    plan = L1.flash_bwd_plan(B, T, H, Dh)
    for name, k in plan.items():
        assert k["rows"] == k["warpgroups"] * L1.FLASH_BWD_WG_ROWS and k["threads"] == 128 * (k["warpgroups"] + 1)
        assert (k["tiles"] - 1) * k["rows"] < T <= k["tiles"] * k["rows"], name
        assert (k["walk_tiles"] - 1) * k["walk"] < T <= k["walk_tiles"] * k["walk"], name
        assert k["grid"] == (k["tiles"] * k["split"], H, B), name
        assert k["split"] == (2 if name == "dkv" and Dh == 256 else 1)
        assert k["smem"] == L1._bwd_smem(name, Dh, k["walk"], k["stages"]) <= L1.SMEM_PER_BLOCK, name
        assert 2 <= k["stages"] <= L1.FLASH_BWD_MAX_STAGES
        assert k["walk"] == L1.FLASH_BWD_WALKS[name][Dh][0]


def test_plan_overrides_and_refusals():
    plan = L1.flash_bwd_plan(4, 6999, 16, 64, walk=32, stages=2)
    assert all(k["walk"] == 32 and k["stages"] == 2 for k in plan.values())
    assert L1.flash_bwd_plan(1, 6999, 16, 64)["dkv"]["grid"] == (55, 16, 1)  # 880 CTAs, 6.67 waves of 132
    with pytest.raises(ValueError):
        L1.flash_bwd_plan(1, 100, 2, 64, walk=48)  # not compiled
    with pytest.raises(ValueError):
        L1.flash_bwd_plan(1, 100, 2, 256, stages=3)  # dK/dV at 256: 3 stages exceed the block's shared memory
    with pytest.raises(ValueError):
        L1.flash_bwd_plan(1, 100, 2, 96)


@pytest.mark.parametrize("T", [1000, 6999])
def test_no_cross_tiles_at_length_zero_or_full(T):
    """A row of length 0 or T has no cross-segment tile: only own rows past
    T are skipped, and only tiles past T are masked."""
    for length in (0, T):
        for r0 in range(0, -(-T // 128) * 128, 64):
            for c0 in range(0, T, 64):
                cls = L1.flash_bwd_tile_class(r0, c0, 64, length, T)
                assert (cls == L1.BWD_SKIP) == (r0 >= T)
                assert (cls == L1.BWD_MASKED) == (r0 < T and c0 + 64 > T)


def _inputs(B, T, H, Dh, lengths, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, T, H, Dh).astype(np.float32)).to(torch.bfloat16) for _ in range(4))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    o, m, l = L1.flash_self_attention_reference(q, k, v, lens, return_stats=True)
    return q, k, v, do, o, m, l, L1.attention_di(o, do), lens


def emulate(q, k, v, do, m, l, di, lengths, scale, plan, skip=True):
    """(dq, dk, dv) bf16 by the kernels' tile walk, and {(kernel, b, r0,
    c0): class} of every (warpgroup, walked tile) pair below T. Without
    `skip`, cross tiles are computed, masked."""
    B, T, H, Dh = q.shape
    f32, bf16 = torch.float32, torch.bfloat16
    qf, kf, vf, dof = (a.to(f32).permute(0, 2, 1, 3) for a in (q, k, v, do))  # (B, H, T, Dh)
    m2, il, sl2 = m * LOG2E, 1.0 / l, scale * LOG2E
    grads = {n: torch.zeros(B, H, T, Dh) for n in ("dq", "dk", "dv")}
    classes = {}
    for name in ("dkv", "dq"):
        kp = plan[name]
        W = kp["walk"]
        own, walk = (kf, qf) if name == "dkv" else (qf, kf)
        own1, walk1 = (vf, dof) if name == "dkv" else (dof, vf)
        for b in range(B):
            length = T if lengths is None else int(lengths[b])
            for t in range(kp["tiles"]):
                for w in range(kp["warpgroups"]):
                    r0 = t * kp["rows"] + w * L1.FLASH_BWD_WG_ROWS
                    r1 = min(r0 + L1.FLASH_BWD_WG_ROWS, T)
                    for c in range(kp["walk_tiles"]):
                        c0, c1 = c * W, min(c * W + W, T)
                        cls = L1.flash_bwd_tile_class(r0, c0, W, length, T)
                        if r0 < T:
                            classes[(name, b, r0, c0)] = cls
                        if cls == L1.BWD_SKIP:
                            if skip or r0 >= T:
                                continue
                            cls = L1.BWD_MASKED
                        s = own[b, :, r0:r1] @ walk[b, :, c0:c1].transpose(1, 2)  # (H, own, walked)
                        dp = own1[b, :, r0:r1] @ walk1[b, :, c0:c1].transpose(1, 2)
                        if name == "dkv":  # rows keys, columns queries: per-column statistics
                            p = torch.exp2(s * sl2 - m2[b, :, None, c0:c1]) * il[b, :, None, c0:c1]
                            dic = di[b, :, None, c0:c1]
                        else:
                            p = torch.exp2(s * sl2 - m2[b, :, r0:r1, None]) * il[b, :, r0:r1, None]
                            dic = di[b, :, r0:r1, None]
                        if cls == L1.BWD_MASKED:
                            rows = torch.arange(r0, r1)[:, None] < length
                            cols = torch.arange(c0, c1)[None, :] < length
                            p = torch.where(rows == cols, p, torch.zeros(()))
                        ds = ((dp - dic) * p) * scale
                        ds = ds.to(bf16).to(f32)
                        if name == "dkv":
                            grads["dv"][b, :, r0:r1] += p.to(bf16).to(f32) @ dof[b, :, c0:c1]
                            grads["dk"][b, :, r0:r1] += ds @ qf[b, :, c0:c1]
                        else:
                            grads["dq"][b, :, r0:r1] += ds @ kf[b, :, c0:c1]
    out = tuple(grads[n].permute(0, 2, 1, 3).to(bf16) for n in ("dq", "dk", "dv"))
    return out, classes


def _plain_p(q, k, m, l, lengths, scale):
    """p (B, H, T, T) of _backward_plain: exp(s - m) * (1 / l), s with the mask value across segments."""
    B, T = q.shape[:2]
    qf, kf = (a.float() for a in (q, k))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if lengths is not None:
        seg = torch.arange(T)[None, :] < lengths.reshape(B, 1)
        s = s + torch.where(seg[:, None, :, None] == seg[:, None, None, :], 0.0, L1.MASK_VALUE)
    return torch.exp(s - m[..., None]) * (1.0 / l)[..., None]


CASES = [
    (3, 700, 2, 64, [700, 0, 333], None),  # full, empty, and a length off the tile edges
    (2, 333, 2, 64, [333, 64], 32),        # Dh = 64 on its other compiled walk; a length on a tile edge
    (1, 512, 2, 64, None, None),           # T % 128 == 0, no lengths: no mask at all
    (2, 450, 2, 128, [450, 200], None),
    (2, 300, 2, 256, [129, 300], None),    # dK/dV's column split
]


@pytest.mark.parametrize("B,T,H,Dh,lengths,walk", CASES)
def test_tile_walk_skips_only_zero_tiles_and_matches_plain(B, T, H, Dh, lengths, walk):
    q, k, v, do, o, m, l, di, lens = _inputs(B, T, H, Dh, lengths, seed=T + Dh)
    scale = Dh**-0.5
    plan = L1.flash_bwd_plan(B, T, H, Dh, walk=walk)
    got, classes = emulate(q, k, v, do, m, l, di, lens, scale, plan)
    # the skipped tiles are exactly those whose p is all zero in the plain version
    p = _plain_p(q, k, m, l, lens, scale)
    n_skip = 0
    for (name, b, r0, c0), cls in classes.items():
        r1, c1 = min(r0 + L1.FLASH_BWD_WG_ROWS, T), min(c0 + plan[name]["walk"], T)
        block = p[b, :, c0:c1, r0:r1] if name == "dkv" else p[b, :, r0:r1, c0:c1]
        assert (cls == L1.BWD_SKIP) == bool((block == 0).all()), (name, b, r0, c0, cls)
        n_skip += cls == L1.BWD_SKIP
    assert (n_skip > 0) == (lengths is not None and any(0 < x < T for x in lengths))
    # skipping them changes no bit
    full, _ = emulate(q, k, v, do, m, l, di, lens, scale, plan, skip=False)
    for a, b_ in zip(got, full):
        assert torch.equal(a.view(torch.int16), b_.view(torch.int16))
    # and the walk computes the plain version's gradients
    ref = L1._backward_plain(q, k, v, do, m, l, di, lens, scale, ("dq", "dk", "dv"))
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a.float()).all(), name
        torch.testing.assert_close(a.float(), r.float(), atol=ATOL, rtol=0, msg=name)


@pytest.mark.parametrize("B,T,H,Dh,lengths,walk", [CASES[1], CASES[3]])
def test_tile_walk_matches_jax_library_vjp_in_interpret_mode(B, T, H, Dh, lengths, walk):
    """The emulated walk against jax.vjp of ssak_tpu's flash_self_attention
    (the library's Pallas kernels in TPU interpret mode), dO on every row."""
    q, k, v, do, o, m, l, di, lens = _inputs(B, T, H, Dh, lengths, seed=7 * T + Dh)
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (q, k, v)]
    jlens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: JL.flash_self_attention(a, b, c, lengths=jlens), *jargs)
        ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do.float().numpy()).astype(jnp.bfloat16))]
    got, _ = emulate(q, k, v, do, m, l, di, lens, Dh**-0.5, L1.flash_bwd_plan(B, T, H, Dh, walk=walk))
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.float().numpy(), r, atol=ATOL, rtol=0, err_msg=name)
    assert math.isfinite(float(got[0].float().abs().max()))
