"""K4's split on the CPU: its plan (ssak_tpu_torch.ops.flash_decode.
flash_decode_plan), its copies (flash_decode_row_copy) and an emulation of
the kernel (csrc/flash_decode.cu).

The plan splits each (batch, head) site over a cluster of CTAs by rows of
d and sizes their ring of row buffers; every row a rank needs is one bulk
copy between 16-byte boundaries inside the tensor, plus plain loads for
bytes outside them. The emulation runs the kernel's arithmetic on those
copies: each row lands in a row buffer pre-filled with 0xff bytes (NaN in
bf16) wherever no copy writes, keys are read in groups of VE aligned in
absolute positions, each rank sums its rows' partial logits, the ranks'
partials are added in rank order, one global maximum, p rounded to bf16,
each rank's rows of o. It is held to flash_decode_reference at 1e-5 of the
largest logit (only the order of the f32 sums differs) and to JAX's Pallas
kernel in interpret mode at 2e-2 on the output (the tolerance of
tests/test_torch_kernels.py: bf16 p may round the other way where two sum
orders straddle a bf16 boundary). The kernel itself is held against its
plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssak_tpu.models import layers as JL
from ssak_tpu.ops.flash_decode import flash_decode_attention as jax_flash_decode
from ssak_tpu_torch.models.layers import quantize_decode_kv
from ssak_tpu_torch.ops import flash_decode as FD

H, DH = 20, 64
NEG = np.float32(-1e30)


def _sites(B, H):
    """The sites whose copies are enumerated: first, last and one between."""
    return sorted({0, (B * H) // 2, B * H - 1})


def _ranges(T):
    """(name, lo, hi): full, ragged, a single key, empty (lo > hi), and a
    range inside one chunk of the cache."""
    return [("full", 0, T - 1), ("ragged", T // 5, T - 1 - T // 7), ("single", T // 2, T // 2),
            ("empty", min(7, T - 1) + 1, min(7, T - 1)), ("inner", T // 3, min(T - 1, T // 3 + 40))]


@pytest.mark.parametrize("variant", ["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 448, 1500, 12288])
@pytest.mark.parametrize("B", [1, 20, 24, 32, 40])
def test_plan_fits_and_covers(B, T, variant):
    """A cluster of at most 8 (8 only where fewer would leave the card short
    of two CTAs an SM), within one block's shared memory, rows that cover Dh
    exactly, ring segments that cover a rank's rows, a ring of at least two
    stages at the decoder's shapes, and persistent clusters that the card
    holds at once, each taking the same number of sites to within one."""
    _check_plan(B, H, T, variant)


@pytest.mark.parametrize("variant", ["bf16", "int8"])
@pytest.mark.parametrize("T", [448, 1500])
@pytest.mark.parametrize("B", [1, 8, 20, 24, 25, 40, 64])
@pytest.mark.parametrize("heads", [10, 5])
def test_plan_fits_and_covers_a_tensor_parallel_ranks_heads(heads, B, T, variant):
    """The same at a tensor-parallel rank's heads of large-v3 (20 heads: 10
    at tp 2, 5 at tp 4), for every row count of the decode loops (B up to
    64: a window batch, or B * beam or B * best_of rows)."""
    _check_plan(B, heads, T, variant)


def _check_plan(B, H, T, variant):
    p = FD.flash_decode_plan(B, H, DH, T, variant)
    sites = B * H
    assert p["cluster"] in (1, 2, 4, 8)
    assert p["smem"] == FD.flash_decode_smem(T, variant, p["rows"], p["seg_rows"], p["stages"]) <= 232448
    assert p["cluster"] * p["rows"] == DH
    assert p["rows"] % p["seg_rows"] == 0 and p["segments"] * p["seg_rows"] == 2 * p["rows"]
    assert 1 <= p["stages"] <= 2 * p["segments"]
    if T <= 1500:
        assert p["stages"] >= 2, "the next segment should be in flight while one is used"
    assert p["warps"] == (8 if T >= FD.FD_LONG_T else 2) and p["threads"] == 32 * p["warps"] + 32
    assert p["ctas_per_sm"] * (p["smem"] + 1024) <= FD.FD_SM_SMEM and p["ctas_per_sm"] <= FD.FD_WARPS_PER_SM[p["warps"]]
    assert p["grid"] == p["cluster"] * p["clusters"] <= FD.FD_SMS * p["ctas_per_sm"]
    per = p["sites_per_cluster"]
    assert p["clusters"] * per >= sites > p["clusters"] * (per - 1)
    assert p["clusters"] <= sites
    if sites * p["cluster"] < 2 * FD.FD_SMS:
        assert p["cluster"] == 8
    elif p["cluster"] > 1:
        assert sites * p["cluster"] // 2 < 2 * FD.FD_SMS, "a smaller cluster would fill the card"


def test_plan_at_the_decoder_shapes_and_refusals():
    p = FD.flash_decode_plan(24, 20, 64, 1500, "bf16")
    assert (p["cluster"], p["rows"], p["vec"], p["warps"], p["seg_rows"], p["stages"]) == (1, 64, 8, 8, 16, 2)
    assert (p["clusters"], p["sites_per_cluster"]) == (264, 2)
    p = FD.flash_decode_plan(24, 20, 64, 448, "bf16")
    assert (p["warps"], p["ctas_per_sm"], p["clusters"], p["sites_per_cluster"]) == (2, 7, 480, 1)
    assert FD.flash_decode_plan(24, 20, 64, 1500, "int8")["vec"] == 4
    assert FD.flash_decode_plan(24, 20, 64, 448, "int8")["vec"] == 8
    assert FD.flash_decode_plan(24, 20, 64, 448, "bf16")["vec"] == 16
    assert FD.flash_decode_plan(1, 20, 64, 1500, "bf16")["cluster"] == 8
    p = FD.flash_decode_plan(1, 20, 64, 1500, "bf16", cluster=2, seg_rows=8, stages=3)
    assert (p["rows"], p["segments"], p["stages"]) == (32, 8, 3)
    for kw in (dict(cluster=3), dict(cluster=16), dict(seg_rows=5), dict(stages=40), dict(warps=4)):
        with pytest.raises(ValueError, match="flash_decode_plan"):
            FD.flash_decode_plan(24, 20, 64, 1500, "bf16", **kw)
    with pytest.raises(ValueError, match="flash_decode_plan"):
        FD.flash_decode_plan(24, 20, 64, FD.MAX_T + 1, "bf16")
    with pytest.raises(ValueError, match="flash_decode_plan"):
        FD.flash_decode_plan(24, 20, 60, 1500, "bf16")
    with pytest.raises(ValueError):
        FD.flash_decode_plan(24, 20, 64, 1500, "fp8")


def _check_copy(src, n, tb, te, pitch):
    a0, bulk, plain = FD.flash_decode_row_copy(src, n, tb, te)
    pieces = list(plain)
    if bulk is not None:
        start, size = bulk
        assert start % 16 == 0 and size % 16 == 0 and size > 0
        assert tb <= start and start + size <= te, "a bulk copy leaves the tensor"
        assert a0 <= start and start + size - a0 <= pitch, "a bulk copy overruns its row buffer"
        assert all(hi - lo < 16 for lo, hi in plain), "plain loads beyond the tensor's edge granules"
        pieces.append((max(start, src), min(start + size, src + n)))
    for lo, hi in plain:
        assert tb <= lo < hi <= te and hi - a0 <= pitch
    at = src  # the pieces tile [src, src + n): no gap, no overlap
    for lo, hi in sorted(p for p in pieces if p[0] < p[1]):
        assert lo == at, "the copy misses or repeats bytes of the range"
        at = hi
    assert at == src + n
    return a0, bulk, plain


@pytest.mark.parametrize("variant", ["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 448, 1500, 12288])
@pytest.mark.parametrize("B", [1, 20, 24, 32, 40])
def test_every_copy_is_aligned_and_inside_the_tensor(B, T, variant):
    """Every row's bulk copy starts on a 16-byte address, moves a multiple
    of 16 bytes and stays inside the tensor and its row buffer; with the
    plain loads it covers the keys in range exactly. The tensors start on
    16 bytes, as the caching allocator gives them, and (bf16) at 2 bytes
    past it, as a view can."""
    p = FD.flash_decode_plan(B, H, DH, T, variant)
    elt = 1 if variant == "int8" else 2
    R = p["rows"]
    for tb in (4096, 4098) if elt == 2 else (4096, 4099):
        te = tb + B * H * DH * T * elt
        vec = FD.flash_decode_vec(T, variant, tb)
        assert 16 % vec == 0 and vec % elt == 0
        for name, lo, hi in _ranges(T):
            t0, t1 = FD.flash_decode_range(lo, hi, T)
            n = t1 - t0 + 1
            ve = vec // elt
            # a row buffer of this range; a ring slot holds at least seg_rows of them
            pitch = FD.flash_decode_pitch(n, variant)
            assert p["seg_rows"] <= min(p["rows"], p["seg_rows"] * p["pitch"] // pitch)
            for site in _sites(B, H):
                for rank in range(p["cluster"]):
                    for r in range(R):
                        src = tb + ((site * DH + rank * R + r) * T + t0) * elt
                        a0, _, _ = _check_copy(src, n * elt, tb, te, pitch)
                        # the first group of keys: aligned to the vector in the buffer, and the last one inside it
                        first = src - (t0 - t0 // ve * ve) * elt
                        assert first >= a0 and (first - a0) % vec == 0, (name, site, rank, r)
                        assert first - a0 + (t1 // ve - t0 // ve + 1) * vec <= pitch
                    # q of the rank's rows, (B, H, Dh) bf16, into the site buffer
                    qb = tb & ~15
                    _check_copy(qb + (site * DH + rank * R) * 2, R * 2, qb, qb + B * H * DH * 2, -(-2 * R // 16) * 16 + 32)
                if variant == "int8":  # the scale rows, (B, H, 1, T) bf16
                    sb = tb & ~15
                    _check_copy(sb + (site * T + t0) * 2, n * 2, sb, sb + B * H * T * 2, FD.flash_decode_pitch(T, "bf16"))


# --- the emulation -------------------------------------------------------------


def _bf16_round(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).to(torch.float32).numpy()


def _raw(t):
    """The bytes of a contiguous tensor."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint8).reshape(-1)
    return t.contiguous().numpy().view(np.uint8).reshape(-1)


def _decode(raw, variant):
    if variant == "int8":
        return raw.view(np.int8).astype(np.float32)
    return (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


class _Tensor:
    """A tensor's bytes at a device address."""

    def __init__(self, t, base):
        self.raw, self.tb = _raw(t), base
        self.te = base + self.raw.size

    def copy_row(self, src, n, pitch):
        """The row buffer the kernel fills for [src, src + n): 0xff wherever
        no copy writes; returns (buffer, a0)."""
        a0, bulk, plain = FD.flash_decode_row_copy(src, n, self.tb, self.te)
        buf = np.full(pitch, 0xFF, np.uint8)
        for lo, hi in ([(bulk[0], bulk[0] + bulk[1])] if bulk else []) + plain:
            assert self.tb <= lo and hi <= self.te and hi - a0 <= pitch
            buf[lo - a0:hi - a0] = self.raw[lo - self.tb:hi - self.tb]
        return buf, a0


def emulate(q, k, v, lo, hi, ks=None, vs=None, bases=(0, 0, 0, 0), plan=None):
    """The kernel's arithmetic on its copies. q (B, H, Dh) bf16; k/v (B, H,
    Dh, T) bf16 or int8 with ks/vs (B, H, 1, T) bf16; lo/hi lists. Returns
    (out (B, H, Dh) f32, logits (B, H, T) f32 in range, NaN elsewhere)."""
    B, H_, Dh = q.shape
    T = k.shape[-1]
    quant = ks is not None
    variant = "int8" if quant else "bf16"
    elt = 1 if quant else 2
    p = plan or FD.flash_decode_plan(B, H_, Dh, T, variant)
    C, R = p["cluster"], p["rows"]
    vec = FD.flash_decode_vec(T, variant, bases[0], bases[1])
    ve = vec // elt
    K, V = _Tensor(k, bases[0]), _Tensor(v, bases[1])
    KS, VS = (_Tensor(ks, bases[2]), _Tensor(vs, bases[3])) if quant else (None, None)
    spitch = FD.flash_decode_pitch(T, "bf16")
    qf = q.to(torch.float32).numpy()
    out = np.zeros((B, H_, Dh), np.float32)
    logits = np.full((B, H_, T), np.nan, np.float32)

    def keys(tensor, row, t0, t1):
        src = tensor.tb + (row * T + t0) * elt
        pitch = FD.flash_decode_pitch(t1 - t0 + 1, variant)
        buf, a0 = tensor.copy_row(src, (t1 - t0 + 1) * elt, pitch)
        off = src - a0 - (t0 - t0 // ve * ve) * elt  # the first group's byte in the buffer
        ng = t1 // ve - t0 // ve + 1
        assert off >= 0 and off % vec == 0 and off + ng * vec <= pitch
        return _decode(buf[off:off + ng * vec], variant)

    def scales(tensor, site, t, t0, t1):
        src = tensor.tb + (site * T + t0) * 2
        buf, a0 = tensor.copy_row(src, (t1 - t0 + 1) * 2, spitch)
        idx = src - a0 + 2 * (np.clip(t, t0, t1) - t0)
        return _decode(np.stack([buf[idx], buf[idx + 1]], -1).reshape(-1), "bf16")

    for b in range(B):
        t0, t1 = FD.flash_decode_range(int(lo[b]), int(hi[b]), T)
        t = t0 // ve * ve + np.arange((t1 // ve - t0 // ve + 1) * ve)
        inr = (t >= t0) & (t <= t1)
        for h in range(H_):
            site = b * H_ + h
            parts = []
            for rank in range(C):
                acc = np.zeros(t.size, np.float32)
                for r in range(R):
                    d = rank * R + r
                    acc = (acc + np.float32(qf[b, h, d]) * keys(K, site * Dh + d, t0, t1)).astype(np.float32)
                parts.append(acc)
            l = parts[0]
            for part in parts[1:]:  # rank order
                l = (l + part).astype(np.float32)
            with np.errstate(invalid="ignore", over="ignore"):
                if quant:
                    l = l * scales(KS, site, t, t0, t1)
                l = np.where((t >= int(lo[b])) & (t <= int(hi[b])), l, NEG).astype(np.float32)
                m = l[inr].max()
                e = np.where(inr, np.exp(l - m), 0).astype(np.float32)
            s = np.float32(e[inr].sum(dtype=np.float32))
            pv = _bf16_round(e * scales(VS, site, t, t0, t1) if quant else e)
            pv = np.where(inr, pv, 0).astype(np.float32)
            for d in range(Dh):
                x = keys(V, site * Dh + d, t0, t1)
                if not quant:  # bf16 padding may hold any bits, NaN too; int8 padding is finite, and its p is 0
                    x = np.where(inr, x, 0)
                out[b, h, d] = np.float32((pv * x).sum(dtype=np.float32)) / s
            logits[b, h, t[inr]] = l[inr]
    return out, logits


def _case(T, quant, seed):
    """q pre-scaled (bf16), K/V (bf16, or int8 with scales), and one batch
    row per range of _ranges."""
    rng = np.random.RandomState(seed)
    ranges = _ranges(T)
    B, H_ = len(ranges), 2
    q = (rng.randn(B, H_, DH).astype(np.float32) * 0.5 * DH**-0.5)
    k = rng.randn(B, H_, DH, T).astype(np.float32)
    v = rng.randn(B, H_, DH, T).astype(np.float32)
    lo = np.array([r[1] for r in ranges], np.int32)
    hi = np.array([r[2] for r in ranges], np.int32)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    if quant:
        kv = quantize_decode_kv(torch.from_numpy(k), torch.from_numpy(v))
        return qt, kv["k8"], kv["v8"], lo, hi, kv["ks"].to(torch.bfloat16), kv["vs"].to(torch.bfloat16)
    return qt, torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16), lo, hi, None, None


def _reference_logits(q, k, lo, hi, ks):
    f32 = torch.float32
    logits = torch.einsum("bhd,bhdt->bht", q.to(f32), k.to(torch.bfloat16).to(f32))
    if ks is not None:
        logits = logits * ks[:, :, 0, :].to(f32)
    t = torch.arange(k.shape[-1])
    valid = (t[None, :] >= torch.from_numpy(lo)[:, None]) & (t[None, :] <= torch.from_numpy(hi)[:, None])
    return torch.where(valid[:, None, :], logits, FD._NEG).numpy()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 448, 1500])
def test_emulation_matches_reference_and_pallas(T, quant):
    """Full, ragged, single-key, empty and inner ranges: the emulated
    kernel's logits against the plain version's, its output against the
    plain version and JAX's Pallas kernel, and two runs equal."""
    q, k, v, lo, hi, ks, vs = _case(T, quant, seed=T + quant)
    out, logits = emulate(q, k, v, lo, hi, ks, vs)
    again, _ = emulate(q, k, v, lo, hi, ks, vs)
    assert np.array_equal(out, again, equal_nan=True)
    ref_l = _reference_logits(q, k, lo, hi, ks)
    have = ~np.isnan(logits)
    for b, (_name, lo_b, hi_b) in enumerate(_ranges(T)):
        t0, t1 = FD.flash_decode_range(lo_b, hi_b, T)
        assert have[b, :, t0:t1 + 1].all() and not have[b, :, :t0].any() and not have[b, :, t1 + 1:].any()
    scale = np.abs(ref_l[have & (ref_l > FD._NEG)]).max()
    np.testing.assert_allclose(logits[have], ref_l[have], rtol=0, atol=1e-5 * scale)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    ref = FD.flash_decode_reference(q, k, v, lo_t, hi_t, ks, vs).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)
    j = lambda t: jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)  # noqa: E731
    if quant:
        pal = jax_flash_decode(j(q), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), jnp.asarray(lo), jnp.asarray(hi),
                               j(ks), j(vs), interpret=True)
    else:
        pal = jax_flash_decode(j(q), j(k), j(v), jnp.asarray(lo), jnp.asarray(hi), interpret=True)
    np.testing.assert_allclose(out, np.asarray(pal), rtol=0, atol=2e-2)


# chip_smoke.py's limit for K4 in every (batch, head) row, relative to the
# row's largest output (K4_REL there)
K4_REL = 1e-2


def _row_rel(out, ref):
    return float((np.abs(out - ref).max(-1) / np.abs(ref).max(-1)).max())


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [448, 1500])
def test_row_limit_passes_the_kernel_and_catches_a_misplaced_group(T, quant):
    """The emulated kernel is within K4_REL of each row's largest output at
    every range of _ranges, and the plain version on inputs whose first
    group of keys in range (VE keys) is taken from the next group, as a
    kernel with a wrong edge offset would read them, is not."""
    q, k, v, lo, hi, ks, vs = _case(T, quant, seed=20 + T + quant)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    ref = FD.flash_decode_reference(q, k, v, lo_t, hi_t, ks, vs).numpy()
    out, _ = emulate(q, k, v, lo, hi, ks, vs)
    assert _row_rel(out, ref) <= K4_REL
    ve = FD.flash_decode_vec(T, "int8" if quant else "bf16") // (1 if quant else 2)
    for which in (k, v):
        bad = which.clone()
        for b in range(len(lo)):
            t0, t1 = FD.flash_decode_range(int(lo[b]), int(hi[b]), T)
            if t1 - t0 + 1 >= 2 * ve:
                bad[b, ..., t0:t0 + ve] = which[b, ..., t0 + ve:t0 + 2 * ve]
        kf, vf = (bad, v) if which is k else (k, bad)
        planted = FD.flash_decode_reference(q, kf, vf, lo_t, hi_t, ks, vs).numpy()
        assert _row_rel(planted, ref) > K4_REL


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_emulation_on_a_ring_and_unaligned_tensors(quant):
    """T = 12,288 (the ring cycles over row segments), odd T (vectors of one
    key), and tensors that start off a 16-byte boundary (plain loads for
    the bytes before the first boundary and after the last): the emulated
    kernel against the plain version."""
    for T, bases in ((12288, (0, 0, 0, 0)), (1501, (0, 0, 0, 0)), (448, (2, 6, 4, 10) if not quant else (3, 5, 2, 6))):
        q, k, v, lo, hi, ks, vs = _case(T, quant, seed=T)
        q, k, v = q[:, :1], k[:, :1], v[:, :1]
        ks, vs = (ks[:, :1].contiguous(), vs[:, :1].contiguous()) if quant else (None, None)
        out, logits = emulate(q, k, v, lo, hi, ks, vs, bases=bases)
        ref = FD.flash_decode_reference(q, k, v, torch.from_numpy(lo), torch.from_numpy(hi), ks, vs).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)
        ref_l = _reference_logits(q, k, lo, hi, ks)
        have = ~np.isnan(logits)
        scale = np.abs(ref_l[have & (ref_l > FD._NEG)]).max()
        np.testing.assert_allclose(logits[have], ref_l[have], rtol=0, atol=1e-5 * scale)
        if T == 12288:
            p = FD.flash_decode_plan(len(lo), 1, DH, T, "int8" if quant else "bf16")
            assert p["stages"] < p["segments"]


def test_emulation_on_other_plans():
    """Other splits give the same logits and outputs as the default one
    (the partials' sums in rank order change only the order of f32 sums)."""
    q, k, v, lo, hi, ks, vs = _case(448, False, seed=9)
    base, _ = emulate(q, k, v, lo, hi)
    for c in (1, 2, 8):
        p = FD.flash_decode_plan(len(lo), 2, DH, 448, "bf16", cluster=c)
        out, _ = emulate(q, k, v, lo, hi, plan=p)
        np.testing.assert_allclose(out, base, rtol=0, atol=2e-2)


def test_jax_int8_cache_format_matches():
    """The int8 cache the emulation reads is the JAX package's format: the
    port's quantize_decode_kv gives the same int8 values and scales."""
    rng = np.random.RandomState(1)
    k = rng.randn(2, 2, DH, 30).astype(np.float32)
    v = rng.randn(2, 2, DH, 30).astype(np.float32)
    mine = quantize_decode_kv(torch.from_numpy(k), torch.from_numpy(v))
    theirs = JL.quantize_decode_kv(jnp.asarray(k), jnp.asarray(v))
    assert np.array_equal(mine["k8"].numpy(), np.asarray(theirs["k8"]))
    np.testing.assert_allclose(mine["ks"].to(torch.float32).numpy(), np.asarray(theirs["ks"], np.float32), rtol=1e-2)
