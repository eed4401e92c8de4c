"""Fused single-query decode attention (kernel K4, flash-decode).

Counterpart of ssak_tpu.ops.flash_decode.flash_decode_attention. Each
Whisper token step runs 64 attention sites (32 self, 32 cross); the kernel
does one whole site — dot, range mask, softmax, PV product, normalize — in
one launch that reads K and V once, in bf16 or as int8 with per-position
scales (the int8 KV-cache format of models.layers). The CUDA kernel is
`csrc/flash_decode.cu`; `flash_decode_reference` is the plain PyTorch
version of the same function, used for CPU tensors and by the on-card
comparison. `flash_decode_plan` chooses the kernel's persistent grid, its
split of a site over a thread-block cluster and its ring of row buffers;
`flash_decode_row_copy` gives the byte ranges of the kernel's copy of one
row, so the CPU tests can hold both to what the kernel needs.
"""

import ctypes
import functools

import torch

from ssak_tpu_torch.ops import _build

LAUNCHES = {"flash_decode_bf16": 0, "flash_decode_int8": 0}  # counted by the wrapper
# Each CTA of the kernel keeps a site's logits twice in shared memory (its
# rows' partial sums and the summed logits: 8*T bytes), in int8 the scale
# rows of two sites (8*T), and a ring of at least two rows: at T = 12,288 in
# int8 that is 222 KB of the 227 KB a block may use
MAX_T = 12288
MAX_DH = 256
_NEG = -1e30
_fns = {}

FD_SMEM_LIMIT = 232448  # shared bytes one block may use on the H100
FD_SM_SMEM = 233472  # shared bytes of one SM (each resident block also takes 1 KB)
FD_SMS = 132  # the H100's streaming multiprocessors
# Consumer warps of a CTA, by cache length, and the CTAs an SM is planned
# to hold (by registers: <= 97 a thread at 2 warps and 7 CTAs, <= 113 at 8
# and 2). A cache of fewer than FD_LONG_T slots is a decoder's
# self-attention cache, read over [lo, pos] with pos anywhere in it: its
# 480-800 sites run side by side in narrow CTAs, one wave of them. Timed
# at ranges [0, 31] to [0, 447] of the 448-slot cache at B = 24 and 40 on
# an H100 (tools/torch_flash_decode_variants.py --ranges), 2 warps were up
# to 2.4x faster than 8 from 31 to 223 keys and at most 10% slower above.
# A longer cache holds the encoder's keys, read whole: bound by bytes, and
# wider CTAs with deeper rings keep more of them in flight.
FD_LONG_T = 1024
FD_WARPS_PER_SM = {2: 7, 8: 2}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _elt(variant: str) -> int:
    if variant not in ("bf16", "int8"):
        raise ValueError(f"flash_decode: variant must be 'bf16' or 'int8', got {variant!r}")
    return 1 if variant == "int8" else 2


def flash_decode_pitch(n: int, variant: str) -> int:
    """Bytes of one row buffer for n keys in range: from the 16-byte
    boundary at or below the first key to the one at or above the last. A
    ring slot holds seg_rows buffers of all T keys, or, for a site with
    fewer keys in range, as many more as fit (at most the rank's rows)."""
    return _round_up(n * _elt(variant), 16) + 32


def flash_decode_smem(T: int, variant: str, rows: int, seg_rows: int, stages: int) -> int:
    """Shared bytes of one CTA (csrc/flash_decode.cu `layout`): the ring of
    `stages` x `seg_rows` row buffers; the partial logits and the logits
    (f32, T + 32 each); two site buffers (lo and hi, q of the rank's rows,
    in int8 the two scale rows); the reduction slots (4 for each of 8
    warps); 2 * stages + 6 mbarriers."""
    quant = _elt(variant) == 1
    n_p = _round_up(T + 32, 4)
    site = 16 + _round_up(2 * rows, 16) + 32 + (2 * (_round_up(2 * T, 16) + 32) if quant else 0)
    return (stages * seg_rows * flash_decode_pitch(T, variant) + 8 * n_p + 2 * site + 4 * 8 * 4
            + 8 * (2 * stages + 6))


@functools.lru_cache(maxsize=None)
def flash_decode_plan(B: int, H: int, Dh: int, T: int, variant: str, cluster: int = None, seg_rows: int = None,
                      stages: int = None, warps: int = None) -> dict:
    """The kernel's split of the B * H (batch, head) sites, which it takes
    as given. cluster: the CTAs of a site (1, 2, 4 or 8), each owning rows
    = Dh / cluster rows of K and V; seg_rows: rows a ring stage holds (a
    divisor of rows; more where a site has fewer keys in range); stages:
    the ring's depth; `segments` = 2 * rows / seg_rows (K's, then V's) pass
    through it for each site; warps: the consumer warps of a CTA (2 below
    FD_LONG_T slots, else 8). The grid holds `clusters` persistent
    clusters, as many as the card keeps resident (ctas_per_sm by shared
    memory, at most FD_WARPS_PER_SM[warps]) and at most one a site; cluster
    c takes sites c, c + clusters, ..., sites_per_cluster or one fewer. By
    default the smallest cluster that gives the card two CTAs an SM's worth
    of sites; a ring of what leaves the planned CTAs on an SM (or one,
    where that holds less than two rows), cut into the largest segments of
    which two fit it, as many stages as fit (at most two sites'
    segments)."""
    elt = _elt(variant)
    if B < 1 or H < 1 or not 1 <= T <= MAX_T or Dh % 8 or not 8 <= Dh <= MAX_DH:
        raise ValueError(f"flash_decode_plan: kernel takes T in [1, {MAX_T}], Dh % 8 == 0 and Dh <= {MAX_DH}; "
                         f"got B={B} H={H} Dh={Dh} T={T}")
    sites = B * H
    C = cluster or next((c for c in (1, 2, 4) if sites * c >= 2 * FD_SMS), 8)
    if C not in (1, 2, 4, 8) or Dh % C:
        raise ValueError(f"flash_decode_plan: cluster {C} must be 1, 2, 4 or 8 and divide Dh={Dh}")
    R = Dh // C
    pitch = flash_decode_pitch(T, variant)

    def fits(g, s):
        return flash_decode_smem(T, variant, R, g, s) <= FD_SMEM_LIMIT

    warps = warps or (8 if T >= FD_LONG_T else 2)
    if warps not in FD_WARPS_PER_SM:
        raise ValueError(f"flash_decode_plan: warps {warps} must be 2 or 8")
    # the ring's bytes: what leaves the planned CTAs on an SM, or where two row buffers do not fit that, one CTA
    fixed = flash_decode_smem(T, variant, R, 0, 0)
    budget = FD_SM_SMEM // FD_WARPS_PER_SM[warps] - 1024 - fixed
    if budget < 2 * pitch:
        budget = FD_SMEM_LIMIT - fixed
    if seg_rows is None:
        seg_rows = next(g for g in range(R, 0, -1) if R % g == 0 and (2 * g * pitch <= budget or g == 1))
    g = seg_rows
    if g < 1 or R % g:
        raise ValueError(f"flash_decode_plan: seg_rows {g} must divide the {R} rows of a rank")
    segments = 2 * R // g
    if stages is None:
        stages = max(1, min(2 * segments, budget // (g * pitch)))
    if not 1 <= stages <= 2 * segments or not fits(g, stages):
        raise ValueError(f"flash_decode_plan: {stages} stages of {g} rows exceed {FD_SMEM_LIMIT} shared bytes at "
                         f"T={T}, or two sites' {2 * segments} segments")
    smem = flash_decode_smem(T, variant, R, g, stages)
    per_sm = max(1, min(FD_WARPS_PER_SM[warps], FD_SM_SMEM // (smem + 1024)))
    G = min(sites, max(1, FD_SMS * per_sm // C))
    per = -(-sites // G)
    return dict(cluster=C, rows=R, seg_rows=g, stages=stages, segments=segments, pitch=pitch, smem=smem,
                ctas_per_sm=per_sm, clusters=G, sites_per_cluster=per, grid=C * G, warps=warps, threads=32 * warps + 32,
                vec=flash_decode_vec(T, variant))


def flash_decode_vec(T: int, variant: str, *bases: int) -> int:
    """Bytes of the consumers' vectors of keys: the widest power of two up
    to 16 (8 in int8) that divides a row's bytes and every base address
    given, so a group of keys at a multiple of vec / element bytes is
    aligned in every row (csrc/flash_decode.cu `vector_bytes`)."""
    elt = _elt(variant)
    w = 8 if elt == 1 else 16
    while w > elt and ((T * elt) % w or any(b % w for b in bases)):
        w //= 2
    return w


def flash_decode_row_copy(src: int, nbytes: int, tb: int, te: int):
    """The kernel's copy of the bytes [src, src + nbytes) of a tensor that
    occupies [tb, te) into a 16-aligned row buffer that holds byte x at x -
    a0 (csrc/flash_decode.cu `row_copy`). Returns (a0, bulk, plain): a0 is
    src rounded down to 16; bulk is (start, size) of the one bulk copy,
    between 16-byte boundaries inside the tensor, or None; plain lists the
    byte ranges read with plain loads (before the tensor's first boundary
    or after its last)."""
    e = src + nbytes
    a0 = src & ~15
    A = max(a0, _round_up(tb, 16))
    E = min(_round_up(e, 16), te & ~15)
    if A < E:
        plain = [r for r in ((src, min(A, e)), (max(E, src), e)) if r[0] < r[1]]
        return a0, (A, E - A), plain
    return a0, None, [(src, e)] if src < e else []


def flash_decode_range(lo: int, hi: int, T: int) -> tuple:
    """The keys [t0, t1] a site reads: [lo, hi] within the cache, or all T
    when that is empty (every key masked, weighted alike)."""
    t0, t1 = max(lo, 0), min(hi, T - 1)
    return (0, T - 1) if t0 > t1 else (t0, t1)


def flash_decode_reference(q, kT, vT, lo, hi, k_scales=None, v_scales=None):
    """Plain version of the Pallas kernels, step by step. q (B, H, Dh)
    pre-scaled; kT/vT (B, H, Dh, T) bf16, or int8 with k_scales/v_scales
    (B, H, 1, T); lo/hi (B,) inclusive key range -> (B, H, Dh) f32."""
    quant = k_scales is not None
    T = kT.shape[-1]
    f32, bf16 = torch.float32, torch.bfloat16
    logits = torch.einsum("bhd,bhdt->bht", q.to(bf16).to(f32), kT.to(bf16).to(f32))
    if quant:
        logits = logits * k_scales[:, :, 0, :].to(f32)
    t = torch.arange(T, device=q.device)
    valid = (t[None, :] >= lo.reshape(-1, 1)) & (t[None, :] <= hi.reshape(-1, 1))
    logits = torch.where(valid[:, None, :], logits, _NEG)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = torch.sum(p, dim=-1, keepdim=True)
    pv = p * v_scales[:, :, 0, :].to(f32) if quant else p
    o = torch.einsum("bht,bhdt->bhd", pv.to(bf16).to(f32), vT.to(bf16).to(f32))
    return o / s


def _kernel(variant):
    if variant not in _fns:
        lib = _build.library("flash_decode")
        if variant == "int8":
            fn = lib.ssak_flash_decode_int8
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        else:
            fn = lib.ssak_flash_decode_bf16
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[variant] = fn
    return _fns[variant]


def flash_decode_attention(q, kT, vT, lo, hi, k_scales=None, v_scales=None, plan=None):
    """Single-query attention over [lo, hi] per row. See
    flash_decode_reference for shapes. CPU tensors take the plain version;
    CUDA tensors launch the kernel (contiguous q bf16, K/V bf16 or int8,
    scales bf16, T <= MAX_T) on `plan` (flash_decode_plan's by default) or
    raise."""
    quant = k_scales is not None
    if (v_scales is not None) != quant:
        raise ValueError("flash_decode_attention: pass both k_scales and v_scales or neither")
    if q.ndim != 3 or kT.ndim != 4:
        raise ValueError(f"flash_decode_attention: bad ranks q={tuple(q.shape)} kT={tuple(kT.shape)}")
    B, H, Dh = q.shape
    T = kT.shape[-1]
    if tuple(kT.shape) != (B, H, Dh, T) or tuple(vT.shape) != (B, H, Dh, T):
        raise ValueError(f"flash_decode_attention: K/V must be {(B, H, Dh, T)}, got {tuple(kT.shape)}, {tuple(vT.shape)}")
    if quant and (tuple(k_scales.shape) != (B, H, 1, T) or tuple(v_scales.shape) != (B, H, 1, T)):
        raise ValueError("flash_decode_attention: scales must be (B, H, 1, T)")
    if lo.numel() != B or hi.numel() != B:
        raise ValueError("flash_decode_attention: lo/hi must have one entry per row")
    tensors = [q, kT, vT, lo, hi] + ([k_scales, v_scales] if quant else [])
    devices = {a.device for a in tensors}
    if len(devices) != 1:
        raise ValueError(f"flash_decode_attention: tensors on different devices {devices}")
    if q.device.type == "cpu":
        return flash_decode_reference(q, kT, vT, lo, hi, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    kv_dtype = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16 or kT.dtype != kv_dtype or vT.dtype != kv_dtype:
        raise TypeError(f"flash_decode_attention: q bf16 and K/V {kv_dtype} required, got {q.dtype}, {kT.dtype}, {vT.dtype}")
    if quant and (k_scales.dtype != torch.bfloat16 or v_scales.dtype != torch.bfloat16):
        raise TypeError("flash_decode_attention: scales must be bf16")
    if T > MAX_T or Dh > MAX_DH:
        raise ValueError(f"flash_decode_attention: kernel takes T<={MAX_T}, Dh<={MAX_DH}; got T={T}, Dh={Dh}")
    if not all(a.is_contiguous() for a in tensors[:3] + tensors[5:]):
        raise ValueError("flash_decode_attention: q, K, V and scales must be contiguous")
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    plan = plan or flash_decode_plan(B, H, Dh, T, "int8" if quant else "bf16")
    split = (plan["cluster"], plan["seg_rows"], plan["stages"], plan["clusters"], plan["warps"], plan["smem"])
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=q.device)
    stream = _build.stream_ptr(q.device)
    if quant:
        rc = _kernel("int8")(q.data_ptr(), kT.data_ptr(), k_scales.data_ptr(), vT.data_ptr(), v_scales.data_ptr(),
                             lo.data_ptr(), hi.data_ptr(), out.data_ptr(), B, H, Dh, T, *split, stream)
        name = "flash_decode_int8"
    else:
        rc = _kernel("bf16")(q.data_ptr(), kT.data_ptr(), vT.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                             out.data_ptr(), B, H, Dh, T, *split, stream)
        name = "flash_decode_bf16"
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def flash_decode_supported(q, Dh: int, T: int) -> bool:
    """Route single-query decode attention through the kernel: whenever
    the tensors are on CUDA (on by default, unlike ssak_tpu's
    SSAK_FLASH_DECODE opt-in, whose only reason was the TPU runtime's
    per-launch floor). On the CPU, decode attention takes the mask paths,
    as ssak_tpu does off the TPU."""
    return q.is_cuda and Dh % 8 == 0 and Dh <= MAX_DH and T <= MAX_T
