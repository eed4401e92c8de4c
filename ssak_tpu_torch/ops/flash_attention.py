"""Segment-masked flash self-attention, forward and backward (kernel L1).

Counterpart of ssak_tpu.models.layers.flash_self_attention, which calls
JAX's library Pallas flash attention (`_flash_attention_impl`, and under
jax.grad its VJP `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`)
on the TPU. q/k/v (B, T, H, Dh) bf16; T is padded to Tp = ceil(T / 128) *
128 with zero q/k/v; frames below a row's length form segment 1 and the
rest segment 0, and a query sees exactly the keys of its own segment (a pad
query attends over every pad key of [length, Tp), the zero keys included).
Without lengths and with T % 128 == 0 there is no mask.

The CUDA kernels are `csrc/flash_attention.cu` (the forward; for training
it also writes each row's max m and sum l) and `csrc/flash_attention_bwd.cu`
(dK/dV and dQ, from q, k, v, dO, m, l and di = sum_d o * dO). Their tilings
come from `flash_fwd_plan` and `flash_bwd_plan`, which the C entry points
check; `flash_fwd_tile_class` and `flash_bwd_tile_class` mirror how each
kernel classes a (64 rows, tile) pair: skipped across segments, unmasked
within one, masked where it straddles a row's length (or, backward, T).
`flash_self_attention_reference` and `flash_self_attention_backward_reference`
are the plain PyTorch versions of the same functions, with the library's
arithmetic, used for CPU tensors and by the on-card comparison.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ssak_tpu_torch.ops import _build

# counted by the wrappers, one per kernel launch
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}
HEAD_DIMS = (64, 128, 256)
# L1's backward kernels: a CTA owns FLASH_BWD_ROWS rows (two consumer
# warpgroups of FLASH_BWD_WG_ROWS) and walks the other side in tiles of
# `walk` rows; the walks each kernel is compiled for, per Dh, default first
FLASH_BWD_ROWS, FLASH_BWD_WG_ROWS = 128, 64
FLASH_BWD_WALKS = {"dkv": {64: (64, 32), 128: (32,), 256: (32,)}, "dq": {64: (64, 32), 128: (64,), 256: (32,)}}
FLASH_BWD_MAX_STAGES = 4
SMEM_PER_BLOCK = 232448  # shared memory one block can use on the H100
BWD_SKIP, BWD_WITHIN, BWD_MASKED = 0, 1, 2
# L1's forward kernel: a CTA owns FLASH_FWD_ROWS[Dh] query rows (consumer
# warpgroups of FLASH_FWD_WG_ROWS) and walks the keys of [0, Tp) in tiles of
# FLASH_FWD_BN[Dh] rows
FLASH_FWD_WG_ROWS = 64
FLASH_FWD_ROWS = {64: 192, 128: 128, 256: 128}
FLASH_FWD_BN = {64: 128, 128: 128, 256: 64}
FLASH_FWD_MAX_STAGES = 4
FWD_SKIP, FWD_WITHIN, FWD_MASKED = 0, 1, 2
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the library kernel's DEFAULT_MASK_VALUE
_fns = {}


def padded_len(T: int) -> int:
    return -(-T // 128) * 128


def _segments(B, T, n, lengths, device):
    """(B, n) bool over positions [0, n): True below each row's length
    (segment 1), the length T where lengths is None."""
    lens = torch.full((B,), T, device=device) if lengths is None else lengths.to(device)
    return torch.arange(n, device=device)[None, :] < lens.reshape(B, 1)


def flash_self_attention_reference(q, k, v, lengths=None, scale=None, return_stats=False):
    """Plain version: q/k/v (B, T, H, Dh), lengths (B,) or None -> (B, T,
    H, Dh) bf16, and with return_stats also m and l, f32 (B, H, T): each
    row's max of the masked, scaled logits and its sum of exp(s - m) over
    [0, Tp), the zero keys included. Logits are exact f32 products of the
    bf16 values, scaled, plus the mask value across segments; p = exp(s -
    max) rounded to bf16 for P.V, the row sum taken over the f32 p."""
    B, T, H, Dh = q.shape
    scale = Dh**-0.5 if scale is None else scale
    Tp = padded_len(T)
    f32, bf16 = torch.float32, torch.bfloat16
    qf, kf, vf = (torch.nn.functional.pad(a.to(bf16).to(f32), (0, 0, 0, 0, 0, Tp - T)) for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if lengths is not None or Tp != T:
        seg = _segments(B, T, Tp, lengths, q.device)  # the zero keys past T are segment 0
        s = s + torch.where(seg[:, None, :, None] == seg[:, None, None, :], 0.0, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)  # (B, H, Tp)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(bf16).to(f32), vf) / l.permute(0, 2, 1)[..., None]
    o = o[:, :T].to(bf16)
    if return_stats:
        return o, m[..., 0][:, :, :T].contiguous(), l[:, :, :T].contiguous()
    return o


def _backward_plain(q, k, v, do, m, l, di, lengths, scale, want):
    """The library's backward arithmetic over queries and keys [0, T) (the
    pad rows past T add nothing: dO is zero there, and so are the keys):
    p = exp(s - m) * (1 / l) in f32; dv from p rounded to bf16; dp = dO.V^T
    in f32; ds = ((dp - di) * p) * scale; dk and dq from ds rounded to bf16;
    f32 sums and one bf16 cast at the end. `want` names the outputs ("dq",
    "dk", "dv"); the (B, H, T, T) f32 tensors are updated in place."""
    B, T, H, Dh = q.shape
    f32, bf16 = torch.float32, torch.bfloat16
    qf, kf, vf, dof = (a.to(bf16).to(f32) for a in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf).mul_(scale)
    if lengths is not None:
        seg = _segments(B, T, T, lengths, q.device)
        s.add_(torch.where(seg[:, None, :, None] == seg[:, None, None, :], 0.0, MASK_VALUE))
    p = s.sub_(m[..., None]).exp_().mul_((1.0 / l)[..., None])
    out = {}
    if "dv" in want:
        out["dv"] = torch.einsum("bhqk,bqhd->bkhd", p.to(bf16).to(f32), dof).to(bf16)
    if "dk" in want or "dq" in want:
        ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf).sub_(di[..., None]).mul_(p).mul_(scale)
        del p, s
        ds = ds.to(bf16).to(f32)
        if "dk" in want:
            out["dk"] = torch.einsum("bhqk,bqhd->bkhd", ds, qf).to(bf16)
        if "dq" in want:
            out["dq"] = torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(bf16)
    return [out[w] for w in want]


def attention_di(o, do):
    """di = sum_d o * dO in f32, (B, T, H, Dh) -> (B, H, T) contiguous (the
    library computes it outside its Pallas calls)."""
    return (o.float() * do.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def flash_self_attention_backward_reference(q, k, v, o, m, l, do, lengths=None, scale=None):
    """Plain version of both backward kernels: the forward's q/k/v and output
    o (B, T, H, Dh), its m and l (B, H, T) f32, the output gradient dO (B, T,
    H, Dh) -> (dq, dk, dv) bf16 (B, T, H, Dh)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return tuple(_backward_plain(q, k, v, do, m, l, attention_di(o, do), lengths, scale, ("dq", "dk", "dv")))


def _bwd_smem(kernel, Dh, walk, stages):
    """Shared bytes of a backward CTA, as csrc/flash_attention_bwd.cu lays
    them out: 1024 of alignment slack, the own rows of two operands, per
    stage two walked operands, two mbarriers and, for dK/dV, boxes of walk
    + 4 values of m, l and di in 128-byte slots, their per-column m *
    log2(e), 1 / l and di and a third mbarrier; one more mbarrier."""
    dkv = kernel == "dkv"
    vec = -(-(walk + 4) * 4 // 128) * 128
    stage = 2 * walk * Dh * 2 + (3 * vec + 12 * walk + 24 if dkv else 16)
    return 1024 + 2 * FLASH_BWD_ROWS * Dh * 2 + stages * stage + 8


def flash_bwd_plan(B: int, T: int, H: int, Dh: int, walk=None, stages=None) -> dict:
    """The backward kernels' plan, {"dkv": ..., "dq": ...}, each with its
    own rows per CTA (`rows`), walked tile rows (`walk`), TMA ring `stages`,
    consumer `warpgroups`, `threads`, column `split` (dK/dV at Dh = 256: two
    CTAs per key tile, half the output columns each), own-row `tiles`,
    `walk_tiles`, shared bytes (`smem`) and `grid`. Pure Python; the
    wrapper passes it to the C entry points, which check it.

    Why: a CTA of 128 own rows is two 64-row wgmma warpgroups plus a
    producer, 384 threads at 168 registers, one CTA an SM. At Dh = 64 a walk
    of 64 keeps the consumers' live registers under the 224 that setmaxnreg
    gives them (S, dP, dK and dV accumulators of 32 each, the own rows' A
    fragments, 32, the bf16 P and dS fragments, 16 each); Dh = 128 and 256
    walk 32 (dQ at 128: 64) to keep their wider accumulators in registers. Stages: the most, up to 4, that
    fit SMEM_PER_BLOCK. Grid: ceil(T / 128) own tiles x H x B; at T = 6,999
    and H = 16 that is 880 CTAs at B = 1 (6.67 waves of 132, the last wave
    two thirds full: 95% of the slots busy) and 3,520 at B = 4 (26.67
    waves, 99%). `walk` and `stages` override the defaults (the variants
    tool times other tilings)."""
    if Dh not in HEAD_DIMS or min(B, T, H) < 1:
        raise ValueError(f"flash_bwd_plan: Dh in {HEAD_DIMS} and B, T, H >= 1, got B={B} T={T} H={H} Dh={Dh}")
    plan = {}
    for kernel in ("dkv", "dq"):
        walks = FLASH_BWD_WALKS[kernel][Dh]
        w = walks[0] if walk is None else walk
        if w not in walks:
            raise ValueError(f"flash_bwd_plan: {kernel} at Dh={Dh} is compiled for walks {walks}, got {w}")
        fits = [n for n in range(2, FLASH_BWD_MAX_STAGES + 2) if _bwd_smem(kernel, Dh, w, n) <= SMEM_PER_BLOCK]
        n = max(x for x in fits if x <= FLASH_BWD_MAX_STAGES) if stages is None else stages
        if n not in fits:
            raise ValueError(f"flash_bwd_plan: {kernel} at Dh={Dh}, walk={w}: {n} stages do not fit "
                             f"{SMEM_PER_BLOCK} bytes")
        split = 2 if kernel == "dkv" and Dh == 256 else 1
        tiles = -(-T // FLASH_BWD_ROWS)
        plan[kernel] = dict(rows=FLASH_BWD_ROWS, walk=w, stages=n, warpgroups=FLASH_BWD_ROWS // FLASH_BWD_WG_ROWS,
                            threads=128 * (FLASH_BWD_ROWS // FLASH_BWD_WG_ROWS + 1), split=split, tiles=tiles,
                            walk_tiles=-(-T // w), smem=_bwd_smem(kernel, Dh, w, n), grid=(tiles * split, H, B))
    return plan


def flash_bwd_tile_class(r0: int, c0: int, walk: int, length: int, T: int) -> int:
    """The backward kernels' class of the pair (a warpgroup's own rows [r0,
    r0 + 64), walked rows [c0, c0 + walk)) in a row of `length` valid frames
    (T where there are no lengths), as csrc/flash_attention_bwd.cu
    `tile_class` decides it: BWD_SKIP where every (own, walked) pair below T
    lies across the segment boundary (p is exactly 0) or the own rows all lie
    past T; BWD_MASKED where a tile straddles the length or runs past T;
    else BWD_WITHIN (no mask)."""
    r1, c1 = min(r0 + FLASH_BWD_WG_ROWS, T), min(c0 + walk, T)
    if r0 >= r1:
        return BWD_SKIP
    r_lo, r_hi, c_lo, c_hi = r1 <= length, r0 >= length, c1 <= length, c0 >= length
    if (r_lo and c_hi) or (r_hi and c_lo):
        return BWD_SKIP
    if c0 + walk > T:
        return BWD_MASKED
    return BWD_WITHIN if (r_lo and c_lo) or (r_hi and c_hi) else BWD_MASKED


def flash_bwd_tile_counts(plan: dict, T: int, H: int, lengths=None) -> dict:
    """{kernel: {"skip", "within", "masked": (warpgroup, walked tile) pairs;
    "loaded": walked tiles the CTAs load}} over every row and head, for
    `lengths` (a list, or None: no mask)."""
    out = {}
    for kernel, k in plan.items():
        n = {"skip": 0, "within": 0, "masked": 0, "loaded": 0}
        for length in (lengths if lengths is not None else [T] * k["grid"][2]):
            for t in range(k["tiles"]):
                for c in range(k["walk_tiles"]):
                    cls = [flash_bwd_tile_class(t * k["rows"] + w * FLASH_BWD_WG_ROWS, c * k["walk"], k["walk"],
                                                length, T) for w in range(k["warpgroups"])]
                    for x in cls:
                        n[("skip", "within", "masked")[x]] += H * k["split"]
                    n["loaded"] += H * k["split"] * any(x != BWD_SKIP for x in cls)
        out[kernel] = n
    return out


def _fwd_smem(Dh, rows, bn, stages):
    """Shared bytes of a forward CTA, as csrc/flash_attention.cu lays them
    out: 1024 of alignment slack, Q's rows, per stage a K and a V tile of bn
    rows and two mbarriers; one more mbarrier."""
    return 1024 + rows * Dh * 2 + stages * (2 * bn * Dh * 2 + 16) + 8


def flash_fwd_plan(B: int, T: int, H: int, Dh: int, stages=None) -> dict:
    """The forward kernel's plan: query rows per CTA (`rows`), key tile
    `bn`, TMA ring `stages`, consumer `warpgroups`, `threads`, query
    `tiles`, `key_tiles` over [0, Tp), shared bytes (`smem`) and `grid`.
    Pure Python; the wrapper passes it to the C entry point, which checks it.

    Why: each consumer warpgroup owns 64 query rows and issues wgmma; a
    producer warpgroup feeds the ring; one CTA an SM. At Dh = 64 a key tile
    of 128 halves the turns a tile against 64, and the live registers of a
    consumer (S, 64 f32; the previous tile's bf16 P, 32; O, 32) fit the 160
    that setmaxnreg gives each of three consumers (192 rows), which hide
    more of the softmax's latency than two (128 rows, 224 registers each).
    Dh = 128 takes 128 keys (O, 64) and Dh = 256 64 (O, 128), with two
    consumers. Stages: the most, up to 4, that fit SMEM_PER_BLOCK. Grid:
    ceil(T / rows) query tiles x H x B; at T = 7,001, H = 16 and 192 rows
    that is 37 x 16 = 592 CTAs at B = 1 (4.48 waves of 132, the last about
    half full: 90% of the slots busy; 128 rows would give 880, 6.67 waves)
    and 3,552 at B = 6 (26.9 waves). `stages` overrides the default (the
    variants tool times other ring depths)."""
    if Dh not in HEAD_DIMS or min(B, T, H) < 1:
        raise ValueError(f"flash_fwd_plan: Dh in {HEAD_DIMS} and B, T, H >= 1, got B={B} T={T} H={H} Dh={Dh}")
    r, n = FLASH_FWD_ROWS[Dh], FLASH_FWD_BN[Dh]
    fits = [x for x in range(2, FLASH_FWD_MAX_STAGES + 1) if _fwd_smem(Dh, r, n, x) <= SMEM_PER_BLOCK]
    st = max(fits) if stages is None else stages
    if st not in fits:
        raise ValueError(f"flash_fwd_plan: Dh={Dh}, bn={n}: {st} stages do not fit {SMEM_PER_BLOCK} bytes "
                         f"(or lie outside 2..{FLASH_FWD_MAX_STAGES})")
    tiles, wgs = -(-T // r), r // FLASH_FWD_WG_ROWS
    return dict(rows=r, bn=n, stages=st, warpgroups=wgs, threads=128 * (wgs + 1), tiles=tiles,
                key_tiles=padded_len(T) // n, smem=_fwd_smem(Dh, r, n, st), grid=(tiles, H, B))


def flash_fwd_tile_class(r0: int, c0: int, bn: int, length: int, T: int) -> int:
    """The forward kernel's class of the pair (a warpgroup's query rows [r0,
    r0 + 64), keys [c0, c0 + bn)) in a row of `length` valid frames (T where
    there are no lengths), as csrc/flash_attention.cu `tile_class` decides
    it. A query or key is segment 1 below the length and 0 from it on, the
    zero keys of [T, Tp) included (within for pad queries, across for valid
    ones). Rows past T are not written, so only those of [r0, min(r0 + 64,
    T)) count: FWD_SKIP where every such pair lies across segments (p is
    exactly 0) or there is no such row; FWD_WITHIN where every pair lies in
    one segment (no mask); else FWD_MASKED."""
    r1 = min(r0 + FLASH_FWD_WG_ROWS, T)
    if r0 >= r1:
        return FWD_SKIP
    r_lo, r_hi = r1 <= length, r0 >= length
    c_lo, c_hi = c0 + bn <= length, c0 >= length
    if (r_lo and c_hi) or (r_hi and c_lo):
        return FWD_SKIP
    return FWD_WITHIN if (r_lo and c_lo) or (r_hi and c_hi) else FWD_MASKED


def flash_fwd_tile_counts(plan: dict, T: int, H: int, lengths=None) -> dict:
    """{"skip", "within", "masked": (warpgroup, key tile) pairs; "loaded":
    key tiles the CTAs load} over every row and head, for `lengths` (a
    list, or None: no mask)."""
    n = {"skip": 0, "within": 0, "masked": 0, "loaded": 0}
    for length in (lengths if lengths is not None else [T] * plan["grid"][2]):
        for t in range(plan["tiles"]):
            for c in range(plan["key_tiles"]):
                cls = [flash_fwd_tile_class(t * plan["rows"] + w * FLASH_FWD_WG_ROWS, c * plan["bn"], plan["bn"],
                                            length, T) for w in range(plan["warpgroups"])]
                for x in cls:
                    n[("skip", "within", "masked")[x]] += H
                n["loaded"] += H * any(x != FWD_SKIP for x in cls)
    return n


def _kernel(name):
    if name not in _fns:
        if name == "fwd":
            fn = _build.library("flash_attention").ssak_flash_attention_fwd
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong),
                           ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        else:
            lib = _build.library("flash_attention_bwd")
            fn = lib.ssak_flash_attention_bwd_dkv if name == "dkv" else lib.ssak_flash_attention_bwd_dq
            n_out = 2 if name == "dkv" else 1
            fn.argtypes = ([ctypes.c_void_p] * (8 + n_out) + [ctypes.c_int] * 4
                           + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float] + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _kernel_operand(x):
    """x itself when the kernel can read it through its strides (a
    contiguous, 16-byte aligned Dh row per (b, t, h)), else a contiguous copy."""
    if x.stride(3) == 1 and all(s % 8 == 0 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


def _check(what, tensors, lengths):
    """Shapes and devices shared by every entry; returns the device type."""
    q = tensors[0]
    if q.ndim != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{what}: q/k/v must share a (B, T, H, Dh) shape, got {[tuple(t.shape) for t in tensors]}")
    if lengths is not None and lengths.numel() != q.shape[0]:
        raise ValueError(f"{what}: lengths must have one entry per row, got {tuple(lengths.shape)}")
    devices = {a.device for a in tensors} | ({lengths.device} if lengths is not None else set())
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on different devices {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    return q.device.type


def _check_cuda(what, tensors):
    B, T, H, Dh = tensors[0].shape
    if not all(a.dtype == torch.bfloat16 for a in tensors):
        raise TypeError(f"{what}: q/k/v must be bf16, got {[a.dtype for a in tensors]}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes Dh in {HEAD_DIMS}, got {Dh}")
    if H > 65535 or B > 65535:
        raise ValueError(f"{what}: the kernel's grid takes B, H <= 65535, got B={B}, H={H}")


def _kernel_lengths(lengths, B, T, device):
    if lengths is None and T % 128:
        lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    return None if lengths is None else lengths.to(torch.int32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flash_forward(q, k, v, lengths, scale, stats=False, plan=None):
    """o, or with stats (o, m, l) for the backward; CUDA tensors on
    flash_fwd_plan's tiling, or `plan`."""
    if _check("flash_self_attention", (q, k, v), lengths) == "cpu":
        return flash_self_attention_reference(q, k, v, lengths, scale, return_stats=stats)
    _check_cuda("flash_self_attention", (q, k, v))
    B, T, H, Dh = q.shape
    scale = Dh**-0.5 if scale is None else scale
    kp = plan or flash_fwd_plan(B, T, H, Dh)
    q, k, v = (_tma_operand(a) for a in (q, k, v))
    lens = _kernel_lengths(lengths, B, T, q.device)
    out = torch.empty((B, T, H, Dh), dtype=torch.bfloat16, device=q.device)
    m = l = None
    if stats:
        m, l = (torch.empty((B, H, T), dtype=torch.float32, device=q.device) for _ in range(2))
    strides = (ctypes.c_longlong * 9)(*(s for a in (q, k, v) for s in a.stride()[:3]))
    rc = _kernel("fwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(lens), out.data_ptr(), _ptr(m), _ptr(l),
                        B, T, H, Dh, strides, float(scale), kp["rows"], kp["stages"], kp["smem"],
                        _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, m, l) if stats else out


def _check_stats(what, q, tensors):
    B, T, H, _ = q.shape
    for t in tensors:
        if t.shape != (B, H, T) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{what}: m, l and di must be f32 (B, H, T) = {(B, H, T)} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _tma_operand(x):
    """_kernel_operand(x), made contiguous unless its (head, time, batch)
    strides rise in that order: the kernels' tensor maps list the dimensions
    as (Dh, H, T, B)."""
    x = _kernel_operand(x)
    return x if x.stride(2) <= x.stride(1) <= x.stride(0) else x.contiguous()


def _launch_bwd(name, q, k, v, do, m, l, di, lengths, scale, outs, plan=None):
    B, T, H, Dh = q.shape
    if B * H * T >= 2**31:
        raise ValueError(f"flash_attention_bwd_{name}: B*H*T must be below 2**31, got {B * H * T}")
    kp = (plan or flash_bwd_plan(B, T, H, Dh))[name]
    q, k, v, do = (_tma_operand(a) for a in (q, k, v, do))
    m, l, di = (a.contiguous() for a in (m, l, di))
    lens = _kernel_lengths(lengths, B, T, q.device)
    strides = (ctypes.c_longlong * 12)(*(s for a in (q, k, v, do) for s in a.stride()[:3]))
    rc = _kernel(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
                       di.data_ptr(), _ptr(lens), *(o.data_ptr() for o in outs), B, T, H, Dh, strides, float(scale),
                       kp["walk"], kp["stages"], kp["smem"], _build.stream_ptr(q.device))
    _build.check(rc, f"flash_attention_bwd_{name}")
    LAUNCHES[f"flash_attention_bwd_{name}"] += 1


def _backward_entry(what, q, k, v, do, m, l, di, lengths, scale):
    device = _check(what, (q, k, v, do), lengths)
    _check_stats(what, q, (m, l, di))
    if device == "cuda":
        _check_cuda(what, (q, k, v, do))
    return device, (q.shape[-1] ** -0.5 if scale is None else scale)


def flash_attention_bwd_dkv(q, k, v, do, m, l, di, lengths=None, scale=None, plan=None):
    """dK and dV (B, T, H, Dh) bf16 from the forward's q/k/v, the output
    gradient dO, m, l and di (f32 (B, H, T)). CUDA tensors launch the dK/dV
    kernel (on flash_bwd_plan's tiling, or `plan`) or raise; CPU tensors
    take its plain version."""
    device, scale = _backward_entry("flash_attention_bwd_dkv", q, k, v, do, m, l, di, lengths, scale)
    if device == "cpu":
        return tuple(_backward_plain(q, k, v, do, m, l, di, lengths, scale, ("dk", "dv")))
    dk, dv = (torch.empty(q.shape, dtype=torch.bfloat16, device=q.device) for _ in range(2))
    _launch_bwd("dkv", q, k, v, do, m, l, di, lengths, scale, (dk, dv), plan)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, m, l, di, lengths=None, scale=None, plan=None):
    """dQ (B, T, H, Dh) bf16, from the same inputs as flash_attention_bwd_dkv.
    CUDA tensors launch the dQ kernel (on flash_bwd_plan's tiling, or
    `plan`) or raise; CPU tensors take its plain version."""
    device, scale = _backward_entry("flash_attention_bwd_dq", q, k, v, do, m, l, di, lengths, scale)
    if device == "cpu":
        return _backward_plain(q, k, v, do, m, l, di, lengths, scale, ("dq",))[0]
    dq = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    _launch_bwd("dq", q, k, v, do, m, l, di, lengths, scale, (dq,), plan)
    return dq


class FlashSelfAttention(torch.autograd.Function):
    """L1 under autograd: the forward saves q, k, v, its output and the row
    statistics m, l; the backward runs the dK/dV and dQ kernels on CUDA
    tensors (their plain version on CPU tensors). Like the library's VJP,
    it is not differentiable again."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale):
        o, m, l = _flash_forward(q, k, v, lengths, scale, stats=True)
        ctx.save_for_backward(q, k, v, o, m, l, lengths)
        ctx.scale = q.shape[-1] ** -0.5 if scale is None else scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, o, m, l, lengths = ctx.saved_tensors
        do = grad_out.contiguous()
        di = attention_di(o, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, m, l, di, lengths, ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, do, m, l, di, lengths, ctx.scale)
        return dq, dk, dv, None, None


def flash_self_attention(q, k, v, lengths=None, scale=None):
    """Segment-masked self-attention, q/k/v (B, T, H, Dh) bf16, lengths
    (B,) valid frames or None, scale default Dh**-0.5 -> (B, T, H, Dh) bf16.
    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16,
    Dh in HEAD_DIMS) or raise. Where a gradient is wanted, through
    FlashSelfAttention (the forward then also writes m and l)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashSelfAttention.apply(q, k, v, lengths, scale)
    return _flash_forward(q, k, v, lengths, scale)
