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
(dK/dV and dQ, from q, k, v, dO, m, l and di = sum_d o * dO).
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


def _kernel(name):
    if name not in _fns:
        if name == "fwd":
            fn = _build.library("flash_attention").ssak_flash_attention_fwd
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
                           + [ctypes.c_float, ctypes.c_void_p])
        else:
            lib = _build.library("flash_attention_bwd")
            fn = lib.ssak_flash_attention_bwd_dkv if name == "dkv" else lib.ssak_flash_attention_bwd_dq
            n_out = 2 if name == "dkv" else 1
            fn.argtypes = ([ctypes.c_void_p] * (8 + n_out) + [ctypes.c_int] * 4
                           + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p])
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


def _flash_forward(q, k, v, lengths, scale, stats=False):
    """o, or with stats (o, m, l) for the backward."""
    if _check("flash_self_attention", (q, k, v), lengths) == "cpu":
        return flash_self_attention_reference(q, k, v, lengths, scale, return_stats=stats)
    _check_cuda("flash_self_attention", (q, k, v))
    B, T, H, Dh = q.shape
    scale = Dh**-0.5 if scale is None else scale
    q, k, v = (_kernel_operand(a) for a in (q, k, v))
    lens = _kernel_lengths(lengths, B, T, q.device)
    out = torch.empty((B, T, H, Dh), dtype=torch.bfloat16, device=q.device)
    m = l = None
    if stats:
        m, l = (torch.empty((B, H, T), dtype=torch.float32, device=q.device) for _ in range(2))
    rc = _kernel("fwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(lens), out.data_ptr(), _ptr(m), _ptr(l),
                        B, T, H, Dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
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


def _launch_bwd(name, q, k, v, do, m, l, di, lengths, scale, outs):
    B, T, H, Dh = q.shape
    q, k, v, do = (_kernel_operand(a) for a in (q, k, v, do))
    m, l, di = (a.contiguous() for a in (m, l, di))
    lens = _kernel_lengths(lengths, B, T, q.device)
    strides = (ctypes.c_longlong * 12)(*(s for a in (q, k, v, do) for s in a.stride()[:3]))
    rc = _kernel(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
                       di.data_ptr(), _ptr(lens), *(o.data_ptr() for o in outs), B, T, H, Dh, strides, float(scale),
                       _build.stream_ptr(q.device))
    _build.check(rc, f"flash_attention_bwd_{name}")
    LAUNCHES[f"flash_attention_bwd_{name}"] += 1


def _backward_entry(what, q, k, v, do, m, l, di, lengths, scale):
    device = _check(what, (q, k, v, do), lengths)
    _check_stats(what, q, (m, l, di))
    if device == "cuda":
        _check_cuda(what, (q, k, v, do))
    return device, (q.shape[-1] ** -0.5 if scale is None else scale)


def flash_attention_bwd_dkv(q, k, v, do, m, l, di, lengths=None, scale=None):
    """dK and dV (B, T, H, Dh) bf16 from the forward's q/k/v, the output
    gradient dO, m, l and di (f32 (B, H, T)). CUDA tensors launch the dK/dV
    kernel or raise; CPU tensors take its plain version."""
    device, scale = _backward_entry("flash_attention_bwd_dkv", q, k, v, do, m, l, di, lengths, scale)
    if device == "cpu":
        return tuple(_backward_plain(q, k, v, do, m, l, di, lengths, scale, ("dk", "dv")))
    dk, dv = (torch.empty(q.shape, dtype=torch.bfloat16, device=q.device) for _ in range(2))
    _launch_bwd("dkv", q, k, v, do, m, l, di, lengths, scale, (dk, dv))
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, m, l, di, lengths=None, scale=None):
    """dQ (B, T, H, Dh) bf16, from the same inputs as flash_attention_bwd_dkv.
    CUDA tensors launch the dQ kernel or raise; CPU tensors take its plain
    version."""
    device, scale = _backward_entry("flash_attention_bwd_dq", q, k, v, do, m, l, di, lengths, scale)
    if device == "cpu":
        return _backward_plain(q, k, v, do, m, l, di, lengths, scale, ("dq",))[0]
    dq = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    _launch_bwd("dq", q, k, v, do, m, l, di, lengths, scale, (dq,))
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
