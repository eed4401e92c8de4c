"""Segment-masked flash self-attention, forward (kernel L1).

Counterpart of ssak_tpu.models.layers.flash_self_attention, which calls
JAX's library Pallas flash attention (`_flash_attention_impl`) on the TPU.
q/k/v (B, T, H, Dh) bf16; T is padded to Tp = ceil(T / 128) * 128 with zero
q/k/v; frames below a row's length form segment 1 and the rest segment 0,
and a query sees exactly the keys of its own segment (a pad query attends
over every pad key of [length, Tp), the zero keys included). Without
lengths and with T % 128 == 0 there is no mask. The CUDA kernel is
`csrc/flash_attention.cu`; `flash_self_attention_reference` is the plain
PyTorch version of the same function (the masked softmax over Tp in f32,
p rounded to bf16 before the P.V product), used for CPU tensors and by the
on-card comparison.

Only the forward is ported: the autograd Function's backward raises (the
two backward Pallas calls come with long-utterance training, ROADMAP.md).
"""

import ctypes

import torch

from ssak_tpu_torch.ops import _build

LAUNCHES = {"flash_attention": 0}  # counted by the wrapper
HEAD_DIMS = (64, 128, 256)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the library kernel's DEFAULT_MASK_VALUE
_fns = {}


def padded_len(T: int) -> int:
    return -(-T // 128) * 128


def flash_self_attention_reference(q, k, v, lengths=None, scale=None):
    """Plain version: q/k/v (B, T, H, Dh), lengths (B,) or None -> (B, T,
    H, Dh) bf16. Logits are exact f32 products of the bf16 values, scaled,
    plus the mask value across segments; p = exp(s - max) rounded to bf16
    for P.V, the row sum taken over the f32 p."""
    B, T, H, Dh = q.shape
    scale = Dh**-0.5 if scale is None else scale
    Tp = padded_len(T)
    f32, bf16 = torch.float32, torch.bfloat16
    qf, kf, vf = (torch.nn.functional.pad(a.to(bf16).to(f32), (0, 0, 0, 0, 0, Tp - T)) for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if lengths is not None or Tp != T:
        lens = torch.full((B,), T, device=q.device) if lengths is None else lengths.to(q.device)
        seg = torch.arange(Tp, device=q.device)[None, :] < lens.reshape(B, 1)  # (B, Tp)
        s = s + torch.where(seg[:, None, :, None] == seg[:, None, None, :], 0.0, MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).permute(0, 2, 1)[..., None]  # (B, Tp, H, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(bf16).to(f32), vf) / l
    return o[:, :T].to(bf16)


def _kernel():
    if "fwd" not in _fns:
        fn = _build.library("flash_attention").ssak_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_float,
                                                                                             ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["fwd"] = fn
    return _fns["fwd"]


def _kernel_operand(x):
    """x itself when the kernel can read it through its strides (a
    contiguous, 16-byte aligned Dh row per (b, t, h)), else a contiguous copy."""
    if x.stride(3) == 1 and all(s % 8 == 0 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


def _flash_forward(q, k, v, lengths, scale):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_self_attention: q/k/v must share a (B, T, H, Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, Dh = q.shape
    if lengths is not None and lengths.numel() != B:
        raise ValueError(f"flash_self_attention: lengths must have one entry per row, got {tuple(lengths.shape)}")
    devices = {a.device for a in (q, k, v)} | ({lengths.device} if lengths is not None else set())
    if len(devices) != 1:
        raise ValueError(f"flash_self_attention: tensors on different devices {devices}")
    if q.device.type == "cpu":
        return flash_self_attention_reference(q, k, v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_self_attention: unsupported device {q.device}")
    if not all(a.dtype == torch.bfloat16 for a in (q, k, v)):
        raise TypeError(f"flash_self_attention: q/k/v must be bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_self_attention: the kernel takes Dh in {HEAD_DIMS}, got {Dh}")
    if H > 65535 or B > 65535:
        raise ValueError(f"flash_self_attention: the kernel's grid takes B, H <= 65535, got B={B}, H={H}")
    scale = Dh**-0.5 if scale is None else scale
    q, k, v = (_kernel_operand(a) for a in (q, k, v))
    if lengths is None and T % 128:
        lengths = torch.full((B,), T, dtype=torch.int32, device=q.device)
    lens = None if lengths is None else lengths.to(torch.int32).contiguous()
    out = torch.empty((B, T, H, Dh), dtype=torch.bfloat16, device=q.device)
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if lens is None else lens.data_ptr(),
                   out.data_ptr(), B, T, H, Dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
                   _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


class FlashSelfAttention(torch.autograd.Function):
    """L1's forward under autograd. The backward (the library's dK/dV and dQ
    Pallas calls) is not ported yet: training at T >= FLASH_MIN_SEQ keeps the
    unfused attention (models.layers._can_flash)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale):
        return _flash_forward(q, k, v, lengths, scale)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError("flash_self_attention's backward (L1 bwd) is not ported yet "
                                  "(comes with long-utterance training, ROADMAP.md)")


def flash_self_attention(q, k, v, lengths=None, scale=None):
    """Segment-masked self-attention, q/k/v (B, T, H, Dh) bf16, lengths
    (B,) valid frames or None, scale default Dh**-0.5 -> (B, T, H, Dh) bf16.
    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16,
    Dh in HEAD_DIMS) or raise."""
    return FlashSelfAttention.apply(q, k, v, lengths, scale)
