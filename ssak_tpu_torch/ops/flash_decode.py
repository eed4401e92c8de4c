"""Fused single-query decode attention (kernel K4, flash-decode).

Counterpart of ssak_tpu.ops.flash_decode.flash_decode_attention. Each
Whisper token step runs 64 attention sites (32 self, 32 cross); the kernel
does one whole site — dot, range mask, softmax, PV product, normalize — in
one launch that reads K and V once, in bf16 or as int8 with per-position
scales (the int8 KV-cache format of models.layers). The CUDA kernel is
`csrc/flash_decode.cu`; `flash_decode_reference` is the plain PyTorch
version of the same function, used for CPU tensors and by the on-card
comparison.
"""

import ctypes

import torch

from ssak_tpu_torch.ops import _build

LAUNCHES = {"flash_decode_bf16": 0, "flash_decode_int8": 0}  # counted by the wrapper
MAX_T = 12288  # logits of one site are kept in shared memory (4*T bytes)
MAX_DH = 256
_NEG = -1e30
_fns = {}


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
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        else:
            fn = lib.ssak_flash_decode_bf16
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[variant] = fn
    return _fns[variant]


def flash_decode_attention(q, kT, vT, lo, hi, k_scales=None, v_scales=None):
    """Single-query attention over [lo, hi] per row. See
    flash_decode_reference for shapes. CPU tensors take the plain version;
    CUDA tensors launch the kernel (contiguous q bf16, K/V bf16 or int8,
    scales bf16, T <= MAX_T) or raise."""
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
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=q.device)
    stream = _build.stream_ptr(q.device)
    if quant:
        rc = _kernel("int8")(q.data_ptr(), kT.data_ptr(), k_scales.data_ptr(), vT.data_ptr(), v_scales.data_ptr(),
                             lo.data_ptr(), hi.data_ptr(), out.data_ptr(), B, H, Dh, T, stream)
        name = "flash_decode_int8"
    else:
        rc = _kernel("bf16")(q.data_ptr(), kT.data_ptr(), vT.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                             out.data_ptr(), B, H, Dh, T, stream)
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
