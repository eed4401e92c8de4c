"""Fused int8-weight dequantize-matmul (kernel K2) for the decode loop.

Counterpart of ssak_tpu.ops.int8_matmul.matmul_int8. Decode re-reads every
decoder weight each token step; with weight-only int8 (models.quant) the
kernel streams the int8 bytes and widens them on chip, so the weight
traffic is one byte per parameter. The CUDA kernel is
`csrc/int8_matmul.cu` (its header says what bounds it and how it is laid
out); `matmul_int8_reference` is the plain PyTorch version of the same
function, used for CPU tensors and by the on-card comparison.
"""

import ctypes

import torch

from ssak_tpu_torch.ops import _build

LAUNCHES = {"matmul_int8": 0}  # kernel launches, counted by the wrapper
MAX_M = 64
_fn = None


def matmul_int8_reference(x, q8, scale):
    """Plain version of the Pallas body: (bf16(x) @ bf16(q8)) with f32
    accumulation, times the per-column scale. x (M, K), q8 (K, N) int8,
    scale (1, N) or (N,) f32 -> (M, N) f32. bf16 values and their products
    are exact in f32, so this is the kernel's function up to sum order."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    wb = q8.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, wb) * scale.to(torch.float32).reshape(1, -1)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("int8_matmul").ssak_int8_matmul
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def matmul_int8(x, q8, scale):
    """x: (M, K) float, q8: (K, N) int8, scale: (1, N) f32 -> (M, N) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (1 <= M <= 64, K and N multiples of 8, q8/scale contiguous) or raise."""
    if x.ndim != 2 or q8.ndim != 2 or x.shape[1] != q8.shape[0]:
        raise ValueError(f"matmul_int8: bad shapes x={tuple(x.shape)} q8={tuple(q8.shape)}")
    M, K = x.shape
    N = q8.shape[1]
    if scale.numel() != N:
        raise ValueError(f"matmul_int8: scale has {scale.numel()} values for N={N}")
    if q8.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"matmul_int8: q8 must be int8 and scale f32, got {q8.dtype}, {scale.dtype}")
    devices = {x.device, q8.device, scale.device}
    if len(devices) != 1:
        raise ValueError(f"matmul_int8: tensors on different devices {devices}")
    if x.device.type == "cpu":
        return matmul_int8_reference(x, q8, scale)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int8: unsupported device {x.device}")
    if not 1 <= M <= MAX_M or K % 8 or N % 8:
        raise ValueError(f"matmul_int8: kernel takes 1<=M<={MAX_M}, K%8==0, N%8==0; got M={M} K={K} N={N}")
    if not (q8.is_contiguous() and scale.is_contiguous()):
        raise ValueError("matmul_int8: q8 and scale must be contiguous")
    if q8.data_ptr() % 8 or scale.data_ptr() % 16:
        raise ValueError("matmul_int8: q8 must be 8-byte and scale 16-byte aligned")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # the kernel reads x in 16-byte words
        xb = xb.clone()
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = _kernel()(xb.data_ptr(), q8.data_ptr(), scale.data_ptr(), y.data_ptr(), M, K, N,
                   _build.stream_ptr(x.device))
    _build.check(rc, "matmul_int8")
    LAUNCHES["matmul_int8"] += 1
    return y


def int8_dense_supported(x, q8) -> bool:
    """Route a quantized dense through the kernel: CUDA tensors,
    decode-shaped activations (one token per sequence, at most 64 rows)
    over lane-aligned contractions. On the CPU, dense takes the dequantize
    path, as ssak_tpu does off the TPU."""
    if not x.is_cuda:
        return False
    K, N = q8.shape
    if K % 128 or N % 128:
        return False
    if x.ndim == 2:
        return x.shape[0] <= MAX_M
    return x.ndim == 3 and x.shape[1] == 1 and x.shape[0] <= MAX_M
