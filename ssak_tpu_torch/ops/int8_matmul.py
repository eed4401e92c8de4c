"""Fused dequantize-matmuls for the decode loop: int8 weights (kernel K2)
and packed int4 weights (kernel K3).

Counterpart of ssak_tpu.ops.int8_matmul (matmul_int8, matmul_int4,
int8_dense_supported, int4_dense_supported). Decode re-reads every decoder
weight each token step; with weight-only quantization (models.quant) the
kernels stream the quantized bytes and widen them on chip, so the weight
traffic is one byte (int8) or half a byte (int4) per parameter. The CUDA
kernels are `csrc/int8_matmul.cu` and `csrc/int4_matmul.cu` (their headers
say what bounds them and how they are laid out); `matmul_int8_reference`
and `matmul_int4_reference` are the plain PyTorch versions of the same
functions, used for CPU tensors and by the on-card comparison.
"""

import ctypes
import functools

import torch

from ssak_tpu_torch.ops import _build

LAUNCHES = {"matmul_int8": 0, "matmul_int4": 0}  # kernel launches, counted by the wrappers
MAX_M = 64
INT4_SUB = 32  # packed int4 rows per scale block (models.quant INT4_BLOCK // 2)
_fns = {}


def matmul_int8_reference(x, q8, scale):
    """Plain version of the Pallas body: (bf16(x) @ bf16(q8)) with f32
    accumulation, times the per-column scale. x (M, K), q8 (K, N) int8,
    scale (1, N) or (N,) f32 -> (M, N) f32. bf16 values and their products
    are exact in f32, so this is the kernel's function up to sum order."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    wb = q8.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, wb) * scale.to(torch.float32).reshape(1, -1)


def _kernel(name):
    if name not in _fns:
        if name == "int8":
            fn = _build.library("int8_matmul").ssak_int8_matmul
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        else:
            fn = _build.library("int4_matmul").ssak_int4_matmul
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


INT8_BN = 64  # output columns per block (csrc/int8_matmul.cu)
INT8_KSTEP = 128  # k rows per ring stage; every K slice is a run of whole stages
INT8_MAX_SPLITS = 8  # the slices of a column tile form one cluster: the portable size
INT8_MIN_BLOCKS = 132  # one block per SM of the H100
# at most ~1.2 blocks an SM where that reaches INT8_MIN_BLOCKS: a cluster's
# blocks share a GPC and pack unevenly there, so a larger grid can spill into
# a second wave
INT8_MAX_BLOCKS = 160


def int8_slices(K: int, splits: int) -> list:
    """The K rows [lo, hi) of each slice, as the kernel cuts them: slice r
    takes stages [r*T // splits, (r+1)*T // splits) of the T = ceil(K /
    INT8_KSTEP), the last one ending at K."""
    T = -(-K // INT8_KSTEP)
    return [(r * T // splits * INT8_KSTEP, min(K, (r + 1) * T // splits * INT8_KSTEP)) for r in range(splits)]


@functools.lru_cache(maxsize=None)
def int8_plan(M: int, K: int, N: int) -> tuple:
    """(block_n, splits, k_per_split): the kernel's grid, column tiles of
    block_n times `splits` K slices (int8_slices: whole stages of
    INT8_KSTEP rows, every slice non-empty), at most INT8_MAX_SPLITS;
    k_per_split is the longest slice, which sizes the block's ring. The
    most splits within INT8_MAX_BLOCKS blocks (the shortest slices, so that
    a block's whole slice fits its ring and every load is in flight at
    once); if those leave SMs idle, the fewest that fill them
    (INT8_MIN_BLOCKS). The tiling does not depend on M (the weight bytes
    bound the kernel), which is only checked. The kernel takes the plan as
    given."""
    if not 1 <= M <= MAX_M or K < 1 or N < 1 or K % 8 or N % 8:
        raise ValueError(f"int8_plan: kernel takes 1<=M<={MAX_M}, K%8==0, N%8==0; got M={M} K={K} N={N}")
    T = -(-K // INT8_KSTEP)
    tiles = -(-N // INT8_BN)
    cap = min(INT8_MAX_SPLITS, T)
    splits = max(1, min(cap, INT8_MAX_BLOCKS // tiles))
    if tiles * splits < INT8_MIN_BLOCKS:
        splits = min(cap, -(-INT8_MIN_BLOCKS // tiles))
    return INT8_BN, splits, -(-T // splits) * INT8_KSTEP


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
    block_n, splits, per = int8_plan(M, K, N)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = _kernel("int8")(xb.data_ptr(), q8.data_ptr(), scale.data_ptr(), y.data_ptr(), M, K, N,
                         block_n, splits, per, _build.stream_ptr(x.device))
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


# --- int4: fused unpack-dequantize-matmul (K3) --------------------------------

INT4_BN = 64  # output columns per block (csrc/int4_matmul.cu)
INT4_KSTEP = 128  # weight rows per ring stage: two whole scale blocks; every K slice is a run of whole stages


def matmul_int4_reference(x, q4, scale):
    """Plain version of the Pallas body as the TPU runs it (cdt = bf16):
    each weight is its nibble times its block scale in f32, rounded to
    bf16; x is rounded to bf16; the products (exact in f32) are summed in
    f32. x (M, K), q4 (K/2, N) packed int4, scale (K/64, N) or (K/64, 1, N)
    f32 -> (M, N) f32."""
    from ssak_tpu_torch.models.quant import dequantize_int4

    xb = x.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, dequantize_int4(q4, scale, torch.bfloat16).to(torch.float32))


@functools.lru_cache(maxsize=None)
def int4_slices(K: int, splits: int) -> tuple:
    """The weight rows [lo, hi) of each slice, as the kernel cuts them:
    slice r takes stages [r*T // splits, (r+1)*T // splits) of the T =
    ceil(K / INT4_KSTEP), the last one ending at K. A stage holds whole
    scale blocks, so no scale block straddles two slices."""
    T = -(-K // INT4_KSTEP)
    return tuple((r * T // splits * INT4_KSTEP, min(K, (r + 1) * T // splits * INT4_KSTEP)) for r in range(splits))


@functools.lru_cache(maxsize=None)
def int4_plan(M: int, K: int, N: int) -> tuple:
    """(block_n, splits, k_per_split): the kernel's grid, column tiles of
    block_n times `splits` slices of the K weight rows (int4_slices: whole
    stages of INT4_KSTEP rows, every slice non-empty); k_per_split is the
    longest slice, which sizes the block's ring. A block walks its slice
    stage after stage, so the plan takes the shortest longest slice that a
    grid of at most INT8_MAX_BLOCKS blocks and clusters of at most
    INT8_MAX_SPLITS allow, and of those the fewest splits (fewer blocks
    than SMs then leaves none with two, and the cluster's sum is cheaper).
    The tiling does not depend on M (the weight bytes bound the kernel),
    which is only checked. The kernel takes the plan as given."""
    if not 1 <= M <= MAX_M or K < 2 * INT4_SUB or N < 8 or K % (2 * INT4_SUB) or N % 8:
        raise ValueError(f"int4_plan: kernel takes 1<=M<={MAX_M}, K%{2 * INT4_SUB}==0, N%8==0; "
                         f"got M={M} K={K} N={N}")
    T = -(-K // INT4_KSTEP)
    cap = max(1, min(INT8_MAX_SPLITS, T, INT8_MAX_BLOCKS // -(-N // INT4_BN)))
    splits = min(range(1, cap + 1), key=lambda s: (-(-T // s), s))
    return INT4_BN, splits, -(-T // splits) * INT4_KSTEP


def matmul_int4(x, q4, scale):
    """x: (M, K) float, q4: (K/2, N) int8 packed nibbles (models.quant
    layout), scale: (K/64, 1, N) or (K/64, N) f32 -> (M, N) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (1 <= M <= 64, K/2 == 32 * (K/64) scale blocks, N a multiple of 8,
    q4/scale contiguous) or raise."""
    if x.ndim != 2 or q4.ndim != 2 or x.shape[1] != 2 * q4.shape[0]:
        raise ValueError(f"matmul_int4: bad shapes x={tuple(x.shape)} q4={tuple(q4.shape)}")
    M, K = x.shape
    K2, N = q4.shape
    if scale.ndim not in (2, 3) or scale.shape[-1] != N or (scale.ndim == 3 and scale.shape[1] != 1):
        raise ValueError(f"matmul_int4: scale must be (nb, N) or (nb, 1, N) with N={N}, got {tuple(scale.shape)}")
    nb = scale.shape[0]
    if K2 % nb:
        raise ValueError(f"matmul_int4: {nb} scale blocks do not divide {K2} packed rows")
    if q4.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"matmul_int4: q4 must be int8 and scale f32, got {q4.dtype}, {scale.dtype}")
    devices = {x.device, q4.device, scale.device}
    if len(devices) != 1:
        raise ValueError(f"matmul_int4: tensors on different devices {devices}")
    if x.device.type == "cpu":
        return matmul_int4_reference(x, q4, scale)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int4: unsupported device {x.device}")
    if not 1 <= M <= MAX_M or K2 != INT4_SUB * nb or N % 8:
        raise ValueError(f"matmul_int4: kernel takes 1<=M<={MAX_M}, K/2 == {INT4_SUB}*nb, N%8==0; "
                         f"got M={M} K={K} N={N} nb={nb}")
    if not (q4.is_contiguous() and scale.is_contiguous()):
        raise ValueError("matmul_int4: q4 and scale must be contiguous")
    if q4.data_ptr() % 8 or scale.data_ptr() % 16:
        raise ValueError("matmul_int4: q4 must be 8-byte and scale 16-byte aligned")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # the kernel reads x in 16-byte words
        xb = xb.clone()
    block_n, splits, per = int4_plan(M, K, N)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = _kernel("int4")(xb.data_ptr(), q4.data_ptr(), scale.data_ptr(), y.data_ptr(), M, K, N,
                         block_n, splits, per, _build.stream_ptr(x.device))
    _build.check(rc, "matmul_int4")
    LAUNCHES["matmul_int4"] += 1
    return y


def int4_dense_supported(x, q4, scale) -> bool:
    """Route an int4 dense through the kernel: CUDA tensors, decode-shaped
    activations (one token per sequence, at most 64 rows), lane-aligned
    contractions (K/2 and N multiples of 128) and one scale block per 32
    packed rows (K/2 == 32 * nb). On the CPU, dense takes the dequantize
    path, as ssak_tpu does off the TPU."""
    if not x.is_cuda:
        return False
    K2, N = q4.shape
    if K2 % 128 or N % 128 or K2 != INT4_SUB * scale.shape[0]:
        return False
    if x.ndim == 2:
        return x.shape[0] <= MAX_M
    return x.ndim == 3 and x.shape[1] == 1 and x.shape[0] <= MAX_M
