"""Shared layers in PyTorch (counterpart of ssak_tpu.models.layers): the
subset on the Whisper serving and fine-tuning and the wav2vec2- and
Conformer-CTC training and serving paths.

Parameters live in small `nn.Module`s (Linear, QuantLinear, LayerNorm,
Conv1d, MultiHeadAttention, MLP); the layer math is plain functions on
tensors that follow the JAX functions step by step, dtype casts included.
Conventions kept from ssak_tpu so the tests compare like with like:
activations (B, T, D), heads (B, T, H, Dh), decode caches (B, H, Dh, T)
with time minor, and "a product in `dtype` with f32 accumulation".

How that product is formed here: attention products cast the
`dtype`-rounded operands to f32 and multiply in f32 — bf16 values and
their products are exact in f32, so this is JAX's
`preferred_element_type=f32` exactly, up to the order of the sums. Dense
layers (and Whisper's logits) go through `matmul_f32`: on a CUDA tensor
one bf16 GEMM with an f32 result (`torch.mm(..., out_dtype=float32)`, the
tensor cores' own f32 accumulator), on the CPU the same widening as
attention. Either way the product is never rounded to `dtype`; the LoRA
term and the bias are added to the f32 result, which is rounded once, as
JAX rounds it.

Parameters are created frozen (`requires_grad=False`), so serving builds no
autograd graph; training turns them on for its model alone
(`module.requires_grad_(True)`, train.steps.init_train_state).
"""

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ssak_tpu_torch.ops.flash_attention import HEAD_DIMS as _FLASH_HEAD_DIMS
from ssak_tpu_torch.ops.flash_attention import flash_self_attention
from ssak_tpu_torch.ops.flash_decode import flash_decode_attention, flash_decode_supported
from ssak_tpu_torch.ops.int8_matmul import int4_dense_supported, int8_dense_supported, matmul_int4, matmul_int8
from ssak_tpu_torch.parallel.collectives import all_gather, all_reduce, copy_to_region

_NEG = -1e30


# --- parameter containers ---------------------------------------------------


def _param(t):
    return nn.Parameter(t, requires_grad=False)


class _Dense(nn.Module):
    """A dense layer's optional LoRA adapter (models.lora): parameters
    lora_A (in, r) and lora_B (r, out) in ssak_tpu's layout and names, and
    the buffer lora_scale (alpha / r, f32), so that named_parameters() reads
    like ssak_tpu's paths ('decoder.blocks.0.attn.query.lora_A' for
    '/decoder/blocks/0/attn/query/lora_A'). `tp`: the layer's tensor
    parallelism (parallel.mesh.TensorParallel) once shard_params cut it,
    else None."""

    def __init__(self):
        super().__init__()
        self.tp = None
        self.register_parameter("lora_A", None)
        self.register_parameter("lora_B", None)
        self.register_buffer("lora_scale", None)

    def set_lora(self, a, b, scale):
        """Attach (or replace) the adapter, frozen like every parameter."""
        self.lora_A, self.lora_B = _param(a), _param(b)
        self.register_buffer("lora_scale", torch.as_tensor(scale, dtype=torch.float32, device=a.device))


class Linear(_Dense):
    """Dense layer in torch layout: weight (out, in), optional bias (out,)."""

    def __init__(self, weight, bias=None):
        super().__init__()
        self.weight = _param(weight)
        self.bias = None if bias is None else _param(bias)


class QuantLinear(_Dense):
    """Weight-only quantized dense layer in ssak_tpu's layout (the kernels
    read the payload along out), optional float bias (out,). int8: buffers
    q8 int8 (in, out) and scale f32 (1, out); int4: q4 int8 (in/2, out) of
    packed nibbles and scale f32 (nb, 1, out). The scale's rank picks the
    kind (models.quant)."""

    def __init__(self, q, scale, bias=None):
        super().__init__()
        self.bits = 4 if scale.ndim == 3 else 8
        self.register_buffer("q4" if self.bits == 4 else "q8", q)
        self.register_buffer("scale", scale)
        self.bias = None if bias is None else _param(bias)

    @property
    def payload(self):
        return self.q4 if self.bits == 4 else self.q8


class LayerNorm(nn.Module):
    def __init__(self, scale, bias):
        super().__init__()
        self.scale = _param(scale)
        self.bias = _param(bias)


class Conv1d(nn.Module):
    """weight in torch layout (Cout, Cin/groups, K), optional bias."""

    def __init__(self, weight, bias=None):
        super().__init__()
        self.weight = _param(weight)
        self.bias = None if bias is None else _param(bias)


class MultiHeadAttention(nn.Module):
    """query/key/value/out projections; fuse_qkv_params replaces the first
    three by one `qkv`. tp_size: the ranks its heads are split over
    (parallel.mesh.shard_params), each rank holding n_heads / tp_size."""

    def __init__(self, out, query, key, value):
        super().__init__()
        self.tp_size = 1
        self.out = out
        self.query, self.key, self.value = query, key, value


class MLP(nn.Module):
    def __init__(self, fc1, fc2):
        super().__init__()
        self.fc1, self.fc2 = fc1, fc2


# --- functions ----------------------------------------------------------------


def _round_scalar(v: float, dtype) -> float:
    """The Python float `v` rounded to `dtype` (JAX's jnp.asarray(v, dtype))."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


def _f32(x, dtype):
    """x rounded to `dtype`, then widened to f32 for an exact f32 product."""
    return x.to(dtype).to(torch.float32)


def layer_norm(x, p, eps: float = 1e-5):
    """Statistics and affine in f32, output in the input dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(x.dtype)


def group_norm(x, p, num_groups: int, eps: float = 1e-5):
    """x: (B, T, C). GroupNorm with torch semantics: statistics over each
    channel group and the time axis, in f32; output in the input dtype."""
    B, T, C = x.shape
    g = x.reshape(B, T, num_groups, C // num_groups).to(torch.float32)
    mu = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
    g = (g - mu) * torch.rsqrt(var + eps)
    return (g.reshape(x.shape) * p.scale + p.bias).to(x.dtype)


_HALF = (torch.bfloat16, torch.float16)


def _mm_f32(x, w):
    """(M, K) @ (K, N) of two bf16 or f16 matrices -> f32 (M, N): one GEMM
    with an f32 result on the card, the operands widened to f32 on the
    CPU."""
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return torch.mm(x.to(torch.float32), w.to(torch.float32))


class _HalfMatmul(torch.autograd.Function):
    """`_mm_f32` with a backward (torch has no derivative for mm's out_dtype
    overload). The gradients are the products torch.matmul's backward
    forms in the operands' dtype: the f32 cotangent rounded to that dtype,
    then gx = g wᵀ and gw = xᵀ g."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.t() if ctx.needs_input_grad[0] else None
        gw = x.t() @ g if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x, w):
    """x (..., K) @ w (K, N) -> f32 (..., N), JAX's
    `jnp.matmul(x, w, preferred_element_type=float32)`: for bf16 or f16
    operands (both of one dtype) the exact products summed in f32 and
    never rounded to that dtype; f32 operands multiply as they are."""
    if x.dtype not in _HALF:
        return torch.matmul(x, w)
    return _HalfMatmul.apply(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])


def _add_rounded(y, bias, dtype):
    """(y + bias) rounded once to `dtype`, both f32: one pass that writes
    `dtype` when nothing needs a gradient (torch.add computes in f32 and
    rounds on the store), else the sum and then the cast."""
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        return (y + bias).to(dtype)
    out = torch.empty(y.shape, dtype=dtype, device=y.device)
    return torch.add(y, bias, out=out)


def dense(x, p, dtype=None):
    """Linear or QuantLinear layer. With `dtype` the operands are rounded
    to that dtype and the result returned in it; the product is f32
    (`matmul_f32`), the LoRA term and then the bias are added to it, and
    the sum is rounded once, as ssak_tpu's dense does. Tensor-parallel
    (p.tp): a row-parallel layer all-reduces its f32 partial product before
    the bias and the one rounding (where XLA's sharded dot reduces); a
    column-parallel one keeps its output slice, or all-gathers it ('gather').
    A QuantLinear on a
    decode-shaped CUDA activation goes through its fused kernel (K2 for
    int8, K3 for int4, f32 out); elsewhere its weight is dequantized to
    `dtype` first, as ssak_tpu does off the TPU. A LoRA adapter adds
    lora_scale * (x A) B with A and B rounded to x's dtype and both
    products in f32 (exact for bf16 operands, as JAX's
    preferred_element_type=f32)."""
    y = None
    tp = p.tp
    if tp is not None and tp.mode != "row":
        x = copy_to_region(x, tp.group)
    if isinstance(p, QuantLinear):
        kernel = None
        if p.bits == 8 and int8_dense_supported(x, p.q8):
            kernel = matmul_int8
        elif p.bits == 4 and int4_dense_supported(x, p.q4, p.scale):
            kernel = matmul_int4
        if kernel is not None:
            if dtype is not None:
                x = x.to(dtype)
            y = kernel(x.reshape(-1, x.shape[-1]), p.payload, p.scale).reshape(*x.shape[:-1], -1)
        else:
            from ssak_tpu_torch.models.quant import dequantize_kernel

            w = dequantize_kernel(p, dtype if dtype is not None else x.dtype)
    else:
        w = p.weight.t()
    if y is None:
        dt = dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)
        x = x.to(dt)
        y = matmul_f32(x, w.to(dt))
    out_dtype = x.dtype
    if p.lora_A is not None:
        xa = torch.matmul(_f32(x, out_dtype), _f32(p.lora_A, out_dtype))
        y = y + p.lora_scale * torch.matmul(xa, _f32(p.lora_B, out_dtype))
    if tp is not None and tp.mode == "row":
        y = all_reduce(y, tp.group)
    out = _add_rounded(y, p.bias, out_dtype) if p.bias is not None else y.to(out_dtype)
    if tp is not None and tp.mode == "gather":
        out = all_gather(out, -1, tp.group, replicated=True)
    return out


def gelu(x):
    return F.gelu(x, approximate="none")


@functools.lru_cache(maxsize=8)
def sinusoid_position_embedding(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper-style sinusoids (length, channels): [sin | cos] halves.
    The cached array is shared: do not modify it."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


def split_heads(x, n_heads: int):
    B, T, D = x.shape
    return x.reshape(B, T, n_heads, D // n_heads)


def merge_heads(x):
    B, T, H, Dh = x.shape
    return x.reshape(B, T, H * Dh)


def attention(q, k, v, mask=None, dtype=torch.bfloat16, scale=None):
    """q: (B, Tq, H, Dh), k/v: (B, Tk, H, Dh). mask broadcastable to
    (B, H, Tq, Tk), True = attend. Softmax in f32."""
    Dh = q.shape[-1]
    scale = scale if scale is not None else Dh**-0.5
    qh = q.to(dtype) * _round_scalar(scale, dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", _f32(qh, dtype), _f32(k, dtype))
    if mask is not None:
        logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", _f32(probs, dtype), _f32(v, dtype))
    return out.to(dtype)


def decode_attention(q, kT, vT, mask=None, dtype=torch.bfloat16, scale=None):
    """Attention against decode-cache-layout K/V. q: (B, Tq, H, Dh);
    kT/vT: (B, H, Dh, Tk); mask broadcastable to (B, H, Tq, Tk)."""
    Dh = q.shape[-1]
    scale = scale if scale is not None else Dh**-0.5
    qh = q.to(dtype) * _round_scalar(scale, dtype)
    logits = torch.einsum("bqhd,bhdt->bhqt", _f32(qh, dtype), _f32(kT, dtype))
    if mask is not None:
        logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqt,bhdt->bqhd", _f32(probs, dtype), _f32(vT, dtype))
    return out.to(dtype)


def to_decode_kv(x, n_heads: int):
    """(B, T, D) merged K or V -> (B, H, Dh, T) decode-cache layout (a view)."""
    return split_heads(x, n_heads).permute(0, 2, 3, 1)


def _quant_per_position(x):
    """(B, H, Dh, T) -> int8 values + per-(b, h, t) bf16 scales (B, H, 1, T)."""
    xf = x.to(torch.float32)
    s = torch.clamp(torch.amax(torch.abs(xf), dim=2, keepdim=True), min=1e-8) / 127.0
    x8 = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return x8.contiguous(), s.to(torch.bfloat16).contiguous()


def quantize_decode_kv(kT, vT):
    """Decode-layout K/V -> the int8 dict with per-position scales
    ({"k8", "ks", "v8", "vs"}), the one int8 KV format."""
    k8, ks = _quant_per_position(kT)
    v8, vs = _quant_per_position(vT)
    return {"k8": k8, "ks": ks, "v8": v8, "vs": vs}


def init_int8_cache(batch: int, n_heads: int, head_dim: int, length: int, device=None):
    """Empty int8 self-attention decode cache with per-position scales."""
    return {
        "k8": torch.zeros((batch, n_heads, head_dim, length), dtype=torch.int8, device=device),
        "ks": torch.zeros((batch, n_heads, 1, length), dtype=torch.bfloat16, device=device),
        "v8": torch.zeros((batch, n_heads, head_dim, length), dtype=torch.int8, device=device),
        "vs": torch.zeros((batch, n_heads, 1, length), dtype=torch.bfloat16, device=device),
    }


def update_int8_cache(cache, kT_new, vT_new, index: int):
    """Quantize this step's k/v (B, H, Dh, Tnew) per position and write
    values and scales at time `index`. Unlike ssak_tpu (pure functions),
    the port writes into the preallocated cache IN PLACE and returns it."""
    k8n, ksn = _quant_per_position(kT_new)
    v8n, vsn = _quant_per_position(vT_new)
    n = k8n.shape[-1]
    for key, val in (("k8", k8n), ("ks", ksn), ("v8", v8n), ("vs", vsn)):
        cache[key][..., index : index + n].copy_(val)
    return cache


def self_attention_int8(q, cache, mask=None, dtype=torch.bfloat16, scale=None):
    """Decode attention over an int8 cache with per-position scales, q and
    probabilities quantized to int8 as in ssak_tpu. PyTorch has no int8
    einsum on CPU or CUDA: the integer products run in f64 on the integer
    values, which is exact (|sums| < 2**53)."""
    Dh = q.shape[-1]
    scale = scale if scale is not None else Dh**-0.5
    f32, f64 = torch.float32, torch.float64
    qf = q.to(f32)
    qs = torch.clamp(torch.amax(torch.abs(qf), dim=-1, keepdim=True), min=1e-8) / 127.0  # (B,Tq,H,1)
    q8 = torch.clamp(torch.round(qf / qs), -127, 127)
    dots = torch.einsum("bqhd,bhdt->bhqt", q8.to(f64), cache["k8"].to(f64))
    mult = (scale * qs.permute(0, 2, 1, 3)) * cache["ks"]  # (B,H,Tq,1) x (B,H,1,T)
    logits = dots.to(f32) * mult
    if mask is not None:
        logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1)
    pv = probs * cache["vs"]  # fold the per-position V scale
    ps = torch.clamp(torch.amax(pv, dim=-1, keepdim=True), min=1e-12) / 127.0
    p8 = torch.clamp(torch.round(pv / ps), 0, 127)
    acc = torch.einsum("bhqt,bhdt->bqhd", p8.to(f64), cache["v8"].to(f64))
    out = acc.to(f32) * ps.permute(0, 2, 1, 3)
    return out.to(dtype)


def decode_attention_int8(q, kv8, mask=None, dtype=torch.bfloat16, scale=None):
    """decode_attention against int8 K/V with per-position scales (the
    quantize_decode_kv / init_int8_cache format): self_attention_int8's
    arithmetic under ssak_tpu's cross-attention name."""
    return self_attention_int8(q, kv8, mask=mask, dtype=dtype, scale=scale)


def decode_attention_bounded(q, kv, lo, hi, dtype=torch.bfloat16, scale=None):
    """Single-query decode attention with an inclusive index-range mask.

    q: (B, 1, H, Dh). kv: {"k", "v"} bf16 decode layout or the int8 dict.
    lo/hi: ints or (B,) int tensors. On CUDA this is the fused flash-decode
    kernel (K4), always — ssak_tpu gates it behind SSAK_FLASH_DECODE only
    for its TPU runtime's launch floor. On the CPU it takes the mask paths
    (decode_attention / self_attention_int8), as ssak_tpu does off the TPU.
    Returns (B, 1, H, Dh)."""
    B, Tq, H, Dh = q.shape
    scale = scale if scale is not None else Dh**-0.5
    is_int8 = "k8" in kv
    T = (kv["k8"] if is_int8 else kv["k"]).shape[-1]
    lo = torch.as_tensor(lo, dtype=torch.int32, device=q.device).expand(B)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=q.device).expand(B)
    if Tq == 1 and flash_decode_supported(q, Dh, T):
        qs = (q[:, 0].to(torch.bfloat16) * _round_scalar(scale, torch.bfloat16)).contiguous()  # (B, H, Dh)
        if is_int8:
            o = flash_decode_attention(qs, kv["k8"], kv["v8"], lo, hi, kv["ks"], kv["vs"])
        else:
            o = flash_decode_attention(qs, kv["k"], kv["v"], lo, hi)
        return o[:, None].to(dtype)
    t = torch.arange(T, device=q.device)
    mask = ((t[None, :] >= lo[:, None]) & (t[None, :] <= hi[:, None]))[:, None, None, :]
    if is_int8:
        return self_attention_int8(q, kv, mask=mask, dtype=dtype, scale=scale)
    return decode_attention(q, kv["k"], kv["v"], mask=mask, dtype=dtype, scale=scale)


# ssak_tpu's threshold, kept as it is: below it the unfused attention runs
# (whose (B, H, T, T) f32 logits fit the card at the 30 s bucket), from it
# on L1, forward and, in training, backward
FLASH_MIN_SEQ = 4096


def _can_flash(q, dtype) -> bool:
    """Route full self-attention with a padding mask to L1 (forward and
    backward): ssak_tpu's predicate with its TPU backend read as a CUDA
    tensor, i.e. a bf16 compute dtype with Dh in (64, 128, 256) and
    T >= FLASH_MIN_SEQ. Like ssak_tpu's, it reads the compute dtype and
    not q's own (dense returns the compute dtype on every path)."""
    return (
        q.is_cuda
        and dtype == torch.bfloat16
        and q.shape[-1] in _FLASH_HEAD_DIMS
        and q.shape[1] >= FLASH_MIN_SEQ
    )


def mha(x, p, n_heads: int, kv_x=None, mask=None, cache=None, cache_index=None,
        dtype=torch.bfloat16, lengths=None, attn_bounds=None):
    """Multi-head attention: self-attention over x, or cross-attention from
    x to `kv_x` (keys and values from kv_x, e.g. the audio features of a
    teacher-forced decoder). Without a cache: full attention, with an
    optional mask or padding `lengths` (self-attention without a mask goes
    through the fused kernel L1 where _can_flash holds). With a decode cache
    ({k, v} (B, H, Dh, L) or the int8 dict), cache_index and
    attn_bounds=(lo, hi): the step's k/v are written into the cache IN
    PLACE at cache_index and attention runs over [lo, hi]
    (decode_attention_bounded). A tensor-parallel attention (p.tp_size > 1)
    runs the rank's n_heads / tp_size heads. Returns (y, cache)."""
    n_heads //= p.tp_size
    src = x if kv_x is None else kv_x
    if kv_x is None and hasattr(p, "qkv"):
        qkv = dense(x, p.qkv, dtype)
        D = qkv.shape[-1] // 3
        q = split_heads(qkv[..., :D], n_heads)
        km, vm = qkv[..., D : 2 * D], qkv[..., 2 * D :]
    else:
        q = split_heads(dense(x, p.query, dtype), n_heads)
        km = dense(src, p.key, dtype)
        vm = dense(src, p.value, dtype)
    if cache is not None:
        if cache_index is None or attn_bounds is None:
            raise ValueError("a decode cache needs cache_index and attn_bounds (decode-step use only)")
        kT = to_decode_kv(km, n_heads)
        vT = to_decode_kv(vm, n_heads)
        if "k8" in cache:
            update_int8_cache(cache, kT, vT, cache_index)
        else:
            n = kT.shape[-1]
            cache["k"][..., cache_index : cache_index + n].copy_(kT)
            cache["v"][..., cache_index : cache_index + n].copy_(vT)
        y = decode_attention_bounded(q, cache, attn_bounds[0], attn_bounds[1], dtype=dtype)
        return dense(merge_heads(y), p.out, dtype), cache
    k = split_heads(km, n_heads)
    v = split_heads(vm, n_heads)
    # full-sequence self-attention with only a padding mask -> fused kernel
    if kv_x is None and mask is None and _can_flash(q, dtype):
        y = flash_self_attention(q, k, v, lengths=lengths)
    else:
        if mask is None and lengths is not None:
            mask = (torch.arange(k.shape[1], device=x.device)[None, :] < lengths[:, None])[:, None, None, :]
        y = attention(q, k, v, mask=mask, dtype=dtype)
    return dense(merge_heads(y), p.out, dtype), None


def fuse_qkv_params(attn):
    """Fuse one attention module's query/key/value projections into a
    single `qkv` Linear ((3D, D) weight, zeros where a projection had no
    bias), IN PLACE, dropping the three originals. Skipped when any
    projection is quantized, carries a LoRA adapter or is tensor-parallel
    (a rank's q, k and v slices are not a slice of the fused weight).
    Returns the module."""
    projs = [attn.query, attn.key, attn.value]
    if not all(isinstance(pr, Linear) and pr.lora_A is None and pr.tp is None for pr in projs):
        return attn
    w0 = projs[0].weight
    biases = [pr.bias if pr.bias is not None else torch.zeros(w0.shape[0], dtype=w0.dtype, device=w0.device) for pr in projs]
    attn.qkv = Linear(torch.cat([pr.weight for pr in projs], dim=0), torch.cat(biases))
    del attn.query, attn.key, attn.value
    return attn


def mlp(x, p, dtype=torch.bfloat16, activation=gelu):
    return dense(activation(dense(x, p.fc1, dtype)), p.fc2, dtype)


def causal_mask(Tq: int, Tk: int, offset: int = 0, device=None):
    """(1, 1, Tq, Tk) boolean lower-triangular mask, True = attend; offset
    shifts the query positions (cached decode)."""
    q = torch.arange(Tq, device=device)[:, None] + offset
    k = torch.arange(Tk, device=device)[None, :]
    return (k <= q)[None, None]


def conv1d(x, p, stride: int = 1, padding=(0, 0), groups: int = 1, dtype=torch.bfloat16):
    """x: (B, T, Cin) -> (B, T', Cout); explicit (left, right) padding.
    The channel transposes happen here, not at the API."""
    xt = x.to(dtype).transpose(1, 2)
    left, right = padding
    if left != right:
        xt = F.pad(xt, (left, right))
        left = 0
    y = F.conv1d(xt, p.weight.to(dtype), stride=stride, padding=left, groups=groups).transpose(1, 2)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


# --- initializers (seeded on a torch.Generator; JAX's key bits are not reproduced) ---


def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def linear_init(gen, d_in, d_out, bias=True, scale=None) -> Linear:
    """N(0, 1/d_in) weight (std `scale` when given), zero bias."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return Linear(_normal(gen, (d_out, d_in), std), torch.zeros(d_out) if bias else None)


def ln_init(d) -> LayerNorm:
    return LayerNorm(torch.ones(d), torch.zeros(d))


def conv_init(gen, k, c_in, c_out, bias=True, groups: int = 1) -> Conv1d:
    """N(0, 1/(k c_in/groups)) weight (Cout, Cin/groups, K), zero bias."""
    std = 1.0 / math.sqrt(k * c_in / groups)
    return Conv1d(_normal(gen, (c_out, c_in // groups, k), std), torch.zeros(c_out) if bias else None)
