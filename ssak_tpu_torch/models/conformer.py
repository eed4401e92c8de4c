"""Conformer-CTC acoustic model in PyTorch (counterpart of ssak_tpu.models.conformer).

Log-mel features -> conv subsampling (x4) -> N conformer blocks (half-step
FFN with swish, self-attention, depthwise conv module, half-step FFN, final
LN) -> CTC head. Both attention variants of the JAX package: RoPE (halves
rotated, through `layers.attention`), and Transformer-XL relative-position
attention with pos_bias_u / pos_bias_v (`pos_type="relpos"`), the form of
NeMo / Parakeet checkpoints (`models.hf_loader.load_nemo_conformer`). The
attention stays unfused, as in ssak_tpu, whose Conformer never reaches its
flash kernel: products of `dtype`-rounded operands in f32, softmax in f32
(the `layers.attention` idiom). Public functions keep ssak_tpu's layouts:
waveform (B, T), mel (B, n_mels, F), hidden (B, T', D), logits (B, T', V).
"""

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ssak_tpu_torch.models import layers as L


@dataclass(frozen=True)
class ConformerConfig:
    n_mels: int = 80
    d_model: int = 256
    num_layers: int = 16
    num_heads: int = 4
    ff_expansion: int = 4
    conv_kernel: int = 31
    subsampling_factor: int = 4
    vocab_size: int = 128
    blank_id: int = 0
    dtype: str = "bfloat16"
    # NeMo checkpoint-compatible variant: pos_type "relpos" (Transformer-XL
    # rel-pos attention with pos_bias_u/v), subsampling "striding2d" (NeMo's
    # pre_encode Conv2d stack), conv_norm "affine" (BatchNorm folded at
    # import), xscale (the encoder input times sqrt(d_model))
    pos_type: str = "rope"
    subsampling: str = "conv1d"
    conv_norm: str = "ln"
    xscale: bool = False
    # "whisper" = ops.logmel.log_mel_spectrogram, "nemo" = nemo_log_mel_spectrogram
    frontend: str = "whisper"

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


PRESETS = {
    # NeMo conformer_ctc_small/medium/large dims
    "small": dict(d_model=176, num_layers=16, num_heads=4),
    "medium": dict(d_model=256, num_layers=16, num_heads=4),
    "large": dict(d_model=512, num_layers=17, num_heads=8),
    "tiny_test": dict(d_model=64, num_layers=2, num_heads=2, conv_kernel=7, vocab_size=32),
}


def make_config(name: str = "medium", **overrides) -> ConformerConfig:
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return ConformerConfig(**kw)


# --- modules (parameter containers) ------------------------------------------------


class Conv2d(nn.Module):
    """weight in torch layout (Cout, Cin, KH, KW), bias (Cout,)."""

    def __init__(self, weight, bias):
        super().__init__()
        self.weight = L._param(weight)
        self.bias = L._param(bias)


class Subsampling(nn.Module):
    """conv1 / conv2 (Conv1d, or Conv2d for striding2d) and the projection."""

    def __init__(self, conv1, conv2, proj):
        super().__init__()
        self.conv1, self.conv2, self.proj = conv1, conv2, proj


class RelPosAttention(L.MultiHeadAttention):
    """Projections, plus linear_pos (no bias) and pos_bias_u / pos_bias_v (H, Dh)."""

    def __init__(self, out, query, key, value, linear_pos, pos_bias_u, pos_bias_v):
        super().__init__(out, query, key, value)
        self.linear_pos = linear_pos
        self.pos_bias_u = L._param(pos_bias_u)
        self.pos_bias_v = L._param(pos_bias_v)


class ConvModule(nn.Module):
    """pointwise1 (D -> 2D, GLU), depthwise Conv1d, bn (a LayerNorm, or the
    folded BatchNorm's scale and bias), pointwise2."""

    def __init__(self, pointwise1, depthwise, bn, pointwise2):
        super().__init__()
        self.pointwise1, self.depthwise, self.bn, self.pointwise2 = pointwise1, depthwise, bn, pointwise2


class ConformerBlock(nn.Module):
    def __init__(self, ff1_ln, ff1, attn_ln, attn, conv_ln, conv, ff2_ln, ff2, final_ln):
        super().__init__()
        self.ff1_ln, self.ff1, self.attn_ln, self.attn = ff1_ln, ff1, attn_ln, attn
        self.conv_ln, self.conv, self.ff2_ln, self.ff2, self.final_ln = conv_ln, conv, ff2_ln, ff2, final_ln


class ConformerModel(nn.Module):
    def __init__(self, subsampling, blocks, lm_head):
        super().__init__()
        self.subsampling = subsampling
        self.blocks = nn.ModuleList(blocks)
        self.lm_head = lm_head


def _sub2d_out_len(n, k=3, s=2, p=1):
    return (n + 2 * p - k) // s + 1


def init_params(cfg: ConformerConfig, seed: int = 0, device="cpu") -> ConformerModel:
    """A seeded model with ssak_tpu's initializers on a torch.Generator:
    dense N(0, 1/d_in), conv N(0, 1/fan_in), striding2d kernels N(0, 0.1)
    and N(0, 0.02), zero biases and pos_bias_u/v, unit norms."""
    gen = torch.Generator().manual_seed(seed)
    d = cfg.d_model
    ff = cfg.ff_expansion * d
    if cfg.subsampling == "striding2d":
        f_out = _sub2d_out_len(_sub2d_out_len(cfg.n_mels))
        sub = Subsampling(Conv2d(L._normal(gen, (d, 1, 3, 3), 0.1), torch.zeros(d)),
                          Conv2d(L._normal(gen, (d, d, 3, 3), 0.02), torch.zeros(d)),
                          L.linear_init(gen, d * f_out, d))
    else:
        sub = Subsampling(L.conv_init(gen, 3, cfg.n_mels, d), L.conv_init(gen, 3, d, d), L.linear_init(gen, d, d))
    blocks = []
    for _ in range(cfg.num_layers):
        proj = {n: L.linear_init(gen, d, d) for n in ("out", "query", "key", "value")}
        if cfg.pos_type == "relpos":
            dh = d // cfg.num_heads
            attn = RelPosAttention(**proj, linear_pos=L.linear_init(gen, d, d, bias=False),
                                   pos_bias_u=torch.zeros(cfg.num_heads, dh), pos_bias_v=torch.zeros(cfg.num_heads, dh))
        else:
            attn = L.MultiHeadAttention(**proj)
        conv = ConvModule(L.linear_init(gen, d, 2 * d), L.conv_init(gen, cfg.conv_kernel, d, d, groups=d), L.ln_init(d),
                          L.linear_init(gen, d, d))
        blocks.append(ConformerBlock(
            L.ln_init(d), L.MLP(L.linear_init(gen, d, ff), L.linear_init(gen, ff, d)), L.ln_init(d), attn,
            L.ln_init(d), conv, L.ln_init(d), L.MLP(L.linear_init(gen, d, ff), L.linear_init(gen, ff, d)), L.ln_init(d)))
    return ConformerModel(sub, blocks, L.linear_init(gen, d, cfg.vocab_size)).to(device)


# --- forward -----------------------------------------------------------------------------


def _swish(x):
    return x * torch.sigmoid(x)


def _rope(x, positions):
    """x: (B, T, H, Dh) -> its halves rotated; positions: (T,) f32."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = 10000.0 ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None] * freqs[None, :]  # (T, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _conv_module(x, p, cfg, pad_mask):
    """GLU, pad frames zeroed, depthwise conv, LayerNorm or the folded
    affine, swish, pointwise."""
    dt = cfg.compute_dtype
    h = L.dense(x, p.pointwise1, dt)
    a, b = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(b)  # GLU
    h = torch.where(pad_mask[..., None], h, 0.0)
    k = cfg.conv_kernel
    h = L.conv1d(h, p.depthwise, stride=1, padding=(k // 2, k // 2), groups=cfg.d_model, dtype=dt)
    if cfg.conv_norm == "affine":
        h = (h.to(torch.float32) * p.bn.scale + p.bn.bias).to(h.dtype)
    else:
        h = L.layer_norm(h, p.bn)
    return L.dense(_swish(h), p.pointwise2, dt)


def _attention_rope(x, p, cfg, pad_mask):
    dt = cfg.compute_dtype
    T = x.shape[1]
    H = cfg.num_heads // p.tp_size  # the rank's heads under tensor parallelism
    q = L.split_heads(L.dense(x, p.query, dt), H)
    k = L.split_heads(L.dense(x, p.key, dt), H)
    v = L.split_heads(L.dense(x, p.value, dt), H)
    positions = torch.arange(T, dtype=torch.float32, device=x.device)
    q = _rope(q, positions)
    k = _rope(k, positions)
    y = L.attention(q, k, v, mask=pad_mask[:, None, None, :], dtype=dt)
    return L.dense(L.merge_heads(y), p.out, dt)


def _relpos_table(T: int, d: int, device="cpu"):
    """(2T-1, d) f32 sinusoidal relative-position table, row j = position
    T-1-j ([T-1 ... 0 ... -(T-1)]), sin at even dims and cos at odd."""
    pos = torch.arange(T - 1, -T, -1, dtype=torch.float32, device=device)
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / d))
    ang = pos[:, None] * div[None, :]  # (2T-1, d/2)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(2 * T - 1, d)


def _rel_shift(x):
    """(B, H, T, 2T-1) raw position scores -> (B, H, T, T) with
    out[i, j] = in[i, T-1-i+j]: the Transformer-XL pad / reshape shift."""
    B, H, T, Lr = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(B, H, Lr + 1, T)
    return x[:, :, 1:].reshape(B, H, T, Lr)[:, :, :, :T]


def _attention_relpos(x, p, cfg, pad_mask, pe=None):
    """Transformer-XL relative-position attention: (AC + shifted BD) / sqrt(Dh),
    -1e30 on pad keys, softmax in f32. `pe`: the (2T-1, D) table, made here
    when not given (encode makes it once for all blocks)."""
    dt = cfg.compute_dtype
    T = x.shape[1]
    H = cfg.num_heads // p.tp_size  # the rank's heads (and their linear_pos and pos_bias slices) under TP
    q = L.split_heads(L.dense(x, p.query, dt), H)  # (B, T, H, Dh)
    k = L.split_heads(L.dense(x, p.key, dt), H)
    v = L.split_heads(L.dense(x, p.value, dt), H)
    Dh = q.shape[-1]
    if pe is None:
        pe = _relpos_table(T, cfg.d_model, x.device)
    pos = L.dense(pe[None].to(dt), p.linear_pos, dt)[0].reshape(2 * T - 1, H, Dh)
    qu = q + p.pos_bias_u.to(dt)
    qv = q + p.pos_bias_v.to(dt)
    ac = torch.einsum("bthd,bshd->bhts", L._f32(qu, dt), L._f32(k, dt))
    bd = _rel_shift(torch.einsum("bthd,lhd->bhtl", L._f32(qv, dt), L._f32(pos, dt)))
    scores = (ac + bd) / math.sqrt(Dh)
    del ac, bd
    scores = torch.where(pad_mask[:, None, None, :], scores, L._NEG)
    probs = torch.softmax(scores, dim=-1)
    del scores
    y = torch.einsum("bhts,bshd->bthd", L._f32(probs, dt), L._f32(v, dt)).to(dt)
    return L.dense(L.merge_heads(y), p.out, dt)


def subsample(model, mel, cfg: ConformerConfig):
    """mel: (B, n_mels, T) -> (B, T', d_model) through two stride-2 convs."""
    if cfg.subsampling == "striding2d":
        return _subsample_striding2d(model, mel, cfg)
    dt = cfg.compute_dtype
    sub = model.subsampling
    x = mel.transpose(-2, -1)  # (B, T, n_mels)
    x = L.gelu(L.conv1d(x, sub.conv1, stride=2, padding=(1, 1), dtype=dt))
    x = L.gelu(L.conv1d(x, sub.conv2, stride=2, padding=(1, 1), dtype=dt))
    return L.dense(x, sub.proj, dt)


def _subsample_striding2d(model, mel, cfg: ConformerConfig):
    """NeMo pre_encode: two stride-2 Conv2d + ReLU over the (time, freq)
    plane of a one-channel mel image, then a linear over the channel-major
    (C, F/4) features of each frame."""
    dt = cfg.compute_dtype
    sub = model.subsampling
    x = mel.transpose(-2, -1)[:, None]  # (B, 1, T, F)
    for conv in (sub.conv1, sub.conv2):
        x = F.conv2d(x.to(dt), conv.weight.to(dt), stride=2, padding=1)
        x = torch.relu(x + conv.bias.to(dt)[None, :, None, None])
    B, C, T4, F4 = x.shape
    x = x.transpose(1, 2).reshape(B, T4, C * F4)
    return L.dense(x, sub.proj, dt)


def subsampled_length(cfg: ConformerConfig, n_frames):
    n = n_frames
    for _ in range(2):
        n = (n + 1) // 2
    return n


def mel_frame_count(cfg: ConformerConfig, n_samples: int) -> int:
    """Mel frames of n_samples of 16 kHz audio: the whisper frontend drops
    the final centred frame, the nemo one keeps it."""
    return n_samples // 160 + (1 if cfg.frontend == "nemo" else 0)


def encode(model, mel, cfg: ConformerConfig, frame_lengths=None, time_mask=None):
    """mel: (B, n_mels, T) -> (hidden (B, T', D), lengths (B,)). time_mask:
    optional bool (B, T'); masked subsampled frames are zeroed."""
    x = subsample(model, mel, cfg)
    if cfg.xscale:
        x = x * L._round_scalar(cfg.d_model**0.5, x.dtype)
    if time_mask is not None:
        x = torch.where(time_mask[:, : x.shape[1], None], 0.0, x)
    T = x.shape[1]
    if frame_lengths is not None:
        lengths = subsampled_length(cfg, torch.as_tensor(frame_lengths, device=x.device))
    else:
        lengths = torch.full((x.shape[0],), T, dtype=torch.int32, device=x.device)
    pad_mask = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    dt = cfg.compute_dtype
    if cfg.pos_type == "relpos":
        pe = _relpos_table(T, cfg.d_model, x.device)

        def attention(h, p):
            return _attention_relpos(h, p, cfg, pad_mask, pe)
    else:
        def attention(h, p):
            return _attention_rope(h, p, cfg, pad_mask)

    for blk in model.blocks:
        x = x + 0.5 * L.mlp(L.layer_norm(x, blk.ff1_ln), blk.ff1, dtype=dt, activation=_swish)
        x = x + attention(L.layer_norm(x, blk.attn_ln), blk.attn)
        x = x + _conv_module(L.layer_norm(x, blk.conv_ln), blk.conv, cfg, pad_mask)
        x = x + 0.5 * L.mlp(L.layer_norm(x, blk.ff2_ln), blk.ff2, dtype=dt, activation=_swish)
        x = L.layer_norm(x, blk.final_ln)
    return x, lengths


def ctc_logits_from_mel(model, mel, cfg: ConformerConfig, frame_lengths=None, time_mask=None):
    hidden, lengths = encode(model, mel, cfg, frame_lengths, time_mask=time_mask)
    return L.dense(hidden, model.lm_head, cfg.compute_dtype), lengths


def ctc_log_probs(model, waveform, cfg: ConformerConfig, sample_lengths=None, time_mask=None):
    """waveform (B, T) f32 at 16 kHz -> (log_probs (B, T', V) f32, lengths
    (B,)): log-mel by cfg.frontend, the encoder, log_softmax in f32."""
    from ssak_tpu_torch.ops.logmel import HOP_LENGTH, log_mel_spectrogram, nemo_log_mel_spectrogram

    if sample_lengths is not None:
        sample_lengths = torch.as_tensor(sample_lengths, device=waveform.device)
    if cfg.frontend == "nemo":
        mel, frame_lengths = nemo_log_mel_spectrogram(waveform, n_mels=cfg.n_mels, sample_lengths=sample_lengths)
    else:
        mel = log_mel_spectrogram(waveform, n_mels=cfg.n_mels)
        frame_lengths = None if sample_lengths is None else torch.clamp(sample_lengths // HOP_LENGTH, max=mel.shape[-1])
    logits, lengths = ctc_logits_from_mel(model, mel, cfg, frame_lengths, time_mask=time_mask)
    return torch.log_softmax(logits.to(torch.float32), dim=-1), lengths
