"""Whisper encoder-decoder in PyTorch (counterpart of ssak_tpu.models.whisper):
the greedy serving path.

`WhisperModel` holds the weights as `nn.Module`s; `encode`,
`precompute_cross_kv`, `init_cache`, `_decode_step` and `greedy_decode`
are plain functions that follow the JAX ones step by step. The token loop
is a Python loop over preallocated caches (B, H, Dh, n_text_ctx), written
in place; it runs the whole budget with no host synchronization, as the
JAX lax.scan does, and pads finished rows with eot.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn as nn

from ssak_tpu_torch.models import layers as L


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    # special tokens (multilingual vocab defaults)
    sot: int = 50258
    eot: int = 50257
    no_timestamps: int = 50363
    sot_prev: int = 50361
    no_speech: int = 50362
    timestamp_begin: int = 50364
    dtype: str = "bfloat16"
    # int8 K/V caches (set by load_model with quantize_bits=8)
    kv_int8: bool = False

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


PRESETS = {
    "tiny": dict(n_audio_state=384, n_audio_head=6, n_audio_layer=4, n_text_state=384, n_text_head=6, n_text_layer=4),
    "base": dict(n_audio_state=512, n_audio_head=8, n_audio_layer=6, n_text_state=512, n_text_head=8, n_text_layer=6),
    "small": dict(n_audio_state=768, n_audio_head=12, n_audio_layer=12, n_text_state=768, n_text_head=12, n_text_layer=12),
    "medium": dict(n_audio_state=1024, n_audio_head=16, n_audio_layer=24, n_text_state=1024, n_text_head=16, n_text_layer=24),
    "large-v2": dict(n_audio_state=1280, n_audio_head=20, n_audio_layer=32, n_text_state=1280, n_text_head=20, n_text_layer=32),
    "large-v3": dict(n_audio_state=1280, n_audio_head=20, n_audio_layer=32, n_text_state=1280, n_text_head=20, n_text_layer=32, n_mels=128, n_vocab=51866),
    # seeded micro-config for tests (no pretrained weights needed)
    "tiny_test": dict(n_audio_state=64, n_audio_head=2, n_audio_layer=2, n_text_state=64, n_text_head=2, n_text_layer=2, n_vocab=128, n_audio_ctx=100, n_text_ctx=32, n_mels=80, sot=1, eot=2, no_timestamps=3, sot_prev=4, no_speech=5, timestamp_begin=100),
}


def make_config(name: str = "tiny", **overrides) -> WhisperConfig:
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return WhisperConfig(**kw)


# --- modules ---------------------------------------------------------------


class ResidualAttentionBlock(nn.Module):
    def __init__(self, attn_ln, attn, mlp_ln, mlp, cross_attn_ln=None, cross_attn=None):
        super().__init__()
        self.attn_ln, self.attn, self.mlp_ln, self.mlp = attn_ln, attn, mlp_ln, mlp
        if cross_attn is not None:
            self.cross_attn_ln, self.cross_attn = cross_attn_ln, cross_attn


class AudioEncoder(nn.Module):
    def __init__(self, conv1, conv2, blocks, ln_post):
        super().__init__()
        self.conv1, self.conv2, self.ln_post = conv1, conv2, ln_post
        self.blocks = nn.ModuleList(blocks)


class TextDecoder(nn.Module):
    def __init__(self, token_embedding, positional_embedding, blocks, ln):
        super().__init__()
        self.token_embedding = L._param(token_embedding)  # (V, D), also the logits projection
        self.positional_embedding = L._param(positional_embedding)  # (n_text_ctx, D)
        self.blocks = nn.ModuleList(blocks)
        self.ln = ln


class WhisperModel(nn.Module):
    def __init__(self, encoder: AudioEncoder, decoder: TextDecoder):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder


def init_params(generator: torch.Generator, cfg: WhisperConfig, device=None) -> WhisperModel:
    """Random model with ssak_tpu's init distributions (N(0, 1/d_in)
    kernels, zero biases, unit LayerNorms, 0.02 / 0.01 embeddings), drawn
    from `generator` on `device` in f32. The numbers differ from JAX's for
    the same seed; the tests move weights across with models.convert."""
    device = torch.device(device if device is not None else generator.device)

    def randn(*shape, std):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * std

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=torch.float32)

    def linear(d_in, d_out, bias=True):
        return L.Linear(randn(d_out, d_in, std=1.0 / math.sqrt(d_in)), zeros(d_out) if bias else None)

    def ln(d):
        return L.LayerNorm(torch.ones(d, device=device), zeros(d))

    def conv(k, c_in, c_out):
        return L.Conv1d(randn(c_out, c_in, k, std=1.0 / math.sqrt(k * c_in)), zeros(c_out))

    def attn(d):
        return L.MultiHeadAttention(query=linear(d, d), key=linear(d, d, bias=False), value=linear(d, d),
                                    out=linear(d, d))

    def block(d, cross):
        extra = dict(cross_attn_ln=ln(d), cross_attn=attn(d)) if cross else {}
        return ResidualAttentionBlock(ln(d), attn(d), ln(d), L.MLP(linear(d, 4 * d), linear(4 * d, d)), **extra)

    d_a, d_t = cfg.n_audio_state, cfg.n_text_state
    encoder = AudioEncoder(
        conv(3, cfg.n_mels, d_a), conv(3, d_a, d_a),
        [block(d_a, cross=False) for _ in range(cfg.n_audio_layer)], ln(d_a),
    )
    decoder = TextDecoder(
        randn(cfg.n_vocab, d_t, std=0.02), randn(cfg.n_text_ctx, d_t, std=0.01),
        [block(d_t, cross=True) for _ in range(cfg.n_text_layer)], ln(d_t),
    )
    return WhisperModel(encoder, decoder)


# --- forward ---------------------------------------------------------------


def encode(model: WhisperModel, mel, cfg: WhisperConfig):
    """mel: (B, n_mels, T_frames) -> (B, T_frames//2, D)."""
    dt = cfg.compute_dtype
    enc = model.encoder
    x = mel.transpose(-2, -1)  # (B, T, n_mels)
    x = L.gelu(L.conv1d(x, enc.conv1, stride=1, padding=(1, 1), dtype=dt))
    x = L.gelu(L.conv1d(x, enc.conv2, stride=2, padding=(1, 1), dtype=dt))
    T = x.shape[1]
    pos = torch.from_numpy(L.sinusoid_position_embedding(cfg.n_audio_ctx, cfg.n_audio_state)[:T]).to(x.device)
    x = x + pos
    for blk in enc.blocks:
        h, _ = L.mha(L.layer_norm(x, blk.attn_ln), blk.attn, cfg.n_audio_head, dtype=dt)
        x = x + h
        x = x + L.mlp(L.layer_norm(x, blk.mlp_ln), blk.mlp, dtype=dt)
    return L.layer_norm(x, enc.ln_post)


def fuse_decode_qkv(model: WhisperModel) -> WhisperModel:
    """Load-time decode optimization: fuse each decoder block's self-
    attention q/k/v projections into one (3D, D) matmul, in place.
    Cross-attention and the encoder are untouched; quantized projections
    are skipped (layers.fuse_qkv_params)."""
    for blk in model.decoder.blocks:
        L.fuse_qkv_params(blk.attn)
    return model


def _decode_layer(blk, cache, cross_kv, x, attn_bounds, cross_bounds, cache_index, cfg: WhisperConfig):
    """One decoder layer of a cached decode step."""
    dt = cfg.compute_dtype
    h, _ = L.mha(
        L.layer_norm(x, blk.attn_ln), blk.attn, cfg.n_text_head,
        attn_bounds=attn_bounds, cache=cache, cache_index=cache_index, dtype=dt,
    )
    x = x + h
    xq = L.layer_norm(x, blk.cross_attn_ln)
    q = L.split_heads(L.dense(xq, blk.cross_attn.query, dt), cfg.n_text_head)
    y = L.decode_attention_bounded(q, cross_kv, cross_bounds[0], cross_bounds[1], dtype=dt)
    x = x + L.dense(L.merge_heads(y), blk.cross_attn.out, dt)
    return x + L.mlp(L.layer_norm(x, blk.mlp_ln), blk.mlp, dtype=dt)


def precompute_cross_kv(model: WhisperModel, audio_features, cfg: WhisperConfig):
    """Cross-attention K/V, once per utterance, in the decode-cache layout
    (B, H, Dh, T_audio), contiguous; int8 with per-position scales when
    cfg.kv_int8."""
    dt = cfg.compute_dtype
    out = []
    for blk in model.decoder.blocks:
        c = blk.cross_attn
        k = L.to_decode_kv(L.dense(audio_features, c.key, dt), cfg.n_text_head).contiguous()
        v = L.to_decode_kv(L.dense(audio_features, c.value, dt), cfg.n_text_head).contiguous()
        out.append(L.quantize_decode_kv(k, v) if cfg.kv_int8 else {"k": k, "v": v})
    return out


def init_cache(cfg: WhisperConfig, batch: int, device=None):
    """Per-layer self-attention caches (B, H, Dh, n_text_ctx): compute
    dtype, or the int8 format when cfg.kv_int8."""
    Dh = cfg.n_text_state // cfg.n_text_head
    shape = (batch, cfg.n_text_head, Dh, cfg.n_text_ctx)

    def empty():
        if cfg.kv_int8:
            return L.init_int8_cache(batch, cfg.n_text_head, Dh, cfg.n_text_ctx, device=device)
        return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}

    return [empty() for _ in range(cfg.n_text_layer)]


def _decode_step(model: WhisperModel, token, pos: int, caches, cross_kvs, cfg: WhisperConfig):
    """One cached decoder step. token: (B, 1) int64; pos: the position
    written. The caches are updated in place. Returns (logits (B, V) f32,
    caches)."""
    dt = cfg.compute_dtype
    dec = model.decoder
    B = token.shape[0]
    dev = token.device
    x = dec.token_embedding[token] + dec.positional_embedding[pos : pos + 1]
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    attn_bounds = (zero, torch.full((B,), pos, dtype=torch.int32, device=dev))
    T_audio = (cross_kvs[0]["k8"] if cfg.kv_int8 else cross_kvs[0]["k"]).shape[-1]
    cross_bounds = (zero, torch.full((B,), T_audio - 1, dtype=torch.int32, device=dev))
    for blk, cache, cross_kv in zip(dec.blocks, caches, cross_kvs):
        x = _decode_layer(blk, cache, cross_kv, x, attn_bounds, cross_bounds, pos, cfg)
    x = L.layer_norm(x, dec.ln)
    logits = torch.matmul(x.to(dt), dec.token_embedding.t().to(dt)).to(torch.float32)
    return logits[:, 0], caches


@torch.inference_mode()
def greedy_decode(model: WhisperModel, mel, cfg: WhisperConfig, prompt, max_tokens: int = None):
    """Batched greedy decode. mel: (B, n_mels, T). prompt: forced initial
    tokens, teacher-forced at positions 0..P-1. Returns (tokens (B,
    max_tokens) int64, lengths (B,)): the generated ids after the prompt,
    padded with eot once a row has emitted it."""
    B = mel.shape[0]
    dev = mel.device
    max_tokens = max_tokens or (cfg.n_text_ctx - len(prompt) - 1)
    audio_features = encode(model, mel, cfg)
    cross_kvs = precompute_cross_kv(model, audio_features, cfg)
    caches = init_cache(cfg, B, device=dev)

    logits = None
    for i, tok in enumerate(prompt):
        token = torch.full((B, 1), int(tok), dtype=torch.int64, device=dev)
        logits, caches = _decode_step(model, token, i, caches, cross_kvs, cfg)

    tokens = torch.empty((B, max_tokens), dtype=torch.int64, device=dev)
    nxt = torch.argmax(logits, dim=-1)
    done = nxt == cfg.eot
    tokens[:, 0] = nxt
    for i in range(1, max_tokens):
        logits, caches = _decode_step(model, nxt[:, None], len(prompt) + i - 1, caches, cross_kvs, cfg)
        nxt = torch.where(done, cfg.eot, torch.argmax(logits, dim=-1))
        done = done | (nxt == cfg.eot)
        tokens[:, i] = nxt
    lengths = torch.sum(tokens != cfg.eot, dim=1)
    return tokens, lengths
