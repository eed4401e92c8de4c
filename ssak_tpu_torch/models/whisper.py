"""Whisper encoder-decoder in PyTorch (counterpart of ssak_tpu.models.whisper):
the serving and fine-tuning paths.

`WhisperModel` holds the weights as `nn.Module`s; `encode` (with
`cfg.remat`, each block under torch.utils.checkpoint while autograd
records), the teacher-forced `decode_train` and `cross_entropy_loss` of
training, `precompute_cross_kv`, `init_cache`, `_decode_step`, `greedy_decode` and
the decode family of the accurate and long-form paths (`_tile_rows`,
`_best_of_select`, `sample_decode`, `beam_decode`, `_decode_step_padded`,
`_apply_decode_rules`, `decode_window`) are plain functions that follow the
JAX ones step by step. Each token loop is a Python loop over preallocated
caches (B, H, Dh, n_text_ctx), written in place; it runs the whole budget
with no host synchronization, as the JAX lax.scan does, and pads finished
rows with eot.

A model sharded by parallel.mesh.shard_params (infer.general.shard_model)
runs the same functions on each rank's heads, with caches and cross K/V of
those heads; a token embedding cut along the vocabulary is looked up across
the ranks (`_embed`) and gives each rank its slice of the tied logits,
all-gathered (`_tied_logits`), so every rank holds the same logits and
takes the same decisions.

Sampling is Gumbel-max over logits / T, as `jax.random.categorical` is,
with noise from a `torch.Generator` on the model's device seeded by the
integer that seeds JAX's key; the two generators give different bits, so
at T > 0 only the distribution is shared. Layer-stacked decoders
(`stack_decoder_blocks`, SSAK_SCAN_LAYERS) are not ported.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.utils.checkpoint

from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.parallel.collectives import all_gather, copy_to_region, vocab_parallel_lookup


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
    # recompute each transformer block in the backward pass (training):
    # activation memory O(layers) smaller for about a third more operations
    remat: bool = False
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
    """vocab_tp: the token embedding's tensor parallelism once
    parallel.mesh.shard_params cut it along the vocabulary (each rank a
    range of ids), else None."""

    def __init__(self, token_embedding, positional_embedding, blocks, ln):
        super().__init__()
        self.token_embedding = L._param(token_embedding)  # (V, D), also the logits projection
        self.positional_embedding = L._param(positional_embedding)  # (n_text_ctx, D)
        self.blocks = nn.ModuleList(blocks)
        self.ln = ln
        self.vocab_tp = None


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

    def block(blk, x):
        h, _ = L.mha(L.layer_norm(x, blk.attn_ln), blk.attn, cfg.n_audio_head, dtype=dt)
        x = x + h
        return x + L.mlp(L.layer_norm(x, blk.mlp_ln), blk.mlp, dtype=dt)

    for blk in enc.blocks:
        x = _remat(block, cfg)(blk, x)
    return L.layer_norm(x, enc.ln_post)


def _remat(block, cfg: WhisperConfig):
    """`block` itself, or, with cfg.remat while autograd records, the block
    under torch.utils.checkpoint (its activations recomputed in the
    backward pass, as jax.checkpoint does)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return block
    return lambda *args: torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)


def _embed(dec: TextDecoder, tokens):
    """The token embedding's rows of `tokens`; a vocabulary cut over ranks
    is looked up across them (exact)."""
    return vocab_parallel_lookup(dec.token_embedding, tokens, None if dec.vocab_tp is None else dec.vocab_tp.group)


def _tied_logits(dec: TextDecoder, x, dt):
    """x (..., D) @ token_embedding.T in `dt` with an f32 result (..., V).
    A vocabulary cut over ranks gives each rank its slice of the logits,
    all-gathered in rank order: every rank holds the same f32 logits."""
    tp = dec.vocab_tp
    if tp is not None:
        x = copy_to_region(x, tp.group)
    logits = L.matmul_f32(x.to(dt), dec.token_embedding.t().to(dt))
    return logits if tp is None else all_gather(logits, -1, tp.group, replicated=True)


def decode_train(model: WhisperModel, tokens, audio_features, cfg: WhisperConfig):
    """Teacher-forced decoder: tokens (B, U) -> logits (B, U, V) f32, under
    a causal mask, cross-attending to audio_features (B, T, D)."""
    dt = cfg.compute_dtype
    dec = model.decoder
    U = tokens.shape[1]
    x = _embed(dec, tokens.long()) + dec.positional_embedding[:U]
    mask = L.causal_mask(U, U, device=tokens.device)

    def block(blk, x, audio_features):
        h, _ = L.mha(L.layer_norm(x, blk.attn_ln), blk.attn, cfg.n_text_head, mask=mask, dtype=dt)
        x = x + h
        h, _ = L.mha(L.layer_norm(x, blk.cross_attn_ln), blk.cross_attn, cfg.n_text_head, kv_x=audio_features, dtype=dt)
        x = x + h
        return x + L.mlp(L.layer_norm(x, blk.mlp_ln), blk.mlp, dtype=dt)

    for blk in dec.blocks:
        x = _remat(block, cfg)(blk, x, audio_features)
    x = L.layer_norm(x, dec.ln)
    return _tied_logits(dec, x, dt)


def cross_entropy_loss(logits, targets, mask):
    """Mean token negative log-likelihood over mask (no label smoothing).
    logits (B, U, V) f32, targets (B, U) ints, mask (B, U) f32."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def fuse_decode_qkv(model: WhisperModel) -> WhisperModel:
    """Load-time decode optimization: fuse each decoder block's self-
    attention q/k/v projections into one (3D, D) matmul, in place.
    Cross-attention and the encoder are untouched; quantized and
    tensor-parallel projections are skipped (layers.fuse_qkv_params), as
    ssak_tpu does not fuse under tensor parallelism."""
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
    q = L.split_heads(L.dense(xq, blk.cross_attn.query, dt), cfg.n_text_head // blk.cross_attn.tp_size)
    y = L.decode_attention_bounded(q, cross_kv, cross_bounds[0], cross_bounds[1], dtype=dt)
    x = x + L.dense(L.merge_heads(y), blk.cross_attn.out, dt)
    return x + L.mlp(L.layer_norm(x, blk.mlp_ln), blk.mlp, dtype=dt)


def precompute_cross_kv(model: WhisperModel, audio_features, cfg: WhisperConfig):
    """Cross-attention K/V, once per utterance, in the decode-cache layout
    (B, H, Dh, T_audio), contiguous (a tensor-parallel attention's H: the
    rank's heads); int8 with per-position scales when cfg.kv_int8."""
    dt = cfg.compute_dtype
    out = []
    for blk in model.decoder.blocks:
        c = blk.cross_attn
        H = cfg.n_text_head // c.tp_size
        k = L.to_decode_kv(L.dense(audio_features, c.key, dt), H).contiguous()
        v = L.to_decode_kv(L.dense(audio_features, c.value, dt), H).contiguous()
        out.append(L.quantize_decode_kv(k, v) if cfg.kv_int8 else {"k": k, "v": v})
    return out


def init_cache(cfg: WhisperConfig, batch: int, device=None, model: WhisperModel = None):
    """Per-layer self-attention caches (B, H, Dh, n_text_ctx): compute
    dtype, or the int8 format when cfg.kv_int8. With `model`, each layer's
    H is the heads its self-attention runs on this rank (tensor parallel:
    n_text_head / tp), else n_text_head."""
    Dh = cfg.n_text_state // cfg.n_text_head

    def empty(H):
        if cfg.kv_int8:
            return L.init_int8_cache(batch, H, Dh, cfg.n_text_ctx, device=device)
        shape = (batch, H, Dh, cfg.n_text_ctx)
        return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}

    if model is None:
        return [empty(cfg.n_text_head) for _ in range(cfg.n_text_layer)]
    return [empty(cfg.n_text_head // blk.attn.tp_size) for blk in model.decoder.blocks]


DECODE_STEPS = {"n": 0}  # cached decoder steps run (each runs every decoder layer once)


def _step(model: WhisperModel, token, pos_emb, attn_bounds, cache_index: int, caches, cross_kvs, cfg: WhisperConfig):
    """One cached decoder step over all layers: token (B, 1) int64 plus its
    positional embedding, self-attention over attn_bounds = (lo, hi) (B,)
    int32 with this step's K/V written at cache_index."""
    dt = cfg.compute_dtype
    dec = model.decoder
    B = token.shape[0]
    x = _embed(dec, token) + pos_emb
    zero = torch.zeros((B,), dtype=torch.int32, device=token.device)
    T_audio = (cross_kvs[0]["k8"] if cfg.kv_int8 else cross_kvs[0]["k"]).shape[-1]
    cross_bounds = (zero, torch.full((B,), T_audio - 1, dtype=torch.int32, device=token.device))
    for blk, cache, cross_kv in zip(dec.blocks, caches, cross_kvs):
        x = _decode_layer(blk, cache, cross_kv, x, attn_bounds, cross_bounds, cache_index, cfg)
    x = L.layer_norm(x, dec.ln)
    logits = _tied_logits(dec, x, dt)
    DECODE_STEPS["n"] += 1
    return logits[:, 0], caches


def _decode_step(model: WhisperModel, token, pos: int, caches, cross_kvs, cfg: WhisperConfig):
    """One cached decoder step. token: (B, 1) int64; pos: the position
    written. The caches are updated in place. Returns (logits (B, V) f32,
    caches)."""
    B = token.shape[0]
    zero = torch.zeros((B,), dtype=torch.int32, device=token.device)
    bounds = (zero, torch.full((B,), pos, dtype=torch.int32, device=token.device))
    return _step(model, token, model.decoder.positional_embedding[pos : pos + 1], bounds, pos, caches, cross_kvs, cfg)


def _prompt_forward(model, mel, cfg: WhisperConfig, prompt):
    """Encoder, cross K/V and the prompt teacher-forced through fresh
    caches: (last logits (B, V), caches, cross_kvs)."""
    B = mel.shape[0]
    cross_kvs = precompute_cross_kv(model, encode(model, mel, cfg), cfg)
    caches = init_cache(cfg, B, device=mel.device, model=model)
    logits = None
    for i, tok in enumerate(prompt):
        token = torch.full((B, 1), int(tok), dtype=torch.int64, device=mel.device)
        logits, caches = _decode_step(model, token, i, caches, cross_kvs, cfg)
    return logits, caches, cross_kvs


@torch.inference_mode()
def greedy_decode(model: WhisperModel, mel, cfg: WhisperConfig, prompt, max_tokens: int = None):
    """Batched greedy decode. mel: (B, n_mels, T). prompt: forced initial
    tokens, teacher-forced at positions 0..P-1. Returns (tokens (B,
    max_tokens) int64, lengths (B,)): the generated ids after the prompt,
    padded with eot once a row has emitted it."""
    B = mel.shape[0]
    dev = mel.device
    max_tokens = max_tokens or (cfg.n_text_ctx - len(prompt) - 1)
    logits, caches, cross_kvs = _prompt_forward(model, mel, cfg, prompt)
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


# --- beam search, sampling, best-of (the accurate chain) ---------------------


def _tile_rows(tree, n: int):
    """Repeat every row n times along the batch axis (row b -> rows
    b*n..b*n+n-1): a tensor, or a list of per-layer cache dicts."""
    if torch.is_tensor(tree):
        return tree.repeat_interleave(n, dim=0)
    return [{k: v.repeat_interleave(n, dim=0) for k, v in c.items()} for c in tree]


def _best_of_select(tokens, lengths, sum_logprob, B: int, best_of: int):
    """(B*best_of, ...) candidates -> per-utterance best by average log
    probability, sum_logprob / (length + 1); ties go to the lower index."""
    avg = sum_logprob.reshape(B, best_of) / (lengths.reshape(B, best_of).to(torch.float32) + 1.0)
    rows = torch.arange(B, device=tokens.device) * best_of + torch.argmax(avg, dim=1)
    return tokens[rows], lengths[rows], sum_logprob[rows]


def _generator(seed: int, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def _pick(logits, temperature: float, generator):
    """Next token and its log probability under log_softmax(logits).
    T > 0: Gumbel-max over logits / T (a draw from softmax(logits / T), as
    jax.random.categorical); T = 0: argmax."""
    logp = torch.log_softmax(logits, dim=-1)
    if temperature > 0:
        u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
        tok = torch.argmax(logits / temperature + gumbel, dim=-1)
    else:
        tok = torch.argmax(logits, dim=-1)
    return tok, torch.gather(logp, 1, tok[:, None])[:, 0]


@torch.inference_mode()
def sample_decode(model: WhisperModel, mel, cfg: WhisperConfig, prompt, seed: int = 0, temperature: float = 1.0,
                  max_tokens: int = None, best_of: int = 1):
    """Temperature sampling decode (the fallback chain's T > 0 decoder;
    argmax at T = 0). best_of > 1 draws that many candidates per utterance
    and keeps the one of highest average log probability; the encoder and
    the prompt run once per utterance, only the sampling loop is tiled to
    B*best_of rows. `seed` seeds the sampler's torch.Generator. Returns
    (tokens (B, max_tokens), lengths (B,), sum_logprob (B,))."""
    B = mel.shape[0]
    max_tokens = max_tokens or (cfg.n_text_ctx - len(prompt) - 1)
    logits, caches, cross_kvs = _prompt_forward(model, mel, cfg, prompt)
    n = best_of if temperature > 0 else 1
    if n > 1:
        logits, caches, cross_kvs = _tile_rows(logits, n), _tile_rows(caches, n), _tile_rows(cross_kvs, n)
    gen = _generator(seed, mel.device) if temperature > 0 else None
    tok, acc = _pick(logits, temperature, gen)
    done = tok == cfg.eot
    tokens = torch.empty((B * n, max_tokens), dtype=torch.int64, device=mel.device)
    tokens[:, 0] = tok
    for i in range(1, max_tokens):
        logits, caches = _decode_step(model, tok[:, None], len(prompt) + i - 1, caches, cross_kvs, cfg)
        nxt, lp = _pick(logits, temperature, gen)
        tok = torch.where(done, cfg.eot, nxt)
        acc = acc + torch.where(done, 0.0, lp)
        done = done | (tok == cfg.eot)
        tokens[:, i] = tok
    lengths = torch.sum(tokens != cfg.eot, dim=1)
    if n > 1:
        return _best_of_select(tokens, lengths, acc, B, n)
    return tokens, lengths, acc


def _top_k(x, k: int):
    """Top k along the last axis, descending, ties to the lower index (as
    jax.lax.top_k): a stable sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _reorder_caches_(caches, rows):
    """caches[i][key] = caches[i][key][rows], written in place."""
    for c in caches:
        for t in c.values():
            t.copy_(t.index_select(0, rows))


@torch.inference_mode()
def beam_decode(model: WhisperModel, mel, cfg: WhisperConfig, prompt, beam_size: int = 5, max_tokens: int = None,
                length_penalty: float = None):
    """Batched beam search, beams folded into the batch (B*K rows). The
    encoder and the prompt run on B rows and their state is tiled to the
    beams (the same values as running them on B*K copies). Finished beams
    extend only with eot at no cost; the best beam is chosen by score /
    (length + 1), or the length penalty. Returns the best beam per
    utterance: (tokens (B, max_tokens), lengths (B,), scores (B,))."""
    B, K = mel.shape[0], beam_size
    dev = mel.device
    max_tokens = max_tokens or (cfg.n_text_ctx - len(prompt) - 1)
    logits, caches, cross_kvs = _prompt_forward(model, mel, cfg, prompt)
    caches, cross_kvs = _tile_rows(caches, K), _tile_rows(cross_kvs, K)
    V = logits.shape[-1]
    scores, first = _top_k(torch.log_softmax(logits, dim=-1), K)  # (B, K): only beam 0 is live
    hist = torch.full((B, K, max_tokens), cfg.eot, dtype=torch.int64, device=dev)
    hist[:, :, 0] = first
    finished = first == cfg.eot
    eot_only = torch.where(torch.arange(V, device=dev) == cfg.eot, 0.0, L._NEG)
    base = (torch.arange(B, device=dev) * K)[:, None]
    for i in range(1, max_tokens):
        token = hist[:, :, i - 1].reshape(B * K, 1)
        logits, caches = _decode_step(model, token, len(prompt) + i - 1, caches, cross_kvs, cfg)
        logp = torch.log_softmax(logits.reshape(B, K, V), dim=-1)
        logp = torch.where(finished[..., None], eot_only, logp)
        scores, idx = _top_k((scores[..., None] + logp).reshape(B, K * V), K)
        src = idx // V
        new_tok = idx % V
        hist = torch.gather(hist, 1, src[..., None].expand(B, K, max_tokens))
        hist[:, :, i] = new_tok
        finished = torch.gather(finished, 1, src) | (new_tok == cfg.eot)
        _reorder_caches_(caches, (src + base).reshape(-1))
    lengths = torch.sum(hist != cfg.eot, dim=2)  # (B, K)
    lf = lengths.to(torch.float32)
    norm = lf + 1.0 if length_penalty is None else ((5.0 + lf) / 6.0) ** length_penalty
    best = torch.argmax(scores / norm, dim=1)
    rows = torch.arange(B, device=dev)
    return hist[rows, best], lengths[rows, best], scores[rows, best]


# --- long-form window decode (openai-whisper transcribe-loop semantics) ----


def _decode_step_padded(model: WhisperModel, token, pos_idx, slot: int, pad_len, caches, cross_kvs, cfg: WhisperConfig):
    """Cached decoder step with per-row positions and left padding: token
    (B, 1) is written at cache slot `slot`; its positional-embedding index
    is pos_idx (B,) (slot - pad_len, clipped to the table); attention skips
    the pad_len (B,) unused left slots."""
    B = token.shape[0]
    pos_emb = model.decoder.positional_embedding[torch.clamp(pos_idx, 0, cfg.n_text_ctx - 1)][:, None, :]
    bounds = (pad_len.to(torch.int32), torch.full((B,), slot, dtype=torch.int32, device=token.device))
    return _step(model, token, pos_emb, bounds, slot, caches, cross_kvs, cfg)


def _apply_decode_rules(logits, cfg: WhisperConfig, *, with_timestamps: bool, is_first: bool,
                        last_was_ts=None, penult_was_ts=None, max_ts=None, max_initial_timestamp_index: int = 50):
    """openai-whisper's logit filters (SuppressTokens + ApplyTimestampRules)
    per row. The state arguments are (B,) tensors; the flags are Python
    booleans. Returns new logits."""
    V = logits.shape[-1]
    ids = torch.arange(V, device=logits.device)
    neg = L._NEG
    logits = logits.clone()
    for t in (cfg.sot, cfg.sot_prev, cfg.no_speech, cfg.no_timestamps):
        if t < V:
            logits[:, t] = neg
    is_ts = ids >= cfg.timestamp_begin
    if not with_timestamps:
        return torch.where(is_ts[None, :], neg, logits)
    text_tok = ~is_ts & (ids != cfg.eot)
    if is_first:
        # the first sampled token is a timestamp, at most max_initial_timestamp_index
        logits = torch.where(~is_ts[None, :], neg, logits)
        logits = torch.where(ids[None, :] > cfg.timestamp_begin + max_initial_timestamp_index, neg, logits)
    else:
        # timestamps come in pairs: after <ts><ts> text; after one <ts>, a timestamp or eot
        pair_done = last_was_ts & penult_was_ts
        pair_open = last_was_ts & ~penult_was_ts
        logits = torch.where(pair_done[:, None] & is_ts[None, :], neg, logits)
        logits = torch.where(pair_open[:, None] & text_tok[None, :], neg, logits)
        # monotonic: a closing timestamp may equal the opening one, others increase
        min_allowed = max_ts + torch.where(pair_open, 0, 1)
        ts_offset = ids - cfg.timestamp_begin
        logits = torch.where(is_ts[None, :] & (ts_offset[None, :] < min_allowed[:, None]), neg, logits)
    # when the timestamps together outweigh every single text token, sample a timestamp
    logp = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(torch.where(is_ts[None, :], logp, neg), dim=-1)
    max_text = torch.amax(torch.where(is_ts[None, :], neg, logp), dim=-1)
    force_ts = ts_logprob > max_text
    return torch.where(force_ts[:, None] & ~is_ts[None, :], neg, logits)


def host_array(a) -> np.ndarray:
    """A host array of `a` (numpy, list or tensor; a device tensor is copied)."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def window_prompt_forward(model: WhisperModel, mel, prompt, prompt_len, cfg: WhisperConfig, sot_distance: int):
    """The teacher-forced half of decode_window: encoder, cross K/V and the
    right-aligned prompt buffer (B, P) through fresh caches. Returns
    (last logits (B, V), no-speech probe logits (B, V), pad_len (B,) on
    the device, caches, cross_kvs).

    Slots j < pad_len[b] are inert for row b (their queries see an empty
    range, their K/V are never attended, their logits never read), so the
    loop starts at the smallest pad_len of the batch: the same function as
    running every slot, without paying for the padding."""
    dev = mel.device
    prompt = torch.as_tensor(host_array(prompt), device=dev).to(torch.int64)
    B, P = prompt.shape
    pad_host = P - host_array(prompt_len).astype(np.int64).reshape(B)
    pad_len = torch.as_tensor(pad_host, dtype=torch.int32).to(dev)
    cross_kvs = precompute_cross_kv(model, encode(model, mel, cfg), cfg)
    caches = init_cache(cfg, B, device=dev, model=model)
    sot_slot = P - sot_distance
    probe = logits = None
    for j in range(min(int(pad_host.min()), sot_slot, P - 1), P):
        logits, caches = _decode_step_padded(model, prompt[:, j : j + 1], j - pad_len, j, pad_len, caches, cross_kvs, cfg)
        if j == sot_slot:
            probe = logits
    return logits, probe, pad_len, caches, cross_kvs


@torch.inference_mode()
def decode_window(model: WhisperModel, mel, prompt, prompt_len, cfg: WhisperConfig, *, sot_distance: int,
                  max_tokens: int, with_timestamps: bool = False, temperature: float = 0.0, seed: int = 0,
                  max_initial_timestamp_index: int = 50, best_of: int = 1):
    """One 30 s window of the long-form loop, on the device.

    mel: (B, n_mels, T). prompt: (B, P) ints (array or tensor), RIGHT-aligned (slots
    [P - prompt_len[b], P) hold [<sot_prev> previous text...] + the sot
    sequence; the left slots are padding). prompt_len: (B,) host ints.
    sot_distance: the sot token's distance from the buffer end (=
    len(sot_sequence)); its logits give the no-speech probability. At T > 0
    best_of candidates are sampled per row (seeded by `seed`) and the best
    kept; the probe stays per utterance.

    Returns (tokens (B, max_tokens), lengths, sum_logprob, no_speech_prob):
    the generated ids (timestamps included when with_timestamps),
    eot-padded."""
    B, P = prompt.shape
    if P + max_tokens > cfg.n_text_ctx:
        raise ValueError(f"prompt buffer {P} + budget {max_tokens} exceeds the text context {cfg.n_text_ctx}")
    last, probe, pad_len, caches, cross_kvs = window_prompt_forward(model, mel, prompt, prompt_len, cfg, sot_distance)
    no_speech_prob = torch.softmax(probe, dim=-1)[:, cfg.no_speech]
    n = best_of if temperature > 0 else 1
    if n > 1:
        caches, cross_kvs = _tile_rows(caches, n), _tile_rows(cross_kvs, n)
        last, pad_len = _tile_rows(last, n), _tile_rows(pad_len, n)
    gen = _generator(seed, mel.device) if temperature > 0 else None
    ts0 = cfg.timestamp_begin
    first_logits = _apply_decode_rules(last, cfg, with_timestamps=with_timestamps, is_first=True,
                                       max_initial_timestamp_index=max_initial_timestamp_index)
    tok, acc = _pick(first_logits, temperature, gen)
    done = tok == cfg.eot
    # with fewer than two sampled tokens the penultimate counts as a
    # timestamp, so the token right after the initial <ts> is text
    last_was_ts = (tok >= ts0) & ~done
    penult_was_ts = torch.ones_like(done)
    max_ts = torch.where(last_was_ts, tok - ts0, 0)
    tokens = torch.empty((B * n, max_tokens), dtype=torch.int64, device=mel.device)
    tokens[:, 0] = tok
    for i in range(1, max_tokens):
        slot = P + i - 1
        logits, caches = _decode_step_padded(model, tok[:, None], slot - pad_len, slot, pad_len, caches, cross_kvs, cfg)
        logits = _apply_decode_rules(logits, cfg, with_timestamps=with_timestamps, is_first=False,
                                     last_was_ts=last_was_ts, penult_was_ts=penult_was_ts, max_ts=max_ts)
        nxt, lp = _pick(logits, temperature, gen)
        tok = torch.where(done, cfg.eot, nxt)
        acc = acc + torch.where(done, 0.0, lp)
        tok_is_ts = (tok >= ts0) & ~done
        penult_was_ts = last_was_ts & ~done
        last_was_ts = tok_is_ts
        max_ts = torch.where(tok_is_ts, tok - ts0, max_ts)
        done = done | (tok == cfg.eot)
        tokens[:, i] = tok
    lengths = torch.sum(tokens != cfg.eot, dim=1)
    if n > 1:
        tokens, lengths, acc = _best_of_select(tokens, lengths, acc, B, n)
    return tokens, lengths, acc, no_speech_prob
