"""wav2vec2-style CTC acoustic model in PyTorch.

Counterpart of ssak_tpu.models.wav2vec2: raw-waveform conv feature encoder,
feature projection, transformer encoder with a grouped convolutional
positional embedding, CTC head. Both HF variants: do_stable_layer_norm=False
(base: group norm on conv0, post-LN blocks) and True (large/XLSR: per-conv
layer norm, pre-LN blocks), MMS attention adapters, block rematerialization
(`torch.utils.checkpoint`), and the Mixture-of-Experts FFN (`num_experts >
0`: each block's `moe` in place of its `mlp`, parallel.moe; the per-layer
load-balancing losses collected through `aux_out`). Public functions keep
ssak_tpu's layouts: waveform (B, T), hidden (B, F, D), logits (B, F, V).
HF checkpoints load through `models.hf_loader`.
"""

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from ssak_tpu_torch.models import layers as L


@dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    vocab_size: int = 32
    blank_id: int = 0
    dtype: str = "bfloat16"
    num_experts: int = 0
    moe_top_k: int = 2
    adapter_attn_dim: int = 0
    remat: bool = False

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


PRESETS = {
    "base": dict(),
    "large": dict(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096, do_stable_layer_norm=True, conv_bias=True),
    "xlsr": dict(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096, do_stable_layer_norm=True, conv_bias=True),
    "tiny_test": dict(conv_dim=(32, 32, 32), conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8), hidden_size=64, num_layers=2,
                      num_heads=2, intermediate_size=128, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
                      vocab_size=32),
}


def make_config(name: str = "base", **overrides) -> Wav2Vec2Config:
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return Wav2Vec2Config(**kw)


def feature_extract_output_length(cfg: Wav2Vec2Config, input_length):
    """Frames the conv stack produces for a waveform length (int or tensor;
    floor division, so 1 sample gives -1 frames at the base strides)."""
    n = input_length
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n


# --- modules (parameter containers) ------------------------------------------------


class ConvLayer(nn.Module):
    """One conv of the feature encoder with its optional norm (layer_norm on
    every conv for the stable variant, group_norm on conv0 for base)."""

    def __init__(self, conv, layer_norm=None, group_norm=None):
        super().__init__()
        self.conv = conv
        self.layer_norm = layer_norm
        self.group_norm = group_norm


class FeatureProjection(nn.Module):
    def __init__(self, layer_norm, projection):
        super().__init__()
        self.layer_norm, self.projection = layer_norm, projection


class Adapter(nn.Module):
    """MMS attention adapter: LN -> down -> relu -> up, residual."""

    def __init__(self, norm, down, up):
        super().__init__()
        self.norm, self.down, self.up = norm, down, up


class EncoderBlock(nn.Module):
    """attention, norms and the FFN: `mlp`, or with experts `moe` (mlp None)."""

    def __init__(self, attn, attn_ln, mlp_ln, mlp, adapter=None, moe=None):
        super().__init__()
        self.attn, self.attn_ln, self.mlp_ln, self.mlp = attn, attn_ln, mlp_ln, mlp
        self.adapter = adapter
        self.moe = moe


class Encoder(nn.Module):
    def __init__(self, pos_conv, layer_norm, blocks):
        super().__init__()
        self.pos_conv, self.layer_norm = pos_conv, layer_norm
        self.blocks = nn.ModuleList(blocks)


class Wav2Vec2Model(nn.Module):
    """classifier: an optional dense head over the mean-pooled hidden states
    (ssak_tpu's 'classifier' leaf; utils.gender.classify_speech)."""

    def __init__(self, convs, feature_projection, encoder, lm_head, classifier=None):
        super().__init__()
        self.feature_extractor = nn.ModuleList(convs)
        self.feature_projection = feature_projection
        self.encoder = encoder
        self.lm_head = lm_head
        self.classifier = classifier


def init_params(cfg: Wav2Vec2Config, seed: int = 0, device="cpu") -> Wav2Vec2Model:
    """A seeded model: dense N(0, 1/d_in), conv N(0, 1/fan_in), zero biases,
    unit norms (ssak_tpu's initializers, on a torch.Generator); with
    experts, parallel.moe.moe_init's in place of each mlp."""
    gen = torch.Generator().manual_seed(seed)
    D = cfg.hidden_size
    convs, c_in = [], 1
    for i, (c_out, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        conv = L.conv_init(gen, k, c_in, c_out, bias=cfg.conv_bias)
        if cfg.do_stable_layer_norm:
            convs.append(ConvLayer(conv, layer_norm=L.ln_init(c_out)))
        else:
            convs.append(ConvLayer(conv, group_norm=L.ln_init(c_out) if i == 0 else None))
        c_in = c_out
    blocks = []
    for _ in range(cfg.num_layers):
        attn = L.MultiHeadAttention(L.linear_init(gen, D, D), query=L.linear_init(gen, D, D),
                                    key=L.linear_init(gen, D, D), value=L.linear_init(gen, D, D))
        mlp = moe = None
        if cfg.num_experts:
            from ssak_tpu_torch.parallel.moe import moe_init

            moe = moe_init(gen, D, cfg.intermediate_size, cfg.num_experts)
        else:
            mlp = L.MLP(L.linear_init(gen, D, cfg.intermediate_size), L.linear_init(gen, cfg.intermediate_size, D))
        adapter = None
        if cfg.adapter_attn_dim:
            adapter = Adapter(L.ln_init(D), L.linear_init(gen, D, cfg.adapter_attn_dim), L.linear_init(gen, cfg.adapter_attn_dim, D))
        blocks.append(EncoderBlock(attn, L.ln_init(D), L.ln_init(D), mlp, adapter, moe))
    model = Wav2Vec2Model(
        convs,
        FeatureProjection(L.ln_init(cfg.conv_dim[-1]), L.linear_init(gen, cfg.conv_dim[-1], D)),
        Encoder(L.conv_init(gen, cfg.num_conv_pos_embeddings, D, D, bias=True, groups=cfg.num_conv_pos_embedding_groups),
                L.ln_init(D), blocks),
        L.linear_init(gen, D, cfg.vocab_size),
    )
    return model.to(device)


# --- forward -----------------------------------------------------------------------------


def feature_extractor(model, waveform, cfg: Wav2Vec2Config):
    """waveform: (B, T) -> (B, frames, C). VALID conv stack with GELU."""
    dt = cfg.compute_dtype
    x = waveform[..., None]
    for i, layer in enumerate(model.feature_extractor):
        x = L.conv1d(x, layer.conv, stride=cfg.conv_stride[i], padding=(0, 0), dtype=dt)
        if layer.layer_norm is not None:
            x = L.layer_norm(x, layer.layer_norm)
        elif layer.group_norm is not None:
            x = L.group_norm(x, layer.group_norm, num_groups=x.shape[-1])
        x = L.gelu(x)
    return x


def _adapt(blk, x, dt):
    if blk.adapter is None:
        return x
    a = blk.adapter
    h = L.dense(L.layer_norm(x, a.norm), a.down, dt)
    h = torch.relu(h.to(torch.float32)).to(dt)
    return x + L.dense(h, a.up, dt)


def _attend(blk, x, frame_lengths, cfg):
    """The layer's self-attention: layers.mha (L1 where it routes there)."""
    return L.mha(x, blk.attn, cfg.num_heads, lengths=frame_lengths, dtype=cfg.compute_dtype)[0]


def _ffn(blk, x, cfg, aux_out, data_group):
    dt = cfg.compute_dtype
    if blk.moe is None:
        return L.mlp(x, blk.mlp, dtype=dt)
    from ssak_tpu_torch.parallel.moe import moe_mlp

    y, aux = moe_mlp(x, blk.moe, top_k=cfg.moe_top_k, dtype=dt, data_group=data_group)
    if aux_out is not None:
        aux_out.append(aux)
    return y


def _block_stable(blk, x, frame_lengths, cfg, aux_out=None, data_group=None, attend=_attend):
    dt = cfg.compute_dtype
    x = x + attend(blk, L.layer_norm(x, blk.attn_ln), frame_lengths, cfg)
    x = x + _ffn(blk, L.layer_norm(x, blk.mlp_ln), cfg, aux_out, data_group)
    return _adapt(blk, x, dt)


def _block_post(blk, x, frame_lengths, cfg, aux_out=None, data_group=None, attend=_attend):
    dt = cfg.compute_dtype
    x = L.layer_norm(x + attend(blk, x, frame_lengths, cfg), blk.attn_ln)
    x = L.layer_norm(x + _ffn(blk, x, cfg, aux_out, data_group), blk.mlp_ln)
    return _adapt(blk, x, dt)


def block_fn(cfg: Wav2Vec2Config):
    """One transformer-encoder layer of either variant, fn(blk, x,
    frame_lengths, cfg, aux_out=None, data_group=None, attend=...) -> x:
    the body of `encode`, of parallel.pipeline's stages and of
    parallel.sequence's time-sharded encoder, which passes its own
    `attend(blk, x, frame_lengths, cfg)`. data_group: the data-parallel
    ranks an MoE layer routes over (parallel.moe.moe_mlp)."""
    return _block_stable if cfg.do_stable_layer_norm else _block_post


def embed(model, waveform, cfg: Wav2Vec2Config, lengths=None, time_mask=None, freeze_feature_encoder=False):
    """The encoder before its transformer blocks: conv stack, feature
    projection, padding zeroed, convolutional positional embedding ->
    (x (B, F, D), frame_lengths (B,) int32)."""
    dt = cfg.compute_dtype
    if freeze_feature_encoder:
        with torch.no_grad():
            feats = feature_extractor(model, waveform, cfg)
    else:
        feats = feature_extractor(model, waveform, cfg)
    fp = model.feature_projection
    x = L.dense(L.layer_norm(feats, fp.layer_norm), fp.projection, dt)
    if time_mask is not None:
        x = torch.where(time_mask[:, : x.shape[1], None], 0.0, x)

    B, F = x.shape[0], x.shape[1]
    if lengths is not None:
        frame_lengths = feature_extract_output_length(cfg, torch.as_tensor(lengths, device=x.device).long()).to(torch.int32)
    else:
        frame_lengths = torch.full((B,), F, dtype=torch.int32, device=x.device)
    pad_mask = torch.arange(F, device=x.device)[None, :] < frame_lengths[:, None]
    x = torch.where(pad_mask[..., None], x, 0.0)

    # convolutional positional embedding: pad k//2 on both sides, trim one
    # frame when k is even
    k = cfg.num_conv_pos_embeddings
    pos = L.conv1d(x, model.encoder.pos_conv, stride=1, padding=(k // 2, k // 2),
                   groups=cfg.num_conv_pos_embedding_groups, dtype=dt)
    if k % 2 == 0:
        pos = pos[:, :-1]
    return x + L.gelu(pos), frame_lengths


def encode(model, waveform, cfg: Wav2Vec2Config, lengths=None, time_mask=None, freeze_feature_encoder=False,
           aux_out=None, data_group=None):
    """waveform: (B, T) f32 -> (hidden (B, F, D), frame_lengths (B,)).

    time_mask: optional bool (B, F); masked frames are zeroed after the
    feature projection. freeze_feature_encoder=True runs the conv stack
    without autograd (ssak_tpu's stop_gradient): its weights get no
    gradient and no backward is built for it. aux_out: a list that each
    MoE layer appends its load-balancing loss to. With experts no block is
    rematerialized (as in ssak_tpu: the loss is collected as the layer runs).
    data_group: the data-parallel ranks whose batches make the global one,
    which the MoE layers route over together (None: this batch alone)."""
    x, frame_lengths = embed(model, waveform, cfg, lengths, time_mask, freeze_feature_encoder)
    block = block_fn(cfg)

    def run(blk, x):
        if cfg.remat and not cfg.num_experts and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(block, blk, x, frame_lengths, cfg, use_reentrant=False)
        return block(blk, x, frame_lengths, cfg, aux_out, data_group)

    if cfg.do_stable_layer_norm:
        for blk in model.encoder.blocks:
            x = run(blk, x)
        x = L.layer_norm(x, model.encoder.layer_norm)
    else:
        x = L.layer_norm(x, model.encoder.layer_norm)
        for blk in model.encoder.blocks:
            x = run(blk, x)
    return x, frame_lengths


def ctc_logits(model, waveform, cfg: Wav2Vec2Config, lengths=None, time_mask=None, freeze_feature_encoder=False,
               aux_out=None, data_group=None):
    """Full forward: waveform -> (logits (B, F, V) in the compute dtype, frame_lengths)."""
    hidden, frame_lengths = encode(model, waveform, cfg, lengths, time_mask=time_mask,
                                   freeze_feature_encoder=freeze_feature_encoder, aux_out=aux_out,
                                   data_group=data_group)
    return L.dense(hidden, model.lm_head, cfg.compute_dtype), frame_lengths


def ctc_log_probs(model, waveform, cfg: Wav2Vec2Config, lengths=None, time_mask=None, freeze_feature_encoder=False,
                  aux_out=None, data_group=None):
    """log_softmax in f32 of the logits -> (log_probs (B, F, V), frame_lengths)."""
    logits, fl = ctc_logits(model, waveform, cfg, lengths, time_mask=time_mask,
                            freeze_feature_encoder=freeze_feature_encoder, aux_out=aux_out,
                            data_group=data_group)
    return torch.log_softmax(logits.to(torch.float32), dim=-1), fl
