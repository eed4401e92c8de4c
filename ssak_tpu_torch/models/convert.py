"""ssak_tpu parameter trees <-> the port's modules.

Takes the JAX package's Whisper, wav2vec2 or Conformer parameter tree with
numpy (or array-like) leaves — as from `init_params`, `quantize_params`, a
checkpoint or a NeMo archive — and builds a `WhisperModel`,
`Wav2Vec2Model` or `ConformerModel`; a CTC model also goes back to such a
tree (`wav2vec2_to_tree`, `conformer_to_tree`, or `ctc_to_tree` for either),
and so does a Whisper model (`whisper_to_tree`, with its LoRA leaves),
which is how training checkpoints keep ssak_tpu's layout. Dense kernels
(in, out) become torch-layout (out, in) weights, conv kernels (K, Cin,
Cout) become (Cout, Cin, K), 2-D conv kernels (KH, KW, Cin, Cout) become
(Cout, Cin, KH, KW);
quantized leaves, int8 {"q8", "scale"} and int4 {"q4", "scale"}, are
carried as they are (QuantLinear keeps ssak_tpu's (in, out) layout).
"""

import numpy as np
import torch

from ssak_tpu_torch.models import conformer as C
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import wav2vec2 as W2V
from ssak_tpu_torch.models import whisper as W


def _t(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def linear_from_tree(p, device) -> torch.nn.Module:
    """A dense dict -> Linear, or QuantLinear for a quantized kernel; its
    lora_A / lora_B / lora_scale leaves, when present, become the layer's
    adapter (models.lora) in their own dtype."""
    k = p["kernel"]
    bias = p.get("bias")
    bias = None if bias is None else _t(bias, device)
    if isinstance(k, dict):
        q = k["q8"] if "q8" in k else k["q4"]
        out = L.QuantLinear(_t(q, device).contiguous(), _t(k["scale"], device).contiguous(), bias)
    else:
        out = L.Linear(_t(np.asarray(k).T, device), bias)
    if "lora_A" in p:
        out.set_lora(_t(p["lora_A"], device), _t(p["lora_B"], device), _t(p.get("lora_scale", 1.0), device))
    return out


def ln_from_tree(p, device) -> L.LayerNorm:
    return L.LayerNorm(_t(p["scale"], device), _t(p["bias"], device))


def conv_from_tree(p, device) -> L.Conv1d:
    bias = p.get("bias")
    return L.Conv1d(_t(np.asarray(p["kernel"]).transpose(2, 1, 0), device), None if bias is None else _t(bias, device))


def attn_from_tree(p, device) -> L.MultiHeadAttention:
    return L.MultiHeadAttention(linear_from_tree(p["out"], device),
                                **{n: linear_from_tree(p[n], device) for n in ("query", "key", "value")})


def _block(p, device) -> W.ResidualAttentionBlock:
    extra = {}
    if "cross_attn" in p:
        extra = dict(cross_attn_ln=ln_from_tree(p["cross_attn_ln"], device), cross_attn=attn_from_tree(p["cross_attn"], device))
    mlp = L.MLP(linear_from_tree(p["mlp"]["fc1"], device), linear_from_tree(p["mlp"]["fc2"], device))
    return W.ResidualAttentionBlock(ln_from_tree(p["attn_ln"], device), attn_from_tree(p["attn"], device),
                                    ln_from_tree(p["mlp_ln"], device), mlp, **extra)


def whisper_from_tree(params, device="cpu") -> W.WhisperModel:
    """ssak_tpu Whisper tree (list-of-blocks layout) -> WhisperModel on `device`."""
    enc, dec = params["encoder"], params["decoder"]
    if isinstance(dec["blocks"], dict):
        raise ValueError("layer-stacked trees (stack_decoder_blocks) are not supported; pass the list layout")
    encoder = W.AudioEncoder(
        conv_from_tree(enc["conv1"], device), conv_from_tree(enc["conv2"], device),
        [_block(b, device) for b in enc["blocks"]], ln_from_tree(enc["ln_post"], device),
    )
    decoder = W.TextDecoder(
        _t(dec["token_embedding"], device), _t(dec["positional_embedding"], device),
        [_block(b, device) for b in dec["blocks"]], ln_from_tree(dec["ln"], device),
    )
    return W.WhisperModel(encoder, decoder)


# --- wav2vec2 ------------------------------------------------------------------------


def wav2vec2_from_tree(params, device="cpu") -> W2V.Wav2Vec2Model:
    """ssak_tpu wav2vec2 tree (`wav2vec2.init_params` layout) -> Wav2Vec2Model."""
    blocks_t = params["encoder"]["blocks"]
    if isinstance(blocks_t, dict):
        raise ValueError("layer-stacked trees are not supported; pass the list layout")
    if any("moe" in b for b in blocks_t):
        raise NotImplementedError("wav2vec2 with a Mixture-of-Experts FFN is not ported yet (comes with parallel/, ROADMAP.md)")
    convs = []
    for c in params["feature_extractor"]["convs"]:
        norms = {k: ln_from_tree(c[k], device) for k in ("layer_norm", "group_norm") if k in c}
        convs.append(W2V.ConvLayer(conv_from_tree(c["conv"], device), **norms))
    blocks = []
    for b in blocks_t:
        mlp = L.MLP(linear_from_tree(b["mlp"]["fc1"], device), linear_from_tree(b["mlp"]["fc2"], device))
        adapter = None
        if "adapter" in b:
            a = b["adapter"]
            adapter = W2V.Adapter(ln_from_tree(a["norm"], device), linear_from_tree(a["down"], device),
                                  linear_from_tree(a["up"], device))
        blocks.append(W2V.EncoderBlock(attn_from_tree(b["attn"], device), ln_from_tree(b["attn_ln"], device),
                                       ln_from_tree(b["mlp_ln"], device), mlp, adapter))
    fp, enc = params["feature_projection"], params["encoder"]
    return W2V.Wav2Vec2Model(
        convs,
        W2V.FeatureProjection(ln_from_tree(fp["layer_norm"], device), linear_from_tree(fp["projection"], device)),
        W2V.Encoder(conv_from_tree(enc["pos_conv"], device), ln_from_tree(enc["layer_norm"], device), blocks),
        linear_from_tree(params["lm_head"], device),
    )


def _np(t):
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _np_as_is(t):
    """A tensor as numpy in its own dtype (bf16, which numpy lacks, as f32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _dense_to_tree(p) -> dict:
    """Linear or QuantLinear -> ssak_tpu's dense dict in the leaves' own
    dtypes: kernel (in, out), or the quantized {q8 | q4, scale}; bias and
    the LoRA leaves where present."""
    if isinstance(p, L.QuantLinear):
        out = {"kernel": {"q4" if p.bits == 4 else "q8": _np_as_is(p.payload), "scale": _np_as_is(p.scale)}}
    else:
        out = {"kernel": _np_as_is(p.weight).T.copy()}
    if p.bias is not None:
        out["bias"] = _np_as_is(p.bias)
    for leaf in ("lora_A", "lora_B", "lora_scale"):
        if getattr(p, leaf) is not None:
            out[leaf] = _np_as_is(getattr(p, leaf))
    return out


def _whisper_block_to_tree(b) -> dict:
    def attn(a):
        return {n: _dense_to_tree(getattr(a, n)) for n in ("query", "key", "value", "out")}

    def ln(p):
        return {"scale": _np_as_is(p.scale), "bias": _np_as_is(p.bias)}

    out = {"attn_ln": ln(b.attn_ln), "attn": attn(b.attn), "mlp_ln": ln(b.mlp_ln),
           "mlp": {"fc1": _dense_to_tree(b.mlp.fc1), "fc2": _dense_to_tree(b.mlp.fc2)}}
    if hasattr(b, "cross_attn"):
        out["cross_attn_ln"], out["cross_attn"] = ln(b.cross_attn_ln), attn(b.cross_attn)
    return out


def whisper_to_tree(model) -> dict:
    """WhisperModel -> ssak_tpu Whisper tree (list-of-blocks layout) with
    numpy leaves in the model's dtypes (bf16 as f32): dense kernels (in,
    out), quantized kernels as {q8 | q4, scale}, conv kernels (K, Cin,
    Cout), LoRA leaves where present. The inverse of whisper_from_tree; a
    model whose decoder q/k/v were fused for decoding has no such tree."""
    enc, dec = model.encoder, model.decoder
    if any(hasattr(b.attn, "qkv") for b in list(enc.blocks) + list(dec.blocks)):
        raise ValueError("whisper_to_tree: fused q/k/v projections (fuse_decode_qkv) have no ssak_tpu tree")

    def conv(p):
        return {"kernel": _np_as_is(p.weight).transpose(2, 1, 0).copy(), "bias": _np_as_is(p.bias)}

    return {
        "encoder": {"conv1": conv(enc.conv1), "conv2": conv(enc.conv2),
                    "blocks": [_whisper_block_to_tree(b) for b in enc.blocks],
                    "ln_post": {"scale": _np_as_is(enc.ln_post.scale), "bias": _np_as_is(enc.ln_post.bias)}},
        "decoder": {"token_embedding": _np_as_is(dec.token_embedding),
                    "positional_embedding": _np_as_is(dec.positional_embedding),
                    "blocks": [_whisper_block_to_tree(b) for b in dec.blocks],
                    "ln": {"scale": _np_as_is(dec.ln.scale), "bias": _np_as_is(dec.ln.bias)}},
    }


def _linear_to_tree(p):
    out = {"kernel": _np(p.weight).T.copy()}
    if p.bias is not None:
        out["bias"] = _np(p.bias)
    return out


def _ln_to_tree(p):
    return {"scale": _np(p.scale), "bias": _np(p.bias)}


def _conv_to_tree(p):
    out = {"kernel": _np(p.weight).transpose(2, 1, 0).copy()}
    if p.bias is not None:
        out["bias"] = _np(p.bias)
    return out


def wav2vec2_to_tree(model) -> dict:
    """Wav2Vec2Model -> ssak_tpu wav2vec2 tree with f32 numpy leaves (dense
    kernels (in, out), conv kernels (K, Cin/groups, Cout))."""
    convs = []
    for c in model.feature_extractor:
        layer = {"conv": _conv_to_tree(c.conv)}
        if c.layer_norm is not None:
            layer["layer_norm"] = _ln_to_tree(c.layer_norm)
        if c.group_norm is not None:
            layer["group_norm"] = _ln_to_tree(c.group_norm)
        convs.append(layer)
    blocks = []
    for b in model.encoder.blocks:
        blk = {
            "attn": {n: _linear_to_tree(getattr(b.attn, n)) for n in ("query", "key", "value", "out")},
            "attn_ln": _ln_to_tree(b.attn_ln),
            "mlp_ln": _ln_to_tree(b.mlp_ln),
            "mlp": {"fc1": _linear_to_tree(b.mlp.fc1), "fc2": _linear_to_tree(b.mlp.fc2)},
        }
        if b.adapter is not None:
            blk["adapter"] = {"norm": _ln_to_tree(b.adapter.norm), "down": _linear_to_tree(b.adapter.down),
                              "up": _linear_to_tree(b.adapter.up)}
        blocks.append(blk)
    fp = model.feature_projection
    return {
        "feature_extractor": {"convs": convs},
        "feature_projection": {"layer_norm": _ln_to_tree(fp.layer_norm), "projection": _linear_to_tree(fp.projection)},
        "encoder": {"pos_conv": _conv_to_tree(model.encoder.pos_conv), "layer_norm": _ln_to_tree(model.encoder.layer_norm),
                    "blocks": blocks},
        "lm_head": _linear_to_tree(model.lm_head),
    }


# --- conformer -------------------------------------------------------------------------


def _mlp_from_tree(p, device) -> L.MLP:
    return L.MLP(linear_from_tree(p["fc1"], device), linear_from_tree(p["fc2"], device))


def _sub_conv_from_tree(p, device):
    k = np.asarray(p["kernel"])
    if k.ndim == 4:  # striding2d: HWIO -> OIHW
        return C.Conv2d(_t(k.transpose(3, 2, 0, 1), device), _t(p["bias"], device))
    return conv_from_tree(p, device)


def conformer_from_tree(params, device="cpu") -> C.ConformerModel:
    """ssak_tpu Conformer tree (`conformer.init_params` or
    `hf_loader.load_nemo_conformer` layout) -> ConformerModel on `device`."""
    sub = params["subsampling"]
    blocks = []
    for b in params["blocks"]:
        a = b["attn"]
        proj = {n: linear_from_tree(a[n], device) for n in ("out", "query", "key", "value")}
        if "linear_pos" in a:
            attn = C.RelPosAttention(**proj, linear_pos=linear_from_tree(a["linear_pos"], device),
                                     pos_bias_u=_t(a["pos_bias_u"], device), pos_bias_v=_t(a["pos_bias_v"], device))
        else:
            attn = L.MultiHeadAttention(**proj)
        c = b["conv"]
        conv = C.ConvModule(linear_from_tree(c["pointwise1"], device), conv_from_tree(c["depthwise"], device),
                            ln_from_tree(c["bn"], device), linear_from_tree(c["pointwise2"], device))
        blocks.append(C.ConformerBlock(
            ln_from_tree(b["ff1_ln"], device), _mlp_from_tree(b["ff1"], device), ln_from_tree(b["attn_ln"], device), attn,
            ln_from_tree(b["conv_ln"], device), conv, ln_from_tree(b["ff2_ln"], device), _mlp_from_tree(b["ff2"], device),
            ln_from_tree(b["final_ln"], device)))
    subsampling = C.Subsampling(_sub_conv_from_tree(sub["conv1"], device), _sub_conv_from_tree(sub["conv2"], device),
                                linear_from_tree(sub["proj"], device))
    return C.ConformerModel(subsampling, blocks, linear_from_tree(params["lm_head"], device))


def _sub_conv_to_tree(p):
    if isinstance(p, C.Conv2d):
        return {"kernel": _np(p.weight).transpose(2, 3, 1, 0).copy(), "bias": _np(p.bias)}
    return _conv_to_tree(p)


def conformer_to_tree(model) -> dict:
    """ConformerModel -> ssak_tpu Conformer tree with f32 numpy leaves."""
    blocks = []
    for b in model.blocks:
        a = b.attn
        attn = {n: _linear_to_tree(getattr(a, n)) for n in ("query", "key", "value", "out")}
        if isinstance(a, C.RelPosAttention):
            attn.update(linear_pos=_linear_to_tree(a.linear_pos), pos_bias_u=_np(a.pos_bias_u),
                        pos_bias_v=_np(a.pos_bias_v))
        c = b.conv
        blocks.append({
            "ff1_ln": _ln_to_tree(b.ff1_ln),
            "ff1": {"fc1": _linear_to_tree(b.ff1.fc1), "fc2": _linear_to_tree(b.ff1.fc2)},
            "attn_ln": _ln_to_tree(b.attn_ln),
            "attn": attn,
            "conv_ln": _ln_to_tree(b.conv_ln),
            "conv": {"pointwise1": _linear_to_tree(c.pointwise1), "depthwise": _conv_to_tree(c.depthwise),
                     "bn": _ln_to_tree(c.bn), "pointwise2": _linear_to_tree(c.pointwise2)},
            "ff2_ln": _ln_to_tree(b.ff2_ln),
            "ff2": {"fc1": _linear_to_tree(b.ff2.fc1), "fc2": _linear_to_tree(b.ff2.fc2)},
            "final_ln": _ln_to_tree(b.final_ln),
        })
    sub = model.subsampling
    return {
        "subsampling": {"conv1": _sub_conv_to_tree(sub.conv1), "conv2": _sub_conv_to_tree(sub.conv2),
                        "proj": _linear_to_tree(sub.proj)},
        "blocks": blocks,
        "lm_head": _linear_to_tree(model.lm_head),
    }


# --- either CTC family ------------------------------------------------------------------


def ctc_to_tree(model) -> dict:
    """A Wav2Vec2Model or ConformerModel -> its ssak_tpu tree."""
    return conformer_to_tree(model) if isinstance(model, C.ConformerModel) else wav2vec2_to_tree(model)


def _copy_params_(model, src):
    src, dst = dict(src.named_parameters()), dict(model.named_parameters())
    if src.keys() != dst.keys():
        raise ValueError(f"parameter tree does not match the model: {sorted(set(src) ^ set(dst))[:8]}")
    with torch.no_grad():
        for name, p in dst.items():
            if p.shape != src[name].shape:
                raise ValueError(f"{name}: shape {tuple(src[name].shape)} in the tree, {tuple(p.shape)} in the model")
            p.copy_(src[name])
    return model


def load_whisper_tree_(model, params):
    """Copy an ssak_tpu Whisper tree into `model`'s parameters IN PLACE
    (same structure required; each keeps the model's dtype). Returns the
    model."""
    return _copy_params_(model, whisper_from_tree(params, "cpu"))


def load_wav2vec2_tree_(model, params):
    """Copy an ssak_tpu wav2vec2 tree into `model`'s parameters IN PLACE
    (same structure required). Returns the model."""
    return _copy_params_(model, wav2vec2_from_tree(params, "cpu"))


def load_conformer_tree_(model, params):
    """The same for a ConformerModel and an ssak_tpu Conformer tree."""
    return _copy_params_(model, conformer_from_tree(params, "cpu"))


def load_ctc_tree_(model, params):
    """load_conformer_tree_ or load_wav2vec2_tree_, by the model's family."""
    load = load_conformer_tree_ if isinstance(model, C.ConformerModel) else load_wav2vec2_tree_
    return load(model, params)
