"""ssak_tpu parameter trees -> the port's modules.

Takes the JAX package's Whisper parameter tree with numpy (or array-like)
leaves — as from `whisper.init_params`, `quantize_params` or a checkpoint —
and builds a `WhisperModel`. Dense kernels (in, out) become torch-layout
(out, in) weights, conv kernels (K, Cin, Cout) become (Cout, Cin, K);
int8 leaves {"q8", "scale"} are carried as they are (QuantLinear keeps
ssak_tpu's (in, out) layout).
"""

import numpy as np
import torch

from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import whisper as W


def _t(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def linear_from_tree(p, device) -> torch.nn.Module:
    k = p["kernel"]
    bias = p.get("bias")
    bias = None if bias is None else _t(bias, device)
    if isinstance(k, dict):
        if "q8" not in k:
            raise NotImplementedError("only int8 quantized leaves are ported (int4 comes with its kernel)")
        return L.QuantLinear(_t(k["q8"], device).contiguous(), _t(k["scale"], device), bias)
    return L.Linear(_t(np.asarray(k).T, device), bias)


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
