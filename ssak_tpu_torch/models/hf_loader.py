"""HuggingFace checkpoints -> ssak_tpu parameter trees (counterpart of the
Whisper and wav2vec2 half of ssak_tpu.models.hf_loader).

A local directory holding config.json and *.safetensors shards (or
*.bin files) becomes the JAX package's parameter tree, with the same numpy
arithmetic, so that both packages give the same leaves bit for bit:
dense weights (out, in) become kernels (in, out), conv weights
(out, in, k) become (k, in, out), a weight-normed positional conv becomes
g * v / max(||v||, 1e-12) over axes (0, 1). `models.convert` builds the
port's modules from the trees.

The safetensors format is read here, with no `safetensors` package: an
8-byte little-endian header length, a JSON header (each tensor's `dtype`,
`shape` and `data_offsets` into the data that follows; `__metadata__`),
then the raw little-endian bytes, memory-mapped so that a large-v3
checkpoint is not copied on the way in. The dtypes are those that
`safetensors.numpy` reads; any other (BF16 included) is refused by name.
*.bin files go through `torch.load(weights_only=True)`.

NeMo Conformer-CTC archives (`load_nemo_conformer`): a .nemo tar, or its
extracted directory, holding model_config.yaml (read by the port's own
`utils.yaml_reader`: the card host has no YAML package) and
model_weights.ckpt (`torch.load(weights_only=True)`), mapped to ssak_tpu's
Conformer tree with the same numpy arithmetic (BatchNorm folded to a
per-channel affine, Conv2d kernels to HWIO).
"""

import json
import os
import struct

import numpy as np

from ssak_tpu_torch.utils.monitoring import logger

# the dtypes safetensors.numpy reads, by their safetensors names
SAFETENSORS_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "U64": np.uint64,
    "I32": np.int32,
    "U32": np.uint32,
    "I16": np.int16,
    "U16": np.uint16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    "C64": np.complex64,
}


def read_safetensors(path: str) -> dict:
    """name -> read-only np.ndarray view of the memory-mapped file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    start = 8 + n
    size = os.path.getsize(path) - start
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=start) if size > 0 else np.zeros(0, np.uint8)
    out = {}
    for name, info in header.items():
        code = info["dtype"]
        if code not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {code}, which is not read "
                             f"(readable: {', '.join(SAFETENSORS_DTYPES)})")
        dtype = np.dtype(SAFETENSORS_DTYPES[code]).newbyteorder("<")
        shape = tuple(int(d) for d in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize or not 0 <= begin <= end <= size:
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} for {shape} {code}")
        out[name] = np.frombuffer(data, dtype=dtype, count=count, offset=begin).reshape(shape)
    return out


def _read_bin(path: str) -> dict:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def _load_state_dict(model_dir: str) -> dict:
    """name -> np.ndarray from the safetensors shards or the *.bin files.
    MMS per-language adapter files (adapter.<lang>.*) are not part of the
    base model: load_wav2vec2_adapter reads them on demand."""
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors") and not f.startswith("adapter."))
    state = {}
    if files:
        for f in files:
            state.update(read_safetensors(os.path.join(model_dir, f)))
        return state
    bins = sorted(f for f in os.listdir(model_dir) if f.endswith(".bin"))
    if bins:
        for f in bins:
            state.update(_read_bin(os.path.join(model_dir, f)))
        return state
    raise FileNotFoundError(f"no *.safetensors or *.bin weights in {model_dir}")


def _strip_prefix(state: dict, prefixes=("model.",)) -> dict:
    out = {}
    for k, v in state.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def load_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        return json.load(f)


def _t(x):  # torch linear weight (out, in) -> kernel (in, out)
    return np.ascontiguousarray(x.T)


def _conv_t(x):  # torch conv1d weight (out, in, k) -> (k, in, out)
    return np.ascontiguousarray(np.transpose(x, (2, 1, 0)))


def _map_attn(sd, pfx):
    p = {
        "query": {"kernel": _t(sd[f"{pfx}.q_proj.weight"]), "bias": sd[f"{pfx}.q_proj.bias"]},
        "key": {"kernel": _t(sd[f"{pfx}.k_proj.weight"])},
        "value": {"kernel": _t(sd[f"{pfx}.v_proj.weight"]), "bias": sd[f"{pfx}.v_proj.bias"]},
        "out": {"kernel": _t(sd[f"{pfx}.out_proj.weight"]), "bias": sd[f"{pfx}.out_proj.bias"]},
    }
    if f"{pfx}.k_proj.bias" in sd:
        p["key"]["bias"] = sd[f"{pfx}.k_proj.bias"]
    return p


def _map_ln(sd, pfx):
    return {"scale": sd[f"{pfx}.weight"], "bias": sd[f"{pfx}.bias"]}


def _map_mlp(sd, fc1, fc2):
    return {"fc1": {"kernel": _t(sd[f"{fc1}.weight"]), "bias": sd[f"{fc1}.bias"]},
            "fc2": {"kernel": _t(sd[f"{fc2}.weight"]), "bias": sd[f"{fc2}.bias"]}}


# --- Whisper ------------------------------------------------------------------------


def whisper_config_from_hf(model_dir: str):
    """The port's WhisperConfig from an HF config.json. As in ssak_tpu, only
    sot and eot come from the file; the other special ids keep the
    config's defaults (a tokenizer supplies them at inference)."""
    from ssak_tpu_torch.models.whisper import WhisperConfig

    c = load_config(model_dir)
    return WhisperConfig(
        n_mels=c["num_mel_bins"],
        n_audio_ctx=c.get("max_source_positions", 1500),
        n_audio_state=c["d_model"],
        n_audio_head=c["encoder_attention_heads"],
        n_audio_layer=c["encoder_layers"],
        n_vocab=c["vocab_size"],
        n_text_ctx=c.get("max_target_positions", 448),
        n_text_state=c["d_model"],
        n_text_head=c["decoder_attention_heads"],
        n_text_layer=c["decoder_layers"],
        sot=c.get("decoder_start_token_id", 50258),
        eot=c.get("eos_token_id", 50257),
    )


def load_whisper(model_dir: str):
    """(ssak_tpu Whisper tree with numpy leaves, WhisperConfig)."""
    cfg = whisper_config_from_hf(model_dir)
    sd = _strip_prefix(_load_state_dict(model_dir))

    def block(pfx, cross):
        p = {"attn_ln": _map_ln(sd, f"{pfx}.self_attn_layer_norm"), "attn": _map_attn(sd, f"{pfx}.self_attn")}
        if cross:
            p["cross_attn_ln"] = _map_ln(sd, f"{pfx}.encoder_attn_layer_norm")
            p["cross_attn"] = _map_attn(sd, f"{pfx}.encoder_attn")
        p["mlp_ln"] = _map_ln(sd, f"{pfx}.final_layer_norm")
        p["mlp"] = _map_mlp(sd, f"{pfx}.fc1", f"{pfx}.fc2")
        return p

    params = {
        "encoder": {
            "conv1": {"kernel": _conv_t(sd["encoder.conv1.weight"]), "bias": sd["encoder.conv1.bias"]},
            "conv2": {"kernel": _conv_t(sd["encoder.conv2.weight"]), "bias": sd["encoder.conv2.bias"]},
            "blocks": [block(f"encoder.layers.{i}", False) for i in range(cfg.n_audio_layer)],
            "ln_post": _map_ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "token_embedding": sd["decoder.embed_tokens.weight"],
            "positional_embedding": sd["decoder.embed_positions.weight"],
            "blocks": [block(f"decoder.layers.{i}", True) for i in range(cfg.n_text_layer)],
            "ln": _map_ln(sd, "decoder.layer_norm"),
        },
    }
    logger.info(f"loaded Whisper from {model_dir}: d={cfg.n_audio_state}, enc={cfg.n_audio_layer}, dec={cfg.n_text_layer}")
    return params, cfg


# --- wav2vec2 -----------------------------------------------------------------------


def wav2vec2_config_from_hf(model_dir: str):
    from ssak_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    c = load_config(model_dir)
    return Wav2Vec2Config(
        conv_dim=tuple(c["conv_dim"]),
        conv_kernel=tuple(c["conv_kernel"]),
        conv_stride=tuple(c["conv_stride"]),
        conv_bias=c.get("conv_bias", False),
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        num_conv_pos_embeddings=c.get("num_conv_pos_embeddings", 128),
        num_conv_pos_embedding_groups=c.get("num_conv_pos_embedding_groups", 16),
        do_stable_layer_norm=c.get("do_stable_layer_norm", False),
        vocab_size=c["vocab_size"],
        blank_id=c.get("pad_token_id", 0),
        adapter_attn_dim=c.get("adapter_attn_dim") or 0,
    )


def _weight_norm_conv(sd, pfx):
    """torch's weight-normed conv: weight = g * v / ||v||, the norm over
    (out, in) (dim=2); both the weight_g / weight_v keys and the
    parametrizations.weight.original0 / original1 form of torch >= 2.1."""
    if f"{pfx}.weight_g" in sd:
        g, v = sd[f"{pfx}.weight_g"], sd[f"{pfx}.weight_v"]
    else:
        g, v = sd[f"{pfx}.parametrizations.weight.original0"], sd[f"{pfx}.parametrizations.weight.original1"]
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(norm, 1e-12)
    return {"kernel": _conv_t(w), "bias": sd[f"{pfx}.bias"]}


def _map_adapter(sd, pfx):
    """HF Wav2Vec2AttnAdapterLayer: norm -> linear_1 (down) -> relu -> linear_2 (up)."""
    return {
        "norm": _map_ln(sd, f"{pfx}.norm"),
        "down": {"kernel": _t(sd[f"{pfx}.linear_1.weight"]), "bias": sd[f"{pfx}.linear_1.bias"]},
        "up": {"kernel": _t(sd[f"{pfx}.linear_2.weight"]), "bias": sd[f"{pfx}.linear_2.bias"]},
    }


def read_wav2vec2_adapter(model_dir: str, language: str, n_layers: int):
    """The trees of an MMS adapter file (adapter.<language>.safetensors, or
    .bin): ({layer index: adapter tree}, lm_head tree or None). Raises
    FileNotFoundError when the checkpoint has no such adapter."""
    path = os.path.join(model_dir, f"adapter.{language}.safetensors")
    if os.path.exists(path):
        sd = read_safetensors(path)
    else:
        path = os.path.join(model_dir, f"adapter.{language}.bin")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no adapter.{language}.safetensors in {model_dir}")
        sd = _read_bin(path)
    sd = _strip_prefix(sd, prefixes=("wav2vec2.",))
    adapters = {}
    for i in range(n_layers):
        pfx = f"encoder.layers.{i}.adapter_layer"
        if f"{pfx}.norm.weight" in sd:
            adapters[i] = _map_adapter(sd, pfx)
    lm_head = {"kernel": _t(sd["lm_head.weight"]), "bias": sd["lm_head.bias"]} if "lm_head.weight" in sd else None
    logger.info(f"loaded {language} adapter from {path}")
    return adapters, lm_head


def load_wav2vec2_adapter(params, model_dir: str, language: str):
    """MMS per-language adapter swap on a wav2vec2 tree: merges
    adapter.<language>.safetensors (the per-layer adapters and, for MMS, the
    language's lm_head) into `params` in place and returns it; raises
    FileNotFoundError when the checkpoint has no such adapter."""
    adapters, lm_head = read_wav2vec2_adapter(model_dir, language, len(params["encoder"]["blocks"]))
    for i, a in adapters.items():
        params["encoder"]["blocks"][i]["adapter"] = a
    if lm_head is not None:
        params["lm_head"] = lm_head
    return params


def load_wav2vec2(model_dir: str):
    """(ssak_tpu wav2vec2 tree with numpy leaves, Wav2Vec2Config); the CTC
    head is in the tree when the checkpoint has one."""
    cfg = wav2vec2_config_from_hf(model_dir)
    sd = _strip_prefix(_load_state_dict(model_dir), prefixes=("wav2vec2.",))

    convs = []
    for i in range(len(cfg.conv_dim)):
        pfx = f"feature_extractor.conv_layers.{i}"
        layer = {"conv": {"kernel": _conv_t(sd[f"{pfx}.conv.weight"])}}
        if f"{pfx}.conv.bias" in sd:
            layer["conv"]["bias"] = sd[f"{pfx}.conv.bias"]
        if f"{pfx}.layer_norm.weight" in sd:
            layer["layer_norm" if cfg.do_stable_layer_norm else "group_norm"] = _map_ln(sd, f"{pfx}.layer_norm")
        convs.append(layer)

    blocks = []
    for i in range(cfg.num_layers):
        pfx = f"encoder.layers.{i}"
        block = {
            "attn": _map_attn(sd, f"{pfx}.attention"),
            "attn_ln": _map_ln(sd, f"{pfx}.layer_norm"),
            "mlp": _map_mlp(sd, f"{pfx}.feed_forward.intermediate_dense", f"{pfx}.feed_forward.output_dense"),
            "mlp_ln": _map_ln(sd, f"{pfx}.final_layer_norm"),
        }
        if f"{pfx}.adapter_layer.norm.weight" in sd:
            block["adapter"] = _map_adapter(sd, f"{pfx}.adapter_layer")
        blocks.append(block)
    params = {
        "feature_extractor": {"convs": convs},
        "feature_projection": {
            "layer_norm": _map_ln(sd, "feature_projection.layer_norm"),
            "projection": {"kernel": _t(sd["feature_projection.projection.weight"]),
                           "bias": sd["feature_projection.projection.bias"]},
        },
        "encoder": {
            "pos_conv": _weight_norm_conv(sd, "encoder.pos_conv_embed.conv"),
            "layer_norm": _map_ln(sd, "encoder.layer_norm"),
            "blocks": blocks,
        },
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": _t(sd["lm_head.weight"]), "bias": sd["lm_head.bias"]}
    logger.info(f"loaded wav2vec2 from {model_dir}: d={cfg.hidden_size}, layers={cfg.num_layers}, vocab={cfg.vocab_size}")
    return params, cfg


# --- NeMo Conformer -------------------------------------------------------------------


def _fold_bn(sd, pfx, eps=1e-5):
    """Eval-mode BatchNorm1d -> per-channel affine {scale, bias}."""
    w, b = sd[f"{pfx}.weight"], sd[f"{pfx}.bias"]
    mean, var = sd[f"{pfx}.running_mean"], sd[f"{pfx}.running_var"]
    scale = w / np.sqrt(var + eps)
    return {"scale": scale.astype(np.float32), "bias": (b - mean * scale).astype(np.float32)}


def _conv2d_t(x):  # torch Conv2d OIHW -> HWIO
    return np.ascontiguousarray(np.transpose(x, (2, 3, 1, 0)))


def nemo_conformer_config(model_cfg: dict):
    """ConformerConfig of a NeMo EncDecCTCModel's model_config dict: rel-pos
    attention, striding2d subsampling, folded BatchNorm, NeMo frontend,
    and NeMo's blank as the LAST class (vocab_size = num_classes + 1)."""
    from ssak_tpu_torch.models.conformer import ConformerConfig

    enc = model_cfg["encoder"]
    dec = model_cfg["decoder"]
    num_classes = dec.get("num_classes", -1)
    if num_classes in (None, -1):
        num_classes = len(dec.get("vocabulary") or model_cfg.get("labels") or [])
    return ConformerConfig(
        n_mels=enc.get("feat_in", 80),
        d_model=enc["d_model"],
        num_layers=enc["n_layers"],
        num_heads=enc.get("n_heads", 4),
        ff_expansion=enc.get("ff_expansion_factor", 4),
        conv_kernel=enc.get("conv_kernel_size", 31),
        vocab_size=num_classes + 1,
        blank_id=num_classes,
        pos_type="relpos",
        subsampling="striding2d",
        conv_norm="affine",
        xscale=bool(enc.get("xscaling", True)),
        frontend="nemo",
    )


def _read_nemo_archive(path: str):
    """(model_config dict, state dict of numpy arrays) of a .nemo tar or a
    directory holding model_config.yaml and model_weights.ckpt."""
    import io
    import tarfile

    import torch

    from ssak_tpu_torch.utils.yaml_reader import safe_load

    if os.path.isdir(path):
        with open(os.path.join(path, "model_config.yaml"), "rb") as f:
            cfg = safe_load(f.read())
        sd = torch.load(os.path.join(path, "model_weights.ckpt"), map_location="cpu", weights_only=True)
    else:
        with tarfile.open(path) as tar:
            names = tar.getnames()

            def member(suffix):
                for n in names:
                    if n.endswith(suffix):
                        return tar.extractfile(n).read()
                raise FileNotFoundError(f"{suffix} not in {path}")

            cfg = safe_load(member("model_config.yaml"))
            sd = torch.load(io.BytesIO(member("model_weights.ckpt")), map_location="cpu", weights_only=True)
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    return cfg, sd


def load_nemo_conformer(path: str):
    """(ssak_tpu Conformer tree with f32 numpy leaves, ConformerConfig,
    vocabulary list) of a NeMo Conformer-CTC archive or extracted directory."""
    model_cfg, sd = _read_nemo_archive(path)
    cfg = nemo_conformer_config(model_cfg)

    def lin(pfx, bias=True):
        out = {"kernel": _t(sd[f"{pfx}.weight"])}
        if bias:
            out["bias"] = sd[f"{pfx}.bias"]
        return out

    def pointwise(pfx):  # Conv1d of kernel 1 -> dense
        return {"kernel": _t(sd[f"{pfx}.weight"][:, :, 0]), "bias": sd[f"{pfx}.bias"]}

    blocks = []
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}"
        blocks.append({
            "ff1_ln": _map_ln(sd, f"{p}.norm_feed_forward1"),
            "ff1": {"fc1": lin(f"{p}.feed_forward1.linear1"), "fc2": lin(f"{p}.feed_forward1.linear2")},
            "attn_ln": _map_ln(sd, f"{p}.norm_self_att"),
            "attn": {
                "query": lin(f"{p}.self_attn.linear_q"),
                "key": lin(f"{p}.self_attn.linear_k"),
                "value": lin(f"{p}.self_attn.linear_v"),
                "out": lin(f"{p}.self_attn.linear_out"),
                "linear_pos": lin(f"{p}.self_attn.linear_pos", bias=False),
                "pos_bias_u": sd[f"{p}.self_attn.pos_bias_u"],
                "pos_bias_v": sd[f"{p}.self_attn.pos_bias_v"],
            },
            "conv_ln": _map_ln(sd, f"{p}.norm_conv"),
            "conv": {
                "pointwise1": pointwise(f"{p}.conv.pointwise_conv1"),
                "depthwise": {"kernel": _conv_t(sd[f"{p}.conv.depthwise_conv.weight"]),
                              "bias": sd[f"{p}.conv.depthwise_conv.bias"]},
                "bn": _fold_bn(sd, f"{p}.conv.batch_norm"),
                "pointwise2": pointwise(f"{p}.conv.pointwise_conv2"),
            },
            "ff2_ln": _map_ln(sd, f"{p}.norm_feed_forward2"),
            "ff2": {"fc1": lin(f"{p}.feed_forward2.linear1"), "fc2": lin(f"{p}.feed_forward2.linear2")},
            "final_ln": _map_ln(sd, f"{p}.norm_out"),
        })
    params = {
        "subsampling": {
            "conv1": {"kernel": _conv2d_t(sd["encoder.pre_encode.conv.0.weight"]), "bias": sd["encoder.pre_encode.conv.0.bias"]},
            "conv2": {"kernel": _conv2d_t(sd["encoder.pre_encode.conv.2.weight"]), "bias": sd["encoder.pre_encode.conv.2.bias"]},
            "proj": lin("encoder.pre_encode.out"),
        },
        "blocks": blocks,
        "lm_head": pointwise("decoder.decoder_layers.0"),
    }
    params = _tree_map(lambda x: np.asarray(x, np.float32), params)
    vocab = model_cfg.get("decoder", {}).get("vocabulary") or model_cfg.get("labels") or []
    logger.info(f"loaded NeMo conformer from {path}: d={cfg.d_model}, layers={cfg.num_layers}, vocab={cfg.vocab_size}")
    return params, cfg, list(vocab)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)
