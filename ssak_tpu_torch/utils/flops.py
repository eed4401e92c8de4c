"""Analytic model-FLOP accounting for MFU reporting (counterpart of
ssak_tpu.utils.flops).

Counting convention, as in ssak_tpu: a matmul of (M,K)x(K,N) costs 2*M*K*N
FLOPs; a training step costs 3x the forward cost for trainable sections
(fwd + 2x bwd), 1x for frozen sections reached without gradient. The
counters are ssak_tpu's arithmetic line for line and read the fields that
the port's Wav2Vec2Config, ConformerConfig and WhisperConfig share with
ssak_tpu's. `peak_flops` (ssak_tpu's `tpu_peak_flops`) gives the card's
dense bf16 tensor-core peak, which an MFU divides by.
"""

from dataclasses import dataclass

# Dense bf16 tensor-core peak FLOP/s (no sparsity) by a substring of
# torch.cuda.get_device_name. Each entry names its data sheet.
_CARD_PEAKS = {
    # H100 SXM5: 989 TFLOP/s bf16 dense at its 700 W limit (NVIDIA H100 Tensor Core GPU data sheet)
    "H100 80GB HBM3": 989e12,
}


def peak_flops(device=None) -> float:
    """Peak dense bf16 FLOP/s of a CUDA card, read from its name (None:
    the current card, or the CPU where there is none). None for the CPU,
    and None with a logged warning for a card that is not in the table:
    no peak is guessed."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    for sub, peak in _CARD_PEAKS.items():
        if sub in name:
            return peak
    from ssak_tpu_torch.utils.monitoring import logger

    logger.warning(f"peak_flops: no bf16 peak is known for {name!r}; add it to utils/flops._CARD_PEAKS "
                   "with its data sheet")
    return None


def _transformer_layer_fwd(T: int, d: int, ffn: int, T_kv: int = None) -> float:
    """One self-attention + MLP block forward: QKVO projections, attention
    einsums, and the 2-matmul MLP."""
    T_kv = T_kv or T
    # q + o projections over T, k/v over T_kv
    proj = 2 * d * d * (2 * T + 2 * T_kv)
    attn = 2 * T * T_kv * d * 2  # scores + weighted sum
    mlp = 2 * T * d * ffn * 2
    return proj + attn + mlp


def _wav2vec2_fwd_parts(cfg, seconds: float = 1.0):
    """(feature_encoder_fwd, transformer_fwd) FLOPs for `seconds` of audio."""
    T = int(seconds * 16000)
    conv = 0.0
    c_in = 1
    for c_out, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        T = (T - k) // s + 1
        conv += 2.0 * T * k * c_in * c_out
        c_in = c_out
    # projection conv_dim[-1] -> hidden
    proj = 2.0 * T * cfg.conv_dim[-1] * cfg.hidden_size
    # conv positional embedding (grouped)
    pos = 2.0 * T * cfg.num_conv_pos_embeddings * cfg.hidden_size * (cfg.hidden_size / cfg.num_conv_pos_embedding_groups)
    layers = cfg.num_layers * _transformer_layer_fwd(T, cfg.hidden_size, cfg.intermediate_size)
    head = 2.0 * T * cfg.hidden_size * cfg.vocab_size
    return conv, proj + pos + layers + head


def wav2vec2_train_flops_per_audio_second(cfg, freeze_feature_encoder: bool = True) -> float:
    """Model FLOPs of one fwd+bwd second of audio for the CTC fine-tune step
    (train.steps.make_ctc_train_step shapes)."""
    conv, rest = _wav2vec2_fwd_parts(cfg)
    conv_mult = 1.0 if freeze_feature_encoder else 3.0
    return conv * conv_mult + 3.0 * rest


def conformer_train_flops_per_audio_second(cfg) -> float:
    """Model FLOPs of one fwd+bwd second of audio for the conformer CTC
    step: macaron double-FFN, MHSA, conv module (pointwise GLU + depthwise
    + pointwise), lm head — at the subsampled frame rate (100 fps mel /
    subsampling_factor). Subsampling front-end excluded (small, and
    underestimating FLOPs under-reports MFU — conservative)."""
    T = 100.0 / cfg.subsampling_factor  # frames per audio second
    d = cfg.d_model
    ffn = cfg.ff_expansion * d
    per_layer = (
        2 * (2 * 2.0 * T * d * ffn)          # two macaron FFNs (fc1+fc2 each)
        + 4 * 2.0 * T * d * d                # qkvo projections
        + 2 * 2.0 * T * T * d                # scores + weighted sum
        + 2.0 * T * d * 2 * d                # conv module pointwise GLU in
        + 2.0 * T * cfg.conv_kernel * d      # depthwise
        + 2.0 * T * d * d                    # conv module pointwise out
    )
    head = 2.0 * T * d * cfg.vocab_size
    return 3.0 * (cfg.num_layers * per_layer + head)


@dataclass
class WhisperStepShape:
    batch: int
    n_frames: int  # mel frames fed to the encoder (3000 for 30 s)
    n_tokens: int  # decoder positions per utterance


def whisper_encoder_fwd_flops(cfg, n_frames: int) -> float:
    d = cfg.n_audio_state
    conv1 = 2.0 * n_frames * 3 * cfg.n_mels * d
    T = n_frames // 2
    conv2 = 2.0 * T * 3 * d * d
    layers = cfg.n_audio_layer * _transformer_layer_fwd(T, d, 4 * d)
    return conv1 + conv2 + layers


def whisper_decoder_fwd_flops(cfg, n_tokens: int, n_audio_frames: int) -> float:
    d = cfg.n_text_state
    T_a = n_audio_frames // 2
    self_blocks = cfg.n_text_layer * _transformer_layer_fwd(n_tokens, d, 4 * d)
    # cross-attention per layer: q over U, k/v over T_a, attention U x T_a
    cross = cfg.n_text_layer * (
        2 * d * d * (2 * n_tokens + 2 * T_a) + 2 * n_tokens * T_a * d * 2
    )
    logits = 2.0 * n_tokens * d * cfg.n_vocab
    return self_blocks + cross + logits


def whisper_train_flops_per_step(cfg, shape: WhisperStepShape, trainable_fraction: float = 1.0) -> float:
    """fwd+bwd FLOPs of one teacher-forced seq2seq step. For LoRA training
    the bwd still traverses the whole graph (activations grads), only the
    weight-grad matmuls shrink — fwd*3 is within ~15% and is the standard
    accounting; trainable_fraction scales the second bwd matmul instead
    when a finer estimate is wanted."""
    fwd = whisper_encoder_fwd_flops(cfg, shape.n_frames) + whisper_decoder_fwd_flops(cfg, shape.n_tokens, shape.n_frames)
    mult = 2.0 + trainable_fraction
    if getattr(cfg, "remat", False):
        mult += 1.0  # block recompute in bwd
    return shape.batch * fwd * mult


def whisper_decode_flops_per_window(cfg, n_frames: int, prompt_len: int, gen_tokens: int) -> float:
    """Greedy/batched decode: one encoder pass + cross-KV precompute +
    per-token cached decoder steps."""
    d = cfg.n_text_state
    T_a = n_frames // 2
    enc = whisper_encoder_fwd_flops(cfg, n_frames)
    cross_kv = cfg.n_text_layer * 2 * 2.0 * T_a * d * d
    steps = prompt_len + gen_tokens
    # per decode step: q,k,v,o over 1 token + self-attn over cache + cross q
    # + cross attention over T_a + mlp + logits
    per_step = cfg.n_text_layer * (
        2 * d * d * 4  # self qkvo
        + 2 * cfg.n_text_ctx * d * 2  # self attention against full cache
        + 2 * d * d  # cross q
        + 2 * T_a * d * 2  # cross attention
        + 2 * d * d  # cross out
        + 2 * d * 4 * d * 2  # mlp
    ) + 2.0 * d * cfg.n_vocab
    return enc + cross_kv + steps * per_step


def ctc_decode_flops_per_audio_second(cfg) -> float:
    """Acoustic-model forward only (the beam itself is O(T*beam*V) scalar
    work, negligible FLOP-wise)."""
    conv, rest = _wav2vec2_fwd_parts(cfg)
    return conv + rest
