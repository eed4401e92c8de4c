"""Model loading and the CTC forward for inference (counterpart of
ssak_tpu.infer.general).

Whisper and wav2vec2-CTC, from seeded weights (`seeded_test_config`) or
from an ssak_tpu parameter tree (`from_tree`, used by the tests).
Checkpoint directories, the Conformer family, quantized CTC models,
tensor-parallel sharding and MMS adapter loading are later slices
(ROADMAP.md) and raise NotImplementedError.
"""

import dataclasses

import numpy as np
import torch

from ssak_tpu_torch.utils.env import resolve_device


class ModelType:
    WAV2VEC2_CTC = "wav2vec2_ctc"
    WHISPER = "whisper"


CTC_TYPES = (ModelType.WAV2VEC2_CTC,)

# the seeded CTC models' 48-token character vocabulary (ssak_tpu's)
_SEEDED_CTC_SPECIALS = ("<pad>", "<s>", "</s>", "<unk>", "|")
_SEEDED_CTC_CHARS = "abcdefghijklmnopqrstuvwxyz'-éèàùâêîôûç0123456789"


class LoadedModel:
    """Bundle of (type, module, config, device, tokenizer). Whisper models
    carry no tokenizer yet (slice 6)."""

    def __init__(self, model_type, module, cfg, device, tokenizer=None):
        self.type = model_type
        self.module = module
        self.cfg = cfg
        self.device = torch.device(device)
        self.tokenizer = tokenizer

    @property
    def sample_rate(self):
        return 16000

    def vocab(self):
        """id -> token list, padded to the model's logit dimension."""
        if self.type in CTC_TYPES:
            n = max(len(self.tokenizer), getattr(self.cfg, "vocab_size", 0))
            return [self.tokenizer.id2tok.get(i, "") for i in range(n)]
        raise ValueError("vocab() only defined for CTC models")


def load_model(model_dir, seeded_test_config: str = None, quantize_bits: int = 0, device=None) -> LoadedModel:
    """Seeded model (`seeded_test_config`: 'whisper[:preset]' or
    'wav2vec2[:preset]') on `device` (default cuda; raises when there is
    none). quantize_bits=8 or 4 replaces a Whisper model's dense kernels by
    int8 / int4 QuantLinears on the device and turns on the int8 K/V caches,
    as ssak_tpu's load_model does."""
    dev = resolve_device(device)
    if not seeded_test_config:
        raise NotImplementedError(f"{model_dir}: checkpoint loading is not ported yet; use seeded_test_config")
    model = _seeded_model(seeded_test_config, dev)
    if quantize_bits:
        if quantize_bits not in (4, 8):
            raise ValueError(f"quantize_bits must be 4 or 8, got {quantize_bits}")
        if model.type != ModelType.WHISPER:
            raise NotImplementedError("quantized CTC models (--load_in_8bit / --load_in_4bit) are not ported yet (ROADMAP.md)")
        from ssak_tpu_torch.models.quant import quantize_params

        quantize_params(model.module, bits=quantize_bits)
        # int8 K/V caches ride along with int8 and int4 weights (ssak_tpu infer/general.py)
        model.cfg = dataclasses.replace(model.cfg, kv_int8=True)
    return model


def _seeded_model(kind: str, device) -> LoadedModel:
    """Random-but-deterministic model: 'whisper[:preset]' (default preset
    tiny_test), drawn from torch.Generator seed 0 on `device`; or
    'wav2vec2[:preset]' (default tiny_test; a named preset takes the 48-token
    vocabulary), seed 0, with ssak_tpu's seeded character tokenizer."""
    family, _, preset = kind.partition(":")
    if family.startswith("whisper"):
        from ssak_tpu_torch.models import whisper

        cfg = whisper.make_config(preset or "tiny_test")
        gen = torch.Generator(device=device).manual_seed(0)
        with torch.no_grad():
            module = whisper.init_params(gen, cfg, device)
        return LoadedModel(ModelType.WHISPER, module, cfg, device)
    if not family.startswith("wav2vec2"):
        raise NotImplementedError(f"seeded {family!r} models are not ported yet (Whisper and wav2vec2 only)")
    from ssak_tpu_torch.models import wav2vec2

    cfg = wav2vec2.make_config(preset, vocab_size=48) if preset else wav2vec2.make_config("tiny_test")
    module = wav2vec2.init_params(cfg, seed=0, device=device)
    return LoadedModel(ModelType.WAV2VEC2_CTC, module, cfg, device, seeded_ctc_tokenizer(cfg.vocab_size))


def seeded_ctc_tokenizer(vocab_size: int):
    """ssak_tpu's seeded CTC vocabulary: the 5 specials, then characters up
    to `vocab_size` tokens."""
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer

    vocab = {t: i for i, t in enumerate(_SEEDED_CTC_SPECIALS)}
    for c in _SEEDED_CTC_CHARS[: vocab_size - len(vocab)]:
        vocab[c] = len(vocab)
    return CTCTokenizer(vocab)


def from_tree(params, cfg, device=None, tokenizer=None) -> LoadedModel:
    """LoadedModel from an ssak_tpu parameter tree (numpy leaves) and its
    config, on `device` (default cuda; raises when there is none): a Whisper
    tree (float, int8- or int4-quantized; models.whisper.WhisperConfig) or a
    wav2vec2 tree (models.wav2vec2.Wav2Vec2Config, with the CTC `tokenizer`,
    by default the seeded vocabulary)."""
    dev = resolve_device(device)
    if "feature_extractor" in params:
        from ssak_tpu_torch.models.convert import wav2vec2_from_tree

        tok = tokenizer if tokenizer is not None else seeded_ctc_tokenizer(cfg.vocab_size)
        return LoadedModel(ModelType.WAV2VEC2_CTC, wav2vec2_from_tree(params, dev), cfg, dev, tok)
    from ssak_tpu_torch.models.convert import whisper_from_tree

    return LoadedModel(ModelType.WHISPER, whisper_from_tree(params, dev), cfg, dev, tokenizer)


def shard_model(model: LoadedModel, model_axis: int = None, mesh=None):
    raise NotImplementedError("tensor-parallel sharding is not ported yet (comes with parallel/, ROADMAP.md)")


def load_adapter(model: LoadedModel, model_dir: str, language: str) -> bool:
    raise NotImplementedError("MMS adapter loading is not ported yet (comes with checkpoint loading, ROADMAP.md)")


def compute_log_probas(model: LoadedModel, audio, lengths=None):
    """CTC log-probs of a batch: audio (B, T) as a host array in the wire
    format (int16 PCM words, decoded to f32 on the device, or f32) or a
    tensor; lengths (B,) valid samples (default T) -> ((B, F, V) f32,
    frame_lengths (B,)), both on the model's device."""
    if model.type not in CTC_TYPES:
        raise ValueError(f"compute_log_probas needs a CTC model, got {model.type}")
    from ssak_tpu_torch.audio.wire import SCALE, to_device_f32
    from ssak_tpu_torch.models import wav2vec2

    if isinstance(audio, np.ndarray):
        x = to_device_f32(audio, model.device)
    else:
        x = audio.to(model.device)
        x = x.to(torch.float32) if x.is_floating_point() else x.to(torch.float32) * (1.0 / SCALE)
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=model.device)
    lengths = torch.as_tensor(np.asarray(lengths) if isinstance(lengths, (list, tuple)) else lengths,
                              device=model.device)
    with torch.no_grad():
        return wav2vec2.ctc_log_probs(model.module, x, model.cfg, lengths)


def decode_log_probas(model: LoadedModel, log_probs, frame_lengths):
    """Greedy decode of CTC log-probs to texts."""
    from ssak_tpu_torch.ops.ctc import ctc_greedy_decode

    log_probs = torch.as_tensor(log_probs)
    frame_lengths = torch.as_tensor(frame_lengths, device=log_probs.device)
    tokens, lengths = ctc_greedy_decode(log_probs, frame_lengths, blank_id=model.cfg.blank_id)
    tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
    return [model.tokenizer.decode(tokens[b, : lengths[b]]) for b in range(tokens.shape[0])]
