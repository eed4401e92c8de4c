"""Model loading and the CTC forward for inference (counterpart of
ssak_tpu.infer.general).

Whisper, wav2vec2-CTC and Conformer-CTC from a model directory, in
ssak_tpu's order: an export of `train.finalize` (ssak_config.json), else a
NeMo archive (.nemo, or a directory with model_config.yaml: a Conformer
with the archive's vocabulary), else an HF checkpoint (config.json: Whisper
with its tokenizer, wav2vec2 with its vocab.json); MMS per-language
adapters (`load_adapter`); seeded weights (`seeded_test_config`, Whisper
and wav2vec2, the families ssak_tpu seeds) or an ssak_tpu parameter tree
(`from_tree`, used by the tests). Any of them may be quantized on load
(`quantize_bits` 8 or 4). A CTC model is sharded tensor-parallel over the
ranks of a process group by `shard_model`; Whisper's tensor-parallel decode
is a later slice of ROADMAP.md (8h) and raises NotImplementedError.
"""

import dataclasses
import json
import os

import numpy as np
import torch

from ssak_tpu_torch.utils.env import resolve_device


class ModelType:
    WAV2VEC2_CTC = "wav2vec2_ctc"
    WHISPER = "whisper"
    CONFORMER_CTC = "conformer_ctc"


CTC_TYPES = (ModelType.WAV2VEC2_CTC, ModelType.CONFORMER_CTC)

# the seeded CTC models' 48-token character vocabulary (ssak_tpu's)
_SEEDED_CTC_SPECIALS = ("<pad>", "<s>", "</s>", "<unk>", "|")
_SEEDED_CTC_CHARS = "abcdefghijklmnopqrstuvwxyz'-éèàùâêîôûç0123456789"


class LoadedModel:
    """Bundle of (type, module, config, device, tokenizer): a
    WhisperTokenizer for an HF Whisper directory, a CTCTokenizer for a CTC
    model, None for a Whisper model without one (seeded, from a tree or
    exported), whose transcripts are then its token ids."""

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


def get_model_type(model_dir: str) -> str:
    """The family of a model directory: a NeMo archive (.nemo, or
    model_config.yaml) is a Conformer; else config.json's architectures or
    model_type say Whisper or wav2vec2."""
    if model_dir.endswith(".nemo") or os.path.exists(os.path.join(model_dir, "model_config.yaml")):
        return ModelType.CONFORMER_CTC
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    archs = cfg.get("architectures") or []
    mt = (cfg.get("model_type") or "").lower()
    if any("whisper" in a.lower() for a in archs) or mt == "whisper":
        return ModelType.WHISPER
    if any("wav2vec2" in a.lower() for a in archs) or mt == "wav2vec2":
        return ModelType.WAV2VEC2_CTC
    raise ValueError(f"cannot determine model type of {model_dir}")


def load_model(model_dir, seeded_test_config: str = None, quantize_bits: int = 0, device=None) -> LoadedModel:
    """A model directory (an HF Whisper or wav2vec2 checkpoint, a NeMo
    Conformer-CTC archive or its extracted directory, or an export of
    train.finalize), or a seeded model (`seeded_test_config`:
    'whisper[:preset]' or 'wav2vec2[:preset]'), on `device` (default cuda;
    raises when there is none). quantize_bits=8 or 4 replaces the model's
    dense kernels of at least 64 x 64 values by int8 / int4 QuantLinears
    on the device (models.quant.quantize_params: every dense layer of a
    CTC model, lm_head and projections included, and no conv kernel), as
    ssak_tpu's load_model does; a Whisper model also turns on the int8
    K/V caches."""
    dev = resolve_device(device)
    model = _seeded_model(seeded_test_config, dev) if seeded_test_config else _load_dir(model_dir, dev)
    if quantize_bits:
        if quantize_bits not in (4, 8):
            raise ValueError(f"quantize_bits must be 4 or 8, got {quantize_bits}")
        from ssak_tpu_torch.models.quant import quantize_params

        quantize_params(model.module, bits=quantize_bits)
        if model.type == ModelType.WHISPER:
            # int8 K/V caches ride along with int8 and int4 weights (ssak_tpu infer/general.py)
            model.cfg = dataclasses.replace(model.cfg, kv_int8=True)
    return model


def _load_dir(model_dir: str, device) -> LoadedModel:
    if os.path.exists(os.path.join(model_dir, "ssak_config.json")):
        from ssak_tpu_torch.train.finalize import load_exported

        mtype, params, cfg, tokenizer = load_exported(model_dir)
        return _from_params(mtype, params, cfg, device, tokenizer)
    mtype = get_model_type(model_dir)
    from ssak_tpu_torch.models import hf_loader
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer, WhisperTokenizer

    if mtype == ModelType.CONFORMER_CTC:
        params, cfg, vocabulary = hf_loader.load_nemo_conformer(model_dir)
        # NeMo's blank is the LAST id and has no token; char vocabularies
        # delimit words with a space, BPE ones mark word starts with '▁'
        vocab = {tok: i for i, tok in enumerate(vocabulary)}
        vocab.setdefault("<pad>", cfg.blank_id)
        delim = "▁" if any(t.startswith("▁") for t in vocabulary) else " "
        return _from_params(mtype, params, cfg, device, CTCTokenizer(vocab, word_delimiter=delim))

    if mtype == ModelType.WHISPER:
        params, cfg = hf_loader.load_whisper(model_dir)
        tok = WhisperTokenizer(model_dir)
        return _from_params(mtype, params, _with_tokenizer_ids(cfg, tok), device, tok)
    params, cfg = hf_loader.load_wav2vec2(model_dir)
    if "lm_head" not in params:
        raise ValueError(f"{model_dir}: the checkpoint has no CTC head (lm_head); fine-tune it with "
                         "python -m ssak_tpu_torch.train.cli --base_model")
    return _from_params(mtype, params, cfg, device, CTCTokenizer(model_dir))


def _with_tokenizer_ids(cfg, tok):
    """The Whisper config with the tokenizer's no_timestamps, sot_prev,
    no_speech and timestamp_begin ids, which config.json does not carry.
    ssak_tpu keeps its config's defaults, which are large-v2's: on a
    large-v3 checkpoint (one more language) they name the token before
    each (ROADMAP.md §3)."""
    ids = {k: getattr(tok, k) for k in ("no_timestamps", "sot_prev", "no_speech", "timestamp_begin")}
    return dataclasses.replace(cfg, **{k: v for k, v in ids.items() if v is not None})


def _from_params(mtype, params, cfg, device, tokenizer) -> LoadedModel:
    from ssak_tpu_torch.models.convert import conformer_from_tree, wav2vec2_from_tree, whisper_from_tree

    build = {ModelType.WHISPER: whisper_from_tree, ModelType.CONFORMER_CTC: conformer_from_tree}.get(mtype,
                                                                                                     wav2vec2_from_tree)
    return LoadedModel(mtype, build(params, device), cfg, device, tokenizer)


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
        raise NotImplementedError(f"no seeded {family!r} model: ssak_tpu seeds Whisper and wav2vec2 only")
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
    tree (float, int8- or int4-quantized; models.whisper.WhisperConfig), a
    wav2vec2 tree (models.wav2vec2.Wav2Vec2Config) or a Conformer tree
    (models.conformer.ConformerConfig); a CTC model takes the `tokenizer`,
    by default the seeded vocabulary."""
    dev = resolve_device(device)
    ctc = {"feature_extractor": ModelType.WAV2VEC2_CTC, "subsampling": ModelType.CONFORMER_CTC}
    for key, mtype in ctc.items():
        if key in params:
            tok = tokenizer if tokenizer is not None else seeded_ctc_tokenizer(cfg.vocab_size)
            return _from_params(mtype, params, cfg, dev, tok)
    return _from_params(ModelType.WHISPER, params, cfg, dev, tokenizer)


def shard_model(model: LoadedModel, model_axis: int = None, mesh=None) -> LoadedModel:
    """Tensor-parallel sharding of a loaded CTC model over the 'model' dim
    of `mesh` (Megatron rules of parallel.sharding: WAV2VEC2_RULES or
    CONFORMER_RULES; MoE experts stay whole): each rank keeps its
    slice of the weights, IN PLACE, and the forward all-reduces and
    all-gathers where XLA would for ssak_tpu. Needs a process group (ranks
    started by torchrun, or parallel.init_distributed); the mesh defaults
    to (1, model_axis), model_axis to the world size. Returns the same
    LoadedModel with `.mesh` set. Whisper's tensor-parallel decode is slice
    8h and raises NotImplementedError."""
    import torch.distributed as dist

    from ssak_tpu_torch.parallel.mesh import make_mesh, shard_params
    from ssak_tpu_torch.parallel.sharding import CONFORMER_RULES, WAV2VEC2_RULES

    if model.type == ModelType.WHISPER:
        raise NotImplementedError("tensor-parallel Whisper decode is not ported yet (slice 8h, ROADMAP.md)")
    if mesh is None:
        if not dist.is_initialized():
            raise ValueError("shard_model needs a process group: start one process per rank with torchrun "
                             "(python -m torch.distributed.run --nproc_per_node N ...)")
        mesh = make_mesh(model=model_axis or dist.get_world_size(), device_type=model.device.type)
    rules = CONFORMER_RULES if model.type == ModelType.CONFORMER_CTC else WAV2VEC2_RULES
    shard_params(model.module, mesh, rules, num_heads=model.cfg.num_heads)
    model.mesh = mesh
    return model


def load_adapter(model: LoadedModel, model_dir: str, language: str) -> bool:
    """MMS per-language adapter swap: merges adapter.<language>.safetensors
    (or .bin) of `model_dir` into the module (each layer's adapter and the
    language's lm_head), switches the tokenizer to the language's
    vocabulary where vocab.json is nested by language, and resizes
    cfg.vocab_size to the new head. Returns False, changing nothing, for a
    non-CTC model or a checkpoint without that adapter."""
    if model.type != ModelType.WAV2VEC2_CTC:
        return False
    if not any(os.path.exists(os.path.join(model_dir, f"adapter.{language}.{ext}")) for ext in ("safetensors", "bin")):
        return False
    from ssak_tpu_torch.models import wav2vec2 as W2V
    from ssak_tpu_torch.models.convert import linear_from_tree, ln_from_tree
    from ssak_tpu_torch.models.hf_loader import read_wav2vec2_adapter

    blocks = model.module.encoder.blocks
    adapters, lm_head = read_wav2vec2_adapter(model_dir, language, len(blocks))
    for i, a in adapters.items():
        blocks[i].adapter = W2V.Adapter(ln_from_tree(a["norm"], model.device), linear_from_tree(a["down"], model.device),
                                        linear_from_tree(a["up"], model.device))
    if lm_head is not None:
        model.module.lm_head = linear_from_tree(lm_head, model.device)
    vp = os.path.join(model_dir, "vocab.json")
    if os.path.exists(vp):
        with open(vp, encoding="utf-8") as f:
            v = json.load(f)
        if language in v and isinstance(v[language], dict):
            from ssak_tpu_torch.models.tokenizer import CTCTokenizer

            model.tokenizer = CTCTokenizer(v[language])
    new_v = int(model.module.lm_head.weight.shape[0])
    if getattr(model.cfg, "vocab_size", new_v) != new_v:
        model.cfg = dataclasses.replace(model.cfg, vocab_size=new_v)
    return True


def infer(model: LoadedModel, audio_batches, language: str = None, **kwargs):
    """Generator of transcripts over batches of 1-D float arrays (CTC
    greedy, or Whisper with `language` and the other options of
    whisper_transcribe_batch)."""
    if model.type in CTC_TYPES:
        from ssak_tpu_torch.infer.ctc_infer import ctc_transcribe_batch

        for batch in audio_batches:
            yield from ctc_transcribe_batch(model, batch)
    else:
        from ssak_tpu_torch.infer.whisper_infer import whisper_transcribe_batch

        for batch in audio_batches:
            yield from whisper_transcribe_batch(model, batch, language=language, **kwargs)


def compute_log_probas(model: LoadedModel, audio, lengths=None):
    """CTC log-probs of a batch: audio (B, T) as a host array in the wire
    format (int16 PCM words, decoded to f32 on the device, or f32) or a
    tensor; lengths (B,) valid samples (default T) -> ((B, F, V) f32,
    frame_lengths (B,)), both on the model's device."""
    if model.type not in CTC_TYPES:
        raise ValueError(f"compute_log_probas needs a CTC model, got {model.type}")
    from ssak_tpu_torch.audio.wire import SCALE, to_device_f32

    if model.type == ModelType.CONFORMER_CTC:
        from ssak_tpu_torch.models import conformer as family
    else:
        from ssak_tpu_torch.models import wav2vec2 as family

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
        return family.ctc_log_probs(model.module, x, model.cfg, lengths)


def decode_log_probas(model: LoadedModel, log_probs, frame_lengths):
    """Greedy decode of CTC log-probs to texts."""
    from ssak_tpu_torch.ops.ctc import ctc_greedy_decode

    log_probs = torch.as_tensor(log_probs)
    frame_lengths = torch.as_tensor(frame_lengths, device=log_probs.device)
    tokens, lengths = ctc_greedy_decode(log_probs, frame_lengths, blank_id=model.cfg.blank_id)
    tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
    return [model.tokenizer.decode(tokens[b, : lengths[b]]) for b in range(tokens.shape[0])]
