"""Model loading for inference (counterpart of ssak_tpu.infer.general).

This slice serves Whisper only, from seeded weights (`seeded_test_config`)
or from an ssak_tpu parameter tree (`from_tree`, used by the tests).
Checkpoint directories and the CTC families are later slices.
"""

import dataclasses

import torch

from ssak_tpu_torch.utils.env import resolve_device


class ModelType:
    WHISPER = "whisper"


class LoadedModel:
    """Bundle of (type, module, config, device). Tokenizers are a later slice."""

    def __init__(self, model_type, module, cfg, device):
        self.type = model_type
        self.module = module
        self.cfg = cfg
        self.device = torch.device(device)


def load_model(model_dir, seeded_test_config: str = None, quantize_bits: int = 0, device=None) -> LoadedModel:
    """Seeded model (`seeded_test_config`: 'whisper' or 'whisper:<preset>')
    on `device` (default cuda; raises when there is none). quantize_bits=8
    or 4 replaces the dense kernels by int8 / int4 QuantLinears on the
    device and turns on the int8 K/V caches, as ssak_tpu's load_model
    does."""
    dev = resolve_device(device)
    if not seeded_test_config:
        raise NotImplementedError(f"{model_dir}: checkpoint loading is not ported yet; use seeded_test_config")
    model = _seeded_model(seeded_test_config, dev)
    if quantize_bits:
        if quantize_bits not in (4, 8):
            raise ValueError(f"quantize_bits must be 4 or 8, got {quantize_bits}")
        from ssak_tpu_torch.models.quant import quantize_params

        quantize_params(model.module, bits=quantize_bits)
        # int8 K/V caches ride along with int8 and int4 weights (ssak_tpu infer/general.py)
        model.cfg = dataclasses.replace(model.cfg, kv_int8=True)
    return model


def _seeded_model(kind: str, device) -> LoadedModel:
    """Random-but-deterministic model: 'whisper[:preset]' (default preset
    tiny_test), drawn from torch.Generator seed 0 on `device`."""
    family, _, preset = kind.partition(":")
    if not family.startswith("whisper"):
        raise NotImplementedError(f"seeded {family!r} models are not ported yet (Whisper only)")
    from ssak_tpu_torch.models import whisper

    cfg = whisper.make_config(preset or "tiny_test")
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        module = whisper.init_params(gen, cfg, device)
    return LoadedModel(ModelType.WHISPER, module, cfg, device)


def from_tree(params, cfg, device=None) -> LoadedModel:
    """LoadedModel from an ssak_tpu Whisper parameter tree (numpy leaves;
    float, int8- or int4-quantized) and its config (models.whisper.WhisperConfig),
    on `device` (default cuda; raises when there is none)."""
    from ssak_tpu_torch.models.convert import whisper_from_tree

    dev = resolve_device(device)
    return LoadedModel(ModelType.WHISPER, whisper_from_tree(params, dev), cfg, dev)
