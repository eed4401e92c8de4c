from ssak_tpu_torch.infer.general import (
    LoadedModel,
    ModelType,
    compute_log_probas,
    decode_log_probas,
    infer,
    load_model,
)

__all__ = [
    "load_model",
    "infer",
    "compute_log_probas",
    "decode_log_probas",
    "LoadedModel",
    "ModelType",
]
