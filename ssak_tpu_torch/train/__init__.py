from ssak_tpu_torch.train.steps import (
    init_train_state,
    make_ctc_eval_step,
    make_ctc_train_step,
    make_optimizer,
    make_whisper_train_step,
)
from ssak_tpu_torch.train.checkpoint import (
    get_last_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "make_optimizer",
    "init_train_state",
    "make_ctc_train_step",
    "make_ctc_eval_step",
    "make_whisper_train_step",
    "save_checkpoint",
    "load_checkpoint",
    "get_last_checkpoint",
]
