"""CTC train and eval steps (counterpart of the CTC half of ssak_tpu.train.steps).

A step runs eagerly: wav2vec2 forward in the config's compute dtype (bf16
products over f32 master weights), log_softmax in f32, the CTC loss through
the fused forward-backward (ops.ctc_fused: kernel K1 on CUDA, its plain
version on the CPU), autograd for the rest, then the optimizer update IN
PLACE on the model's parameters. It returns device tensors and never reads
them back, so the host runs ahead of the card between log points.

Optimizers follow optax (train.optim): `make_optimizer` is
chain(clip_by_global_norm, adamw(schedule)) with lr 0 at step 0 under
warmup; NewBob's optimizers keep their lr in the state (`set_learning_rate`);
`with_grad_accumulation` averages k micro-step gradients. With a frozen
feature encoder the conv stack runs without autograd and its weights get
zero gradients, but they stay in the optimizer, so AdamW's decoupled decay
still shrinks them, exactly as in ssak_tpu.

The Whisper step comes with LoRA (ROADMAP.md slice 8); the conformer family
with its model (slice 7).
"""

import torch

from ssak_tpu_torch.ops.ctc import ctc_greedy_decode
from ssak_tpu_torch.ops.ctc_fused import ctc_loss_fast as ctc_loss
from ssak_tpu_torch.train import optim


def audio_to_f32(a):
    """Decode the int16 wire format on the device (float audio passes through)."""
    if not a.is_floating_point():
        return a.to(torch.float32) * (1.0 / 32768.0)
    return a


def _schedule(kind: str, learning_rate: float, warmup_steps: int, total_steps: int):
    if kind == "linear":
        return optim.join_schedules([optim.linear_schedule(0.0, learning_rate, warmup_steps),
                                     optim.linear_schedule(learning_rate, 0.0, max(1, total_steps - warmup_steps))],
                                    [warmup_steps])
    if kind == "cosine":
        return optim.warmup_cosine_decay_schedule(0.0, learning_rate, warmup_steps, total_steps)
    if kind == "constant":
        return optim.join_schedules([optim.linear_schedule(0.0, learning_rate, warmup_steps), lambda count: learning_rate],
                                    [warmup_steps])
    raise ValueError(kind)


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.01, warmup_steps: int = 500,
                   total_steps: int = 100000, b1: float = 0.9, b2: float = 0.999, grad_clip: float = 1.0,
                   schedule: str = "linear"):
    """AdamW with a warmup schedule ('linear', 'cosine' or 'constant' after
    warmup), after clipping by the global norm."""
    sched = _schedule(schedule, learning_rate, warmup_steps, total_steps)
    return optim.chain(optim.clip_by_global_norm(grad_clip),
                       optim.adamw(sched, b1=b1, b2=b2, weight_decay=weight_decay))


HEAD_RULES = [(r"/lm_head/", "head")]


def make_grouped_optimizer(optimizers: dict, rules, default: str, grad_clip: float = 1.0):
    """Per-parameter-group optimizers after one global-norm clip. rules:
    [(path_regex, group)] matched against /-joined module paths
    ('/lm_head/weight'), first match wins; `default` for the rest."""
    return optim.chain(optim.clip_by_global_norm(grad_clip),
                       optim.multi_transform(optimizers, optim.regex_labels(rules, default)))


def make_sb_ctc_optimizer(pretrained_lr: float = 1e-4, head_lr: float = 1.0, rho: float = 0.95, grad_clip: float = 1.0):
    """The SpeechBrain recipe: Adam on the trunk, Adadelta on the CTC head."""
    return make_grouped_optimizer({"pretrained": optim.adam(pretrained_lr), "head": optim.adadelta(head_lr, rho=rho)},
                                  HEAD_RULES, "pretrained", grad_clip)


def make_newbob_optimizer(learning_rate: float, optimizer: str = "adamw", weight_decay: float = 0.01,
                          rho: float = 0.95, grad_clip: float = 1.0, head_lr: float = 1.0):
    """An optimizer whose lr lives in its state, for NewBob annealing
    (`set_learning_rate` between steps). 'sb_dual' scales the head's
    Adadelta lr with the injected lr."""

    def make(lr):
        if optimizer == "sb_dual":
            return make_grouped_optimizer(
                {"pretrained": optim.adam(lr), "head": optim.adadelta(lr * (head_lr / learning_rate), rho=rho)},
                HEAD_RULES, "pretrained", grad_clip)
        if optimizer == "adadelta":
            inner = optim.adadelta(lr, rho=rho)
        else:
            inner = optim.adamw(lr, weight_decay=weight_decay)
        return optim.chain(optim.clip_by_global_norm(grad_clip), inner)

    return optim.inject_learning_rate(make, learning_rate)


def set_learning_rate(opt_state, lr):
    """A new optimizer state with the injected lr replaced (through gradient
    accumulation's wrapper)."""
    if "inner_opt_state" in opt_state and "mini_step" in opt_state:
        return {**opt_state, "inner_opt_state": set_learning_rate(opt_state["inner_opt_state"], lr)}
    return {**opt_state, "hyperparams": {**opt_state["hyperparams"], "lr": optim._f32(lr)}}


def get_learning_rate(opt_state) -> float:
    if "mini_step" in opt_state:
        return get_learning_rate(opt_state["inner_opt_state"])
    return float(opt_state["hyperparams"]["lr"])


def with_grad_accumulation(optimizer, every: int):
    """One update per `every` micro-steps, on their mean gradient."""
    if every <= 1:
        return optimizer
    return optim.multi_steps(optimizer, every)


class NewBob:
    """SpeechBrain NewBob annealing: when the relative improvement of the
    tracked metric falls below improvement_threshold, multiply the lr by
    annealing_factor (after `patient` tolerated evals)."""

    def __init__(self, initial_lr: float, improvement_threshold: float = 0.0025, annealing_factor: float = 0.8,
                 patient: int = 0):
        self.lr = float(initial_lr)
        self.improvement_threshold = improvement_threshold
        self.annealing_factor = annealing_factor
        self.patient = patient
        self._waited = 0
        self._prev = None

    def __call__(self, metric: float):
        """Feed the new eval metric; returns the (possibly annealed) lr."""
        if self._prev is not None and self._prev != 0:
            improvement = (self._prev - metric) / abs(self._prev)
            if improvement < self.improvement_threshold:
                if self._waited >= self.patient:
                    self.lr *= self.annealing_factor
                    self._waited = 0
                else:
                    self._waited += 1
            else:
                self._waited = 0
        self._prev = metric if self._prev is None else min(self._prev, metric)
        return self.lr


def init_train_state(model, optimizer):
    """{"model", "opt_state", "step"}: the model's parameters become
    trainable leaves (requires_grad) and the optimizer state is built over
    all of them; the step counter is a host integer."""
    model.requires_grad_(True)
    return {"model": model, "opt_state": optimizer.init(dict(model.named_parameters())), "step": 0}


def _check_family(family):
    if family != "wav2vec2":
        raise NotImplementedError(f"CTC family {family!r} is not ported yet (the conformer comes with ROADMAP.md slice 7)")


def _cudnn_benchmark():
    """cuDNN's benchmark mode for the duration of a step, restored after it:
    cuDNN times its algorithms once per convolution shape (one per duration
    bucket); the grouped positional convolution's backward is about 4x
    faster so on the H100 (PERF.md)."""
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=True, deterministic=b.deterministic, allow_tf32=b.allow_tf32)


def make_ctc_train_step(cfg, optimizer, frozen_feature_encoder: bool = True, mask_time_prob: float = 0.0,
                        mask_time_length: int = 10, family: str = "wav2vec2"):
    """step(state, batch) -> (state, {"loss", "grad_norm"} device scalars).
    batch: {audio (B, T) int16 wire words or f32, audio_lengths (B,),
    labels (B, U), label_lengths (B,)} on the model's device. The state is
    updated IN PLACE and returned. grad_norm is the pre-clip global norm of
    the gradients (zeros for a frozen feature encoder). mask_time_prob > 0
    draws a span mask over frames from a generator seeded with the step."""
    _check_family(family)
    from ssak_tpu_torch.augment.specaugment import mask_time_indices
    from ssak_tpu_torch.models import wav2vec2

    def step(state, batch):
        with _cudnn_benchmark():
            return _step(state, batch)

    def _step(state, batch):
        model = state["model"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        audio = audio_to_f32(batch["audio"])
        time_mask = None
        if mask_time_prob > 0:
            B, T = audio.shape
            gen = torch.Generator(device=audio.device).manual_seed(state["step"])
            time_mask = mask_time_indices(gen, (B, wav2vec2.feature_extract_output_length(cfg, T)),
                                          mask_prob=mask_time_prob, mask_length=mask_time_length)
        log_probs, frame_lengths = wav2vec2.ctc_log_probs(
            model, audio, cfg, batch["audio_lengths"], time_mask=time_mask, freeze_feature_encoder=frozen_feature_encoder)
        loss = ctc_loss(log_probs, frame_lengths, batch["labels"], batch["label_lengths"], blank_id=cfg.blank_id)
        loss.backward()
        grads = {}
        for name, p in params.items():
            frozen = frozen_feature_encoder and name.startswith("feature_extractor.")
            grads[name] = torch.zeros_like(p) if frozen or p.grad is None else p.grad
        gnorm = optim.global_norm(grads.values())
        updates, state["opt_state"] = optimizer.update(grads, state["opt_state"], {k: p.detach() for k, p in params.items()})
        optim.apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def make_ctc_eval_step(cfg, family: str = "wav2vec2"):
    """step(model, batch) -> {loss, tokens (B, F) padded with -1, token_lengths (B,)}."""
    _check_family(family)
    from ssak_tpu_torch.models import wav2vec2

    def step(model, batch):
        with torch.no_grad(), _cudnn_benchmark():
            log_probs, frame_lengths = wav2vec2.ctc_log_probs(model, audio_to_f32(batch["audio"]), cfg, batch["audio_lengths"])
            loss = ctc_loss(log_probs, frame_lengths, batch["labels"], batch["label_lengths"], blank_id=cfg.blank_id)
            tokens, lengths = ctc_greedy_decode(log_probs, frame_lengths, blank_id=cfg.blank_id)
        return {"loss": loss, "tokens": tokens, "token_lengths": lengths}

    return step
