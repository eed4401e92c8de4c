"""CTC and Whisper train steps, CTC eval step (counterpart of ssak_tpu.train.steps).

A step runs eagerly: the wav2vec2 or Conformer forward (`family`) in the
config's compute dtype (bf16 products over f32 master weights), log_softmax
in f32, the CTC loss through
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
still shrinks them, exactly as in ssak_tpu. The Conformer has no feature
encoder to freeze: the flag is ignored for it, as in ssak_tpu.

The Whisper step (`make_whisper_train_step`) is teacher-forced
cross-entropy over the encoder and `decode_train`. Its partitioned form
(`quantized=True`, built by `init_train_state(..., quantized=True)`) takes
gradients, their norm and the optimizer update over the trainable
parameters of models.quant.partition_trainable only (the LoRA adapters
when any exist), so a frozen base, float or int8 / int4, stays bit for bit
as it was.
"""

import functools

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


def init_train_state(model, optimizer, quantized: bool = False):
    """{"model", "opt_state", "step"}: the model's parameters become
    trainable leaves (requires_grad) and the optimizer state is built over
    all of them; the step counter is a host integer. quantized=True: only
    the trainable partition (models.quant.partition_trainable) requires
    grad and has optimizer state; the rest stays frozen."""
    if not quantized:
        model.requires_grad_(True)
        return {"model": model, "opt_state": optimizer.init(dict(model.named_parameters())), "step": 0}
    from ssak_tpu_torch.models.quant import partition_trainable

    model.requires_grad_(False)
    trainable, _ = partition_trainable(model)
    for p in trainable.values():
        p.requires_grad_(True)
    return {"model": model, "opt_state": optimizer.init(trainable), "step": 0}


def _family(family):
    """The model module of a CTC family, 'wav2vec2' or 'conformer'."""
    if family == "conformer":
        from ssak_tpu_torch.models import conformer

        return conformer
    if family != "wav2vec2":
        raise ValueError(f"unknown CTC family {family!r} (wav2vec2 or conformer)")
    from ssak_tpu_torch.models import wav2vec2

    return wav2vec2


def _cudnn_benchmark():
    """cuDNN's benchmark mode for the duration of a step, restored after it:
    cuDNN times its algorithms once per convolution shape (one per duration
    bucket); the grouped positional convolution's backward is about 4x
    faster so on the H100 (PERF.md)."""
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=True, deterministic=b.deterministic, allow_tf32=b.allow_tf32)


def make_ctc_train_step(cfg, optimizer, frozen_feature_encoder: bool = True, mask_time_prob: float = 0.0,
                        mask_time_length: int = 10, family: str = "wav2vec2", moe_aux_weight: float = 0.01):
    """step(state, batch) -> (state, {"loss", "grad_norm"} device scalars).
    batch: {audio (B, T) int16 wire words or f32, audio_lengths (B,),
    labels (B, U), label_lengths (B,)} on the model's device. The state is
    updated IN PLACE and returned. grad_norm is the pre-clip global norm of
    the gradients (zeros for a frozen feature encoder). mask_time_prob > 0
    draws a span mask over frames from a generator seeded with the step
    (for the Conformer, over its subsampled frames). A wav2vec2 with experts
    adds moe_aux_weight times the mean of its layers' load-balancing losses
    to the loss.

    step(state, batch, mesh=mesh) is the data-parallel step (what
    shard_train_step returns): each rank takes its slice of the batch on
    the mesh's `data_axis` (equal slices in rank order), the MoE routes over
    the global token set (parallel.moe.moe_mlp's data_group), the
    gradients are averaged over the data ranks before the optimizer, the
    clip and grad_norm read the global norm (parameters split over ranks,
    as sharded experts are, add their group's share:
    parallel.mesh.global_grad_norm), and the loss is the mean over the data
    ranks: ssak_tpu's global program over the whole batch."""
    from ssak_tpu_torch.augment.specaugment import mask_time_indices

    model_fn = _family(family)
    conformer = family == "conformer"
    frozen_feature_encoder = frozen_feature_encoder and not conformer
    moe = not conformer and getattr(cfg, "num_experts", 0)

    def n_frames(n_samples):
        if conformer:
            return model_fn.subsampled_length(cfg, model_fn.mel_frame_count(cfg, n_samples))
        return model_fn.feature_extract_output_length(cfg, n_samples)

    def step(state, batch, mesh=None, data_axis: str = "data"):
        with _cudnn_benchmark():
            return _step(state, batch, mesh, data_axis)

    def _step(state, batch, mesh, data_axis):
        from ssak_tpu_torch.parallel.collectives import all_reduce
        from ssak_tpu_torch.parallel.mesh import axis_group, data_sharding, global_grad_norm, sync_grads

        data_group = n_data = None
        if mesh is not None:
            data_group, _, n_data = axis_group(mesh, data_axis)
            place = data_sharding(mesh, data_axis)
            batch = {k: place(v) for k, v in batch.items()}
        model = state["model"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        audio = audio_to_f32(batch["audio"])
        time_mask = None
        if mask_time_prob > 0:
            B, T = audio.shape
            gen = torch.Generator(device=audio.device).manual_seed(state["step"])
            time_mask = mask_time_indices(gen, (B, n_frames(T)), mask_prob=mask_time_prob, mask_length=mask_time_length)
        aux = [] if moe else None
        if conformer:
            log_probs, frame_lengths = model_fn.ctc_log_probs(model, audio, cfg, batch["audio_lengths"], time_mask=time_mask)
        else:
            log_probs, frame_lengths = model_fn.ctc_log_probs(model, audio, cfg, batch["audio_lengths"], time_mask=time_mask,
                                                              freeze_feature_encoder=frozen_feature_encoder, aux_out=aux,
                                                              data_group=data_group)
        loss = ctc_loss(log_probs, frame_lengths, batch["labels"], batch["label_lengths"], blank_id=cfg.blank_id)
        if aux:
            loss = loss + moe_aux_weight * sum(aux) / len(aux)  # GShard load balancing, mean over layers
        loss.backward()
        grads = {}
        for name, p in params.items():
            frozen = frozen_feature_encoder and name.startswith("feature_extractor.")
            grads[name] = torch.zeros_like(p) if frozen or p.grad is None else p.grad
        norm_fn = None
        if mesh is not None:
            sync_grads(grads, data_group)
            norm_fn = functools.partial(global_grad_norm, params=params)
        gnorm = optim.global_norm(grads.values()) if norm_fn is None else norm_fn(grads)
        updates, state["opt_state"] = optimizer.update(grads, state["opt_state"],
                                                       {k: p.detach() for k, p in params.items()}, norm_fn)
        optim.apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        state["step"] += 1
        loss = loss.detach()
        if mesh is not None:
            loss = all_reduce(loss, data_group) / n_data
        return state, {"loss": loss, "grad_norm": gnorm}

    return step


def shard_train_step(step_fn, mesh, data_axis: str = "data"):
    """The data-parallel form of a step from make_ctc_train_step over the
    mesh's `data_axis` (ssak_tpu's shard_train_step, which places the batch
    on 'data' and runs the global program): step_fn(state, batch,
    mesh=mesh, data_axis=data_axis)."""
    return functools.partial(step_fn, mesh=mesh, data_axis=data_axis)


def make_ctc_eval_step(cfg, family: str = "wav2vec2"):
    """step(model, batch) -> {loss, tokens (B, F) padded with -1, token_lengths (B,)}."""
    model_fn = _family(family)

    def step(model, batch):
        with torch.no_grad(), _cudnn_benchmark():
            log_probs, frame_lengths = model_fn.ctc_log_probs(model, audio_to_f32(batch["audio"]), cfg, batch["audio_lengths"])
            loss = ctc_loss(log_probs, frame_lengths, batch["labels"], batch["label_lengths"], blank_id=cfg.blank_id)
            tokens, lengths = ctc_greedy_decode(log_probs, frame_lengths, blank_id=cfg.blank_id)
        return {"loss": loss, "tokens": tokens, "token_lengths": lengths}

    return step


def make_whisper_train_step(cfg, optimizer, grad_mask=None, quantized: bool = False):
    """step(state, batch) -> (state, {"loss", "grad_norm"} device scalars).
    batch: {mel (B, n_mels, T) f32, tokens_in (B, U), tokens_out (B, U),
    token_mask (B, U) f32} on the model's device (teacher forcing). The
    state is updated IN PLACE and returned. grad_mask: optional
    fn(grads) -> grads over name -> tensor dicts (models.lora.lora_grad_mask
    for adapter-only training over a full optimizer state).
    quantized=True: the partitioned step (the state from
    init_train_state(..., quantized=True)); grad_norm is the pre-clip norm
    of the trainable gradients."""
    from ssak_tpu_torch.models import whisper
    from ssak_tpu_torch.models.quant import partition_trainable

    def step(state, batch):
        with _cudnn_benchmark():
            return _step(state, batch)

    def _step(state, batch):
        model = state["model"]
        params = partition_trainable(model)[0] if quantized else dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        enc = whisper.encode(model, batch["mel"], cfg)
        logits = whisper.decode_train(model, batch["tokens_in"], enc, cfg)
        loss = whisper.cross_entropy_loss(logits, batch["tokens_out"], batch["token_mask"])
        del enc, logits
        loss.backward()
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in params.items()}
        if grad_mask is not None and not quantized:
            grads = grad_mask(grads)
        gnorm = optim.global_norm(grads.values())
        updates, state["opt_state"] = optimizer.update(grads, state["opt_state"], {k: p.detach() for k, p in params.items()})
        optim.apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step
