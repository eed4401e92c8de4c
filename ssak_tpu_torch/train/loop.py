"""Host-side CTC fine-tuning loop (counterpart of ssak_tpu.train.loop.CTCTrainer).

Duration-bucketed static-shape batches (int16 wire audio, power-of-two label
widths with a floor of 16, dummy rows with label length 0) come from a
prefetch thread and feed one train step per batch; eval computes loss and
greedy WER; checkpoints rotate with save_total_limit while the best-WER one
is kept; early stopping on WER; trainer_state.json keeps the HF-schema
log history; resume restarts from the last checkpoint. The step counter
lives on the host, and nothing is read back from the card between log
points.

Runs on `device` (default cuda, via resolve_device; raises without a card
unless device="cpu"). Families: wav2vec2 and conformer (`family`, as in
ssak_tpu). An `augmenter` (augment.SpeechAugment) rewrites each batch's
waveforms on the host, in the prefetch thread, before the wire encoding:
evaluation batches too, as in ssak_tpu.
"""

import json
import os

import numpy as np
import torch

from ssak_tpu_torch.audio.wire import encode_array
from ssak_tpu_torch.data.dataset import bucketed_audio_batches
from ssak_tpu_torch.data.prefetch import prefetch_iterator
from ssak_tpu_torch.train.checkpoint import (
    OPT_STATE_FORMAT,
    get_last_checkpoint,
    load_checkpoint,
    opt_state_from_numpy,
    rotate_checkpoints,
    save_checkpoint,
)
from ssak_tpu_torch.train.steps import (
    NewBob,
    init_train_state,
    make_ctc_eval_step,
    make_ctc_train_step,
    make_newbob_optimizer,
    make_optimizer,
    make_sb_ctc_optimizer,
    set_learning_rate,
    with_grad_accumulation,
)
from ssak_tpu_torch.utils.env import resolve_device
from ssak_tpu_torch.utils.monitoring import ThroughputMeter, logger


class CTCTrainer:
    def __init__(
        self,
        cfg,
        model,
        tokenizer,
        output_dir: str,
        learning_rate: float = 1e-4,
        weight_decay: float = 0.01,
        warmup_steps: int = 500,
        total_steps: int = 10000,
        batch_size: int = 8,
        eval_steps: int = 500,
        save_total_limit: int = 2,
        early_stopping_patience: int = 15,
        freeze_feature_encoder: bool = True,
        mask_time_prob: float = 0.05,
        augmenter=None,
        sample_rate: int = 16000,
        buckets=(2.0, 4.0, 8.0, 15.0, 30.0),
        seed: int = 69,
        normalize_text=None,
        optimizer: str = "adamw",
        schedule: str = "linear",
        head_lr: float = 1.0,
        newbob_improvement_threshold: float = 0.0025,
        newbob_annealing_factor: float = 0.8,
        newbob_patient: int = 0,
        grad_accum: int = 1,
        family: str = "wav2vec2",
        device=None,
    ):
        """model: a Wav2Vec2Model, or a ConformerModel with family="conformer"
        (moved to `device`)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.output_dir = output_dir
        self.batch_size = batch_size
        self.eval_steps = eval_steps
        self.save_total_limit = save_total_limit
        self.early_stopping_patience = early_stopping_patience
        self.augmenter = augmenter
        self.sample_rate = sample_rate
        self.buckets = buckets
        self.seed = seed
        self.total_steps = total_steps
        self.normalize_text = normalize_text or (lambda t: t)

        os.makedirs(output_dir, exist_ok=True)
        self.newbob = None
        if schedule == "newbob":
            self.optimizer = make_newbob_optimizer(learning_rate, optimizer=optimizer, weight_decay=weight_decay, head_lr=head_lr)
            self.newbob = NewBob(learning_rate, improvement_threshold=newbob_improvement_threshold,
                                 annealing_factor=newbob_annealing_factor, patient=newbob_patient)
        elif optimizer == "sb_dual":
            self.optimizer = make_sb_ctc_optimizer(pretrained_lr=learning_rate, head_lr=head_lr)
        else:
            self.optimizer = make_optimizer(learning_rate=learning_rate, weight_decay=weight_decay,
                                            warmup_steps=warmup_steps, total_steps=total_steps, schedule=schedule)
        if grad_accum > 1:
            self.optimizer = with_grad_accumulation(self.optimizer, grad_accum)
        self.family = family
        self.state = init_train_state(model.to(self.device), self.optimizer)
        self.train_step = make_ctc_train_step(cfg, self.optimizer, frozen_feature_encoder=freeze_feature_encoder,
                                              mask_time_prob=mask_time_prob, family=family)
        self.eval_step = make_ctc_eval_step(cfg, family=family)
        self.log_history = []
        self.best_wer = float("inf")
        self.best_step = -1
        self.epoch = 0.0

    # --- data -------------------------------------------------------------

    def _encode_labels(self, rows):
        labels = [self.tokenizer.encode(self.normalize_text(r["text"] or "")) for r in rows]
        # power-of-two label width, floor 16: few distinct shapes per bucket
        U = max(1, max((len(l) for l in labels), default=1))
        W = 16
        while W < U:
            W *= 2
        out = np.zeros((len(labels), W), np.int32)
        lens = np.zeros((len(labels),), np.int32)
        for i, l in enumerate(labels):
            out[i, : len(l)] = l
            lens[i] = len(l)
        return out, lens

    def _batches(self, rows, shuffle_seed=None):
        dev = self.device
        for x, lens, chunk in bucketed_audio_batches(rows, self.batch_size, sample_rate=self.sample_rate,
                                                     buckets=self.buckets, output_rows=True, seed=shuffle_seed):
            real = [r for r in chunk if r is not None]
            if not real:
                continue
            if self.augmenter is not None:
                # one speed factor for the batch; a longer row is cut to the bucket
                audios = self.augmenter.augment_batch([x[i, : lens[i]] for i in range(len(real))])
                x = np.zeros_like(x)
                for i, a in enumerate(audios):
                    n = min(len(a), x.shape[1])
                    x[i, :n] = a[:n]
                    lens[i] = n
            labels, label_lens = self._encode_labels(real)
            if len(real) < x.shape[0]:  # label rows for the batch-pad dummies
                pad = x.shape[0] - len(real)
                labels = np.concatenate([labels, np.zeros((pad, labels.shape[1]), np.int32)])
                label_lens = np.concatenate([label_lens, np.zeros((pad,), np.int32)])
            # audio ships as int16 wire words (f32 if any sample is outside
            # [-1, 1]); the cast back to f32 is steps.audio_to_f32, on the card
            x = encode_array(x)
            # audio seconds ride along as host data: the hot loop reads nothing back from the card
            audio_s = float(np.asarray(lens, np.float64).sum()) / self.sample_rate
            batch = {
                "audio": torch.from_numpy(x).to(dev),
                "audio_lengths": torch.from_numpy(lens).to(dev),
                "labels": torch.from_numpy(labels).to(dev),
                "label_lengths": torch.from_numpy(label_lens).to(dev),
            }
            yield batch, real, audio_s

    # --- eval -------------------------------------------------------------

    def evaluate(self, eval_rows):
        from ssak_tpu_torch.eval.wer import compute_wer

        losses, refs, hyps = [], {}, {}
        for batch, real, _audio_s in self._batches(eval_rows):
            out = self.eval_step(self.state["model"], batch)
            losses.append(float(out["loss"]))
            tokens = out["tokens"].cpu().numpy()
            tlens = out["token_lengths"].cpu().numpy()
            for i, r in enumerate(real):
                refs[r["id"]] = self.normalize_text(r["text"] or "")
                hyps[r["id"]] = self.tokenizer.decode(tokens[i, : tlens[i]])
        wer = compute_wer(refs, hyps)["wer"] if refs else float("inf")
        return {"eval_loss": float(np.mean(losses)) if losses else float("nan"), "eval_wer": wer}

    # --- checkpointing ----------------------------------------------------

    def save(self, metrics=None):
        meta = {"epoch": self.epoch, "log_history": self.log_history[-5:], "best_wer": self.best_wer,
                "best_step": self.best_step, **(metrics or {})}
        path = save_checkpoint(self.output_dir, self.state, metadata=meta)
        keep = ()
        if self.best_step >= 0:
            keep = (os.path.join(self.output_dir, f"checkpoint-{self.best_step}"),)
        rotate_checkpoints(self.output_dir, self.save_total_limit, keep=keep)
        return path

    def resume(self):
        """Load the last checkpoint of output_dir: params and step always
        (an ssak_tpu checkpoint too), the optimizer state when the port wrote it."""
        from ssak_tpu_torch.models.convert import load_ctc_tree_

        last = get_last_checkpoint(self.output_dir)
        if last is None:
            return False
        tree, meta = load_checkpoint(last)
        load_ctc_tree_(self.state["model"], tree["params"])
        self.state["step"] = int(np.asarray(tree["step"]))
        if meta.get("opt_state_format") == OPT_STATE_FORMAT:
            self.state["opt_state"] = opt_state_from_numpy(tree["opt_state"], self.device)
        else:
            logger.warning(f"{last}: optimizer state not written by this package; starting it afresh")
        self.epoch = meta.get("epoch", 0.0)
        self.best_wer = meta.get("best_wer", float("inf"))
        self.best_step = meta.get("best_step", -1)
        logger.info(f"resumed from {last} (step {meta['step']})")
        return True

    def _write_trainer_state(self):
        with open(os.path.join(self.output_dir, "trainer_state.json"), "w") as f:
            json.dump({"global_step": int(self.state["step"]), "epoch": self.epoch, "best_metric": self.best_wer,
                       "log_history": self.log_history}, f, indent=1)

    # --- main loop --------------------------------------------------------

    def train(self, train_rows, eval_rows=None, max_epochs: int = None, max_steps: int = None,
              log_interval: int = 10, final_save: bool = True):
        """final_save=False skips the end-of-run checkpoint write."""
        max_steps = max_steps or self.total_steps
        meter = ThroughputMeter()
        stop = False
        bad_evals = 0
        epoch = int(self.epoch)
        gstep = int(self.state["step"])
        while not stop:
            # decode, pad and copy to the card run ahead in a worker thread
            for batch, real, audio_s in prefetch_iterator(self._batches(train_rows, shuffle_seed=self.seed + epoch)):
                self.state, metrics = self.train_step(self.state, batch)
                gstep += 1
                meter.update(audio_s)
                if gstep % log_interval == 0 or gstep == 1:
                    entry = {
                        "step": gstep,
                        "epoch": round(self.epoch, 4),
                        "loss": round(float(metrics["loss"]), 4),
                        "grad_norm": round(float(metrics["grad_norm"]), 4),
                        "audio_s_per_s": round(meter.audio_seconds_per_second, 2),
                    }
                    self.log_history.append(entry)
                    logger.info(f"train {entry}")
                self.epoch += len(real) / max(1, len(train_rows))
                if eval_rows is not None and self.eval_steps and gstep % self.eval_steps == 0:
                    ev = self.evaluate(eval_rows)
                    ev["step"] = gstep
                    if self.newbob is not None:
                        new_lr = self.newbob(ev["eval_wer"])
                        self.state["opt_state"] = set_learning_rate(self.state["opt_state"], new_lr)
                        ev["learning_rate"] = new_lr
                    self.log_history.append(ev)
                    logger.info(f"eval {ev}")
                    if ev["eval_wer"] < self.best_wer:
                        self.best_wer = ev["eval_wer"]
                        self.best_step = gstep
                        bad_evals = 0
                    else:
                        bad_evals += 1
                    self.save(metrics=ev)
                    self._write_trainer_state()
                    if self.early_stopping_patience and bad_evals >= self.early_stopping_patience:
                        logger.info(f"early stopping at step {gstep} (patience {self.early_stopping_patience})")
                        stop = True
                        break
                if gstep >= max_steps:
                    stop = True
                    break
            epoch += 1
            if max_epochs is not None and epoch >= max_epochs:
                stop = True
        if eval_rows is not None:
            ev = self.evaluate(eval_rows)
            ev["step"] = int(self.state["step"])
            self.log_history.append(ev)
            if ev["eval_wer"] < self.best_wer:
                self.best_wer = ev["eval_wer"]
                self.best_step = ev["step"]
        if final_save:
            self.save()
            self._write_trainer_state()
        return self.log_history
