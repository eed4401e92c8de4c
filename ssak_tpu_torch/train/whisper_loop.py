"""Whisper seq2seq fine-tuning: host loop and CLI (counterpart of
ssak_tpu.train.whisper_loop).

    python -m ssak_tpu_torch.train.whisper_loop TRAIN_DIR VALID_DIR --base_model HF_WHISPER_DIR \\
        --lora 8 [--load_in_8bit | --load_in_4bit] [--language en] [--device cpu]

Mel windows of 30 s feed one train step per batch (train.steps
.make_whisper_train_step); the evaluation decodes greedily and scores WER;
--lora trains adapters only and writes just the adapter leaves
(adapters-<step>.npz at each evaluation, adapters.npz at the end), a full
fine-tune writes checkpoints in ssak_tpu's format. Under --lora without
quantization the frozen base is cast to bf16 first; --load_in_8bit /
--load_in_4bit quantize it after the adapters are added
(models.quant.quantize_params), so the evaluation decodes with bf16 K/V
caches, as ssak_tpu's does. Without --base_model a seeded tiny_test
Whisper trains on byte pseudo-tokens. --remat (not in ssak_tpu's CLI, whose
train_whisper takes a config with remat) recomputes each block in the
backward pass: the port's attention keeps its scores in f32, so large-v3 at
batch 4 needs it on an 80 GB card (PERF.md).

Runs on `device` (default cuda; raises without a card unless
device="cpu" / --device cpu). The evaluation decodes the live training
module under inference mode and leaves nothing on it: no fused q/k/v, no
quantized copy, no cached tensor.
"""

import argparse
import json
import os
import random

import numpy as np
import torch

from ssak_tpu_torch.train.steps import init_train_state, make_optimizer, make_whisper_train_step


class WhisperBatcher:
    """rows -> {mel, tokens_in, tokens_out, token_mask} on `device`, with
    static shapes: (B, n_mels, 3,000) mel windows and U = max_tokens +
    len(prompt) + 1 token columns."""

    def __init__(self, cfg, tokenizer, language=None, batch_size=4, sample_rate=16000, max_tokens=None,
                 normalize_text=None, device="cpu"):
        self.cfg = cfg
        self.tok = tokenizer
        self.language = language
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.window = cfg.n_audio_ctx * 2 * 160
        self.max_tokens = max_tokens or (cfg.n_text_ctx - 8)
        self.normalize_text = normalize_text or (lambda t: t)
        self.device = torch.device(device)
        if tokenizer is not None:
            self.prompt = tokenizer.sot_sequence(language=language)
            self.eot = tokenizer.eot
        else:
            self.prompt = [cfg.sot, cfg.no_timestamps]
            self.eot = cfg.eot

    def _tokens(self, text):
        if self.tok is not None:
            return self.tok.encode(self.normalize_text(text))
        # seeded test model: the bytes of the text as pseudo-tokens
        return [(b % (self.cfg.n_vocab - 10)) + 10 for b in self.normalize_text(text).encode()][: self.max_tokens]

    def batches(self, rows, seed=None):
        """(batch, rows of the batch) over the rows with text, shuffled by
        random.Random(seed) when seed is given."""
        from ssak_tpu_torch.audio.io import load_audio
        from ssak_tpu_torch.audio.wire import encode_array, to_device_f32
        from ssak_tpu_torch.ops.logmel import log_mel_spectrogram

        rows = [r for r in rows if r.get("text")]
        if seed is not None:
            random.Random(seed).shuffle(rows)
        for i in range(0, len(rows), self.batch_size):
            chunk = rows[i : i + self.batch_size]
            audios = np.zeros((len(chunk), self.window), np.float32)
            U = self.max_tokens + len(self.prompt) + 1
            tokens_in = np.full((len(chunk), U), self.eot, np.int64)
            tokens_out = np.full((len(chunk), U), self.eot, np.int64)
            mask = np.zeros((len(chunk), U), np.float32)
            for j, r in enumerate(chunk):
                a = load_audio(r["audio"], start=r.get("start"), end=r.get("end"), sample_rate=self.sample_rate)
                audios[j, : min(len(a), self.window)] = a[: self.window]
                seq = list(self.prompt) + self._tokens(r["text"])[: self.max_tokens] + [self.eot]
                inp, out = seq[:-1][:U], seq[1:][:U]
                tokens_in[j, : len(inp)] = inp
                tokens_out[j, : len(out)] = out
                mask[j, len(self.prompt) - 1 : len(out)] = 1.0  # predict the text and eot
            # audio crosses as int16 wire words (half the bytes of f32); the
            # f32 decode and the mel run on the device
            mel = log_mel_spectrogram(to_device_f32(encode_array(audios), self.device), n_mels=self.cfg.n_mels)
            dev = self.device
            yield {"mel": mel, "tokens_in": torch.from_numpy(tokens_in).to(dev),
                   "tokens_out": torch.from_numpy(tokens_out).to(dev), "token_mask": torch.from_numpy(mask).to(dev)}, chunk


def train_whisper(model, cfg, tokenizer, train_rows, eval_rows, output_dir, language=None, lora_rank: int = 0,
                  learning_rate=1e-5, warmup_steps=50, max_steps=1000, batch_size=4, eval_steps=200, seed=69,
                  normalize_text=None, log_interval=10, quantize_bits: int = 0, grad_accum: int = 1,
                  max_eval_samples: int = None, device=None, resume: bool = False):
    """Fine-tune `model` (a WhisperModel, moved to `device`) and return
    (state, log_history). lora_rank > 0 trains LoRA adapters on the
    attention query/value projections over a frozen base: bf16, or int8 /
    int4 with quantize_bits (QLoRA); lora_rank 0 trains every float
    parameter. Adapters come from torch.Generator(seed), so they differ
    from ssak_tpu's for the same seed. resume=True continues a full
    fine-tune from the last checkpoint of output_dir (parameters, step and
    optimizer state)."""
    from ssak_tpu_torch.data.prefetch import prefetch_iterator
    from ssak_tpu_torch.models.lora import add_lora, extract_lora
    from ssak_tpu_torch.train.checkpoint import save_checkpoint
    from ssak_tpu_torch.train.steps import with_grad_accumulation
    from ssak_tpu_torch.utils.env import resolve_device
    from ssak_tpu_torch.utils.monitoring import logger

    dev = resolve_device(device)
    model = model.to(dev)
    os.makedirs(output_dir, exist_ok=True)
    if lora_rank:
        if not quantize_bits:
            # the base is frozen under LoRA: held in bf16 (half the bytes
            # of the weight stream), the adapters stay f32
            model = model.to(torch.bfloat16)
        add_lora(model, rank=lora_rank, generator=torch.Generator().manual_seed(seed))
    if quantize_bits:
        from ssak_tpu_torch.models.quant import quantize_params, quantized_bytes

        quantize_params(model, bits=quantize_bits)
        qb, db = quantized_bytes(model)
        logger.info(f"quantized base: {qb / 1e6:.1f} MB on the device (dense bf16 equivalent {db / 1e6:.1f} MB)")
    optimizer = make_optimizer(learning_rate=learning_rate, warmup_steps=warmup_steps, total_steps=max_steps)
    if grad_accum > 1:
        optimizer = with_grad_accumulation(optimizer, grad_accum)
    # the partitioned step whenever a frozen partition exists (quantized
    # base and/or adapters): gradients and optimizer state cover the
    # trainable float parameters only (models.quant.partition_trainable)
    partitioned = bool(quantize_bits) or bool(lora_rank)
    state = init_train_state(model, optimizer, quantized=partitioned)
    if resume:
        _resume(state, output_dir, dev)
    step_fn = make_whisper_train_step(cfg, optimizer, quantized=partitioned)
    batcher = WhisperBatcher(cfg, tokenizer, language=language, batch_size=batch_size, normalize_text=normalize_text,
                             device=dev)

    log_history = []
    # a host-side step counter: the loop reads nothing back from the card between log points
    gstep = int(state["step"])
    epoch = 0
    while gstep < max_steps:
        for batch, _chunk in prefetch_iterator(batcher.batches(train_rows, seed=seed + epoch)):
            state, metrics = step_fn(state, batch)
            gstep += 1
            if gstep % log_interval == 0 or gstep == 1:
                entry = {"step": gstep, "loss": round(float(metrics["loss"]), 4)}
                log_history.append(entry)
                logger.info(f"whisper train {entry}")
            if eval_rows and eval_steps and gstep % eval_steps == 0:
                ev = evaluate_whisper(state["model"], cfg, tokenizer, eval_rows, batcher, normalize_text,
                                      max_samples=max_eval_samples)
                ev["step"] = gstep
                log_history.append(ev)
                logger.info(f"whisper eval {ev}")
                if lora_rank:
                    np.savez(os.path.join(output_dir, f"adapters-{gstep}.npz"), **extract_lora(state["model"]))
                else:
                    save_checkpoint(output_dir, state, metadata=ev, save_total_limit=2)
            if gstep >= max_steps:
                break
        epoch += 1
    with open(os.path.join(output_dir, "trainer_state.json"), "w") as f:
        json.dump({"global_step": gstep, "log_history": log_history}, f, indent=1)
    if lora_rank:
        np.savez(os.path.join(output_dir, "adapters.npz"), **extract_lora(state["model"]))
    else:
        save_checkpoint(output_dir, state, save_total_limit=2)
    return state, log_history


def _resume(state, output_dir, device):
    """Load the last checkpoint of output_dir into a train state: the
    parameters and the step always (an ssak_tpu checkpoint too), the
    optimizer state when the port wrote it."""
    from ssak_tpu_torch.models.convert import load_whisper_tree_
    from ssak_tpu_torch.train.checkpoint import (
        OPT_STATE_FORMAT,
        get_last_checkpoint,
        load_checkpoint,
        opt_state_from_numpy,
    )
    from ssak_tpu_torch.utils.monitoring import logger

    last = get_last_checkpoint(output_dir)
    if last is None:
        raise FileNotFoundError(f"resume: no checkpoint in {output_dir}")
    tree, meta = load_checkpoint(last)
    load_whisper_tree_(state["model"], tree["params"])
    state["step"] = int(np.asarray(tree["step"]))
    if meta.get("opt_state_format") == OPT_STATE_FORMAT:
        state["opt_state"] = opt_state_from_numpy(tree["opt_state"], device)
    else:
        logger.warning(f"{last}: optimizer state not written by this package; starting it afresh")
    logger.info(f"resumed from {last} (step {state['step']})")


def evaluate_whisper(model, cfg, tokenizer, eval_rows, batcher, normalize_text=None, max_samples: int = None):
    """Greedy transcripts of the first `max_samples` eval rows (all when
    None), in batches of batcher.batch_size, scored by WER:
    {"eval_wer": ...}."""
    from ssak_tpu_torch.audio.io import load_audio
    from ssak_tpu_torch.eval.wer import compute_wer
    from ssak_tpu_torch.infer.general import LoadedModel, ModelType
    from ssak_tpu_torch.infer.whisper_infer import whisper_transcribe_batch

    normalize_text = normalize_text or (lambda t: t)
    loaded = LoadedModel(ModelType.WHISPER, model, cfg, batcher.device, tokenizer)
    refs, hyps = {}, {}
    rows = [r for r in eval_rows if r.get("text")]
    if max_samples:
        rows = rows[:max_samples]  # a fixed head: evaluations stay comparable
    B = batcher.batch_size
    for i in range(0, len(rows), B):
        chunk = rows[i : i + B]
        audios = [load_audio(r["audio"], start=r.get("start"), end=r.get("end"), sample_rate=16000) for r in chunk]
        texts = whisper_transcribe_batch(loaded, audios, language=batcher.language)
        for r, t in zip(chunk, texts):
            refs[r["id"]] = normalize_text(r["text"])
            hyps[r["id"]] = normalize_text(t) if t else ""
    wer = compute_wer(refs, hyps)["wer"] if refs else float("nan")
    return {"eval_wer": wer}


def main(argv=None):
    p = argparse.ArgumentParser(description="Fine-tune Whisper on Kaldi data (CUDA)")
    p.add_argument("train")
    p.add_argument("valid")
    p.add_argument("--base_model", default=None, help="HF Whisper checkpoint dir")
    p.add_argument("--output_dir", default="runs/whisper")
    p.add_argument("--language", default=None)
    p.add_argument("--lora", type=int, default=0, help="LoRA rank (0 = full fine-tune)")
    p.add_argument("--load_in_8bit", action="store_true", help="int8 frozen base (pair with --lora)")
    p.add_argument("--load_in_4bit", action="store_true", help="int4 frozen base (pair with --lora)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--grad_accum", type=int, default=1, help="gradient accumulation micro-steps per optimizer update")
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--eval_steps", type=int, default=200)
    p.add_argument("--max_eval_samples", type=int, default=None, help="cap the evaluation's cost (first N utterances)")
    p.add_argument("--max_duration", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=69)
    p.add_argument("--remat", action="store_true",
                   help="recompute each transformer block in the backward pass (WhisperConfig.remat)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import dataclasses

    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.models import whisper as whisper_mod
    from ssak_tpu_torch.models.convert import whisper_from_tree
    from ssak_tpu_torch.text import format_text
    from ssak_tpu_torch.utils.env import resolve_device

    dev = resolve_device(args.device)

    def norm(t):
        if not args.language:
            return t.strip()
        try:
            return format_text(t, args.language, extract_parenthesized=False, safety_checks=False).replace("\n", " ")
        except NotImplementedError:  # a language without a normalizer
            return t.lower()

    _m1, train_rows = kaldi_folder_to_manifest(args.train, max_duration=args.max_duration, seed=args.seed)
    _m2, valid_rows = kaldi_folder_to_manifest(args.valid, max_duration=args.max_duration, seed=args.seed)

    if args.base_model:
        from ssak_tpu_torch.infer.general import _with_tokenizer_ids
        from ssak_tpu_torch.models.hf_loader import load_whisper
        from ssak_tpu_torch.models.tokenizer import WhisperTokenizer

        params, cfg = load_whisper(args.base_model)
        tokenizer = WhisperTokenizer(args.base_model)
        cfg = _with_tokenizer_ids(cfg, tokenizer)
        model = whisper_from_tree(params, dev)
        del params
    else:
        cfg = whisper_mod.make_config("tiny_test")
        with torch.no_grad():
            model = whisper_mod.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg, dev)
        tokenizer = None
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)

    state, _hist = train_whisper(
        model, cfg, tokenizer, train_rows, valid_rows, args.output_dir,
        language=args.language, lora_rank=args.lora, learning_rate=args.learning_rate,
        max_steps=args.max_steps, batch_size=args.batch_size, eval_steps=args.eval_steps,
        max_eval_samples=args.max_eval_samples, seed=args.seed, normalize_text=norm,
        quantize_bits=4 if args.load_in_4bit else (8 if args.load_in_8bit else 0),
        grad_accum=args.grad_accum, device=dev,
    )
    print(json.dumps({"output_dir": args.output_dir, "steps": int(state["step"])}))


if __name__ == "__main__":
    main()
