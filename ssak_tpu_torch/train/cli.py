"""`sak-train` for the port: CTC fine-tuning on Kaldi data, wav2vec2 or
Conformer (counterpart of ssak_tpu.train.cli).

    python -m ssak_tpu_torch.train.cli TRAIN_DIR VALID_DIR --output_dir runs [--device cpu]

Kaldi dirs (or list files of "<dir> [weight]") in; a run dir named from a
hash of the arguments; README + source snapshot + vocab.json +
ssak_config.json for provenance; resume from the last checkpoint. With
--base_model DIR the model is an HF wav2vec2 checkpoint with its own
vocab.json (a checkpoint without a CTC head gets a fresh seeded one), or a
NeMo Conformer-CTC archive (.nemo, or its extracted directory) with the
archive's own vocabulary (family conformer, model_type conformer_ctc; the
training text is encoded character by character, as ssak_tpu does);
without it, the seeded tiny_test wav2vec2 with a character vocabulary
built from the training text. Runs on cuda unless --device cpu. Export a
run with `python -m ssak_tpu_torch.train.finalize RUN_DIR`.

Not ported yet, refused at start: --config / --set (YAML configs, ROADMAP.md
slice 8e), --data_augment (slice 8f) and --use_manifest_cache (8e).
"""

import argparse
import dataclasses
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(description="Fine-tune a CTC model (wav2vec2 or Conformer) on Kaldi data (PyTorch/CUDA port)")
    p.add_argument("train", help="Kaldi dir or weighted list file")
    p.add_argument("valid", help="Kaldi dir or list file")
    p.add_argument("--config", default=None, help="YAML config file (not ported yet)")
    p.add_argument("--set", dest="overrides", action="append", default=[], help="config override a.b=value (not ported yet)")
    p.add_argument("--mask_time_prob", type=float, default=0.05, help="on-device span-mask probability")
    p.add_argument("--base_model", default=None,
                   help="HF wav2vec2 checkpoint dir or NeMo Conformer-CTC archive (omit for a seeded tiny model)")
    p.add_argument("--output_dir", default="runs")
    p.add_argument("--language", default="fr")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--grad_accum", type=int, default=1, help="gradient accumulation micro-steps per optimizer update")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--max_steps", type=int, default=10000)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--eval_steps", type=int, default=500)
    p.add_argument("--save_total_limit", type=int, default=2)
    p.add_argument("--early_stopping", type=int, default=15)
    p.add_argument("--min_duration", type=float, default=0.1)
    p.add_argument("--max_data", type=int, default=None, help="cap utterance count")
    p.add_argument("--choose_data_with_max_duration", action="store_true",
                   help="with --max_data: keep the longest utterances instead of a random subset")
    p.add_argument("--use_manifest_cache", action="store_true", help="(not ported yet)")
    p.add_argument("--max_duration", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=69)
    p.add_argument("--data_augment", action="store_true", help="(not ported yet)")
    p.add_argument("--data_augment_noise", default=None)
    p.add_argument("--data_augment_rir", default=None)
    p.add_argument("--no_freeze_feature_encoder", dest="freeze", action="store_false", default=True)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adadelta", "sb_dual"],
                   help="sb_dual = Adam trunk + Adadelta head (SpeechBrain recipe)")
    p.add_argument("--schedule", default="linear", choices=["linear", "cosine", "constant", "newbob"],
                   help="newbob = anneal LR on small relative WER improvement")
    p.add_argument("--head_lr", type=float, default=1.0, help="head LR for --optimizer sb_dual")
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--no-resume", dest="resume", action="store_false")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def args_to_run_name(args) -> str:
    from ssak_tpu_torch.utils.misc import hashmd5

    key = {k: v for k, v in sorted(vars(args).items()) if k not in ("output_dir", "resume", "device")}
    return f"ctc_b{args.batch_size}_lr{args.learning_rate}_s{args.seed}_{hashmd5(key)[:8]}"


def _refuse_unported(args):
    if args.config or args.overrides:
        raise NotImplementedError("--config / --set (YAML configs) are not ported yet (ROADMAP.md slice 8e)")
    if args.data_augment:
        raise NotImplementedError("--data_augment is not ported yet (ROADMAP.md slice 8f)")
    if args.use_manifest_cache:
        raise NotImplementedError("--use_manifest_cache is not ported yet (ROADMAP.md slice 8e)")


def base_model(model_dir: str, seed: int, device):
    """(module, config, tokenizer) of an HF wav2vec2 checkpoint to fine-tune:
    its tree as ssak_tpu's load_wav2vec2 gives it, and its vocab.json. A
    checkpoint without a CTC head gets a fresh one from the port's seeded
    initializer (N(0, 1/d) weights, zero bias, torch.Generator `seed`),
    which is not the JAX package's PRNGKey draw."""
    import torch

    from ssak_tpu_torch.models.convert import wav2vec2_from_tree
    from ssak_tpu_torch.models.hf_loader import load_wav2vec2
    from ssak_tpu_torch.models.layers import linear_init
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer

    params, cfg = load_wav2vec2(model_dir)
    tokenizer = CTCTokenizer(os.path.join(model_dir, "vocab.json"))
    if "lm_head" not in params:
        head = linear_init(torch.Generator().manual_seed(seed), cfg.hidden_size, cfg.vocab_size)
        params["lm_head"] = {"kernel": head.weight.detach().numpy().T.copy(), "bias": head.bias.detach().numpy()}
    return wav2vec2_from_tree(params, device), cfg, tokenizer


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    from ssak_tpu_torch.utils.env import resolve_device

    device = resolve_device(args.device)

    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer
    from ssak_tpu_torch.text import format_text
    from ssak_tpu_torch.train.loop import CTCTrainer
    from ssak_tpu_torch.utils.misc import save_source_dir
    from ssak_tpu_torch.utils.monitoring import logger

    run_dir = os.path.join(args.output_dir, args_to_run_name(args))
    os.makedirs(run_dir, exist_ok=True)

    def norm(t):
        try:
            return format_text(t, args.language, extract_parenthesized=False, safety_checks=False).replace("\n", " ")
        except Exception:
            return t.lower()

    meta_tr, train_rows = kaldi_folder_to_manifest(
        args.train, min_duration=args.min_duration, max_duration=args.max_duration, max_data=args.max_data,
        choose_data_with_max_duration=args.choose_data_with_max_duration, seed=args.seed)
    meta_va, valid_rows = kaldi_folder_to_manifest(args.valid, max_duration=args.max_duration, seed=args.seed)
    logger.info(f"train: {meta_tr} valid: {meta_va}")

    family, model_type = "wav2vec2", "wav2vec2_ctc"
    if args.base_model and (args.base_model.endswith(".nemo")
                            or os.path.exists(os.path.join(args.base_model, "model_config.yaml"))):
        # a pretrained NeMo Conformer, its own vocabulary kept (a same-language fine-tune)
        from ssak_tpu_torch.infer.general import load_model

        m = load_model(args.base_model, device=device)
        model, cfg, tokenizer = m.module, m.cfg, m.tokenizer
        family, model_type = "conformer", "conformer_ctc"
    elif args.base_model:
        model, cfg, tokenizer = base_model(args.base_model, args.seed, device)
    else:
        tokenizer = CTCTokenizer.from_corpus([norm(r["text"] or "") for r in train_rows])
        cfg = wav2vec2.make_config("tiny_test", vocab_size=max(32, len(tokenizer)))
        model = wav2vec2.init_params(cfg, seed=args.seed, device=device)

    with open(os.path.join(run_dir, "README.txt"), "w") as f:
        f.write(" ".join(sys.argv) + "\n\n")
        f.write(json.dumps({"train": meta_tr, "valid": meta_va, "vocab_size": len(tokenizer)}, indent=1))
    save_source_dir(run_dir)
    tokenizer.save(os.path.join(run_dir, "vocab.json"))
    with open(os.path.join(run_dir, "ssak_config.json"), "w") as f:
        json.dump({"model_type": model_type, "config": dataclasses.asdict(cfg)}, f, indent=1)

    trainer = CTCTrainer(
        cfg, model, tokenizer, run_dir,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, total_steps=args.max_steps,
        batch_size=args.batch_size, eval_steps=args.eval_steps,
        save_total_limit=args.save_total_limit, early_stopping_patience=args.early_stopping,
        freeze_feature_encoder=args.freeze, mask_time_prob=args.mask_time_prob, seed=args.seed,
        normalize_text=norm, optimizer=args.optimizer, schedule=args.schedule, head_lr=args.head_lr,
        grad_accum=args.grad_accum, family=family, device=device,
    )
    if args.resume:
        trainer.resume()
    trainer.train(train_rows, valid_rows, max_epochs=args.max_epochs, max_steps=args.max_steps)
    print(json.dumps({"run_dir": run_dir, "best_wer": trainer.best_wer, "best_step": trainer.best_step}))


if __name__ == "__main__":
    main()
