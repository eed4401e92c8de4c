"""Finalize a training run: export its best checkpoint as a standalone
model directory that `infer.general.load_model` reads (counterpart of
ssak_tpu.train.finalize; `sak-finalize`).

    python -m ssak_tpu_torch.train.finalize RUN_DIR [--output_dir DIR] [--device cpu]

The export is ssak_tpu's format, so either package reads the other's:
    ssak_config.json   {"model_type", "config": {...}}
    weights.npz        the parameter tree, flattened (train.checkpoint._flatten)
    vocab.json         the CTC tokenizer's vocabulary (CTC models)
A Whisper config carries `remat`, the training switch, in both
packages. The export runs on the host; like every entry point of the port, `main` asks for the
card unless --device cpu is given, and raises without one.
"""

import argparse
import dataclasses
import json
import os

import numpy as np


def export_model(params, cfg, output_dir: str, model_type: str = "wav2vec2_ctc", tokenizer=None):
    """Write `params` (an ssak_tpu parameter tree with numpy leaves), `cfg`
    and the tokenizer's vocabulary to `output_dir`."""
    from ssak_tpu_torch.train.checkpoint import _flatten

    os.makedirs(output_dir, exist_ok=True)
    np.savez(os.path.join(output_dir, "weights.npz"), **_flatten(params))
    with open(os.path.join(output_dir, "ssak_config.json"), "w") as f:
        json.dump({"model_type": model_type, "config": dataclasses.asdict(cfg)}, f, indent=1)
    if tokenizer is not None:
        tokenizer.save(os.path.join(output_dir, "vocab.json"))
    return output_dir


def _config_from_meta(mtype: str, conf: dict):
    if mtype == "wav2vec2_ctc":
        from ssak_tpu_torch.models.wav2vec2 import Wav2Vec2Config

        return Wav2Vec2Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in conf.items()})
    if mtype == "conformer_ctc":
        from ssak_tpu_torch.models.conformer import ConformerConfig

        return ConformerConfig(**conf)
    from ssak_tpu_torch.models.whisper import WhisperConfig

    return WhisperConfig(**conf)


def load_exported(model_dir: str):
    """(model_type, parameter tree with numpy leaves, config, CTC tokenizer or None)."""
    from ssak_tpu_torch.train.checkpoint import _unflatten

    with open(os.path.join(model_dir, "ssak_config.json")) as f:
        meta = json.load(f)
    mtype = meta["model_type"]
    cfg = _config_from_meta(mtype, meta["config"])
    with np.load(os.path.join(model_dir, "weights.npz"), allow_pickle=False) as z:
        params = _unflatten({k: z[k] for k in z.files})
    tokenizer = None
    vocab = os.path.join(model_dir, "vocab.json")
    if os.path.exists(vocab):
        from ssak_tpu_torch.models.tokenizer import CTCTokenizer

        tokenizer = CTCTokenizer(vocab)
    return mtype, params, cfg, tokenizer


def finalize_run(run_dir: str, output_dir: str = None, model_type: str = "wav2vec2_ctc"):
    """Export the best (or last) checkpoint of a run as run_dir/final (or
    `output_dir`), with the run's config and vocabulary. Returns the
    directory."""
    from ssak_tpu_torch.train.checkpoint import list_checkpoints, load_checkpoint

    output_dir = output_dir or os.path.join(run_dir, "final")
    cks = list_checkpoints(run_dir)
    if not cks:
        raise FileNotFoundError(f"no checkpoints in {run_dir}")
    best = None
    best_meta = None
    for ck in cks:
        with open(os.path.join(ck, "metadata.json")) as f:
            meta = json.load(f)
        if best is None or meta.get("eval_wer", float("inf")) <= best_meta.get("eval_wer", float("inf")):
            if meta.get("best_step", -1) == meta.get("step") or "eval_wer" in meta or best is None:
                best, best_meta = ck, meta
    state, meta = load_checkpoint(best)
    params = state["params"]

    vocab_path = os.path.join(run_dir, "vocab.json")
    tokenizer = None
    if os.path.exists(vocab_path):
        from ssak_tpu_torch.models.tokenizer import CTCTokenizer

        tokenizer = CTCTokenizer(vocab_path)
    cfg_path = os.path.join(run_dir, "ssak_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            saved = json.load(f)
        model_type = saved.get("model_type", model_type)
        cfg = _config_from_meta(model_type, saved["config"])
    else:
        # no config beside the run: the dimensions from the parameters (the head gives the vocabulary)
        from ssak_tpu_torch.models.wav2vec2 import make_config

        vocab_size = np.asarray(params["lm_head"]["kernel"]).shape[1]
        hidden = np.asarray(params["lm_head"]["kernel"]).shape[0]
        cfg = make_config("tiny_test" if hidden <= 128 else "base", vocab_size=vocab_size)
    export_model(params, cfg, output_dir, model_type=model_type, tokenizer=tokenizer)
    with open(os.path.join(output_dir, "finalize_info.json"), "w") as f:
        json.dump({"source_checkpoint": best, **{k: v for k, v in meta.items() if not isinstance(v, (list, dict))}}, f, indent=1)
    return output_dir


def main(argv=None):
    p = argparse.ArgumentParser(description="Export the best checkpoint of a run as a standalone model dir")
    p.add_argument("run_dir")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; the export runs on the host, the option only follows the port's "
                        "rule that an entry point asks for the card unless told otherwise")
    args = p.parse_args(argv)
    from ssak_tpu_torch.utils.env import resolve_device

    resolve_device(args.device)
    print(finalize_run(args.run_dir, args.output_dir))


if __name__ == "__main__":
    main()
