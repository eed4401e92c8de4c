"""Kaldi dir -> JSONL manifest / tarred dataset (the port's counterpart of
tools/kaldi2manifest.py):

    python -m ssak_tpu_torch.tools.kaldi2manifest manifest <kaldi_dir> <out.jsonl> [--language fr]
    ... merge <out.jsonl> <in1.jsonl> <in2.jsonl> ...
    ... tar <kaldi_dir_or_list> <out_dir> [--shard_size 512]
    ... tokenizer <out_dir> --manifest a.jsonl[,b.jsonl] | --data_file txt [--vocab_size 1024 --type bpe|char]
    ... split <in.jsonl> <out_dir> [--ratios 0.8 0.1 0.1 --seed 42]
        honors per-row "split" fields, groups by speaker
    ... clean <in.jsonl> <out.jsonl> [--language fr]
    ... listfiles <dataset_list> <dataset_root> <out> --mode train|dev|test [--subset nocasepunc]

Host only: no card is used. The BPE tokenizer is trained in plain Python
(models/tokenizer.train_bpe_tokenizer).
"""

import argparse
import json
import os

def cmd_manifest(args):
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest

    _meta, rows = kaldi_folder_to_manifest(args.kaldi_dir)
    norm = None
    if args.language:
        from ssak_tpu_torch.text import format_text

        def norm(t):
            return format_text(t, args.language, extract_parenthesized=False, safety_checks=False).replace("\n", " ")

    with open(args.out, "w", encoding="utf-8") as f:
        for r in rows:
            text = r["text"] or ""
            entry = {
                "audio_filepath": r["audio"],
                "offset": r["start"],
                "duration": r["duration"],
                "text": norm(text) if norm else text,
                "utt_id": r["id"],
                "speaker": r["speaker"],
            }
            f.write(json.dumps(entry, ensure_ascii=False) + "\n")
    print(f"{args.out}: {len(rows)} entries")


def cmd_merge(args):
    n = 0
    with open(args.out, "w", encoding="utf-8") as fo:
        for path in args.inputs:
            with open(path, encoding="utf-8") as fi:
                for line in fi:
                    if line.strip():
                        fo.write(line if line.endswith("\n") else line + "\n")
                        n += 1
    print(f"{args.out}: {n} entries")


def cmd_tar(args):
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.data.tarred import create_tarred_dataset

    _meta, rows = kaldi_folder_to_manifest(args.source)
    meta = create_tarred_dataset(rows, args.out_dir, shard_size=args.shard_size)
    print(json.dumps(meta))


def _iter_manifest_texts(paths):
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    yield json.loads(line).get("text", "")


def cmd_tokenizer(args):
    """Train an ASR tokenizer from manifests or a raw text file."""
    os.makedirs(args.out_dir, exist_ok=True)
    if args.manifest:
        texts = list(_iter_manifest_texts(args.manifest.split(",")))
    else:
        with open(args.data_file, encoding="utf-8") as f:
            texts = [l.strip() for l in f if l.strip()]
    if args.type == "char":
        from ssak_tpu_torch.models.tokenizer import CTCTokenizer

        tk = CTCTokenizer.from_corpus(texts)
        tk.save(os.path.join(args.out_dir, "vocab.json"))
        print(json.dumps({"type": "char", "vocab_size": len(tk), "out": args.out_dir}))
    else:
        from ssak_tpu_torch.models.tokenizer import train_bpe_tokenizer

        tk = train_bpe_tokenizer(texts, vocab_size=args.vocab_size,
                                 save_path=os.path.join(args.out_dir, "tokenizer.json"))
        print(json.dumps({"type": "bpe", "vocab_size": tk.get_vocab_size(), "out": args.out_dir}))
    with open(os.path.join(args.out_dir, "corpus_stats.json"), "w") as f:
        json.dump({"documents": len(texts), "characters": sum(len(t) for t in texts)}, f)


def cmd_split(args):
    """Split a manifest into train/validation/test jsonl files. Rows with an
    explicit "split" field keep it; the rest are split speaker-disjointly by
    the ratios."""
    import random

    with open(args.input, encoding="utf-8") as f:
        rows = [json.loads(l) for l in f if l.strip()]
    splits = {"train": [], "validation": [], "test": []}
    by_spk = {}
    loose = []
    for r in rows:
        s = r.get("split", "all")
        s = {"dev": "validation", "valid": "validation"}.get(s, s)
        if s in splits:
            splits[s].append(r)
        elif r.get("speaker"):
            by_spk.setdefault(r["speaker"], []).append(r)
        else:
            loose.append(r)
    train_r, dev_r, test_r = (args.ratios + [0.0, 0.0])[:3]
    rng = random.Random(args.seed)
    speakers = sorted(by_spk)
    rng.shuffle(speakers)
    n = len(speakers)
    n_train = round(n * train_r)
    n_dev = round(n * dev_r) if test_r > 0 else n - n_train
    for i, spk in enumerate(speakers):
        dest = "train" if i < n_train else ("validation" if i < n_train + n_dev else "test")
        splits[dest].extend(by_spk[spk])
    rng.shuffle(loose)
    n = len(loose)
    n_train = round(n * train_r)
    n_dev = round(n * dev_r) if test_r > 0 else n - n_train
    splits["train"].extend(loose[:n_train])
    splits["validation"].extend(loose[n_train:n_train + n_dev])
    splits["test"].extend(loose[n_train + n_dev:])
    os.makedirs(args.out_dir, exist_ok=True)
    report = {}
    for name, items in splits.items():
        if not items:
            continue
        with open(os.path.join(args.out_dir, f"{name}.jsonl"), "w", encoding="utf-8") as f:
            for r in items:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
        report[name] = len(items)
    print(json.dumps(report))


def cmd_clean(args):
    """Normalize the text field of an existing manifest."""
    from ssak_tpu_torch.text import format_text

    n = 0
    with open(args.input, encoding="utf-8") as fi, open(args.out, "w", encoding="utf-8") as fo:
        for line in fi:
            if not line.strip():
                continue
            r = json.loads(line)
            r["text"] = format_text(r.get("text", ""), args.language,
                                    extract_parenthesized=False, safety_checks=False).replace("\n", " ")
            if r["text"] or args.keep_empty:
                fo.write(json.dumps(r, ensure_ascii=False) + "\n")
                n += 1
    print(f"{args.out}: {n} entries")


def cmd_listfiles(args):
    """Resolve a list of dataset names to concrete kaldi-dir paths for one
    mode: prefers
    <root>/<name>/<subset> when it has a wav.scp, falls back to the dataset
    dir itself (matching eval/test/dev name hints), else scans the subset
    dir for train/dev/test split subfolders."""
    import re

    with open(args.dataset_list, encoding="utf-8") as f:
        names = [l.strip() for l in f if l.strip()]
    patterns = {"train": r"train$|split\d$", "dev": r"dev$|split\d_dev$", "test": r"test$|split\d_test$"}[args.mode]
    out = []
    for name in names:
        base = os.path.join(args.dataset_root, name)
        subset = os.path.join(base, args.subset) if args.subset else base
        if os.path.exists(os.path.join(subset, "wav.scp")):
            out.append(subset)
        elif os.path.exists(os.path.join(base, "wav.scp")):
            hinted = "test" if ("eval" in name or "test" in name) else ("dev" if "dev" in name else "train")
            if hinted == args.mode:
                out.append(base)
        elif os.path.isdir(subset):
            for sub in sorted(os.listdir(subset)):
                if re.search(patterns, sub) and os.path.exists(os.path.join(subset, sub, "wav.scp")):
                    out.append(os.path.join(subset, sub))
    with open(args.out, "w") as f:
        f.write("\n".join(out) + ("\n" if out else ""))
    print(f"{args.out}: {len(out)} dirs")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("manifest")
    s.add_argument("kaldi_dir"); s.add_argument("out")
    s.add_argument("--language", default=None)
    s.set_defaults(fn=cmd_manifest)

    s = sub.add_parser("merge")
    s.add_argument("out"); s.add_argument("inputs", nargs="+")
    s.set_defaults(fn=cmd_merge)

    s = sub.add_parser("tar")
    s.add_argument("source"); s.add_argument("out_dir")
    s.add_argument("--shard_size", type=int, default=512)
    s.set_defaults(fn=cmd_tar)

    s = sub.add_parser("tokenizer")
    s.add_argument("out_dir")
    s.add_argument("--manifest", default=None, help="comma-separated jsonl manifests")
    s.add_argument("--data_file", default=None, help="raw text corpus (one doc per line)")
    s.add_argument("--vocab_size", type=int, default=1024)
    s.add_argument("--type", choices=["bpe", "char"], default="bpe")
    s.set_defaults(fn=cmd_tokenizer)

    s = sub.add_parser("split")
    s.add_argument("input"); s.add_argument("out_dir")
    s.add_argument("--ratios", type=float, nargs="+", default=[0.8, 0.1, 0.1])
    s.add_argument("--seed", type=int, default=42)
    s.set_defaults(fn=cmd_split)

    s = sub.add_parser("clean")
    s.add_argument("input"); s.add_argument("out")
    s.add_argument("--language", default="fr")
    s.add_argument("--keep_empty", action="store_true")
    s.set_defaults(fn=cmd_clean)

    s = sub.add_parser("listfiles")
    s.add_argument("dataset_list"); s.add_argument("dataset_root"); s.add_argument("out")
    s.add_argument("--mode", choices=["train", "dev", "test"], required=True)
    s.add_argument("--subset", default=None)
    s.set_defaults(fn=cmd_listfiles)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
