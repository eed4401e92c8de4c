"""Kaldi data-dir manipulation (the port's counterpart of
tools/kaldi_tools.py): stats, split, subsample, validate/fix.

    python -m ssak_tpu_torch.tools.kaldi_tools stats <dir> [...]
    ... split <dir> <out_prefix> --ratios 0.8 0.1 0.1 [--by_utterance]
    ... subsample <dir> <out> --n 100 [--mode head|random|spread]
    ... fix <dir> [--language fr]
    ... glue <dir> <out> [--max_silence 0.5 --max_duration 15 --mode overlap|all]
    ... rename <dir> <out> --char : --replacement - [--utt_ids_only|--audio_ids_only]
    ... spk2gender <dir> [--force] [--device cpu]
    ... duration <files/dirs...>
    ... move <dataset_dir> <target_dir> [--kaldi_annotations d]

Host only: no card is used. spk2gender (utils.gender's pitch heuristic)
follows the port's rule for entry points all the same: it asks for the
card unless --device cpu is given, and raises without one.
"""

import argparse
import json
import os

def cmd_stats(args):
    from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset

    for d in args.dirs:
        ds = KaldiDataset.load(d)
        durs = [r.duration or 0.0 for r in ds]
        genders = {}
        for r in ds:
            if r.gender:
                genders[r.gender] = genders.get(r.gender, 0) + 1
        stats = {
            "dir": d,
            "utterances": len(ds),
            "speakers": len(ds.speakers()),
            "total_hours": round(ds.total_duration() / 3600, 4),
            "min_duration": round(min(durs), 3) if durs else 0,
            "max_duration": round(max(durs), 3) if durs else 0,
            "mean_duration": round(sum(durs) / len(durs), 3) if durs else 0,
            "genders": genders,
        }
        print(json.dumps(stats))


def cmd_split(args):
    from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset

    ds = KaldiDataset.load(args.dir)
    parts = ds.split(ratios=tuple(args.ratios), by_speaker=not args.by_utterance, seed=args.seed)
    names = ["train", "dev", "test"][: len(parts)]
    for part, name in zip(parts, names):
        out = f"{args.out_prefix}_{name}"
        part.save(out)
        print(f"{out}: {len(part)} utts")


def cmd_subsample(args):
    import random

    from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset

    ds = KaldiDataset.load(args.dir)
    rows = list(ds.rows)
    if args.mode == "random":
        random.Random(args.seed).shuffle(rows)
        rows = rows[: args.n]
    elif args.mode == "spread":
        step = max(1, len(rows) // max(1, args.n))
        rows = rows[::step][: args.n]
    else:
        rows = rows[: args.n]
    KaldiDataset(rows).save(args.out)
    print(f"{args.out}: {len(rows)} utts")


def cmd_fix(args):
    from ssak_tpu_torch.data.kaldi import check_kaldi_dir

    report = check_kaldi_dir(args.dir, fix=True, language=args.language)
    print(json.dumps({k: v for k, v in report.items() if k != "removed_utts"} | {"removed": len(report["removed_utts"])}))


def cmd_glue(args):
    from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset
    from ssak_tpu_torch.data.segment_ops import glue_overlapping_segments

    ds = KaldiDataset.load(args.dir)
    n_before = len(ds)
    glued = glue_overlapping_segments(ds, max_silence=args.max_silence, max_duration=args.max_duration, mode=args.mode)
    glued.save(args.out)
    print(json.dumps({"segments_before": n_before, "segments_after": len(glued)}))


def cmd_rename(args):
    from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset
    from ssak_tpu_torch.data.segment_ops import rename_ids

    ds = KaldiDataset.load(args.dir)
    rename_ids(
        ds,
        args.char,
        args.replacement,
        rename_utt_ids=not args.audio_ids_only,
        rename_audio_ids=not args.utt_ids_only,
        rename_speakers=not args.audio_ids_only,
    )
    ds.save(args.out)
    print(f"{args.out}: {len(ds)} utts renamed ('{args.char}' -> '{args.replacement}')")


def cmd_spk2gender(args):
    from ssak_tpu_torch.utils.env import resolve_device
    from ssak_tpu_torch.utils.gender import predict_gender_kaldi_dir

    resolve_device(args.device)
    out = os.path.join(args.dir, "spk2gender")
    if os.path.exists(out) and not args.force:
        print(f"WARNING: {out} already exists (use --force to overwrite)")
        return
    spk2gender = predict_gender_kaldi_dir(args.dir, output_path=out)
    print(json.dumps({"speakers": len(spk2gender), "genders": {g: sum(1 for v in spk2gender.values() if v == g) for g in "mf"}}))


def _second2time(val: float) -> str:
    h, rem = divmod(int(val), 3600)
    m, s = divmod(rem, 60)
    ms = int((val % 1) * 1000)
    return f"{h:02d}:{m:02d}:{s:02d}.{ms:03d}"


def cmd_duration(args):
    from ssak_tpu_torch.audio.io import get_audio_duration
    from ssak_tpu_torch.utils.misc import walk_files

    total, nb = 0.0, 0
    for inp in args.inputs:
        exts = (".wav", ".mp3", ".flac", ".ogg", ".m4a", ".opus")
        paths = (p for p in walk_files(inp) if p.lower().endswith(exts)) if os.path.isdir(inp) else [inp]
        for path in paths:
            d = get_audio_duration(path)
            if args.verbose:
                print(f"{path}\t{_second2time(d)}")
            total += d
            nb += 1
    print(f"Total Duration of {nb} files: {_second2time(total)}")


def cmd_move(args):
    """Move a dataset dir and rewrite wav.scp paths in its kaldi annotations."""
    import shutil

    src = os.path.abspath(args.dataset_dir)
    dest = os.path.abspath(args.target_dir)
    annot = args.kaldi_annotations
    if annot is None:
        for cand in ("annotations", "kaldi"):
            if os.path.isdir(os.path.join(src, cand)):
                annot = os.path.join(src, cand)
                break
    rewritten = []
    if annot:
        scps = []
        if os.path.exists(os.path.join(annot, "wav.scp")):
            scps.append(os.path.join(annot, "wav.scp"))
        else:
            scps = [os.path.join(annot, d, "wav.scp") for d in sorted(os.listdir(annot)) if os.path.exists(os.path.join(annot, d, "wav.scp"))]
        for scp in scps:
            with open(scp) as f:
                content = f.read()
            if not args.no_backup:
                shutil.copy(scp, scp + ".bak")
            with open(scp, "w") as f:
                f.write(content.replace(src, dest))
            rewritten.append(scp)
    shutil.move(src, dest)
    print(json.dumps({"moved": dest, "rewritten_wavscp": rewritten}))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("stats")
    s.add_argument("dirs", nargs="+")
    s.set_defaults(fn=cmd_stats)

    s = sub.add_parser("split")
    s.add_argument("dir")
    s.add_argument("out_prefix")
    s.add_argument("--ratios", type=float, nargs="+", default=[0.8, 0.1, 0.1])
    s.add_argument("--by_utterance", action="store_true")
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_split)

    s = sub.add_parser("subsample")
    s.add_argument("dir")
    s.add_argument("out")
    s.add_argument("--n", type=int, required=True)
    s.add_argument("--mode", choices=["head", "random", "spread"], default="random")
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_subsample)

    s = sub.add_parser("fix")
    s.add_argument("dir")
    s.add_argument("--language", default=None)
    s.set_defaults(fn=cmd_fix)

    s = sub.add_parser("glue")
    s.add_argument("dir")
    s.add_argument("out")
    s.add_argument("--max_silence", type=float, default=0.5)
    s.add_argument("--max_duration", type=float, default=15.0)
    s.add_argument("--mode", choices=["overlap", "all"], default="overlap")
    s.set_defaults(fn=cmd_glue)

    s = sub.add_parser("rename")
    s.add_argument("dir")
    s.add_argument("out")
    s.add_argument("--char", default=":")
    s.add_argument("--replacement", default="-")
    s.add_argument("--utt_ids_only", action="store_true")
    s.add_argument("--audio_ids_only", action="store_true")
    s.set_defaults(fn=cmd_rename)

    s = sub.add_parser("spk2gender")
    s.add_argument("dir")
    s.add_argument("--force", action="store_true")
    s.add_argument("--device", default=None,
                   help="cuda (default) or cpu; the heuristic runs on the host, the option only follows the port's "
                        "rule that an entry point asks for the card unless told otherwise")
    s.set_defaults(fn=cmd_spk2gender)

    s = sub.add_parser("duration")
    s.add_argument("inputs", nargs="+")
    s.add_argument("--verbose", action="store_true")
    s.set_defaults(fn=cmd_duration)

    s = sub.add_parser("move")
    s.add_argument("dataset_dir")
    s.add_argument("target_dir")
    s.add_argument("--kaldi_annotations", default=None)
    s.add_argument("--no_backup", action="store_true")
    s.set_defaults(fn=cmd_move)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
