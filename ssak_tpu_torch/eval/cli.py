"""`sak-wer` for the port: WER/CER between reference and hypothesis files
(counterpart of ssak_tpu.eval.cli).

    python -m ssak_tpu_torch.eval.cli REF HYP [--normalization fr] [--char] [--details] [--bootstrap_ci] [--device cpu]

The scoring runs on the host; like every entry point of the port it asks
for the card unless --device cpu is given, and raises without one. --plot
draws the WER bar plot with eval.plots (matplotlib, imported when the plot
is drawn: where it is absent, --plot raises ImportError naming it).
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="WER/CER between two '<id> <text>' files")
    p.add_argument("references")
    p.add_argument("predictions")
    p.add_argument("--normalization", default=None, help="e.g. fr, fr+, fr++")
    p.add_argument("--char", action="store_true", help="character error rate")
    p.add_argument("--details", action="store_true", help="print per-utterance alignments")
    p.add_argument("--bootstrap_ci", action="store_true")
    p.add_argument("--plot", default=None, help="save a WER bar plot to this path")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; the scoring runs on the host, the option only follows the port's "
                        "rule that an entry point asks for the card unless told otherwise")
    args = p.parse_args(argv)
    from ssak_tpu_torch.utils.env import resolve_device

    resolve_device(args.device)

    from ssak_tpu_torch.eval.wer import compute_wer

    result = compute_wer(
        args.references, args.predictions,
        normalization=args.normalization,
        character_level=args.char,
        details=args.details,
        bootstrap_ci=args.bootstrap_ci,
    )
    if args.details:
        for a in result["alignments"]:
            print(f"--- {a['id']} (wer {a['wer']:.3f})")
            print(a["viz"])
        result = {k: v for k, v in result.items() if k != "alignments"}
    if args.plot:
        from ssak_tpu_torch.eval.plots import plot_wer

        plot_wer(result, output=args.plot)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
