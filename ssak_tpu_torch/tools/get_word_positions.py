"""Word timestamps for every utterance of a Kaldi folder by CTC forced
alignment (the port's counterpart of tools/get_word_positions.py):

    python -m ssak_tpu_torch.tools.get_word_positions KALDI_DIR --model CTC_DIR \
        [--language fr] [--output FILE] [--device cpu]

prints '<utt-id> <word> <start> <end> <score>' lines. The model and the
trellis run on cuda unless --device cpu.
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="Word timestamps of a Kaldi folder by CTC forced alignment")
    p.add_argument("kaldi_dir")
    p.add_argument("--model", default=None)
    p.add_argument("--language", default="fr")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--seeded_test_config", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    from ssak_tpu_torch.align.forced import align_audio_to_transcript
    from ssak_tpu_torch.audio import load_audio
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.text import format_text

    model = load_model(args.model, seeded_test_config=args.seeded_test_config, device=args.device)
    _meta, rows = kaldi_folder_to_manifest(args.kaldi_dir)
    out = open(args.output, "w", encoding="utf-8") if args.output else sys.stdout
    try:
        for row in rows:
            if not row["text"]:
                continue
            audio = load_audio(row["audio"], start=row["start"], end=row["end"], sample_rate=model.sample_rate)
            transcript = format_text(row["text"], args.language, extract_parenthesized=False,
                                     safety_checks=False).replace("\n", " ")
            for w in align_audio_to_transcript(model, audio, transcript, model.sample_rate):
                out.write(f"{row['id']} {w.label} {w.start:.3f} {w.end:.3f} {w.score:.3f}\n")
    finally:
        if args.output:
            out.close()


if __name__ == "__main__":
    main()
