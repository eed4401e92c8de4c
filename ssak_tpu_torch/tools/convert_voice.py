"""Voice-convert a Kaldi dir to trained target voices, for augmentation or
anonymisation (the port's counterpart of tools/convert_voice.py):

    # train a target-voice model from that speaker's audio
    python -m ssak_tpu_torch.tools.convert_voice train SPEAKER_DIR_OR_WAVS... -o spk1.npz [--device cpu]

    # convert a Kaldi dir, choosing among the target models at random per segment
    python -m ssak_tpu_torch.tools.convert_voice convert KALDI_IN spk1.npz spk2.npz -ok KALDI_OUT [--device cpu]

The converter (augment/vc) trains and runs on cuda unless --device cpu;
its npz files are those of ssak_tpu's tool, read by either package.
"""

import argparse
import os


def _collect_audios(paths, sample_rate):
    from ssak_tpu_torch.audio import load_audio

    out = []
    for p in paths:
        if os.path.isdir(p):
            for fn in sorted(os.listdir(p)):
                if fn.rsplit(".", 1)[-1].lower() in ("wav", "mp3", "flac", "ogg"):
                    out.append(load_audio(os.path.join(p, fn), sample_rate=sample_rate))
        else:
            out.append(load_audio(p, sample_rate=sample_rate))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Voice-convert a Kaldi dir to trained target voices")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train a target-voice model from the speaker's audio")
    pt.add_argument("audio", nargs="+", help="wav files or directories of the target speaker")
    pt.add_argument("-o", "--output", required=True, help="output model .npz")
    pt.add_argument("--steps", type=int, default=1000)
    pt.add_argument("--hidden", type=int, default=128)
    pt.add_argument("--blocks", type=int, default=4)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--device", default=None, help="cuda (default) or cpu")

    pc = sub.add_parser("convert", help="voice-convert a Kaldi dir")
    pc.add_argument("kaldi_input", help="input Kaldi folder")
    pc.add_argument("models", nargs="+", help="target-voice model .npz files")
    pc.add_argument("-ok", "--kaldi_output", default=None, help="output Kaldi folder")
    pc.add_argument("-oa", "--audio_output", default=None, help="output wav folder")
    pc.add_argument("--seed", type=int, default=0)
    pc.add_argument("--gl_iters", type=int, default=24, help="Griffin-Lim iterations")
    pc.add_argument("--device", default=None, help="cuda (default) or cpu")

    args = p.parse_args(argv)
    from ssak_tpu_torch.utils.env import resolve_device

    device = resolve_device(args.device)
    if args.cmd == "train":
        from ssak_tpu_torch.augment.vc import save_vc, train_voice_converter

        audios = _collect_audios(args.audio, 16000)
        model, losses = train_voice_converter(audios, steps=args.steps, hidden=args.hidden, blocks=args.blocks,
                                              seed=args.seed, device=device)
        save_vc(model, args.output)
        print(f"{args.output} (final L1 {losses[-1]:.4f})")
    else:
        from ssak_tpu_torch.augment.vc import convert_kaldi_dir

        out = args.kaldi_output or (args.kaldi_input.rstrip("/") + "_augmented_vc")
        convert_kaldi_dir(args.kaldi_input, args.models, out, audio_out_dir=args.audio_output, seed=args.seed,
                          gl_iters=args.gl_iters, device=device)
        print(out)


if __name__ == "__main__":
    main()
