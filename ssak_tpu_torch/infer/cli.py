"""`sak-infer` for the port: transcribe with any supported model, its type
read from the model directory (counterpart of ssak_tpu.infer.cli).

    python -m ssak_tpu_torch.infer.cli DATA MODEL_DIR [options of the Whisper or CTC CLI] [--device cpu]

An HF Whisper directory goes to infer.whisper_infer's CLI; an HF wav2vec2
directory and a NeMo Conformer-CTC archive (.nemo, or its extracted
directory with model_config.yaml) go to the CTC CLI; an export of
train.finalize goes to the one of its family (its ssak_config.json's
model_type). With --seeded_test_config (a test hook) the family is that
of the seeded model.
"""

import json
import os
import sys


def model_family(argv) -> str:
    """'whisper' or 'ctc' for the command line `argv` (its second positional
    argument is the model directory)."""
    from ssak_tpu_torch.infer.general import ModelType, get_model_type

    for i, a in enumerate(argv):
        if a == "--seeded_test_config" and i + 1 < len(argv):
            return "whisper" if argv[i + 1].startswith("whisper") else "ctc"
        if a.startswith("--seeded_test_config="):
            return "whisper" if a.split("=", 1)[1].startswith("whisper") else "ctc"
    pos = [a for a in argv if not a.startswith("-")]
    if len(pos) < 2:
        return "ctc"  # the CTC CLI reports the missing arguments
    model_dir = pos[1]
    exported = os.path.join(model_dir, "ssak_config.json")
    if os.path.exists(exported):
        with open(exported, encoding="utf-8") as f:
            mtype = json.load(f)["model_type"]
    else:
        mtype = get_model_type(model_dir)
    return "whisper" if mtype == ModelType.WHISPER else "ctc"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if model_family(argv) == "whisper":
        from ssak_tpu_torch.infer.whisper_infer import cli
    else:
        from ssak_tpu_torch.infer.ctc_infer import cli
    return cli(argv)


if __name__ == "__main__":
    main()
