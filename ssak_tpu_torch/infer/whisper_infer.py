"""Whisper inference: batched greedy decode over 30 s windows
(counterpart of ssak_tpu.infer.whisper_infer, short-window greedy branch).

Each group of windows becomes one (W, n_mels, frames) mel batch through
models.whisper.greedy_decode. Device work for a batch is enqueued before
the previous batch's tokens are fetched to the host (one batch behind),
and file decode runs in a prefetch thread. Beam search, --best_of,
temperature fallback and long-form seek are later slices and raise
NotImplementedError.

CLI: python -m ssak_tpu_torch.infer.whisper_infer <audio|list|kaldi_dir> <model>
"""

import os
import sys

import torch

from ssak_tpu_torch.ops.logmel import log_mel_spectrogram


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _not_ported(beam_size: int, temperature_fallback: bool, best_of: int):
    if beam_size > 1 or temperature_fallback or best_of > 1:
        raise NotImplementedError("beam search, --best_of and temperature fallback are not ported yet (greedy only)")


def whisper_transcribe_batch(model, batch, max_tokens: int = 224, beam_size: int = 0, temperature_fallback: bool = False,
                             longform: bool = True, best_of: int = 1, return_async: bool = False):
    """batch: list of 1-D float32 arrays at 16 kHz -> list of transcripts:
    the generated token ids joined by spaces (tokenizers are a later slice,
    so the prompt is the config's [sot, no_timestamps], as ssak_tpu uses
    for a model without tokenizer).
    longform=False splits audio longer than one window into windows whose
    pieces are joined; with longform=True (the default, as in ssak_tpu)
    such audio needs the long-form seek loop, not ported yet.

    return_async=True returns resolve() instead of the texts: the device
    work is enqueued before returning, resolve() fetches and decodes."""
    from ssak_tpu_torch.audio.wire import encode_rows, to_device_f32
    from ssak_tpu_torch.models import whisper

    _not_ported(beam_size, temperature_fallback, best_of)
    cfg = model.cfg
    prompt = [cfg.sot, cfg.no_timestamps]
    eot = cfg.eot

    window_samples = cfg.n_audio_ctx * 2 * 160
    max_tokens = min(max_tokens, cfg.n_text_ctx - len(prompt) - 1)
    if longform and any(len(a) > window_samples for a in batch):
        raise NotImplementedError("long-form (> one window) seek decoding is not ported yet; pass longform=False to cut windows")

    windows, origins = [], []
    for bi, a in enumerate(batch):
        for s in range(0, max(1, len(a)), window_samples):
            windows.append(a[s : s + window_samples])
            origins.append(bi)

    texts = [""] * len(batch)
    handles = []  # (w0, group_len, tokens, lengths) on the device
    cap = max(1, len(batch))
    for w0 in range(0, len(windows), cap):
        group = windows[w0 : w0 + cap]
        # pow2 width buckets (capped at the nominal batch), as ssak_tpu does
        Wg = max(len(group), min(_next_pow2(len(group)), cap))
        audio = to_device_f32(encode_rows(group, Wg, window_samples), model.device)
        mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
        tokens, lengths = whisper.greedy_decode(model.module, mel, cfg, prompt, max_tokens=max_tokens)
        handles.append((w0, len(group), tokens, lengths))

    def resolve():
        for w0, glen, tokens, lengths in handles:
            tk, ln = tokens.cpu().numpy(), lengths.cpu().numpy()
            for gi in range(glen):
                ids = [int(t) for t in tk[gi, : ln[gi]] if int(t) != eot]
                piece = " ".join(map(str, ids))
                bi = origins[w0 + gi]
                texts[bi] = (texts[bi] + " " + piece).strip() if piece else texts[bi]
        return texts

    return resolve if return_async else resolve()


def auto_window_batch(cfg, quantize_bits: int = 0) -> int:
    """Window-batch size by model width and weight precision. The numbers
    are ssak_tpu's (caps set by its TPU compiler and memory); they are to
    be re-sized from the H100's memory."""
    d = getattr(cfg, "n_audio_state", 1280)
    if d >= 1280:  # large
        return {8: 40, 4: 32}.get(quantize_bits, 24)
    if d >= 1024:  # medium
        return {8: 56, 4: 48}.get(quantize_bits, 32)
    if d >= 768:  # small
        return 48
    return 64


def whisper_infer(model_dir, audios, batch_size: int = 0, output_ids: bool = False, seeded_test_config: str = None,
                  beam_size: int = 0, temperature_fallback: bool = False, quantize_bits: int = 0, best_of: int = 1,
                  max_tokens: int = 224, device=None):
    """Transcripts of `audios` (anything data.dataset.to_audio_batches
    takes), as an iterator of texts or (id, text) pairs. Loads the model on
    `device` (default cuda; raises here, at the call, when there is none),
    casts it to bf16 unless quantized, and fuses the decoder's q/k/v."""
    from ssak_tpu_torch.data.dataset import to_audio_batches
    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.models.whisper import fuse_decode_qkv

    _not_ported(beam_size, temperature_fallback, best_of)
    model = load_model(model_dir, seeded_test_config=seeded_test_config, quantize_bits=quantize_bits, device=device)
    if not quantize_bits:
        # decode-only: bf16 weights (quantized models keep int8 kernels + f32 leaves)
        model.module.to(torch.bfloat16)
    fuse_decode_qkv(model.module)
    if not batch_size or batch_size <= 0:
        batch_size = auto_window_batch(model.cfg, quantize_bits)
    batches = to_audio_batches(audios, batch_size=batch_size, sample_rate=16000, output_ids=True,
                               io_threads=min(4, os.cpu_count() or 2))
    return _transcripts(model, batches, max_tokens, output_ids)


def _transcripts(model, batches, max_tokens, output_ids):
    from ssak_tpu_torch.data.prefetch import prefetch_iterator

    pending = None
    for batch, ids in prefetch_iterator(batches, depth=2):
        resolve = whisper_transcribe_batch(model, batch, max_tokens=max_tokens, return_async=True)
        if pending is not None:
            for i, t in zip(pending[1], pending[0]()):
                yield (i, t) if output_ids else t
        pending = (resolve, ids)
    if pending is not None:
        for i, t in zip(pending[1], pending[0]()):
            yield (i, t) if output_ids else t


def cli(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Transcribe audio with Whisper (PyTorch/CUDA port)")
    parser.add_argument("data", help="audio file, list file of audio files, or Kaldi dir (wav.scp of plain paths)")
    parser.add_argument("model", help="model directory (only seeded models are ported: pass any name with --seeded_test_config)")
    parser.add_argument("--output", default=None)
    parser.add_argument("--batch_size", type=int, default=0, help="0 (default) = auto window batch by model size/precision")
    parser.add_argument("--use_ids", action="store_true", default=True)
    parser.add_argument("--no-use_ids", dest="use_ids", action="store_false")
    parser.add_argument("--beam_size", type=int, default=0)
    parser.add_argument("--best_of", type=int, default=1)
    parser.add_argument("--accurate", action="store_true", help="beam 5 + best_of 5 + temperature fallback (not ported yet)")
    parser.add_argument("--efficient", action="store_true", help="greedy decode")
    parser.add_argument("--load_in_8bit", action="store_true", help="int8 weight-only quantized decode")
    parser.add_argument("--load_in_4bit", action="store_true", help="int4 weight-only quantized decode (not ported yet)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--seeded_test_config", default=None, help=argparse.SUPPRESS)  # test hook: random model
    args = parser.parse_args(argv)
    beam = 5 if args.accurate else (0 if args.efficient else args.beam_size)
    best_of = 5 if args.accurate else (1 if args.efficient else args.best_of)

    texts = whisper_infer(
        args.model, args.data, batch_size=args.batch_size, output_ids=args.use_ids,
        beam_size=beam, temperature_fallback=args.accurate, best_of=best_of,
        quantize_bits=4 if args.load_in_4bit else (8 if args.load_in_8bit else 0),
        seeded_test_config=args.seeded_test_config, device=args.device,
    )
    out = open(args.output, "w", encoding="utf-8") if args.output else sys.stdout
    try:
        for item in texts:
            out.write(f"{item[0]} {item[1]}\n" if args.use_ids else f"{item}\n")
            out.flush()
    finally:
        if args.output:
            out.close()


if __name__ == "__main__":
    cli()
