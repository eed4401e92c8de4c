"""Whisper inference (counterpart of ssak_tpu.infer.whisper_infer).

Three paths, as in the JAX package:
  - greedy: each group of 30 s windows becomes one (W, n_mels, frames) mel
    batch through models.whisper.greedy_decode; its device work is enqueued
    before the previous batch's tokens are fetched (one batch behind), and
    file decode runs in a prefetch thread;
  - accurate (beam_size > 1 or temperature_fallback): beam search at T = 0,
    then sampled best-of-n at rising temperatures for the windows that
    fail the compression-ratio or log-probability check
    (transcribe_with_fallback);
  - long-form (longform=True and audio longer than one window): the
    openai-whisper seek loop with timestamps, conditioning on the previous
    text, temperature fallback and the no-speech skip, with all long files
    of a batch advancing together (transcribe_longform_batch).
The accurate and long-form paths read tokens on the host once per decode
call, by design, and resolve eagerly.

With a tokenizer (a model loaded from an HF directory), prompts are its
sot_sequence(language, task, timestamps) and transcripts its decoded text;
its eot, sot_prev, timestamp_begin and no_speech ids drive the loops. A
model without one (seeded, from a tree or an export) uses the config's
special ids, ignores language= and task=, and gives the generated token
ids joined by spaces, as ssak_tpu does.

With tensor_parallel=N (`--tensor_parallel N` under torchrun, one process
per rank) the model is sharded over the ranks; every rank runs each path
above on the same logits, and rank 0 alone yields the transcripts.

CLI: python -m ssak_tpu_torch.infer.whisper_infer <audio|list|kaldi_dir> <model_dir> [--language fr]
     python -m torch.distributed.run --nproc_per_node 2 -m ssak_tpu_torch.infer.whisper_infer
         <data> <model_dir> --tensor_parallel 2 [--dist_backend gloo]
"""

import os
import sys
import zlib

import numpy as np
import torch

from ssak_tpu_torch.models.whisper import host_array as _host
from ssak_tpu_torch.ops.logmel import log_mel_spectrogram

TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _ids_text(model, ids) -> str:
    """The tokenizer's text of `ids`, or the ids joined by spaces for a model without one."""
    return model.tokenizer.decode(ids) if model.tokenizer is not None else " ".join(map(str, ids))


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    return len(data) / max(1, len(zlib.compress(data)))


def transcribe_with_fallback(model, mel, prompt, max_tokens: int = 224, beam_size: int = 0, temperatures=TEMPERATURES,
                             compression_ratio_threshold: float = 2.4, logprob_threshold: float = -1.0, seed: int = 0,
                             best_of: int = 1):
    """Whisper-style temperature fallback over a (B, n_mels, T) mel batch:
    beam search (beam_size > 1) or argmax at T = 0, then the rows that fail
    the compression-ratio or average-log-probability check are retried with
    sampling (best_of candidates, seed + the temperature's index) at the
    next temperature; a retry decodes only the pending rows, gathered and
    padded to a power of two. Rows that passed keep their first result."""
    from ssak_tpu_torch.models import whisper

    cfg = model.cfg
    eot = model.tokenizer.eot if model.tokenizer is not None else cfg.eot
    B = mel.shape[0]
    texts = [None] * B
    pending = list(range(B))
    for ti, temp in enumerate(temperatures):
        if not pending:
            break
        if len(pending) == B:
            rows, sub_mel = list(range(B)), mel
        else:
            rows = pending
            idx = rows + [rows[0]] * (_next_pow2(len(rows)) - len(rows))
            sub_mel = mel.index_select(0, torch.tensor(idx, device=mel.device))
        if temp == 0.0 and beam_size > 1:
            out = whisper.beam_decode(model.module, sub_mel, cfg, prompt, beam_size=beam_size, max_tokens=max_tokens)
        else:
            out = whisper.sample_decode(model.module, sub_mel, cfg, prompt, seed + ti, temperature=temp,
                                        max_tokens=max_tokens, best_of=best_of)
        tokens, lengths, scores = (_host(a) for a in out)
        avg_lp = scores / np.maximum(1, lengths)
        still = []
        for j, b in enumerate(rows):
            if texts[b] is not None:
                continue
            text = _ids_text(model, [int(t) for t in tokens[j][: int(lengths[j])] if int(t) != eot])
            ok = compression_ratio(text) <= compression_ratio_threshold and (
                avg_lp[j] >= logprob_threshold or temp == temperatures[-1]
            )
            if ok or ti == len(temperatures) - 1:
                texts[b] = text
            else:
                still.append(b)
        pending = still
    return ["" if t is None else t for t in texts]


def parse_timestamp_segments(toks, ts_begin: int, precision: float, chunk_dur: float):
    """Split one window's generated tokens into timestamped segments, as
    openai-whisper's transcribe loop does. Returns (segments, consumed,
    advance): segments are (start_s, end_s, token_ids) relative to the
    window start; consumed is the token prefix kept for conditioning;
    advance is how far (seconds) to move the seek pointer (None = the whole
    window)."""
    is_ts = [t >= ts_begin for t in toks]
    # indices of the SECOND timestamp of each consecutive <ts><ts> pair
    cuts = [i for i in range(1, len(toks)) if is_ts[i] and is_ts[i - 1]]
    if cuts:
        segments, prev = [], 0
        for cut in cuts:
            seg = toks[prev:cut]
            start = (seg[0] - ts_begin) * precision
            end = (seg[-1] - ts_begin) * precision
            segments.append((start, end, [t for t in seg if t < ts_begin]))
            prev = cut
        advance = (toks[cuts[-1] - 1] - ts_begin) * precision
        return segments, toks[: cuts[-1]], advance
    # no complete pair: one segment covering the window (or up to the last
    # timestamp the model emitted), full-window advance
    duration = chunk_dur
    ts_list = [t for t, b in zip(toks, is_ts) if b]
    if ts_list and ts_list[-1] != ts_begin:
        duration = (ts_list[-1] - ts_begin) * precision
    start = (ts_list[0] - ts_begin) * precision if ts_list else 0.0
    return [(start, duration, [t for t in toks if t < ts_begin])], list(toks), None


def transcribe_longform_batch(model, audios, language: str = None, task: str = "transcribe",
                              with_timestamps: bool = True, condition_on_previous_text: bool = True,
                              no_speech_threshold: float = 0.6, logprob_threshold: float = -1.0,
                              compression_ratio_threshold: float = 2.4, temperatures=TEMPERATURES,
                              max_tokens: int = None, seed: int = 0, batch_decode_fn=None, sample_rate: int = 16000,
                              best_of: int = 1):
    """Batched long-form transcription: N long utterances advance through
    the openai-whisper seek loop together. Per-row state (seek pointer,
    conditioning prompt, prompt reset) lives on the host; each iteration
    gathers the active rows' windows, padded to a power-of-two width, into
    one decode_window call. Rows are independent: each keeps its own
    timestamp-driven seek with last-segment carryover, conditioning,
    temperature fallback (a retry decodes only the pending rows; rows that
    passed keep their first result) and no-speech/logprob silence skip.

    audios: list of 1-D float arrays at `sample_rate`. Returns one
    {"text", "segments", "language"} dict per input, what
    transcribe_longform gives for each row alone at T = 0.

    batch_decode_fn(mel (A, ...), prompt_buf (A, P), prompt_lens (A,),
    temperature, step_seed) -> (token lists, sum_logprob (A,),
    no_speech_prob (A,)) may be injected for testing; the default runs
    models.whisper.decode_window."""
    from ssak_tpu_torch.audio.wire import encode_rows, to_device_f32
    from ssak_tpu_torch.models import whisper

    cfg = model.cfg
    tok = model.tokenizer
    if tok is not None:
        sot_seq = tok.sot_sequence(language=language, task=task, timestamps=with_timestamps)
        eot, sot_prev, ts_begin = tok.eot, tok.sot_prev, tok.timestamp_begin
    else:
        sot_seq = [cfg.sot] + ([] if with_timestamps else [cfg.no_timestamps])
        eot, sot_prev, ts_begin = cfg.eot, cfg.sot_prev, cfg.timestamp_begin

    window_samples = cfg.n_audio_ctx * 2 * 160
    precision = 2 * 160 / sample_rate  # seconds per timestamp unit (0.02 s)
    if condition_on_previous_text:
        P = cfg.n_text_ctx // 2 + len(sot_seq)  # [sot_prev] + capped previous text + sot_seq
    else:
        P = len(sot_seq)
    budget = cfg.n_text_ctx - P
    if max_tokens:
        budget = min(budget, max_tokens)
    max_prev = P - 1 - len(sot_seq)

    def default_batch_decode(mel, buf, plens, temperature, step_seed):
        tokens, lengths, sum_lp, nsp = whisper.decode_window(
            model.module, mel, buf, plens, cfg, sot_distance=len(sot_seq), max_tokens=budget,
            with_timestamps=with_timestamps, temperature=temperature, seed=step_seed, best_of=best_of,
        )
        tokens, lengths = _host(tokens), _host(lengths)
        toks = [[int(t) for t in tokens[b, : lengths[b]]] for b in range(tokens.shape[0])]
        return toks, _host(sum_lp), _host(nsp)

    decode = batch_decode_fn or default_batch_decode

    def decode_text(ids):
        return tok.decode(ids) if tok is not None else " ".join(str(i) for i in ids if i < ts_begin)

    audios = [np.asarray(a, np.float32) for a in audios]
    B = len(audios)
    state = [{"seek": 0, "all_tokens": [], "prompt_reset_since": 0, "segments": []} for _ in range(B)]
    it_n = 0
    while True:
        active = [b for b in range(B) if state[b]["seek"] < len(audios[b])]
        if not active:
            break
        bufs, plens, chunks = [], [], []
        for b in active:
            st = state[b]
            chunk = audios[b][st["seek"] : st["seek"] + window_samples]
            chunks.append(chunk)
            prev = st["all_tokens"][st["prompt_reset_since"]:] if condition_on_previous_text else []
            prev = prev[-max_prev:] if (prev and max_prev > 0) else []
            ids = ([sot_prev] + prev if prev else []) + sot_seq
            buf = np.full((P,), eot, np.int32)
            buf[P - len(ids):] = ids
            bufs.append(buf)
            plens.append(len(ids))
        # pad the active rows to a power-of-two width with copies of row 0,
        # whose outputs are never read
        W = _next_pow2(len(active))
        rows = chunks + [chunks[0]] * (W - len(chunks))
        while len(bufs) < W:
            bufs.append(bufs[0])
            plens.append(plens[0])
        mel = log_mel_spectrogram(to_device_f32(encode_rows(rows, W, window_samples), model.device), n_mels=cfg.n_mels)
        buf = np.stack(bufs)

        results = [None] * len(active)  # (toks, avg_lp, nsp, text, temp)
        pending = list(range(len(active)))
        for ti, temp in enumerate(temperatures):
            if not pending:
                break
            # decorrelated retry seed: iteration and temperature index never alias
            step_seed = (seed ^ (it_n * 0x9E3779B1) ^ (ti * 0x85EBCA6B)) & 0x7FFFFFFF
            if len(pending) == len(active):
                rows_idx, d_mel, d_buf, d_plens = pending, mel, buf, plens
            else:
                gather = pending + [pending[0]] * (_next_pow2(len(pending)) - len(pending))
                d_mel = mel.index_select(0, torch.tensor(gather, device=mel.device))
                d_buf = buf[gather]
                d_plens = [plens[i] for i in gather]
                rows_idx = pending
            toks_l, sum_lp, nsp = decode(d_mel, d_buf, d_plens, temp, step_seed)
            still = []
            for k, j in enumerate(rows_idx):
                toks = [t for t in toks_l[k] if t != eot]
                avg_lp = float(sum_lp[k]) / (len(toks) + 1)
                text = decode_text(toks)
                ok = compression_ratio(text) <= compression_ratio_threshold and avg_lp >= logprob_threshold
                if ok or ti == len(temperatures) - 1:
                    results[j] = (toks, avg_lp, float(nsp[k]), text, temp)
                else:
                    still.append(j)
            pending = still
        it_n += 1

        for j, b in enumerate(active):
            st = state[b]
            toks, avg_lp, nsp_b, text, temp_used = results[j]
            chunk = chunks[j]
            chunk_dur = len(chunk) / sample_rate
            window_offset = st["seek"] / sample_rate
            # silence skip: confident no-speech AND weak transcription evidence
            if no_speech_threshold is not None and nsp_b > no_speech_threshold and avg_lp < logprob_threshold:
                st["seek"] += len(chunk)
                continue
            if with_timestamps:
                raw_segs, consumed, advance = parse_timestamp_segments(toks, ts_begin, precision, chunk_dur)
            else:
                raw_segs, consumed, advance = [(0.0, chunk_dur, list(toks))], list(toks), None
            for start, end, seg_ids in raw_segs:
                seg_text = decode_text(seg_ids)
                if not seg_text.strip():
                    continue
                st["segments"].append({
                    "id": len(st["segments"]),
                    "seek": st["seek"],
                    "start": window_offset + start,
                    "end": window_offset + end,
                    "text": seg_text,
                    "tokens": seg_ids,
                    "temperature": temp_used,
                    "avg_logprob": avg_lp,
                    "compression_ratio": compression_ratio(text),
                    "no_speech_prob": nsp_b,
                })
            st["all_tokens"].extend(consumed)
            if temp_used > 0.5:
                # unreliable window: do not condition the next one on it
                st["prompt_reset_since"] = len(st["all_tokens"])
            if advance is None or advance <= 0:
                st["seek"] += len(chunk)
            else:
                st["seek"] += max(int(advance * sample_rate), 2 * 160)

    sep = "" if tok is not None else " "  # decoded segments carry their own leading spaces
    return [{"text": sep.join(s["text"] for s in st["segments"]).strip(), "segments": st["segments"],
             "language": language} for st in state]


def transcribe_longform(model, audio, language: str = None, task: str = "transcribe", with_timestamps: bool = True,
                        condition_on_previous_text: bool = True, no_speech_threshold: float = 0.6,
                        logprob_threshold: float = -1.0, compression_ratio_threshold: float = 2.4,
                        temperatures=TEMPERATURES, max_tokens: int = None, seed: int = 0, decode_fn=None,
                        sample_rate: int = 16000, best_of: int = 1):
    """Long-form transcription of one file: the B=1 view of
    transcribe_longform_batch (one engine). Returns {"text", "segments",
    "language"}. decode_fn(mel, prompt_buf, prompt_len, temperature,
    step_seed) -> (token list, sum_logprob, no_speech_prob) may be injected
    for testing."""
    batch_fn = None
    if decode_fn is not None:
        def batch_fn(mel, buf, plens, temperature, step_seed):
            outs = [decode_fn(mel[i : i + 1], buf[i : i + 1], int(plens[i]), temperature, step_seed)
                    for i in range(mel.shape[0])]
            return ([list(o[0]) for o in outs], np.asarray([o[1] for o in outs], np.float32),
                    np.asarray([o[2] for o in outs], np.float32))

    return transcribe_longform_batch(
        model, [audio], language=language, task=task, with_timestamps=with_timestamps,
        condition_on_previous_text=condition_on_previous_text, no_speech_threshold=no_speech_threshold,
        logprob_threshold=logprob_threshold, compression_ratio_threshold=compression_ratio_threshold,
        temperatures=temperatures, max_tokens=max_tokens, seed=seed, batch_decode_fn=batch_fn,
        sample_rate=sample_rate, best_of=best_of,
    )[0]


def whisper_transcribe_batch(model, batch, language: str = None, task: str = "transcribe", max_tokens: int = 224,
                             beam_size: int = 0, temperature_fallback: bool = False, longform: bool = True,
                             best_of: int = 1, return_async: bool = False):
    """batch: list of 1-D float32 arrays at 16 kHz -> list of transcripts.
    With longform=True (the default) audio longer than one window goes
    through the long-form seek loop (all such files together, the full
    temperature chain when temperature_fallback, the budget the prompt
    buffer leaves); shorter audio, or every file with longform=False (cut
    into windows whose pieces are joined), decodes as batched windows:
    greedy, or the accurate chain when beam_size > 1 or
    temperature_fallback (best_of candidates at T > 0).

    return_async=True returns resolve() instead of the texts: greedy
    windows are enqueued on the device before returning and resolve()
    fetches them; the long-form and accurate paths have already run."""
    from ssak_tpu_torch.audio.wire import encode_rows, to_device_f32
    from ssak_tpu_torch.models import whisper

    cfg = model.cfg
    if model.tokenizer is not None:
        prompt = model.tokenizer.sot_sequence(language=language, task=task)
        eot = model.tokenizer.eot
    else:
        prompt = [cfg.sot, cfg.no_timestamps]
        eot = cfg.eot
    temperatures = TEMPERATURES if temperature_fallback else (0.0,)

    window_samples = cfg.n_audio_ctx * 2 * 160
    max_tokens = min(max_tokens, cfg.n_text_ctx - len(prompt) - 1)
    texts_long = {}
    if longform:
        long_idx = [bi for bi, a in enumerate(batch) if len(a) > window_samples]
        short_idx = [bi for bi, a in enumerate(batch) if len(a) <= window_samples]
        if long_idx:
            results = transcribe_longform_batch(model, [batch[bi] for bi in long_idx], language=language, task=task,
                                                temperatures=temperatures, best_of=best_of)
            texts_long = {bi: r["text"] for bi, r in zip(long_idx, results)}
    else:
        short_idx = list(range(len(batch)))

    windows, origins = [], []
    for bi in short_idx:
        a = batch[bi]
        for s in range(0, max(1, len(a)), window_samples):
            windows.append(a[s : s + window_samples])
            origins.append(bi)

    texts = [""] * len(batch)

    def add_piece(bi, piece):
        texts[bi] = (texts[bi] + " " + piece).strip() if piece else texts[bi]

    greedy = not (beam_size > 1 or temperature_fallback)
    handles = []  # greedy: (w0, group_len, tokens, lengths) on the device
    cap = max(1, len(batch))
    for w0 in range(0, len(windows), cap):
        group = windows[w0 : w0 + cap]
        # pow2 width buckets (capped at the nominal batch), as ssak_tpu does
        Wg = max(len(group), min(_next_pow2(len(group)), cap))
        audio = to_device_f32(encode_rows(group, Wg, window_samples), model.device)
        mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
        if greedy:
            tokens, lengths = whisper.greedy_decode(model.module, mel, cfg, prompt, max_tokens=max_tokens)
            handles.append((w0, len(group), tokens, lengths))
            continue
        pieces = transcribe_with_fallback(model, mel, prompt, max_tokens=max_tokens, beam_size=beam_size,
                                          temperatures=temperatures, best_of=best_of)
        for gi, piece in enumerate(pieces[: len(group)]):
            add_piece(origins[w0 + gi], piece)

    def resolve():
        for w0, glen, tokens, lengths in handles:
            tk, ln = _host(tokens), _host(lengths)
            for gi in range(glen):
                add_piece(origins[w0 + gi], _ids_text(model, [int(t) for t in tk[gi, : ln[gi]] if int(t) != eot]))
        for bi, t in texts_long.items():
            texts[bi] = t
        return texts

    return resolve if return_async else resolve()


def auto_window_batch(cfg, quantize_bits: int = 0, beam_size: int = 0, best_of: int = 1) -> int:
    """Window-batch size by model width and weight precision. The base
    sizes are carried over from ssak_tpu unchanged and are still to be
    re-sized from the H100's memory (ROADMAP). Beam search and best_of
    decode batch * max(beam_size, best_of) rows at once; the batch is capped
    so that those rows stay within the decode kernels' 64-row limit (K2, K3
    take M <= 64), and kept a power of two so that the long-form loop's
    power-of-two padding of its active rows stays within it too."""
    d = getattr(cfg, "n_audio_state", 1280)
    if d >= 1280:  # large
        base = {8: 40, 4: 32}.get(quantize_bits, 24)
    elif d >= 1024:  # medium
        base = {8: 56, 4: 48}.get(quantize_bits, 32)
    elif d >= 768:  # small
        base = 48
    else:
        base = 64
    width = max(beam_size, best_of, 1)
    if width > 1:
        cap = 1
        while 2 * cap * width <= 64:
            cap *= 2
        base = min(base, cap)
    return base


def whisper_infer(model_dir, audios, batch_size: int = 0, output_ids: bool = False, seeded_test_config: str = None,
                  beam_size: int = 0, temperature_fallback: bool = False, quantize_bits: int = 0, best_of: int = 1,
                  max_tokens: int = 224, device=None, language: str = None, tensor_parallel: int = 0,
                  dist_backend: str = None):
    """Transcripts of `audios` (anything data.dataset.to_audio_batches
    takes), as an iterator of texts or (id, text) pairs. Loads the model on
    `device` (default cuda; raises here, at the call, when there is none),
    casts it to bf16 unless quantized (quantize_bits 8 or 4), and fuses the
    decoder's q/k/v where they are not quantized. beam_size,
    temperature_fallback and best_of select the accurate chain; files
    longer than 30 s take the long-form seek loop.

    tensor_parallel=N shards the model over the N ranks of a process group
    (torchrun's; raises ValueError without one) on the backend
    `dist_backend`, without the q/k/v fusion, as ssak_tpu does: every rank
    runs every decode loop on its own heads and gets the same logits, so
    every rank takes the same host decisions; only rank 0 yields
    transcripts."""
    from ssak_tpu_torch.data.dataset import to_audio_batches
    from ssak_tpu_torch.infer.general import drain, join_tensor_parallel, load_model, shard_model
    from ssak_tpu_torch.models.whisper import fuse_decode_qkv

    rank0 = True
    if tensor_parallel:
        device, rank0 = join_tensor_parallel(tensor_parallel, device, dist_backend, "whisper_infer")
    model = load_model(model_dir, seeded_test_config=seeded_test_config, quantize_bits=quantize_bits, device=device)
    if not quantize_bits:
        # decode-only: bf16 weights (quantized models keep their kernels' payloads and the other leaves as loaded,
        # f32 or a checkpoint's f16)
        model.module.to(torch.bfloat16)
    if tensor_parallel:
        shard_model(model, model_axis=tensor_parallel)
    else:
        fuse_decode_qkv(model.module)
    if not batch_size or batch_size <= 0:
        batch_size = auto_window_batch(model.cfg, quantize_bits, beam_size=beam_size, best_of=best_of)
    batches = to_audio_batches(audios, batch_size=batch_size, sample_rate=16000, output_ids=True,
                               io_threads=min(4, os.cpu_count() or 2))
    options = dict(language=language, max_tokens=max_tokens, beam_size=beam_size,
                   temperature_fallback=temperature_fallback, best_of=best_of)
    items = _transcripts(model, batches, options, output_ids)
    return items if rank0 else drain(items)


def _transcripts(model, batches, options, output_ids):
    from ssak_tpu_torch.data.prefetch import prefetch_iterator

    pending = None
    for batch, ids in prefetch_iterator(batches, depth=2):
        resolve = whisper_transcribe_batch(model, batch, return_async=True, **options)
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
    parser.add_argument("model", help="model directory: an HF Whisper checkpoint (config.json, *.safetensors or *.bin, "
                                          "tokenizer.json or vocab.json + merges.txt) or an export of train.finalize")
    parser.add_argument("--language", default=None, help="language code of the audio (e.g. fr); default: the model's choice")
    parser.add_argument("--output", default=None)
    parser.add_argument("--batch_size", type=int, default=0,
                        help="0 (default) = auto window batch by model size/precision; beam/best_of keep "
                             "batch*width within the decode kernels' 64 rows")
    parser.add_argument("--use_ids", action="store_true", default=True)
    parser.add_argument("--no-use_ids", dest="use_ids", action="store_false")
    parser.add_argument("--beam_size", type=int, default=0)
    parser.add_argument("--best_of", type=int, default=1,
                        help="sampled candidates per utterance at T>0, best kept by average log probability")
    parser.add_argument("--accurate", action="store_true", help="beam 5 + best_of 5 + temperature fallback")
    parser.add_argument("--efficient", action="store_true", help="greedy decode")
    parser.add_argument("--tensor_parallel", "--tp", type=int, default=0, dest="tensor_parallel",
                        help="shard the model's weights over N ranks (megatron TP rules); run under torchrun "
                             "--nproc_per_node N")
    parser.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                        help="backend of the tensor-parallel process group (default nccl on cards, gloo on the CPU)")
    parser.add_argument("--load_in_8bit", action="store_true", help="int8 weight-only quantized decode")
    parser.add_argument("--load_in_4bit", action="store_true", help="int4 weight-only quantized decode")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--seeded_test_config", default=None, help=argparse.SUPPRESS)  # test hook: random model
    args = parser.parse_args(argv)
    beam = 5 if args.accurate else (0 if args.efficient else args.beam_size)
    best_of = 5 if args.accurate else (1 if args.efficient else args.best_of)

    texts = whisper_infer(
        args.model, args.data, batch_size=args.batch_size, language=args.language, output_ids=args.use_ids,
        beam_size=beam, temperature_fallback=args.accurate, best_of=best_of,
        quantize_bits=4 if args.load_in_4bit else (8 if args.load_in_8bit else 0),
        seeded_test_config=args.seeded_test_config, device=args.device, tensor_parallel=args.tensor_parallel,
        dist_backend=args.dist_backend,
    )
    import torch.distributed as dist

    to_file = args.output and (not dist.is_initialized() or dist.get_rank() == 0)  # rank 0 writes the transcripts
    out = open(args.output, "w", encoding="utf-8") if to_file else sys.stdout
    try:
        for item in texts:  # none on the other ranks
            out.write(f"{item[0]} {item[1]}\n" if args.use_ids else f"{item}\n")
            out.flush()
    finally:
        if to_file:
            out.close()
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    cli()
