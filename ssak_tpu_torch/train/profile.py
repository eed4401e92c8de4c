"""Where the time goes in the port's CTC and Whisper train steps, on one CUDA card.

    python3 -m ssak_tpu_torch.train.profile [--preset base] [--batch 32] [--seconds 15] [--labels 256] [--tf32]
    python3 -m ssak_tpu_torch.train.profile --preset whisper_large3_lora[_int8|_int4] [--batch 4] [--remat]

--preset names a wav2vec2 preset (base, large, xlsr) or `conformer_large`:
NeMo Conformer-CTC Large at the widths of an stt_en_conformer_ctc_large
archive (models.hf_loader.nemo_conformer_config: 18 layers of d_model 512,
8 heads, rel-pos attention, striding2d subsampling, 128 pieces + the blank
last). A seeded model (bf16 compute over f32 master weights, mask_time_prob
0.05; wav2vec2's feature encoder frozen) and one random batch of int16
audio and labels, as CTCTrainer feeds it; two warm-up steps, then
  - phase times with CUDA events (mean of 3): the frozen conv stack alone
    (wav2vec2) or the log-mel frontend and the Conv2d subsampling
    (Conformer), the whole forward to log-probs, the CTC loss (kernel K1), the backward,
    the optimizer (global norm, clip, AdamW, in-place update), and the whole
    train step (steps.make_ctc_train_step) with its host enqueue time;
  - one train step under torch.profiler: device busy share, time the host
    was blocked on a full command queue, device time by kernel name;
  - one train step under torch.cuda.set_sync_debug_mode: the lines where
    the host waited for the card.
The whisper_large3_lora presets time the step of train_whisper's LoRA
runs: a seeded Whisper large-v3 (random weights at the published widths),
rank-8 adapters on the attention query / value projections, the base in
bf16 (`whisper_large3_lora`) or quantized to int8 / int4 after the
adapters were added (`_int8`, `_int4`), bf16 compute; one batch of
--batch 30 s windows (3,000 mel frames) and U = 445 teacher-forced tokens
(large-v3's 448-slot context less 8, plus a 4-token prompt and eot); phase
times of the encoder forward, the decoder forward with the loss, the
backward and the optimizer over the adapters, then the same trace, peak
memory and synchronizing calls; --remat recomputes each block in the
backward pass.
TF32 is off (matmul and cuDNN) unless --tf32, as in chip_smoke.py.
Prints one JSON object. Numbers are only meaningful on the card; the
script refuses to run without one.
"""

import argparse
import json
import sys
import time


def _mean_events(torch, fn, n=3):
    """(mean device ms between events around fn, mean host ms to enqueue it)."""
    dev_ms, host_ms = 0.0, 0.0
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        t0 = time.perf_counter()
        fn()
        host_ms += (time.perf_counter() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        dev_ms += a.elapsed_time(b)
    return dev_ms / n, host_ms / n


def _trace(torch, fn):
    """Run fn under torch.profiler: wall ms, the device's busy ms (union of
    kernel and copy intervals), its busy share, the ms the host was blocked
    on a full command queue (CUPTI's "Command Buffer Full": the card was
    behind), and the top kernels by device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, spans, blocked_us = {}, [], 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        dur = e.time_range.end - e.time_range.start
        if e.name == "Command Buffer Full":
            blocked_us += dur
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + dur / 1e3, count + 1)
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    rows = sorted(((ms, c, k) for k, (ms, c) in by_name.items()), reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / 1e3 / wall_ms,
            "host_blocked_on_full_queue_ms": blocked_us / 1e3, "n_device_events": len(spans),
            "top_kernels": [{"name": k[:90], "ms": ms, "count": c} for ms, c, k in rows[:15]]}


# stt_en_conformer_ctc_large's model_config.yaml, the part nemo_conformer_config reads
CONFORMER_LARGE = {"encoder": {"feat_in": 80, "n_layers": 18, "d_model": 512, "n_heads": 8, "ff_expansion_factor": 4,
                               "conv_kernel_size": 31, "xscaling": True},
                   "decoder": {"num_classes": 128}}


def _model(preset, dev):
    """(family, config, seeded model on `dev`) of a --preset."""
    if preset == "conformer_large":
        from ssak_tpu_torch.models import conformer
        from ssak_tpu_torch.models.hf_loader import nemo_conformer_config

        cfg = nemo_conformer_config(CONFORMER_LARGE)
        return "conformer", cfg, conformer.init_params(cfg, seed=0, device=dev)
    from ssak_tpu_torch.models import wav2vec2

    cfg = wav2vec2.make_config(preset)
    return "wav2vec2", cfg, wav2vec2.init_params(cfg, seed=0, device=dev)


def profile(torch, preset, batch, seconds, n_labels):
    from ssak_tpu_torch.models import conformer, wav2vec2
    from ssak_tpu_torch.ops.ctc_fused import ctc_loss_fast
    from ssak_tpu_torch.ops.logmel import nemo_log_mel_spectrogram
    from ssak_tpu_torch.train import optim
    from ssak_tpu_torch.train import steps as TS

    dev = torch.device("cuda", 0)
    family, cfg, model = _model(preset, dev)
    is_conformer = family == "conformer"
    opt = TS.make_optimizer(learning_rate=1e-4, warmup_steps=2, total_steps=100)
    state = TS.init_train_state(model, opt)
    step = TS.make_ctc_train_step(cfg, opt, mask_time_prob=0.05, family=family)
    g = torch.Generator(device=dev).manual_seed(0)
    n = int(seconds * 16000)
    # labels avoid the blank: 0 for wav2vec2, the last class for the Conformer
    lo, hi = (0, cfg.blank_id) if is_conformer else (1, cfg.vocab_size)
    b = {"audio": (torch.randn(batch, n, generator=g, device=dev) * 3000).to(torch.int16),
         "audio_lengths": torch.randint(int(0.7 * n), n + 1, (batch,), generator=g, device=dev, dtype=torch.int32),
         "labels": torch.randint(lo, hi, (batch, n_labels), generator=g, device=dev, dtype=torch.int32),
         "label_lengths": torch.randint(int(0.55 * n_labels), int(0.82 * n_labels) + 1, (batch,), generator=g, device=dev,
                                        dtype=torch.int32)}
    for _ in range(2):
        step(state, b)
    torch.cuda.synchronize()
    audio = TS.audio_to_f32(b["audio"])
    params = dict(model.named_parameters())
    frames = (conformer.subsampled_length(cfg, conformer.mel_frame_count(cfg, n)) if is_conformer
              else wav2vec2.feature_extract_output_length(cfg, n))
    res = {"preset": preset, "family": family, "batch": batch, "seconds": seconds, "frames": frames,
           "labels": n_labels, "card": torch.cuda.get_device_name(0),
           "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]}

    def forward():
        if is_conformer:
            return conformer.ctc_log_probs(model, audio, cfg, b["audio_lengths"])
        return wav2vec2.ctc_log_probs(model, audio, cfg, b["audio_lengths"], freeze_feature_encoder=True)

    with torch.no_grad():  # no autograd graph kept alive beside the timed steps
        lp, fl = forward()
    lp_leaf = lp.requires_grad_(True)

    def loss():
        return ctc_loss_fast(lp_leaf, fl, b["labels"], b["label_lengths"], blank_id=cfg.blank_id)

    def backward():
        for p in params.values():
            p.grad = None
        lp2, fl2 = forward()
        ctc_loss_fast(lp2, fl2, b["labels"], b["label_lengths"], blank_id=cfg.blank_id).backward()

    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
    opt_state = state["opt_state"]

    def optimizer():
        optim.global_norm(grads.values())
        updates, _ = opt.update(grads, opt_state, {k: p.detach() for k, p in params.items()})
        return updates

    from ssak_tpu_torch.models import layers as L

    if is_conformer:
        mel = nemo_log_mel_spectrogram(audio, n_mels=cfg.n_mels, sample_lengths=b["audio_lengths"])[0]

        def frontend():
            nemo_log_mel_spectrogram(audio, n_mels=cfg.n_mels, sample_lengths=b["audio_lengths"])

        def subsampling():
            with torch.no_grad():
                conformer.subsample(model, mel, cfg)

        res["frontend_ms"], _ = _mean_events(torch, frontend)
        res["subsampling_ms"], _ = _mean_events(torch, subsampling)
    else:
        k = cfg.num_conv_pos_embeddings
        x_pos = torch.randn(batch, frames, cfg.hidden_size, generator=g, device=dev).to(cfg.compute_dtype).requires_grad_(True)

        def conv_stack():
            with torch.no_grad():
                wav2vec2.feature_extractor(model, audio, cfg)

        def pos_conv():
            y = L.conv1d(x_pos, model.encoder.pos_conv, padding=(k // 2, k // 2), groups=cfg.num_conv_pos_embedding_groups,
                         dtype=cfg.compute_dtype)
            y.float().sum().backward()

        res["conv_stack_ms"], _ = _mean_events(torch, conv_stack)
        res["pos_conv_fwd_bwd_ms"], _ = _mean_events(torch, pos_conv)
    res["forward_ms"], res["forward_enqueue_ms"] = _mean_events(torch, forward)
    res["ctc_loss_ms"], _ = _mean_events(torch, loss)
    fwd_bwd_ms, _ = _mean_events(torch, backward)
    res["backward_ms"] = fwd_bwd_ms - res["forward_ms"] - res["ctc_loss_ms"]
    res["optimizer_ms"], res["optimizer_enqueue_ms"] = _mean_events(torch, optimizer)
    res["train_step_ms"], res["train_step_enqueue_ms"] = _mean_events(torch, lambda: step(state, b))
    torch.cuda.reset_peak_memory_stats()
    res["train_step_trace"] = _trace(torch, lambda: step(state, b))
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["synchronizing_calls"] = _synchronizing_calls(torch, lambda: step(state, b))
    return res


WHISPER_PRESETS = {"whisper_large3_lora": 0, "whisper_large3_lora_int8": 8, "whisper_large3_lora_int4": 4}


def profile_whisper(torch, preset, batch, remat=False, rank=8, n_tokens=445):
    """Phase times, trace and peak memory of make_whisper_train_step's
    partitioned step on a seeded large-v3, as train_whisper sets it up for
    --lora (and --load_in_8bit / --load_in_4bit, by `preset`)."""
    import dataclasses

    from ssak_tpu_torch.models import whisper as W
    from ssak_tpu_torch.models.lora import add_lora
    from ssak_tpu_torch.models.quant import partition_trainable, quantize_params
    from ssak_tpu_torch.ops.logmel import log_mel_spectrogram
    from ssak_tpu_torch.train import optim
    from ssak_tpu_torch.train import steps as TS

    dev = torch.device("cuda", 0)
    bits = WHISPER_PRESETS[preset]
    cfg = dataclasses.replace(W.make_config("large-v3"), remat=remat)
    with torch.no_grad():
        model = W.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    if not bits:
        model = model.to(torch.bfloat16)
    add_lora(model, rank=rank, generator=torch.Generator().manual_seed(0))
    if bits:
        quantize_params(model, bits=bits)
    opt = TS.make_optimizer(learning_rate=1e-5, warmup_steps=2, total_steps=100)
    state = TS.init_train_state(model, opt, quantized=True)
    step = TS.make_whisper_train_step(cfg, opt, quantized=True)
    g = torch.Generator(device=dev).manual_seed(0)
    audio = torch.randn(batch, 480000, generator=g, device=dev) * 0.1
    tokens = torch.randint(10, 50000, (batch, n_tokens + 1), generator=g, device=dev)
    mask = torch.ones(batch, n_tokens, device=dev)
    mask[:, :3] = 0
    b = {"mel": log_mel_spectrogram(audio, n_mels=cfg.n_mels), "tokens_in": tokens[:, :-1], "tokens_out": tokens[:, 1:],
         "token_mask": mask}
    for _ in range(2):
        step(state, b)
    torch.cuda.synchronize()
    trainable, _ = partition_trainable(model)
    res = {"preset": preset, "family": "whisper", "batch": batch, "seconds": 30.0, "frames": 1500, "tokens": n_tokens,
           "lora_rank": rank, "bits": bits, "remat": remat, "trainable_params": sum(p.numel() for p in trainable.values()),
           "card": torch.cuda.get_device_name(0),
           "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]}
    with torch.no_grad():
        af = W.encode(model, b["mel"], cfg)

    def encoder():
        with torch.no_grad():
            W.encode(model, b["mel"], cfg)

    def decoder_loss():
        with torch.no_grad():
            W.cross_entropy_loss(W.decode_train(model, b["tokens_in"], af, cfg), b["tokens_out"], b["token_mask"])

    def forward_backward():
        for p in trainable.values():
            p.grad = None
        enc = W.encode(model, b["mel"], cfg)
        W.cross_entropy_loss(W.decode_train(model, b["tokens_in"], enc, cfg), b["tokens_out"], b["token_mask"]).backward()

    forward_backward()
    grads = {k: p.grad.clone() for k, p in trainable.items()}
    for p in trainable.values():
        p.grad = None

    def optimizer():
        optim.global_norm(grads.values())
        return opt.update(grads, state["opt_state"], {k: p.detach() for k, p in trainable.items()})[0]

    res["encoder_ms"], _ = _mean_events(torch, encoder)
    res["decoder_loss_ms"], _ = _mean_events(torch, decoder_loss)
    fwd_bwd_ms, _ = _mean_events(torch, forward_backward)
    res["backward_ms"] = fwd_bwd_ms - res["encoder_ms"] - res["decoder_loss_ms"]
    res["optimizer_ms"], res["optimizer_enqueue_ms"] = _mean_events(torch, optimizer)
    del af, grads
    for p in trainable.values():
        p.grad = None
    res["train_step_ms"], res["train_step_enqueue_ms"] = _mean_events(torch, lambda: step(state, b))
    torch.cuda.reset_peak_memory_stats()
    res["train_step_trace"] = _trace(torch, lambda: step(state, b))
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["synchronizing_calls"] = _synchronizing_calls(torch, lambda: step(state, b))
    return res


def _synchronizing_calls(torch, fn):
    """Where fn makes the host wait for the card: the warnings of
    torch.cuda.set_sync_debug_mode, with the Python line that raised each."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [f"{w.filename}:{w.lineno} {str(w.message)[:160]}" for w in caught][:20]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="base", help="wav2vec2 preset (base, large, xlsr), conformer_large, or "
                    "whisper_large3_lora[_int8|_int4]")
    ap.add_argument("--batch", type=int, default=None, help="rows per batch (default 32; 4 for the Whisper presets)")
    ap.add_argument("--remat", action="store_true", help="Whisper presets: recompute each block in the backward pass")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--labels", type=int, default=256)
    ap.add_argument("--tf32", action="store_true", help="leave TF32 on for matmul and cuDNN")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssak_tpu_torch.train.profile: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = args.tf32
    torch.backends.cudnn.allow_tf32 = args.tf32
    if args.preset in WHISPER_PRESETS:
        res = profile_whisper(torch, args.preset, args.batch or 4, remat=args.remat)
    else:
        res = profile(torch, args.preset, args.batch or 32, args.seconds, args.labels)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
