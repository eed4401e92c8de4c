#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (ssak_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):
  1. build   compile csrc/*.cu with nvcc for sm_90a (one process per source);
             L1's wgmma kernels batched in their SASS (cuobjdump); the
             card's dense bf16 peak read by utils.flops.peak_flops (every
             bound's), and whether matplotlib is installed on this host
  2. kernels each kernel's wrapper at the main path's shapes against its
             plain PyTorch version on the card, with CUDA-event timings of
             the kernel, the plain version and one library call, and the
             least time the card could take (bytes or operations bound);
             K1 at the 140 s bucket also against the same recursion in
             f64, bit-identical on repeat at its three timed shapes, S =
             1,025 and 4,097 split over a thread-block cluster, and at the
             Conformer fine-tuning shape (V = 129, blank 128: the branch
             that reads emissions from device memory), beside
             F.ctc_loss(blank=128); K2 and K3 at every M from 1 to 64, bit-identical on
             repeat with one allocation a call at their timed shapes, no
             register spills in their ptxas reports; K4 on full, one-key,
             empty, inner and ragged ranges, at T = 12,288 and on caches off
             a 16-byte boundary, within 1e-2 of each row's largest output
             (a planted edge-group fault shown to exceed that), bit-identical
             on repeat at its timed shapes (the self-attention ranges [0,
             31], [0, 127] and [0, 223] of a decode step included; in bf16
             also a tensor-parallel rank's 10 heads at T = 1,500 and [0,
             31] of 448), no register spills; L1's forward bit-identical on repeat at every
             checked case (8 heads at T = 7,001, a tensor-parallel
             rank's, among them), no register spills and no serialised wgmma in
             its ptxas report, its plan logged at every shape and its tile
             counts on ragged rows, timed also with m and l written (the
             training launch); L1's backward (dK/dV
             and dQ) through autograd, bit-identical on repeat, no register
             spills, timed also on ragged rows and at the 30 s bucket
  3. slices  a seeded Whisper large-v3 written as an HF model directory
             (config.json, model.safetensors in F16 under HF names, a
             byte-level vocab.json + merges.txt + added_tokens.json with
             large-v3's specials) and loaded back bit-identical to
             whisper_from_tree of its f16 tree; from that directory,
             greedy transcription of synthetic wav files listed in a Kaldi
             dir, bf16, --load_in_8bit and --load_in_4bit, transcripts the
             tokenizer's text; the --load_in_4bit --accurate chain (beam 5,
             best_of 5, temperature fallback) over a Kaldi dir of short
             files (16 tokens); the int4 long-form seek loop over 70 s files
             (full temperature chain, best_of 5, 16-token windows); then
             whisper_tp on that directory (two gloo ranks sharing the
             card, spawned: greedy bf16 and int8 over 4 files of 29 s
             through whisper_infer --tensor_parallel 2 at full depth, K4
             bf16 on 10 heads a rank, 64 a decode step, and in int8 K2 256
             and K4 int8 64 a step on whole units; the full-depth sharded
             teacher-forced logits correlated >= 0.999 with the whole
             model's; on a directory of large-v3's widths cut to 2 + 2
             blocks, --accurate over 2 files of 20 s and long-form over one
             of 70 s at T = 0, and in f32 the sharded logits within 1e-4 of
             the CPU's unsharded ones; both ranks decode the same ids in
             every run; the cut directory also through python -m
             torch.distributed.run -m ssak_tpu_torch.infer.whisper_infer
             --tensor_parallel 2); then
             Whisper large-v3 fine-tuning from that directory through
             python -m ssak_tpu_torch.train.whisper_loop (--language en,
             16 files of 20-29 s, batch 4 x 30 s, 3 steps, an evaluation
             at the last over 4 files, --remat): --lora 8 over the bf16 base,
             and with --load_in_8bit and --load_in_4bit (the evaluation's
             K4 bf16, K2 and K3 launches against its decode steps, the frozen base
             bit for bit, adapters.npz reloaded into a fresh model: the
             same loss), and the full fine-tune of the directory's tree,
             cut to 4 + 4 blocks, in f32 with remat (3 steps, a checkpoint,
             a resume for one more step); then
             wav2vec2-base CTC training at full width (CTCTrainer, batch 32
             of 15 s, 8 steps, eval, checkpoint, resume) on a seeded Kaldi
             dir of 64 wavs, exported by train.finalize and reloaded with
             load_model (the trainer's log-probs on an eval batch); then
             wav2vec2-xlsr CTC serving at full width from an HF directory
             (pytorch_model.bin) through ctc_infer over a Kaldi dir of 16
             files (30 s, 140 s and chunked 200 s audio), greedy in bf16
             and quantized on load (--load_in_8bit, --load_in_4bit: the
             same encoder frames, L1 on every 140 s call, K2 and K3 at 0,
             the CER against the bf16 transcripts), and with the device
             beam (width 16, lexicon, word 3-gram) over the 14 files of one
             chunk (its step a CUDA graph, bit for bit the eager loop on a
             cut of the first batch); the host prefix beam (width 16, lexicon, a word 4-gram
             scored by the port's C++ library) over 4 files in process and
             over 4 spawned workers (the same transcripts; each worker, read
             once after the decode, with its CUDA untouched); streaming: the port's WebSocket server over
             the same directory, two 20-30 s files in 8 kB chunks through
             the port's remote_streaming and a lockstep client (one partial
             per chunk, the text, the close; the texts of an in-process
             StreamingCTCDecoder; ms per block and chunk-to-reply
             latency); then a seeded NeMo Conformer-CTC Large written as a
             .nemo archive (model_config.yaml by hand, model_weights.ckpt
             by torch.save; 18 layers of d 512, rel-pos attention, 128
             pieces + the blank last), loaded back against what was
             written, served through ctc_infer over the same 16 files
             (greedy in bf16, int8 and int4; the device beam of width 16
             over the 14 of one chunk) and fine-tuned through the train
             CLI's --base_model
             (batch 16 x 15 s, 6 steps, eval, checkpoint, resume, then
             sak-finalize and load_model of the export: the trainer's
             log-probs); then wav2vec2-xlsr CTC training at full width and depth
             at the 140 s bucket (CTCTrainer, batch 4 x 6,999 frames, 6
             steps, eval, checkpoint, resume; L1 forward and backward on
             every layer); then corpus ingest: a Kaldi dir of FLAC files (the
             port's own decoder, bit for bit to the integers written), sox
             pipes over 8 kHz WAV with a $VAR in their paths and segments of
             16 kHz WAV recordings through check_kaldi_dir (utt2dur within
             10 ms of each decoded length), kaldi2manifest manifest, tar
             (the shards' audio bit for bit) and tokenizer --type bpe, then
             the train CLI on a seeded wav2vec2-base directory with --config,
             --set and --use_manifest_cache (B=16 x 15 s, 4 steps, eval;
             resumed from the cached manifests), an MP3 refused by name (no
             libmpg123 there) and resample_torch against the host resampler;
             then alignment and training data: a Kaldi dir of 4 utterances
             of the serving corpus (two of 90-140 s, one of 200 s, the
             first 20 s of another) split by python -m
             ssak_tpu_torch.tools.align_audio_transcript at --max_duration
             30 through the xlsr directory (L1 forward 24 times a 140 s
             chunk, nothing else; check_kaldi_dir; every cut inside its
             utterance; each long utterance's trellis on the card, graphed
             and eager, bit for bit the CPU's on the card's log-probs,
             timed), the train CLI with --data_augment over noise and RIR
             directories on the ingest corpus (B=16 x 15 s, 4 steps, an
             evaluation; K1 per step and evaluation batch; the host
             augmentation timed), the voice converter at its defaults (20
             steps; vc_forward's delta (out - x - voice) card vs CPU
             within 1e-4 of its max, Griffin-Lim
             card vs CPU correlation >= 0.999 and bit-identical on repeat,
             convert_kaldi_dir over 4 utterances of 10-15 s, lengths kept)
             and the NN VAD (20 steps; speech_probs card vs CPU within
             1e-4); then parallel/ (slice 8g): a probe of what the card's
             process groups carry (two gloo ranks sharing the card, each
             collective on CUDA tensors, f32 all-reduces timed at xlsr's
             and large-v3's partials; one NCCL rank), then, on the xlsr
             directory before it is removed, tp_serving (4 files of the
             serving corpus, 2 of 70-140 s and 2 of 12-28 s, through
             python -m torch.distributed.run -m ssak_tpu_torch.infer.ctc_infer
             --tensor_parallel 2 --dist_backend gloo and through spawned
             ranks; each rank on half the heads, q / k / v / fc1 / lm_head
             column- and out / fc2 row-parallel; L1 forward 24 a 140 s
             call on every rank; rank 0's
             log-probs correlated >= 0.999 with the unsharded model's; CER
             logged) and sp_serving (ctc_log_probs_sp of a 140 s row over
             'seq' 2 against compute_log_probas through L1, >= 0.999); then
             host_modules (slice 8i) on the same directory, loaded once with
             a seeded two-class classifier head: utils.gender.classify_speech
             on a serving file of >= 90 s (L1 forward once a layer, nothing
             else), untraced and inside utils.monitoring.profile_trace and
             annotate (the Chrome-trace JSON holds the region and >= 24 L1
             kernels; probabilities finite, summing to 1 within 1e-6);
             device_memory_stats against torch.cuda.max_memory_allocated;
             utils.flops.peak_flops beside the card's name and power limit;
             predict_gender_kaldi_dir over the corpus's first 8 files; then
             moe_training (wav2vec2-base with 4 experts, top 2, through
             shard_train_step at world size 1, B=8 x 15 s, 4 steps, K1 4)
             and pp_training (make_pp_ctc_train_step, pipe 1, 2
             microbatches, B=8 x 15 s, 3 steps, K1 3, the first loss within
             1e-2 of the unpipelined forward's); each with the kernels' launch counters checked
             against the path exactly (on the accurate and long-form paths,
             against the decode steps the port counts; on CTC serving, L1
             against 24 x the encoder calls at >= 4096 frames)
  4. parity  teacher-forced Whisper logits of the port on the card against
             the port on the CPU in f32 (large-v3 widths, 2+2 layers; bf16,
             int8 and int4 weights), the int4 window decode's no-speech and
             first-step logits card against CPU, and two wav2vec2 train
             steps card against CPU in f32 (large widths, 2 layers, remat),
             and CTC log-probs of a 140 s row card (through L1) against CPU
             in bf16 (xlsr widths, 1 layer), same weights, and of a
             1-layer model quantized to int8 (correlation >= 0.99; int8 and
             int4 against bf16 on the card, reported); a
             bf16 dense with a bias at x 4 x 6,999 x 1,024 -> 4,096, card
             against CPU and against an f64 product rounded once (>= 99.9%
             equal, the rest one bf16 step), timed beside the parent's
             double rounding and an f32 sum cast afterwards; one bf16 train
             step at the 100 s bucket (xlsr widths, 1 layer, remat), the
             card through L1 forward and backward, the CPU unfused; a NeMo
             archive at Conformer Large widths and 2 layers in f32: the
             log-probs of a 30 s and a 140 s row, and two train steps,
             card against CPU; one Whisper LoRA train step over an f32 and
             over an int8 base at large-v3 widths and 2+2 layers in f32,
             card against CPU; one MoE wav2vec2 train step at base widths
             and 2 layers in f32, card against CPU (the same routing in
             every layer)

TF32 is off for the whole run (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 = False): f32 products on the card are full
f32, as on the CPU. The line before the last is the card's name and power
limit from nvidia-smi; before it, one JSON line lists every ported kernel.
The last line is {"ok": true, "device": {...}}.
"""

import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

MAX_TOKENS = 32
# the accurate chain's and the long-form loop's token budgets (32 until the tensor-parallel Whisper run came: the
# script's time limit; their decode steps are host-bound)
ACC_TOKENS, LF_TOKENS = 16, 16
N_FILES = 24
FILE_SECONDS = 29.0
ACC_FILES, ACC_SECONDS = 4, 20.0  # the accurate chain's Kaldi dir: one window batch of 4 (x 5 beams = 20 rows; 8 until
# the tensor-parallel Whisper run came)
LF_FILES, LF_SECONDS = 4, 70.0  # long-form: 3 windows a file, 4 rows (x 5 candidates = 20 rows)
TP_HEADS = 10  # large-v3's 20 heads on each of 2 tensor-parallel ranks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = None  # the card's dense bf16 tensor-core peak: card_peak()
F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM
CTC_FILES, CTC_EVAL_FILES, CTC_BATCH, CTC_STEPS = 64, 32, 32, 8
L2_BYTES = 50 * 2**20
SPIN_CYCLES = 100_000_000  # about 50 ms at the H100's clock: longer than queueing 64 calls


T_START = time.perf_counter()


def log(msg):
    print(f"[chip_smoke {time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def card_peak():
    """The card's dense bf16 tensor-core peak FLOP/s, read once from
    utils.flops.peak_flops; raises for a card outside its table."""
    global BF16_FLOPS
    if BF16_FLOPS is None:
        import torch

        from ssak_tpu_torch.utils.flops import peak_flops

        BF16_FLOPS = peak_flops()
        if BF16_FLOPS is None:
            raise RuntimeError(f"utils.flops.peak_flops knows no bf16 peak for {torch.cuda.get_device_name(0)}: "
                               "the kernels' bounds need one")
    return BF16_FLOPS


def bound(n_bytes, n_flops, peak=None):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / (card_peak() if peak is None else peak)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def hgmma_batching(sass):
    """{function: (HGMMA instructions, those that carry gsb0)} of a cuobjdump
    -sass listing, for the functions that have any. A batch of wgmmas ends
    at the one HGMMA with gsb0; serialised, every HGMMA has it."""
    out = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        lines = f.splitlines()
        hg = [line for line in lines if "HGMMA" in line]
        if hg:
            out[lines[0].strip()] = (len(hg), sum("gsb0" in line for line in hg))
    return out


def time_ms(torch, fn, arg_sets, min_iters=20):
    """Mean ms per call over CUDA events, cycling through `arg_sets` (copies
    whose total exceeds the L2 cache, so each call reads device memory as
    the decode loop does). A spin kernel ahead of the first event lets the
    host queue every call before the card starts them, so the events time
    the card's work and not the host's rate of launching it."""
    for a in arg_sets[:2]:
        fn(*a)
    iters = max(min_iters, len(arg_sets))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def n_copies(bytes_per_set):
    return max(1, min(64, math.ceil(2 * L2_BYTES / max(1, bytes_per_set))))


# --- phase 2: kernels against their plain versions ---------------------------


def check_matmul_int8(torch, dev):
    """K2 against its plain version on the card. Both compute exact products
    of bf16 values in f32 and differ only in the order of the sums: 1e-3 of
    max|ref|. Checked at the six timed shapes (M = 24, 40 at the decoder's
    three (K, N)), odd M with a partial 64-column tile and 8-byte weight
    rows (N % 16 != 0), every M from 1 to 64 at (1280, 1280) (each 16-row
    group count the kernel instantiates), a ragged last K stage with both
    copy widths, and the one-block case. At each timed shape: two launches
    bit-identical (split-K summed in rank order, no atomics), one call
    allocates nothing but y, and the plan (block_n, splits) and the share of
    the bound are logged."""
    from ssak_tpu_torch.models.quant import quantize_kernel
    from ssak_tpu_torch.ops import int8_matmul as IM

    g = torch.Generator(device=dev).manual_seed(1)
    rows, worst = [], 0.0
    shapes = [(m, k, n) for m in (24, 40) for (k, n) in ((1280, 1280), (1280, 5120), (5120, 1280))]
    extra = [(5, 1280, 1288)]  # odd M and a partial 64-column tile
    extra += [(m, 1280, 1280) for m in range(1, 65) if m not in (24, 40)]
    extra += [(33, 1288, 1280), (64, 1288, 1288), (1, 8, 8)]
    for M, K, N in shapes + extra:
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        q8, scale = quantize_kernel(torch.randn(K, N, generator=g, device=dev) * 0.05)
        y = IM.matmul_int8(x, q8, scale)
        ref = IM.matmul_int8_reference(x, q8, scale)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max())
        if not err <= tol:
            raise AssertionError(f"matmul_int8 M={M} K={K} N={N}: max|err| {err} > {tol}")
        worst = max(worst, err)
        if (M, K, N) not in shapes:
            continue
        n_alloc = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        again = IM.matmul_int8(x, q8, scale)
        n_alloc = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - n_alloc
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            raise AssertionError(f"matmul_int8 M={M} K={K} N={N}: two launches differ")
        if n_alloc != 1:
            raise AssertionError(f"matmul_int8 M={M} K={K} N={N}: a call made {n_alloc} allocations, want 1 (y)")
        sets = [(x, q8.clone(), scale.clone()) for _ in range(n_copies(K * N))]
        wdq = [(x, a[1].to(torch.bfloat16), a[2]) for a in sets]  # the dequantized bf16 weight
        block_n, splits, _per = IM.int8_plan(M, K, N)
        row = dict(
            M=M, K=K, N=N, block_n=block_n, splits=splits, max_abs_err=err,
            ms=time_ms(torch, IM.matmul_int8, sets),
            plain_ms=time_ms(torch, IM.matmul_int8_reference, sets),
            library_ms=time_ms(torch, lambda a, w, s: torch.matmul(a, w) * s, wdq),
        )
        row["bound_ms"], row["bound_by"] = bound(M * K * 2 + K * N + N * 4 + M * N * 4, 2 * M * K * N)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"matmul_int8 {row}; repeat bit-identical")
    log(f"matmul_int8: {len(shapes) + len(extra)} shapes within 1e-3 of max|ref|")
    # card ms of K2 per int8 decode step at M = 24: per layer 6 denses of
    # 1280 x 1280 (self q/k/v/o, cross q/o), fc1 1280 x 5120, fc2 5120 x 1280; 32 layers
    t = {(r["K"], r["N"]): r["ms"] for r in rows if r["M"] == 24}
    log(f"matmul_int8 card ms per int8 decode step (M=24, 32 layers): "
        f"{32 * (6 * t[1280, 1280] + t[1280, 5120] + t[5120, 1280])}")
    return rows, worst


def int4_rows():
    """K3's row counts on phase 3's int4 paths: the full int4 window batch,
    the greedy run's batch (N_FILES windows), the accurate run's beam and
    best-of rows (window batch x 5) and long-form's (LF_FILES x 5)."""
    from ssak_tpu_torch.infer.whisper_infer import auto_window_batch
    from ssak_tpu_torch.models.whisper import make_config

    cfg = make_config("large-v3")
    full = auto_window_batch(cfg, 4)
    return (full, min(N_FILES, full), auto_window_batch(cfg, 4, beam_size=5, best_of=5) * 5, LF_FILES * 5)


def check_matmul_int4(torch, dev):
    """K3 against its plain version at the slice's three large-v3 sites.
    Checked at every M from 1 to 64 (each 16-row group count the kernel
    instantiates, full and partial groups, hence every row count the
    fallback and seek loops can reach), plus odd M with a partial 64-column
    tile and 8-byte packed rows (N % 16 != 0), and a contraction of one
    stage; timed at the row counts of phase 3's int4 paths (int4_rows).
    Both compute exact products of bf16 values in f32; only the order of
    the sums differs: 1e-4 of max|y|. At each timed shape: two launches
    bit-identical (split-K summed in rank order, no atomics), one call
    allocates nothing but y, and the plan (block_n, splits) and the share of
    the bound are logged."""
    from ssak_tpu_torch.models.quant import dequantize_int4, quantize_kernel
    from ssak_tpu_torch.ops import int8_matmul as IM

    g = torch.Generator(device=dev).manual_seed(4)
    timed_m = sorted(set(int4_rows()), reverse=True)
    rows, worst = [], 0.0
    for K, N, ms in ((1280, 1280, range(1, 65)), (1280, 5120, range(1, 65)), (5120, 1280, range(1, 65)),
                     (1280, 1288, (5,)), (128, 256, (3,))):
        xs = torch.randn(max(ms), K, generator=g, device=dev).to(torch.bfloat16)
        q4, scale = quantize_kernel(torch.randn(K, N, generator=g, device=dev) * 0.05, bits=4)
        site_err = 0.0
        for M in ms:
            x = xs[:M].contiguous()
            y = IM.matmul_int4(x, q4, scale)
            ref = IM.matmul_int4_reference(x, q4, scale)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max())
            if not err <= tol:
                raise AssertionError(f"matmul_int4 M={M} K={K} N={N}: max|err| {err} > {tol}")
            site_err = max(site_err, err)
            if M not in timed_m or len(ms) == 1:
                continue
            n_alloc = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
            again = IM.matmul_int4(x, q4, scale)
            n_alloc = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - n_alloc
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                raise AssertionError(f"matmul_int4 M={M} K={K} N={N}: two launches differ")
            if n_alloc != 1:
                raise AssertionError(f"matmul_int4 M={M} K={K} N={N}: a call made {n_alloc} allocations, want 1 (y)")
            sets = [(x, q4.clone(), scale.clone()) for _ in range(n_copies(K * N // 2))]
            wdq = [(x, dequantize_int4(a[1], a[2], torch.bfloat16)) for a in sets]
            block_n, splits, _per = IM.int4_plan(M, K, N)
            row = dict(
                M=M, K=K, N=N, block_n=block_n, splits=splits, max_abs_err=err,
                ms=time_ms(torch, IM.matmul_int4, sets),
                plain_ms=time_ms(torch, IM.matmul_int4_reference, sets),
                library_ms=time_ms(torch, torch.matmul, wdq),
            )
            # packed weights + block scales + x read once, y written once
            row["bound_ms"], row["bound_by"] = bound(K * N // 2 + (K // 64) * N * 4 + M * K * 2 + M * N * 4, 2 * M * K * N)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            log(f"matmul_int4 {row}; repeat bit-identical")
            del sets, wdq
        log(f"matmul_int4 K={K} N={N} plan={IM.int4_plan(min(ms), K, N)}: checked at M={min(ms)}..{max(ms)}, "
            f"max|err| {site_err}")
        worst = max(worst, site_err)
    # card ms of K3 per int4 decode step at M = 32: per layer 6 denses of
    # 1280 x 1280 (self q/k/v/o, cross q/o), fc1 1280 x 5120, fc2 5120 x 1280; 32 layers
    t = {(r["K"], r["N"]): r["ms"] for r in rows if r["M"] == 32}
    if len(t) == 3:
        log(f"matmul_int4 card ms per int4 decode step (M=32, 32 layers): "
            f"{32 * (6 * t[1280, 1280] + t[1280, 5120] + t[5120, 1280])}")
    return rows, worst


def _rand_kv(torch, g, dev, B, H, Dh, T, int8):
    from ssak_tpu_torch.models.layers import quantize_decode_kv

    q = (torch.randn(B, H, Dh, generator=g, device=dev) * 0.125).to(torch.bfloat16)
    k = torch.randn(B, H, Dh, T, generator=g, device=dev)
    v = torch.randn(B, H, Dh, T, generator=g, device=dev)
    if int8:
        kv = quantize_decode_kv(k, v)
        return q, (kv["k8"], kv["v8"], kv["ks"], kv["vs"])
    return q, (k.to(torch.bfloat16), v.to(torch.bfloat16))


# K4's limit in every (batch, head) row, relative to the row's largest
# output: well above what the kernel reads and well below what a kernel
# that takes one edge group of keys from the wrong place reads, at every
# checked shape, T = 12,288 included (both logged; _planted).
K4_REL = 1e-2


def k4_rel_err(out, ref):
    """max over (batch, head) rows of max_d |out - ref| / max_d |ref|."""
    return float(((out - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max())


def _planted(torch, FD, args, int8):
    """What k4_rel_err reads when one edge group of keys is taken from the
    neighbouring group: K's first group in range, V's first or V's last
    (the plain version on so faulted inputs stands for a kernel that
    misplaces a group). Rows with fewer than two groups in range are left
    whole. Returns the smallest of the three readings."""
    q, k, v, lo, hi, *sc = args
    T = k.shape[-1]
    ve = FD.flash_decode_vec(T, "int8" if int8 else "bf16") // (1 if int8 else 2)
    ref = FD.flash_decode_reference(*args)
    reads = []
    for which in ("k first", "v first", "v last"):
        kf, vf = k.clone(), v.clone()
        dst, src = (kf, k) if which[0] == "k" else (vf, v)
        for b, (l, h) in enumerate(zip(lo.tolist(), hi.tolist())):
            t0, t1 = FD.flash_decode_range(l, h, T)
            if t1 - t0 + 1 < 2 * ve:
                continue
            a, d = (t0, ve) if which.endswith("first") else (t1 + 1 - ve, -ve)
            dst[b, ..., a:a + ve] = src[b, ..., a + d:a + d + ve]
        reads.append(k4_rel_err(FD.flash_decode_reference(q, kf, vf, lo, hi, *sc), ref))
    return min(reads)


def check_flash_decode(torch, dev, int8):
    """K4 against its plain version at the decoder's shapes (H=20, Dh=64; B
    = 24, 40; T = 448, the self-attention cache, and 1,500, the encoder's
    keys; in bf16 also a tensor-parallel rank's H = 10 of large-v3's 20 at
    tp 2, B = 24, on both caches). Checked on rows with the full range, one
    key, an empty range (lo > hi: every key masked, weighted alike), a
    range inside the cache and ragged ranges, within 2e-2 and, in every
    (batch, head) row, within K4_REL of the row's largest output (bf16 p
    may round the other way where the two sum orders straddle a bf16
    boundary; an output shrinks as 1 / sqrt(T), so a fixed limit would pass
    wrong keys at long ranges). Timed on the full range, and at T = 448 on
    self-attention ranges of a decode step ([0, 31], [0, 127] and [0, 223]:
    B = 24 bf16, 40 int8; [0, 31] at H = 10), each timed call also checked,
    and repeated bit-identical (the exchange over the cluster sums in rank
    order, no atomics). At every timed shape and at T = MAX_T the check is
    shown to catch a planted edge-group fault (_planted). The plan of every
    shape is logged; the bound counts the bytes of the keys in range."""
    import torch.nn.functional as F

    from ssak_tpu_torch.ops import flash_decode as FD

    g = torch.Generator(device=dev).manual_seed(2 + int8)
    Dh = 64
    tag = f"flash_decode_{'int8' if int8 else 'bf16'}"
    rows, worst, worst_rel, weakest = [], 0.0, 0.0, float("inf")
    timed = ([(B, 20, T, 0, T - 1) for B in (24, 40) for T in (448, 1500)]
             + [(40 if int8 else 24, 20, 448, 0, n) for n in (31, 127, 223)]
             + ([] if int8 else [(24, TP_HEADS, 1500, 0, 1499), (24, TP_HEADS, 448, 0, 31)]))
    for B, H, T, t_lo, t_hi in timed:
        q, kv = _rand_kv(torch, g, dev, B, H, Dh, T, int8)
        plan = FD.flash_decode_plan(B, H, Dh, T, "int8" if int8 else "bf16")
        if t_hi == T - 1:  # ragged ranges for the check, once a shape
            lo = torch.randint(0, T // 4, (B,), generator=g, device=dev, dtype=torch.int32)
            hi = torch.randint(T // 2, T, (B,), generator=g, device=dev, dtype=torch.int32)
            lo[0], hi[0] = 0, T - 1
            lo[1], hi[1] = 5, 5
            lo[2], hi[2] = 7, 3  # empty
            lo[3], hi[3] = T // 3, T // 3 + 40
            args = (q, kv[0], kv[1], lo, hi) + tuple(kv[2:])
            out = FD.flash_decode_attention(*args)
            ref = FD.flash_decode_reference(*args)
            torch.cuda.synchronize()
            err, rel = float((out - ref).abs().max()), k4_rel_err(out, ref)
            if not (err <= 2e-2 and rel <= K4_REL):
                raise AssertionError(f"{tag} B={B} H={H} T={T}: max|err| {err} > 2e-2 or {rel} > {K4_REL} of a row's "
                                     "largest output (full, one key, empty, inner, ragged)")
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        t_lo_v = torch.full((B,), t_lo, dtype=torch.int32, device=dev)
        t_hi_v = torch.full((B,), t_hi, dtype=torch.int32, device=dev)
        args = (q, kv[0], kv[1], t_lo_v, t_hi_v) + tuple(kv[2:])
        out = FD.flash_decode_attention(*args)
        again = FD.flash_decode_attention(*args)
        ref = FD.flash_decode_reference(*args)
        torch.cuda.synchronize()
        err, rel, planted = float((out - ref).abs().max()), k4_rel_err(out, ref), _planted(torch, FD, args, int8)
        if not (err <= 2e-2 and rel <= K4_REL):
            raise AssertionError(f"{tag} B={B} H={H} T={T} range [{t_lo}, {t_hi}]: max|err| {err} > 2e-2 or {rel} > {K4_REL}")
        if not torch.equal(out, again):
            raise AssertionError(f"{tag} B={B} H={H} T={T} range [{t_lo}, {t_hi}]: two launches differ")
        if not planted > K4_REL:
            raise AssertionError(f"{tag} B={B} H={H} T={T} range [{t_lo}, {t_hi}]: a planted edge-group fault reads "
                                 f"{planted}, within the limit {K4_REL}")
        worst, worst_rel, weakest = max(worst, err), max(worst_rel, rel), min(weakest, planted)
        n, elt = t_hi - t_lo + 1, 1 if int8 else 2
        kv_bytes = 2 * B * H * Dh * T * elt + (2 * B * H * T * 2 if int8 else 0)  # the caches, for the copies
        sets = [(q, *(a.clone() for a in kv[:2]), t_lo_v, t_hi_v, *(a.clone() for a in kv[2:]))
                for _ in range(n_copies(kv_bytes))]
        # library yardstick: SDPA on bf16 K/V in (B, H, T, Dh), range mask
        mask = torch.zeros(B, 1, 1, T, dtype=torch.bool, device=dev)
        mask[..., t_lo:t_hi + 1] = True
        if int8:
            kb = (kv[0].float() * kv[2].float()).to(torch.bfloat16)
            vb = (kv[1].float() * kv[3].float()).to(torch.bfloat16)
        else:
            kb, vb = kv
        lib_sets = [(q[:, :, None], kb.transpose(-1, -2).contiguous(), vb.transpose(-1, -2).contiguous(), mask)
                    for _ in range(n_copies(2 * B * H * Dh * T * 2))]
        row = dict(
            B=B, H=H, T=T, range=f"{t_lo}:{t_hi}", max_abs_err=err, max_rel_err=rel, planted_fault_reads=planted,
            plan={k: plan[k] for k in ("cluster", "seg_rows", "stages", "warps", "smem", "ctas_per_sm", "clusters",
                                       "sites_per_cluster", "vec")},
            ms=time_ms(torch, FD.flash_decode_attention, sets),
            plain_ms=time_ms(torch, FD.flash_decode_reference, sets),
            library_ms=time_ms(torch, lambda a, k, v, m: F.scaled_dot_product_attention(a, k, v, attn_mask=m, scale=1.0), lib_sets),
        )
        # the keys in range of K and V (and their scales) read once, q read and o written once
        in_range = 2 * B * H * Dh * n * elt + (2 * B * H * n * 2 if int8 else 0)
        row["bound_ms"], row["bound_by"] = bound(in_range + B * H * Dh * (2 + 4) + 8 * B, 4 * B * H * Dh * n)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"{tag} {row}; repeat bit-identical")
        del sets, lib_sets
    # off the decoder's shapes: T = MAX_T (the ring cycles over row segments), odd T (vectors of one key) and
    # caches that start off a 16-byte boundary (views one element into a buffer: plain loads at both ends)
    H = 20
    for B, T, shift in ((3, FD.MAX_T, 0), (5, 1501, 0), (5, 448, 1)):
        q, kv = _rand_kv(torch, g, dev, B, H, Dh, T, int8)
        kv = tuple(torch.cat([a.new_zeros(shift), a.reshape(-1)])[shift:].view(a.shape) for a in kv)
        lo = torch.tensor([0, 5, 7, T // 3, T // 5][:B], dtype=torch.int32, device=dev)
        hi = torch.tensor([T - 1, 5, 3, T // 3 + 40, T - 1 - T // 7][:B], dtype=torch.int32, device=dev)
        args = (q, kv[0], kv[1], lo, hi) + tuple(kv[2:])
        out = FD.flash_decode_attention(*args)
        again = FD.flash_decode_attention(*args)
        ref = FD.flash_decode_reference(*args)
        torch.cuda.synchronize()
        err, rel = float((out - ref).abs().max()), k4_rel_err(out, ref)
        if not (err <= 2e-2 and rel <= K4_REL) or not torch.equal(out, again):
            raise AssertionError(f"{tag} B={B} T={T} shift={shift}: max|err| {err} > 2e-2, {rel} > {K4_REL} "
                                 "or repeats differ")
        planted = _planted(torch, FD, args, int8) if T == FD.MAX_T else None
        if planted is not None and not planted > K4_REL:
            raise AssertionError(f"{tag} B={B} T={T}: a planted edge-group fault reads {planted}, within {K4_REL}")
        worst, worst_rel, weakest = max(worst, err), max(worst_rel, rel), min(weakest, planted or weakest)
        log(f"{tag} B={B} T={T} base offset {kv[0].data_ptr() % 16} bytes: max|err| {err}, rel {rel}, planted "
            f"fault reads {planted}, repeat bit-identical, plan {FD.flash_decode_plan(B, H, Dh, T, 'int8' if int8 else 'bf16')}")
    log(f"{tag}: {len(timed)} timed shapes, {sum(t[-1] == t[2] - 1 for t in timed)} checked with full, one-key, "
        "empty, inner and ragged ranges, 3 more "
        f"off the decoder's shapes, max|err| {worst}, largest error of a row {worst_rel} of its largest output "
        f"(limit {K4_REL}); a planted edge-group fault reads at least {weakest}")
    return rows, worst


def ctc_case(torch, dev, V, seed, B=32, T=749, U=256):
    """log_probs (B, T, V) of random logits; label rows of 150-256 tokens
    (a 15 s utterance at ~14 chars/s), frame lengths of 600-749, with a
    batch-pad dummy (label length 0, frame length -1), an infeasible row
    (200 labels in 100 frames) and a row of repeated labels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = torch.log_softmax(2 * torch.randn(B, T, V, generator=g, device=dev), dim=-1)
    labels = torch.randint(1, V, (B, U), generator=g, device=dev, dtype=torch.int32)
    lab_len = torch.randint(150, U + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    t_len = torch.randint(600, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    t_len[0], lab_len[0] = T, U
    t_len[1], lab_len[1] = -1, 0
    t_len[2], lab_len[2] = 100, 200
    labels[3, :] = labels[3, 0]
    if U > 256:  # labels outside the vocabulary emit 0 and get no gradient
        labels[4, 1], labels[5, 0] = V, -1
    return lp, t_len, labels, lab_len


def ctc_long_case(torch, dev, seed, B=4, T=6999, U=2048, V=32):
    """Phase 3's 140 s bucket (xlsr training): log_probs (B, T, V) of random
    logits, rows of 4,499-6,999 frames (90-140 s) with ~14 chars/s of labels
    (0.28 a frame) in a label width of 2,048 (S = 4,097 states), the first
    row full (6,999 frames, 1,959 labels)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = torch.log_softmax(2 * torch.randn(B, T, V, generator=g, device=dev), dim=-1)
    labels = torch.randint(1, V, (B, U), generator=g, device=dev, dtype=torch.int32)
    t_len = torch.randint(4499, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    t_len[0] = T
    return lp, t_len, labels, (t_len * 0.28).to(torch.int32)


def check_ctc_fused(torch, dev):
    """K1 against its plain version at the slices' shapes, timed: wav2vec2-base
    training's (B=32, T=749, V=32), the largest vocabulary the toolkit trains
    with (V=1024), and xlsr training's 140 s bucket (B=4, T=6,999, S=4,097
    states, each sweep over a cluster of 8 CTAs); checked only, U=512 (S=1025
    states, a cluster of 2) with labels outside the vocabulary. Loss to 1e-5
    relative. Grad to 2e-3 absolute at T=749: alpha reaches about -2,600
    there, where one f32 ulp is 2.4e-4, and a posterior is exp of a
    difference of such sums. At T=6,999 alpha reaches about -2.2e4 (ulp 2e-3),
    so a posterior may be off by about 1% of itself: there the kernel and the
    plain version are held to 1e-2 absolute of each other and of the same
    recursion in f64 (the witness), each valid frame's gradient to a sum of
    -1 within 1e-5 (both divide a frame by its posterior mass, which is 1 in
    exact arithmetic), the gradient's norm to 1e-3 of the witness's and the
    loss to 3e-5 of it. An undivided gradient would carry exp(the loss's
    absolute error) as its scale error (logged as loss_abs); what the
    division leaves is each state's own rounding. Measured on an H100 (NVIDIA
    H100 80GB HBM3, 700 W), kernel and plain alike: loss 6.0e-6, gradient
    4.1e-3, norm 1.4e-4, frame sums 7e-7 from the witness.

    The sweeps' plan (ops/ctc_fused.ctc_plan) is logged with each case; S =
    1,025 and S = 4,097 must run over a cluster of CTAs. At the three timed
    shapes a second call must give a bit-identical loss and gradient (no
    atomics, fixed sum orders). Each row logs the chain's steps (T: the alpha
    and beta sweeps run at once) and the kernel's microseconds a step."""
    import torch.nn.functional as F

    from ssak_tpu_torch.ops import ctc_fused as K1

    rows, worst = [], 0.0
    for V, U in ((32, 256), (1024, 256), (32, 512), (32, 2048)):
        long = U == 2048
        if long:
            lp, t_len, labels, lab_len = ctc_long_case(torch, dev, seed=140)
        else:
            lp, t_len, labels, lab_len = ctc_case(torch, dev, V, seed=V + U, U=U)
        B, T, _ = lp.shape
        S = 2 * labels.shape[1] + 1
        grad_atol = 1e-2 if long else 2e-3
        cluster, threads, kpt, _ = K1.ctc_plan(B, T, S, V)
        plan = dict(cluster=cluster, threads=threads, kpt=kpt)
        if S > 1024 and cluster < 2:
            raise AssertionError(f"ctc_fused V={V} U={U}: plan {plan} does not split S={S} over a cluster")
        loss, grad = K1.ctc_fused(lp, t_len, labels, lab_len)
        ref_loss, ref_grad = K1.ctc_fused_reference(lp, t_len, labels, lab_len)
        torch.cuda.synchronize()
        loss_rel = float(((loss - ref_loss).abs() / ref_loss.abs().clamp(min=1.0)).max())
        err = float((grad - ref_grad).abs().max())
        if not (loss_rel <= 1e-5 and err <= grad_atol and torch.isfinite(loss).all()):
            raise AssertionError(f"ctc_fused V={V} U={U}: loss rel err {loss_rel} (<= 1e-5), grad max|err| {err} (<= {grad_atol})")
        extra = {}
        if long:
            w_loss, w_grad = K1.ctc_fused_reference(lp, t_len, labels, lab_len, dtype=torch.float64)
            valid = torch.arange(T, device=dev)[None, :] < t_len[:, None]
            for name, (l, gr) in (("kernel", (loss, grad)), ("plain", (ref_loss, ref_grad))):
                gr = gr.double()
                extra[f"{name}_vs_f64"] = dict(
                    loss_rel=float(((l.double() - w_loss).abs() / w_loss.abs()).max()),
                    loss_abs=float((l.double() - w_loss).abs().max()),
                    grad_max_abs=float((gr - w_grad).abs().max()),
                    grad_norm_rel=float((gr.norm() / w_grad.norm() - 1).abs()),
                    frame_sum_max_dev=float((gr.sum(-1) + 1)[valid].abs().max()))
            del w_grad
            log(f"ctc_fused V={V} U={U} S={S} against the f64 witness: {json.dumps(extra)}")
            for name, e in extra.items():
                if not (e["loss_rel"] <= 3e-5 and e["grad_max_abs"] <= grad_atol and e["grad_norm_rel"] <= 1e-3
                        and e["frame_sum_max_dev"] <= 1e-5):
                    raise AssertionError(f"ctc_fused V={V} U={U}: {name} against the f64 witness {e}")
        else:
            if not (loss[1] == 0 and loss[2] == 0 and not grad[1].any() and not grad[2].any()):
                raise AssertionError(f"ctc_fused V={V} U={U}: dummy or infeasible row not zeroed")
        worst = max(worst, err)
        if U == 512:
            log(f"ctc_fused V={V} U={U} S={S} plan {plan}: loss rel err {loss_rel}, grad max|err| {err}")
            continue
        loss2, grad2 = K1.ctc_fused(lp, t_len, labels, lab_len)
        if not (torch.equal(loss, loss2) and torch.equal(grad, grad2)):
            raise AssertionError(f"ctc_fused V={V} U={U}: a repeat is not bit-identical "
                                 f"(grad max|diff| {float((grad - grad2).abs().max())})")
        del grad, ref_grad, grad2
        sets = [(lp.clone(), t_len, labels, lab_len) for _ in range(n_copies(B * T * V * 4))]
        lib_in = lp.detach().transpose(0, 1).contiguous()
        lib_len = t_len.clamp(min=1)

        def library(x, tl=lib_len, lab=labels, ll=lab_len):
            x = x.detach().requires_grad_(True)
            F.ctc_loss(x, lab, tl, ll, blank=0, reduction="sum", zero_infinity=True).backward()
            return x.grad

        live = int(sum(max(0, min(int(t), T)) * (2 * min(int(l), S // 2) + 1) for t, l in zip(t_len.tolist(), lab_len.tolist())))
        row = dict(
            B=B, T=T, V=V, S=S, max_abs_err=err, loss_rel_err=loss_rel,
            ms=time_ms(torch, K1.ctc_fused, sets, min_iters=3 if long else 20),
            plain_ms=time_ms(torch, K1.ctc_fused_reference, sets[:1] if long else sets[:2], min_iters=1 if long else 3),
            library_ms=time_ms(torch, library, [(lib_in.clone(),) for _ in range(2)], min_iters=3 if long else 5),
            chain_steps=T, live_states=live, plan=plan, repeat_bit_identical=True, **extra,
        )
        row["us_per_step"] = row["ms"] * 1e3 / T
        # lp read once, labels and lengths read once, loss and grad written
        # once; about 32 f32 operations per live (t, s) state, forward and
        # backward together, over the f32 peak outside the tensor cores
        row["bound_ms"], row["bound_by"] = bound(2 * B * T * V * 4 + B * labels.shape[1] * 4 + 3 * B * 4, 32 * live, F32_FLOPS)
        rows.append(row)
        log(f"ctc_fused {row}")
        del sets
        gc.collect()
        torch.cuda.empty_cache()
    return rows, worst


def ctc_conformer_case(torch, dev, seed, B=16, T=376, U=256, blank=128):
    """Phase 3's Conformer fine-tuning batch: log_probs (B, T, V=129) with
    NeMo's blank last (128), 15 s rows (1,501 mel frames, 376 encoder frames)
    of 300-376 frames with 150-210 labels (~14 chars/s, one a character) in a
    label width of 256 (S = 513), labels in [0, 128); a batch-pad dummy (1
    frame, label length 0), an infeasible row (200 labels in 100 frames) and
    a row of repeated labels."""
    V = blank + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = torch.log_softmax(2 * torch.randn(B, T, V, generator=g, device=dev), dim=-1)
    labels = torch.randint(0, blank, (B, U), generator=g, device=dev, dtype=torch.int32)
    lab_len = torch.randint(150, 211, (B,), generator=g, device=dev, dtype=torch.int32)
    t_len = torch.randint(300, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    t_len[0], lab_len[0] = T, 210
    t_len[1], lab_len[1] = 1, 0
    t_len[2], lab_len[2] = 100, 200
    labels[3, :] = labels[3, 0]
    return lp, t_len, labels, lab_len


def check_ctc_fused_conformer(torch, dev):
    """K1 at the Conformer-CTC Large fine-tuning shape (ctc_conformer_case:
    B=16, T=376, V=129, blank 128): V % 4 != 0 sends the sweeps down the
    branch that reads emissions from device memory instead of the bulk-copy
    ring (csrc/ctc_fused.cu), with a blank other than 0. Against the plain
    version at K1's limits (loss 1e-5 relative, grad 2e-3 absolute), the
    dummy and infeasible rows zeroed, bit-identical on repeat; timed beside
    F.ctc_loss(blank=128) and the bound. Returns the row."""
    import torch.nn.functional as F

    from ssak_tpu_torch.ops import ctc_fused as K1

    blank = 128
    lp, t_len, labels, lab_len = ctc_conformer_case(torch, dev, seed=129, blank=blank)
    B, T, V = lp.shape
    S = 2 * labels.shape[1] + 1
    ringed = V % 4 == 0 and lp.data_ptr() % 16 == 0  # the kernel's own test (csrc/ctc_fused.cu)
    cluster, threads, kpt, _ = K1.ctc_plan(B, T, S, V)
    plan = dict(cluster=cluster, threads=threads, kpt=kpt)
    loss, grad = K1.ctc_fused(lp, t_len, labels, lab_len, blank_id=blank)
    ref_loss, ref_grad = K1.ctc_fused_reference(lp, t_len, labels, lab_len, blank_id=blank)
    torch.cuda.synchronize()
    loss_rel = float(((loss - ref_loss).abs() / ref_loss.abs().clamp(min=1.0)).max())
    err = float((grad - ref_grad).abs().max())
    tag = f"ctc_fused V={V} blank={blank} (the Conformer's shape, {'ringed' if ringed else 'un-ringed'} branch)"
    if ringed or not (loss_rel <= 1e-5 and err <= 2e-3 and torch.isfinite(loss).all()):
        raise AssertionError(f"{tag}: loss rel err {loss_rel} (<= 1e-5), grad max|err| {err} (<= 2e-3), ringed {ringed}")
    if not (loss[1] == 0 and loss[2] == 0 and not grad[1].any() and not grad[2].any() and (loss[4:] > 0).all()):
        raise AssertionError(f"{tag}: dummy or infeasible row not zeroed, or a feasible row without loss")
    loss2, grad2 = K1.ctc_fused(lp, t_len, labels, lab_len, blank_id=blank)
    if not (torch.equal(loss, loss2) and torch.equal(grad, grad2)):
        raise AssertionError(f"{tag}: a repeat is not bit-identical")
    del grad, ref_grad, grad2
    sets = [(lp.clone(), t_len, labels, lab_len) for _ in range(n_copies(B * T * V * 4))]
    lib_in = lp.detach().transpose(0, 1).contiguous()

    def kernel(x, tl, lab, ll):
        return K1.ctc_fused(x, tl, lab, ll, blank_id=blank)

    def plain(x, tl, lab, ll):
        return K1.ctc_fused_reference(x, tl, lab, ll, blank_id=blank)

    def library(x, tl=t_len, lab=labels, ll=lab_len):
        x = x.detach().requires_grad_(True)
        F.ctc_loss(x, lab, tl, ll, blank=blank, reduction="sum", zero_infinity=True).backward()
        return x.grad

    live = int(sum(max(0, min(int(t), T)) * (2 * min(int(l), S // 2) + 1) for t, l in zip(t_len.tolist(), lab_len.tolist())))
    row = dict(B=B, T=T, V=V, S=S, blank=blank, ringed=ringed, max_abs_err=err, loss_rel_err=loss_rel,
               ms=time_ms(torch, kernel, sets), plain_ms=time_ms(torch, plain, sets[:2], min_iters=3),
               library_ms=time_ms(torch, library, [(lib_in.clone(),) for _ in range(2)], min_iters=5),
               chain_steps=T, live_states=live, plan=plan, repeat_bit_identical=True)
    row["us_per_step"] = row["ms"] * 1e3 / T
    # as check_ctc_fused: lp read once, labels and lengths read once, loss and
    # grad written once; about 32 f32 operations per live (t, s) state
    row["bound_ms"], row["bound_by"] = bound(2 * B * T * V * 4 + B * labels.shape[1] * 4 + 3 * B * 4, 32 * live, F32_FLOPS)
    log(f"{tag}: {row}")
    del sets
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _qkv(torch, g, dev, B, T, H=16, Dh=64):
    return [torch.randn(B, T, H, Dh, generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]


def check_flash_attention(torch, dev):
    """L1 against its plain version on the card, all T rows (pad rows
    included): the 140 s bucket (T = 7,001) with one full row and with rows
    of 7,001 and 3,000 frames; T = 4,096 without lengths (the no-mask path);
    a row of length 0 beside a full one at an odd T; 8 heads at the 140 s
    bucket (a tensor-parallel rank's); Dh = 128 and 256; and
    q/k/v read through the strides of one fused (B, T, 3D) projection. The
    plain version computes the same masked softmax with p rounded to bf16
    against the global row max, the kernel against a running max: held to
    2e-2 of max|out|; a second launch must give the same bits (no atomics).
    The plan (flash_fwd_plan) is logged at every shape, and the tile counts
    (flash_fwd_tile_counts) on the ragged rows. Timed at B = 6 and 1 (T =
    7,001), at B = 1, T = 7,001 with 8 heads (a tensor-parallel rank's
    share of xlsr's 16), and at B = 4, T = 6,999 with m and l written (the
    training launch, `_flash_forward(..., stats=True)`), against the plain version
    (B = 1 only: at B = 6 its logits need about 56 GB) and SDPA in bf16 with
    a (B, 1, 1, T) key-padding mask, beside the operations bound (the
    exponentials reckoned on the SFUs go to the log only; the training row
    to the summary, not the kernels line); and at the 30 s bucket (B = 32, T =
    1,499) against the plain version and the unfused attention the encoder
    runs there (layers.attention), for the FLASH_MIN_SEQ question only."""
    import torch.nn.functional as F

    from ssak_tpu_torch.models import layers as L
    from ssak_tpu_torch.ops import flash_attention as L1

    g = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    cases = [
        dict(B=1, T=7001, lengths=[7001]),
        dict(B=1, T=7001, lengths=[7001], H=8),  # a tensor-parallel rank's heads: xlsr's 16 over 2 ranks
        dict(B=2, T=7001, lengths=[7001, 3000]),
        dict(B=1, T=4096, lengths=None),
        dict(B=2, T=4500, lengths=[0, 4500]),
        dict(B=1, T=4100, lengths=[2000], H=4, Dh=128),
        dict(B=1, T=4100, lengths=[4100], H=2, Dh=256),
        dict(B=1, T=4096, lengths=[3333], fused=True),
    ]
    for c in cases:
        H, Dh = c.get("H", 16), c.get("Dh", 64)
        if c.get("fused"):
            qkv = torch.randn(c["B"], c["T"], 3 * H * Dh, generator=g, device=dev).to(torch.bfloat16)
            q, k, v = (qkv[..., i * H * Dh:(i + 1) * H * Dh].reshape(c["B"], c["T"], H, Dh) for i in range(3))
        else:
            q, k, v = _qkv(torch, g, dev, c["B"], c["T"], H, Dh)
        lens = None if c["lengths"] is None else torch.tensor(c["lengths"], dtype=torch.int32, device=dev)
        out = L1.flash_self_attention(q, k, v, lens)
        again = L1.flash_self_attention(q, k, v, lens)
        ref = L1.flash_self_attention_reference(q, k, v, lens)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = 2e-2 * float(ref.float().abs().max())
        if not (torch.isfinite(out).all() and out.shape == q.shape and err <= tol):
            raise AssertionError(f"flash_attention {c}: max|err| {err} > {tol} (finite {bool(torch.isfinite(out).all())})")
        if not torch.equal(out, again):
            raise AssertionError(f"flash_attention {c}: two launches differ")
        worst = max(worst, err)
        plan = L1.flash_fwd_plan(c["B"], c["T"], H, Dh)
        ragged = c["lengths"] is not None and 0 < min(c["lengths"]) < c["T"]
        tiles = f", tiles {L1.flash_fwd_tile_counts(plan, c['T'], H, c['lengths'])}" if ragged else ""
        log(f"flash_attention {c}: max|err| {err:.3g} (limit {tol:.3g}), repeat bit-identical, plan {plan}{tiles}")
        del q, k, v, out, again, ref
    rows = []
    for B, T, stats, H in ((6, 7001, False, 16), (1, 7001, False, 16), (4, 6999, True, 16), (1, 7001, False, 8)):
        Dh = 64
        q, k, v = _qkv(torch, g, dev, B, T, H)
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        mask = torch.ones(B, 1, 1, T, dtype=torch.bool, device=dev)
        sets = [(q, k, v, lens)]
        with torch.no_grad():
            ms = time_ms(torch, lambda *a: L1._flash_forward(*a, None, stats=stats), sets, min_iters=10)
        row = dict(B=B, T=T, H=H, Dh=Dh, ms=ms,
                   library_ms=time_ms(torch, lambda a, b, c, m: F.scaled_dot_product_attention(
                       a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2), attn_mask=m), [(q, k, v, mask)],
                       min_iters=10),
                   plain_ms=time_ms(torch, L1.flash_self_attention_reference, sets, min_iters=3) if B == 1 else None)
        # q, k, v read once and out (and m, l) written once; 4*B*H*T^2*Dh operations
        n_bytes = 4 * B * T * H * Dh * 2 + (2 * B * H * T * 4 if stats else 0)
        row["bound_ms"], row["bound_by"] = bound(n_bytes, 4 * B * H * T * T * Dh)
        row["tflops"] = 4 * B * H * T * T * Dh / (row["ms"] * 1e-3) / 1e12
        # B*H*T*Tp exponentials, reckoned (not measured) at 16 SFU results a clock per SM, 132 SMs, 1.98 GHz:
        # logged only
        ex2_ms = B * H * T * L1.padded_len(T) / (132 * 16 * 1.98e9) * 1e3
        log(f"flash_attention {row}, m and l written: {stats}, plan {L1.flash_fwd_plan(B, T, H, Dh)}, "
            f"exponentials reckoned at {ex2_ms:.4g} ms")
        if stats:
            training = row  # the training launch: in the summary, not in the kernels line
        else:
            rows.append(row)
        del q, k, v, sets
    B, T = 32, 1499
    q, k, v = _qkv(torch, g, dev, B, T)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    short = dict(B=B, T=T, plan=L1.flash_fwd_plan(B, T, 16, 64),
                 ms=time_ms(torch, L1.flash_self_attention, [(q, k, v, lens)], min_iters=10),
                 plain_ms=time_ms(torch, L1.flash_self_attention_reference, [(q, k, v, lens)], min_iters=3),
                 unfused_ms=time_ms(torch, lambda a, b, c, m: L.attention(a, b, c, mask=m), [(q, k, v, mask)],
                                    min_iters=3))
    log(f"flash_attention at the 30 s bucket (FLASH_MIN_SEQ question, routing unchanged): {short}")
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return rows, worst, short, training


def _grads(torch, L1, q, k, v, lens, do):
    """dq, dk, dv of autograd through FlashSelfAttention (the forward with m
    and l, then both backward kernels)."""
    return torch.autograd.grad(L1.flash_self_attention(q, k, v, lens), (q, k, v), do)


def check_flash_attention_bwd(torch, dev):
    """L1's backward kernels (dK/dV and dQ) against their plain version on
    the card: dq, dk, dv from autograd through FlashSelfAttention against
    flash_self_attention_backward_reference given the same forward's o, m
    and l, over all T rows with a random dO on every row (pad rows of
    [len, T) included), in the forward's seven cases with T = 6,999 for
    7,001; and the forward's m and l against the plain forward's. The
    kernels and the plain version compute the library's arithmetic; they
    differ in the order of the f32 sums and in __expf, so p and ds may round
    to the other bf16 neighbour: each gradient held to 2e-2 of its max|ref|,
    the forward's limit. Two launches must give bit-identical gradients (no
    atomics). Timed at B = 4 and 1 (T = 6,999, H = 16, Dh = 64): each kernel
    and the pair, against the plain version (B = 1 only: its (B, H, T, T) f32
    tensors take 3.1 GB each per row) and the backward alone of SDPA with a
    (B, 1, 1, T) key-padding mask on a kept graph; and the forward with m
    and l written against the forward without, at B = 4. Then the pair and
    SDPA's backward with the same key-padding mask at B = 4 with ragged
    rows like phase 3's 90-140 s files (6,999 / 5,800 / 5,000 / 4,500
    frames: the kernels skip the tiles wholly across a row's length, whose
    count is logged, and the bound counts only the same-segment pairs), and
    at the 30 s bucket (B = 32, T = 1,499), for the FLASH_MIN_SEQ question."""
    import torch.nn.functional as F

    from ssak_tpu_torch.ops import flash_attention as L1

    g = torch.Generator(device=dev).manual_seed(8)
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    cases = [
        dict(B=1, T=6999, lengths=[6999]),
        dict(B=2, T=6999, lengths=[6999, 3000]),
        dict(B=1, T=4096, lengths=None),
        dict(B=2, T=4500, lengths=[0, 4500]),
        dict(B=1, T=4100, lengths=[2000], H=4, Dh=128),
        dict(B=1, T=4100, lengths=[4100], H=2, Dh=256),
        dict(B=1, T=4096, lengths=[3333], fused=True),
    ]
    for c in cases:
        B, T, H, Dh = c["B"], c["T"], c.get("H", 16), c.get("Dh", 64)
        if c.get("fused"):
            qkv = torch.randn(B, T, 3 * H * Dh, generator=g, device=dev).to(torch.bfloat16).requires_grad_(True)
            q, k, v = (qkv[..., i * H * Dh:(i + 1) * H * Dh].reshape(B, T, H, Dh) for i in range(3))
        else:
            q, k, v = (t.requires_grad_(True) for t in _qkv(torch, g, dev, B, T, H, Dh))
        do = torch.randn(B, T, H, Dh, generator=g, device=dev).to(torch.bfloat16)
        lens = None if c["lengths"] is None else torch.tensor(c["lengths"], dtype=torch.int32, device=dev)
        got = _grads(torch, L1, q, k, v, lens, do)
        again = _grads(torch, L1, q, k, v, lens, do)
        with torch.no_grad():
            o, m, l = L1._flash_forward(q, k, v, lens, None, stats=True)
            _, pm, pl = L1.flash_self_attention_reference(q, k, v, lens, return_stats=True)
            ref = L1.flash_self_attention_backward_reference(q, k, v, o, m, l, do, lens)
        torch.cuda.synchronize()
        m_err = float((m - pm).abs().max())
        l_rel = float(((l - pl).abs() / pl).max())
        if not (m_err <= 1e-4 * max(1.0, float(pm.abs().max())) and l_rel <= 1e-4):
            raise AssertionError(f"flash_attention m, l {c}: max|m err| {m_err}, max l rel err {l_rel}")
        errs = {}
        for name, a, b, r in zip(("dq", "dk", "dv"), got, again, ref):
            err = float((a.float() - r.float()).abs().max())
            tol = 2e-2 * float(r.float().abs().max())
            if not (torch.isfinite(a).all() and a.shape == q.shape and a.dtype == torch.bfloat16 and err <= tol):
                raise AssertionError(f"flash_attention_bwd {name} {c}: max|err| {err} > {tol} "
                                     f"(finite {bool(torch.isfinite(a).all())}, {a.dtype} {tuple(a.shape)})")
            if not torch.equal(a, b):
                raise AssertionError(f"flash_attention_bwd {name} {c}: two launches differ")
            errs[name] = (err, tol)
            worst[name] = max(worst[name], err)
        log(f"flash_attention_bwd {c}: " + ", ".join(f"{n} max|err| {e:.3g} (limit {t:.3g})" for n, (e, t) in errs.items())
            + f"; m {m_err:.3g}, l rel {l_rel:.3g}; repeat bit-identical")
        del q, k, v, do, got, again, o, m, l, pm, pl, ref
        gc.collect()
        torch.cuda.empty_cache()
    rows = {"dkv": [], "dq": []}
    pairs = []
    for B in (4, 1):
        T, H, Dh = 6999, 16, 64
        q, k, v, do = _qkv(torch, g, dev, B, T, H, Dh) + [torch.randn(B, T, H, Dh, generator=g, device=dev).to(torch.bfloat16)]
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        with torch.no_grad():
            o, m, l = L1._flash_forward(q, k, v, lens, None, stats=True)
            di = L1.attention_di(o, do)
        args = [(q, k, v, do, m, l, di, lens)]
        ms_dkv = time_ms(torch, L1.flash_attention_bwd_dkv, args, min_iters=10)
        ms_dq = time_ms(torch, L1.flash_attention_bwd_dq, args, min_iters=10)
        ms_pair = time_ms(torch, lambda *a: (L1.flash_attention_bwd_dkv(*a), L1.flash_attention_bwd_dq(*a)), args,
                          min_iters=10)
        plain = {}
        if B == 1:
            for name, want in (("dkv", ("dk", "dv")), ("dq", ("dq",))):
                plain[name] = time_ms(torch, lambda *a, w=want: L1._backward_plain(*a, Dh**-0.5, w), args, min_iters=3)
        # library yardstick: the backward alone of SDPA, (B, H, T, Dh) views, key-padding mask, kept graph
        mask = torch.ones(B, 1, 1, T, dtype=torch.bool, device=dev)
        lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
        ldo = do.transpose(1, 2)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True), [()], min_iters=10)
        del lo
        fwd_stats = fwd_plain = None
        if B == 4:
            with torch.no_grad():
                fwd_stats = time_ms(torch, lambda *a: L1._flash_forward(*a, None, stats=True), [(q, k, v, lens)],
                                    min_iters=10)
                fwd_plain = time_ms(torch, lambda *a: L1._flash_forward(*a, None), [(q, k, v, lens)], min_iters=10)
        # q, k, v, dO read once, m, l, di read once, the gradients written once
        io = 4 * B * T * H * Dh * 2 + 3 * B * H * T * 4
        for name, ms, flops, n_out in (("dkv", ms_dkv, 8, 2), ("dq", ms_dq, 6, 1)):
            err = worst["dq"] if name == "dq" else max(worst["dk"], worst["dv"])
            row = dict(B=B, T=T, H=H, Dh=Dh, ms=ms, plain_ms=plain.get(name), library_ms=lib_ms, max_abs_err=err,
                       library="SDPA backward (dq, dk, dv together), key-padding mask")
            row["bound_ms"], row["bound_by"] = bound(io + n_out * B * T * H * Dh * 2, flops * B * H * T * T * Dh)
            row["tflops"] = flops * B * H * T * T * Dh / (ms * 1e-3) / 1e12
            rows[name].append(row)
        # B*H*T^2 exponentials per kernel, reckoned (not measured) at 16 SFU
        # results a clock per SM, 132 SMs, 1.98 GHz: below the operations bound
        pair = dict(B=B, T=T, pair_ms=ms_pair, library_ms=lib_ms, fwd_with_stats_ms=fwd_stats, fwd_ms=fwd_plain,
                    pair_bound_ms=bound(io + 3 * B * T * H * Dh * 2, 14 * B * H * T * T * Dh)[0],
                    ex2_reckoned_ms_per_kernel=B * H * T * T / (132 * 16 * 1.98e9) * 1e3)
        pairs.append(pair)
        log(f"flash_attention_bwd dkv {rows['dkv'][-1]}")
        log(f"flash_attention_bwd dq {rows['dq'][-1]}")
        log(f"flash_attention_bwd pair {pair}")
        del q, k, v, do, o, m, l, di, args, lq, lk, lv
        gc.collect()
        torch.cuda.empty_cache()
    for case, B, T, lengths in (("ragged", 4, 6999, [6999, 5800, 5000, 4500]), ("30s_bucket", 32, 1499, [1499] * 32)):
        H, Dh = 16, 64
        q, k, v, do = _qkv(torch, g, dev, B, T, H, Dh) + [torch.randn(B, T, H, Dh, generator=g, device=dev).to(torch.bfloat16)]
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        with torch.no_grad():
            o, m, l = L1._flash_forward(q, k, v, lens, None, stats=True)
            di = L1.attention_di(o, do)
        args = [(q, k, v, do, m, l, di, lens)]
        ms = {name: time_ms(torch, fn, args, min_iters=10)
              for name, fn in (("dkv", L1.flash_attention_bwd_dkv), ("dq", L1.flash_attention_bwd_dq))}
        ms_pair = time_ms(torch, lambda *a: (L1.flash_attention_bwd_dkv(*a), L1.flash_attention_bwd_dq(*a)), args,
                          min_iters=10)
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
        ldo = do.transpose(1, 2)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True), [()], min_iters=10)
        counts = L1.flash_bwd_tile_counts(L1.flash_bwd_plan(B, T, H, Dh), T, H, lengths)
        # the pairs this data needs: (query, key) in one segment below T
        pairs_needed = H * sum(n * n + (T - n) * (T - n) for n in lengths)
        io = 4 * B * T * H * Dh * 2 + 3 * B * H * T * 4
        extra = dict(case=case, B=B, T=T, lengths=lengths, dkv_ms=ms["dkv"], dq_ms=ms["dq"], pair_ms=ms_pair,
                     library_ms=lib_ms, library="SDPA backward (dq, dk, dv together), key-padding mask",
                     pair_bound_ms=bound(io + 3 * B * T * H * Dh * 2, 14 * pairs_needed * Dh)[0],
                     tiles=counts, skipped_share=counts["dkv"]["skip"] / sum(counts["dkv"][c] for c in
                                                                           ("skip", "within", "masked")))
        pairs.append(extra)
        log(f"flash_attention_bwd {case} {extra}")
        del q, k, v, do, o, m, l, di, args, lq, lk, lv, lo
        gc.collect()
        torch.cuda.empty_cache()
    return rows, worst, pairs


# --- phase 3: the slices at full width ------------------------------------------


def tones(rng, seconds):
    """Three tones and noise at 16 kHz, float32."""
    import numpy as np

    t = np.arange(int(seconds * 16000)) / 16000.0
    audio = sum(0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t) for _ in range(3))
    return (audio + 0.02 * rng.randn(t.size)).astype(np.float32)


def write_corpus(root, n_files=N_FILES, seconds=FILE_SECONDS, seed=0):
    """n_files synthetic 16 kHz wav files of `seconds` and a Kaldi dir."""
    import numpy as np

    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    ids = []
    with open(os.path.join(root, "wav.scp"), "w", encoding="utf-8") as f:
        for i in range(n_files):
            path = os.path.join(root, f"utt{i:03d}.wav")
            save_audio(path, tones(rng, seconds), 16000)
            utt = f"utt{i:03d}"
            f.write(f"{utt} {path}\n")
            ids.append(utt)
    return ids


# Model directories in HF layout, written here: the card host has no safetensors, tokenizers or
# transformers. Whisper large-v3's special tokens, in id order from <|endoftext|> = 50,257.
WHISPER_LANGUAGES = ("en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu ta no th ur "
                     "hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn bs kk sq sw gl mr pa si km "
                     "sn yo so af oc ka be tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha ba jw "
                     "su yue").split()
WHISPER_SPECIALS = (["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{lang}|>" for lang in WHISPER_LANGUAGES]
                    + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>", "<|nospeech|>",
                       "<|notimestamps|>"] + [f"<|{i * 0.02:.2f}|>" for i in range(1501)])
SAFETENSORS_CODES = {"float16": "F16", "float32": "F32"}


def write_safetensors(path, tensors):
    """name -> numpy array, in the safetensors format: 8-byte little-endian
    header length, the JSON header (dtype, shape, data_offsets), the raw
    little-endian bytes in the header's order."""
    import numpy as np

    header, offset = {}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": SAFETENSORS_CODES[a.dtype.name], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for a in tensors.values():
            np.ascontiguousarray(a, a.dtype.newbyteorder("<")).tofile(f)


def hf_whisper_tensors(tree, dtype):
    """An ssak_tpu Whisper tree as HF WhisperForConditionalGeneration's
    tensors (the ones a loader reads), torch layouts, cast to `dtype`."""
    import numpy as np

    out = {}

    def put(name, a, t=None):
        a = np.asarray(a)
        out["model." + name] = np.ascontiguousarray(a.transpose(t) if t else a).astype(dtype)

    def attn(pfx, p):
        for ours, hf in (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj"), ("out", "out_proj")):
            put(f"{pfx}.{hf}.weight", p[ours]["kernel"], (1, 0))
            if "bias" in p[ours]:
                put(f"{pfx}.{hf}.bias", p[ours]["bias"])

    def ln(name, p):
        put(f"{name}.weight", p["scale"])
        put(f"{name}.bias", p["bias"])

    def block(pfx, b):
        ln(f"{pfx}.self_attn_layer_norm", b["attn_ln"])
        attn(f"{pfx}.self_attn", b["attn"])
        if "cross_attn" in b:
            ln(f"{pfx}.encoder_attn_layer_norm", b["cross_attn_ln"])
            attn(f"{pfx}.encoder_attn", b["cross_attn"])
        ln(f"{pfx}.final_layer_norm", b["mlp_ln"])
        for fc in ("fc1", "fc2"):
            put(f"{pfx}.{fc}.weight", b["mlp"][fc]["kernel"], (1, 0))
            put(f"{pfx}.{fc}.bias", b["mlp"][fc]["bias"])

    enc, dec = tree["encoder"], tree["decoder"]
    for conv in ("conv1", "conv2"):
        put(f"encoder.{conv}.weight", enc[conv]["kernel"], (2, 1, 0))
        put(f"encoder.{conv}.bias", enc[conv]["bias"])
    for i, b in enumerate(enc["blocks"]):
        block(f"encoder.layers.{i}", b)
    ln("encoder.layer_norm", enc["ln_post"])
    put("decoder.embed_tokens.weight", dec["token_embedding"])
    put("decoder.embed_positions.weight", dec["positional_embedding"])
    for i, b in enumerate(dec["blocks"]):
        block(f"decoder.layers.{i}", b)
    ln("decoder.layer_norm", dec["ln"])
    return out


def write_byte_level_vocab(root, n_base=50257):
    """A byte-level BPE vocabulary of n_base tokens as vocab.json +
    merges.txt: the 256 characters of GPT-2's byte table, then merges that
    spell lower-case words (' a'..' z', 'aa'..'zz', ' aa'..' zz', 'aaa'..,
    ' aaa'.., 'aaaa'.. until n_base), with large-v3's specials and
    timestamps from n_base on in added_tokens.json: every id below 51,866
    is in the vocabulary. Returns the number of ids."""
    from ssak_tpu_torch.models.tokenizer import bytes_to_unicode

    table = bytes_to_unicode()
    vocab = {c: i for i, c in enumerate(table.values())}
    sp = table[32]  # the table's character for the space byte
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    merges = []

    def add(a, b):
        if len(vocab) < n_base:
            merges.append((a, b))
            vocab[a + b] = len(vocab)

    for c in letters:
        add(sp, c)
    level = letters
    while len(vocab) < n_base:
        for w in level:
            for c in letters:
                add(w, c)
        for w in level:
            for c in letters:
                add(sp + w, c)
        level = [w + c for w in level for c in letters]
    with open(os.path.join(root, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(root, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    with open(os.path.join(root, "added_tokens.json"), "w", encoding="utf-8") as f:
        json.dump({t: n_base + i for i, t in enumerate(WHISPER_SPECIALS)}, f, ensure_ascii=False)
    return n_base + len(WHISPER_SPECIALS)


def write_whisper_dir(root, tree, cfg):
    """An HF Whisper directory from an ssak_tpu tree: config.json,
    model.safetensors in F16 (the tree rounded to f16) and the byte-level
    tokenizer files. Returns the seconds it took."""
    import numpy as np

    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    d = cfg.n_audio_state
    conf = {"architectures": ["WhisperForConditionalGeneration"], "model_type": "whisper", "num_mel_bins": cfg.n_mels,
            "max_source_positions": cfg.n_audio_ctx, "max_target_positions": cfg.n_text_ctx, "d_model": d,
            "encoder_attention_heads": cfg.n_audio_head, "decoder_attention_heads": cfg.n_text_head,
            "encoder_layers": cfg.n_audio_layer, "decoder_layers": cfg.n_text_layer, "encoder_ffn_dim": 4 * d,
            "decoder_ffn_dim": 4 * d, "vocab_size": cfg.n_vocab, "decoder_start_token_id": cfg.sot,
            "eos_token_id": cfg.eot, "torch_dtype": "float16"}
    with open(os.path.join(root, "config.json"), "w", encoding="utf-8") as f:
        json.dump(conf, f, indent=1)
    write_safetensors(os.path.join(root, "model.safetensors"), hf_whisper_tensors(tree, np.float16))
    n = write_byte_level_vocab(root)
    if n != cfg.n_vocab:
        raise AssertionError(f"tokenizer covers {n} ids, the model {cfg.n_vocab}")
    return time.perf_counter() - t0


def write_wav2vec2_dir(root, module, cfg, tokenizer):
    """An HF wav2vec2-CTC directory from the port's module: config.json,
    pytorch_model.bin (torch.save of the HF state dict; the positional
    conv as weight_g / weight_v with g = ||v|| over (out, in)) and
    vocab.json. Returns the seconds it took."""
    import numpy as np
    import torch

    from ssak_tpu_torch.models.convert import wav2vec2_to_tree

    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    tree, sd = wav2vec2_to_tree(module), {}

    def put(name, a, t=None):
        a = np.asarray(a, np.float32)
        sd[name] = torch.from_numpy(np.ascontiguousarray(a.transpose(t) if t else a))

    def dense(name, p):
        put(f"{name}.weight", p["kernel"], (1, 0))
        if "bias" in p:
            put(f"{name}.bias", p["bias"])

    def ln(name, p):
        put(f"{name}.weight", p["scale"])
        put(f"{name}.bias", p["bias"])

    w = "wav2vec2."
    for i, c in enumerate(tree["feature_extractor"]["convs"]):
        pfx = f"{w}feature_extractor.conv_layers.{i}"
        put(f"{pfx}.conv.weight", c["conv"]["kernel"], (2, 1, 0))
        if "bias" in c["conv"]:
            put(f"{pfx}.conv.bias", c["conv"]["bias"])
        for norm in ("layer_norm", "group_norm"):
            if norm in c:
                ln(f"{pfx}.layer_norm", c[norm])
    ln(f"{w}feature_projection.layer_norm", tree["feature_projection"]["layer_norm"])
    dense(f"{w}feature_projection.projection", tree["feature_projection"]["projection"])
    enc = tree["encoder"]
    v = np.ascontiguousarray(np.asarray(enc["pos_conv"]["kernel"]).transpose(2, 1, 0))
    sd[f"{w}encoder.pos_conv_embed.conv.weight_v"] = torch.from_numpy(v)
    sd[f"{w}encoder.pos_conv_embed.conv.weight_g"] = torch.from_numpy(np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True)))
    put(f"{w}encoder.pos_conv_embed.conv.bias", enc["pos_conv"]["bias"])
    ln(f"{w}encoder.layer_norm", enc["layer_norm"])
    for i, b in enumerate(enc["blocks"]):
        pfx = f"{w}encoder.layers.{i}"
        for ours, hf in (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj"), ("out", "out_proj")):
            dense(f"{pfx}.attention.{hf}", b["attn"][ours])
        ln(f"{pfx}.layer_norm", b["attn_ln"])
        dense(f"{pfx}.feed_forward.intermediate_dense", b["mlp"]["fc1"])
        dense(f"{pfx}.feed_forward.output_dense", b["mlp"]["fc2"])
        ln(f"{pfx}.final_layer_norm", b["mlp_ln"])
    dense("lm_head", tree["lm_head"])
    torch.save(sd, os.path.join(root, "pytorch_model.bin"))
    conf = {"architectures": ["Wav2Vec2ForCTC"], "model_type": "wav2vec2", "conv_dim": list(cfg.conv_dim),
            "conv_kernel": list(cfg.conv_kernel), "conv_stride": list(cfg.conv_stride), "conv_bias": cfg.conv_bias,
            "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.intermediate_size, "num_conv_pos_embeddings": cfg.num_conv_pos_embeddings,
            "num_conv_pos_embedding_groups": cfg.num_conv_pos_embedding_groups,
            "do_stable_layer_norm": cfg.do_stable_layer_norm, "vocab_size": cfg.vocab_size, "pad_token_id": cfg.blank_id,
            "adapter_attn_dim": cfg.adapter_attn_dim or None}
    with open(os.path.join(root, "config.json"), "w", encoding="utf-8") as f:
        json.dump(conf, f, indent=1)
    tokenizer.save(os.path.join(root, "vocab.json"))
    return time.perf_counter() - t0


def prepare_whisper_dir(torch, dev, root, keep=None):
    """Writes the seeded large-v3 (seeded_tree, seed 0) as an HF Whisper
    directory and loads it back with load_model: the module must equal
    whisper_from_tree of the f16-rounded tree, bit for bit, and the
    tokenizer's specials be large-v3's. Returns the timings. With a dict
    `keep`, keep["teacher_forced"] holds the loaded model's teacher-forced
    logits in bf16 on wtp_mel (whisper_tp's whole-model reference)."""
    import numpy as np

    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.models.convert import whisper_from_tree
    from ssak_tpu_torch.models.whisper import make_config

    cfg = make_config("large-v3")
    t0 = time.perf_counter()
    tree = seeded_tree(cfg)
    seed_s = time.perf_counter() - t0
    write_s = write_whisper_dir(root, tree, cfg)
    tree16 = tree_map(lambda a: a.astype(np.float16), tree)
    del tree
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = load_model(root, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ref = whisper_from_tree(tree16, dev).state_dict()
    got = m.module.state_dict()
    if sorted(got) != sorted(ref) or not all(got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]) for k in ref):
        raise AssertionError("the Whisper directory did not load as whisper_from_tree of its f16 tree")
    tok = m.tokenizer
    specials = (tok.sot, tok.eot, tok.no_timestamps, tok.timestamp_begin, tok.sot_prev, tok.no_speech)
    cfg_ids = (m.cfg.sot, m.cfg.eot, m.cfg.no_timestamps, m.cfg.timestamp_begin, m.cfg.sot_prev, m.cfg.no_speech)
    if not specials == cfg_ids == (50258, 50257, 50364, 50365, 50362, 50363) or m.cfg.n_vocab != 51866:
        raise AssertionError(f"tokenizer specials {specials}, config's {cfg_ids}, vocabulary {m.cfg.n_vocab}")
    size = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))
    res = dict(seed_s=seed_s, write_s=write_s, load_s=load_s, bytes=size, tensors=len(ref), bit_identical=True)
    log(f"whisper dir {json.dumps(res)}")
    if keep is not None:
        m.module.to(torch.bfloat16)
        keep["teacher_forced"] = teacher_forced_logits(torch, m.module, m.cfg, wtp_mel(torch).to(dev), WTP_TOKENS)
    del m, ref, got, tree16
    gc.collect()
    torch.cuda.empty_cache()
    return res


def prepare_serving_dir(torch, dev, root):
    """Writes the seeded xlsr CTC model (what seeded_test_config
    'wav2vec2:xlsr' draws: init_params seed 0, the 48-token vocabulary) as an
    HF wav2vec2 directory with pytorch_model.bin and loads it back: the same
    config and vocabulary, every parameter equal but the recomposed
    weight-normed positional conv (f32 rounding). Returns the timings."""
    from ssak_tpu_torch.infer.general import load_model, seeded_ctc_tokenizer
    from ssak_tpu_torch.models import wav2vec2

    cfg = wav2vec2.make_config(SERVE_MODEL.split(":")[1], vocab_size=48)
    src = wav2vec2.init_params(cfg, seed=0)
    tok = seeded_ctc_tokenizer(cfg.vocab_size)
    write_s = write_wav2vec2_dir(root, src, cfg, tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = load_model(root, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if m.cfg != cfg or m.tokenizer.vocab != tok.vocab:
        raise AssertionError(f"xlsr directory: config {m.cfg} or vocabulary differs")
    ref, got = src.state_dict(), {k: v.cpu() for k, v in m.module.state_dict().items()}
    pos = "encoder.pos_conv.weight"
    if sorted(got) != sorted(ref) or not all(torch.equal(got[k], ref[k]) for k in ref if k != pos):
        raise AssertionError("the xlsr directory did not load as the module it was written from")
    pos_rel = float((got[pos] - ref[pos]).abs().max() / ref[pos].abs().max())
    if not pos_rel <= 1e-6:
        raise AssertionError(f"xlsr directory: positional conv {pos_rel} off its source")
    size = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))
    res = dict(write_s=write_s, load_s=load_s, bytes=size, pos_conv_rel_err=pos_rel)
    log(f"xlsr dir {json.dumps(res)}")
    del m, src
    gc.collect()
    torch.cuda.empty_cache()
    return res


def leaves(tree):
    """The leaves of a parameter tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def counters():
    """The launch counters of every kernel wrapper and the port's decode-step counter."""
    from ssak_tpu_torch.models import whisper as W
    from ssak_tpu_torch.ops import ctc_fused as K1
    from ssak_tpu_torch.ops import flash_attention as L1
    from ssak_tpu_torch.ops import flash_decode as FD
    from ssak_tpu_torch.ops import int8_matmul as IM

    return (K1.LAUNCHES, IM.LAUNCHES, FD.LAUNCHES, W.DECODE_STEPS, L1.LAUNCHES)


def reset_counts():
    for c in counters():
        for k in c:
            c[k] = 0


def decode_launches():
    _k1, im, fd, steps, _l1 = counters()
    return {**im, **fd}, steps["n"]


def kernel_launches():
    k1, im, fd, _steps, l1 = counters()
    return {**k1, **im, **fd, **l1}


def want_decode(bits, steps, kv_int8=None, layers=32):
    """Launches of a Whisper decode run of `steps` cached steps: 8 dense per
    decoder layer x `layers` (large-v3's 32) through K2 (int8) or K3
    (int4), a self and a cross attention site a layer through K4, int8
    with the int8 K/V caches that load_model's quantized models take
    (kv_int8 defaults to bool(bits)), bf16 otherwise."""
    kv_int8 = bool(bits) if kv_int8 is None else kv_int8
    return {
        "matmul_int8": 8 * layers * steps if bits == 8 else 0,
        "matmul_int4": 8 * layers * steps if bits == 4 else 0,
        "flash_decode_int8": 2 * layers * steps if kv_int8 else 0,
        "flash_decode_bf16": 0 if kv_int8 else 2 * layers * steps,
    }


class Decodes:
    """Records each WhisperTokenizer.decode call (the ids and the text)
    while installed."""

    def __init__(self):
        from ssak_tpu_torch.models.tokenizer import WhisperTokenizer

        self.cls, self.calls, self.orig = WhisperTokenizer, [], WhisperTokenizer.decode

    def __enter__(self):
        orig, calls = self.orig, self.calls

        def decode(tok, ids, *a, **kw):
            text = orig(tok, ids, *a, **kw)
            calls.append(([int(i) for i in ids], text))
            return text

        self.cls.decode = decode
        return self

    def __exit__(self, *exc):
        self.cls.decode = self.orig


def check_transcripts(tag, texts, decodes, cfg, max_tokens, in_order):
    """Transcripts are the tokenizer's text: every decode call's ids lie in
    the vocabulary and within the token budget; each transcript is a
    decoded text; with in_order, the decodes are in file order and some
    transcripts hold letters (text, not ids)."""
    for ids, _text in decodes.calls:
        if not all(0 <= x < cfg.n_vocab for x in ids) or len(ids) > max_tokens:
            raise AssertionError(f"{tag}: decoded ids outside the vocabulary or budget: {ids}")
    decoded = [t.strip() for _, t in decodes.calls]
    if in_order and decoded != list(texts):
        raise AssertionError(f"{tag}: transcripts {list(texts)[:3]} are not the decoded texts {decoded[:3]}")
    if not all(isinstance(t, str) and (not t or t in decoded) for t in texts):
        raise AssertionError(f"{tag}: transcripts that no decode gave: {[t for t in texts if t not in decoded][:3]}")
    if in_order and not any(re.search("[a-z]", t) for t in texts):
        raise AssertionError(f"{tag}: no transcript holds text: {list(texts)[:3]}")


def run_slice(torch, kaldi_dir, ids, quantize_bits, model_dir, texts=None):
    """whisper_infer greedy over the Kaldi dir at quantize_bits (0: bf16);
    the transcripts are appended to `texts` where given."""
    from ssak_tpu_torch.infer.whisper_infer import auto_window_batch, whisper_infer
    from ssak_tpu_torch.models.whisper import make_config

    cfg = make_config("large-v3")
    batch = auto_window_batch(cfg, quantize_bits)
    groups = math.ceil(len(ids) / batch)
    steps = groups * (2 + MAX_TOKENS - 1)  # prompt [sot, no_timestamps] + budget - 1 per group
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    it = whisper_infer(model_dir, kaldi_dir, quantize_bits=quantize_bits, max_tokens=MAX_TOKENS, output_ids=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reset_counts()
    with SelfRanges() as ranges, Decodes() as decodes:
        out = list(it)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches, counted = decode_launches()
    del it
    tag = {0: "bf16", 8: "int8", 4: "int4"}[quantize_bits]
    if [i for i, _ in out] != ids:
        raise AssertionError(f"{tag}: expected one transcript per file in order, got {[i for i, _ in out]}")
    check_transcripts(tag, [t for _, t in out], decodes, cfg, MAX_TOKENS, in_order=True)
    if texts is not None:
        texts.extend(t for _, t in out)
    want = want_decode(quantize_bits, steps)
    if launches != want or counted != steps:
        raise AssertionError(f"{tag}: launch counters {launches} != expected {want} ({steps} decode steps, {counted} counted)")
    audio_s = len(ids) * FILE_SECONDS
    res = dict(config=tag, files=len(ids), batch_size=batch, decode_steps=steps, load_s=t1 - t0, run_s=t2 - t1,
               audio_s_per_s=audio_s / (t2 - t1), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, self_attention_keys=ranges.summary(), sample=out[0][1][:80])
    log(f"slice {json.dumps(res)}")
    return res


class SelfRanges:
    """Records the key range [lo, hi] of each decode step's self-attention
    (the calls of models.layers.decode_attention_bounded on a cache of
    n_text_ctx slots, once a step: every layer takes the same bounds) while
    installed. Keeps the bound tensors and reads them only in summary(), so
    the run it watches is not synchronized."""

    def __init__(self, n_ctx=448):
        from ssak_tpu_torch.models import layers as L

        self.L, self.n_ctx, self.bounds, self.orig = L, n_ctx, [], L.decode_attention_bounded

    def __enter__(self):
        def call(q, kv, lo, hi, *a, **kw):
            if (kv["k8"] if "k8" in kv else kv["k"]).shape[-1] == self.n_ctx and not (self.bounds and self.bounds[-1][1] is hi):
                self.bounds.append((lo, hi, q.shape[0]))
            return self.orig(q, kv, lo, hi, *a, **kw)

        self.L.decode_attention_bounded = call
        return self

    def __exit__(self, *exc):
        self.L.decode_attention_bounded = self.orig

    def summary(self):
        """Keys in range (hi - lo + 1) over every row of every step: steps,
        rows, median, 90th percentile and largest; and the largest hi."""
        import torch

        if not self.bounds:
            return None
        n = torch.cat([(torch.as_tensor(hi).expand(B) - torch.as_tensor(lo).expand(B) + 1).cpu().reshape(-1)
                       for lo, hi, B in self.bounds]).double()
        top = max(int(torch.as_tensor(hi).max()) for _, hi, _ in self.bounds)
        return dict(steps=len(self.bounds), rows=int(n.numel()), median=float(n.median()),
                    p90=float(n.quantile(0.9)), max=float(n.max()), max_hi=top)


class DecodeCalls:
    """Records each call of models.whisper's beam_decode, sample_decode and
    decode_window (kind, temperature, rows) while installed; the port calls
    them through the module, so the wrappers see every call."""

    NAMES = ("beam_decode", "sample_decode", "decode_window")

    def __init__(self):
        from ssak_tpu_torch.models import whisper as W

        self.W, self.calls, self.orig = W, [], {n: getattr(W, n) for n in self.NAMES}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.W, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.W, name, fn)

    def _wrap(self, name, fn):
        def call(model, mel, *args, **kw):
            self.calls.append((name, float(kw.get("temperature", 0.0)), int(mel.shape[0])))
            return fn(model, mel, *args, **kw)

        return call


def run_accurate(torch, kaldi_dir, ids, model_dir):
    """python -m ssak_tpu_torch.infer.whisper_infer DIR MODEL_DIR
    --load_in_4bit --accurate, through whisper_infer, with the token budget
    cut to ACC_TOKENS: beam 5 at T = 0, then sampled best-of-5 at each
    fallback temperature for the windows that fail."""
    from ssak_tpu_torch.infer.whisper_infer import auto_window_batch, whisper_infer
    from ssak_tpu_torch.models.whisper import make_config

    cfg = make_config("large-v3")
    batch = auto_window_batch(cfg, 4, beam_size=5, best_of=5)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with DecodeCalls() as rec, SelfRanges() as ranges, Decodes() as decodes:
        t0 = time.perf_counter()
        it = whisper_infer(model_dir, kaldi_dir, quantize_bits=4, beam_size=5, best_of=5, temperature_fallback=True,
                           max_tokens=ACC_TOKENS, output_ids=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reset_counts()
        out = list(it)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches, steps = decode_launches()
    del it
    if [i for i, _ in out] != ids:
        raise AssertionError(f"int4 accurate: expected one transcript per file in order, got {[i for i, _ in out]}")
    check_transcripts("int4 accurate", [t for _, t in out], decodes, cfg, ACC_TOKENS, in_order=False)
    want = want_decode(4, steps)
    if launches != want or not steps:
        raise AssertionError(f"int4 accurate: launch counters {launches} != expected {want} ({steps} decode steps)")
    if not rec.calls or rec.calls[0][:2] != ("beam_decode", 0.0):
        raise AssertionError(f"int4 accurate: decode calls {rec.calls} do not start with beam search at T=0")
    res = dict(config="int4 accurate (beam 5, best_of 5, fallback)", files=len(ids), file_s=ACC_SECONDS,
               batch_size=batch, decode_steps=steps, decode_calls=rec.calls,
               fallback_temperatures=sorted({t for _, t, _ in rec.calls if t > 0}), load_s=t1 - t0, run_s=t2 - t1,
               audio_s_per_s=len(ids) * ACC_SECONDS / (t2 - t1), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, self_attention_keys=ranges.summary(), sample=out[0][1][:80])
    log(f"slice {json.dumps(res)}")
    return res


def run_longform(torch, model_dir):
    """transcribe_longform_batch on the int4 large-v3 loaded from model_dir
    (as --load_in_4bit loads it) over LF_FILES files of LF_SECONDS (tones +
    noise): timestamps, conditioning, the full temperature chain with
    best_of 5, the no-speech skip, windows cut to LF_TOKENS tokens."""
    import numpy as np

    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.infer.whisper_infer import transcribe_longform_batch
    from ssak_tpu_torch.models.whisper import fuse_decode_qkv

    rng = np.random.RandomState(5)
    audios = [tones(rng, LF_SECONDS) for _ in range(LF_FILES)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = load_model(model_dir, quantize_bits=4)
    fuse_decode_qkv(m.module)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with DecodeCalls() as rec, SelfRanges() as ranges, Decodes() as decodes:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = transcribe_longform_batch(m, audios, best_of=5, max_tokens=LF_TOKENS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches, steps = decode_launches()
    want = want_decode(4, steps)
    if launches != want or not steps:
        raise AssertionError(f"int4 long-form: launch counters {launches} != expected {want} ({steps} decode steps)")
    for r in results:
        starts = [sg["start"] for sg in r["segments"]]
        if not isinstance(r["text"], str) or starts != sorted(starts):
            raise AssertionError(f"int4 long-form: bad result {r['text'][:80]!r}, starts {starts}")
        for sg in r["segments"]:
            if not (0.0 <= sg["start"] <= sg["end"] <= LF_SECONDS + 30.0 and 0.0 <= sg["no_speech_prob"] <= 1.0
                    and math.isfinite(sg["avg_logprob"])):
                raise AssertionError(f"int4 long-form: bad segment {sg}")
        if r["text"] != "".join(sg["text"] for sg in r["segments"]).strip():
            raise AssertionError(f"int4 long-form: text {r['text'][:80]!r} is not its segments' text")
    check_transcripts("int4 long-form", [sg["text"].strip() for r in results for sg in r["segments"]], decodes,
                      m.cfg, m.cfg.n_text_ctx, in_order=False)
    res = dict(config="int4 long-form (full temperature chain, best_of 5)", files=LF_FILES, file_s=LF_SECONDS,
               max_tokens=LF_TOKENS, seek_iterations=sum(1 for _, t, _ in rec.calls if t == 0.0),
               decode_window_calls=len(rec.calls), windows_per_call=sorted({r for _, _, r in rec.calls}),
               temperatures_used=sorted({sg["temperature"] for r in results for sg in r["segments"]}),
               segments=[len(r["segments"]) for r in results], decode_steps=steps, load_s=load_s, run_s=t1 - t0,
               audio_s_per_s=LF_FILES * LF_SECONDS / (t1 - t0), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, self_attention_keys=ranges.summary(), sample=results[0]["text"][:80])
    log(f"slice {json.dumps(res)}")
    del m
    return res


# --- phase 3: Whisper large-v3 fine-tuning from the HF directory -------------------

# python -m ssak_tpu_torch.train.whisper_loop runs over the seeded large-v3 directory: a Kaldi dir of
# WFT_FILES files of 20-29 s with text of lower-case words (all in the written byte-level vocabulary),
# batch WFT_BATCH windows of 30 s (3,000 mel frames), U = 445 teacher-forced tokens (440 + the 4-token
# English prompt + 1). Runs (a)-(c): --lora 8 over the bf16 base, --load_in_8bit and --load_in_4bit,
# WFT_STEPS steps with an evaluation every WFT_EVAL_STEPS over the first WFT_EVAL_SAMPLES files; run (d):
# the full fine-tune of the first WFT_FULL_LAYERS encoder and decoder blocks at large-v3 widths,
# WFT_FULL_STEPS steps, a checkpoint and a resume for one more step.
WFT_FILES, WFT_SECONDS, WFT_BATCH = 16, (20.0, 29.0), 4
# the evaluation decodes one window batch (227 host-bound decode steps, ~15 s): cut from 8 files to 4, and
# from two evaluations a run to one, for the script's time limit (PERF.md); 3 steps (4 until the tensor-parallel
# Whisper run came)
WFT_STEPS, WFT_EVAL_STEPS, WFT_EVAL_SAMPLES, WFT_FULL_STEPS = 3, 3, 4, 3
# the full fine-tune's depth: at 32 + 32 blocks its two f32 checkpoints (parameters and Adam's moments,
# 18.5 GB each) took ~140 s of the script's time limit (PERF.md); 8 + 8 keep every width
WFT_FULL_LAYERS = 4  # 8 until the parallel slice's runs came (the script's time limit)
WFT_PROMPT, WFT_MAX_TOKENS = 4, 224  # sot_sequence("en"); whisper_transcribe_batch's default budget
WFT_LR = 1e-4
WFT_LORA_REMAT = True  # from the reckoning in PERF.md: about 84 GB of activations at B = 4 without it


class WhisperLoopSpy:
    """While installed, wraps what train.whisper_loop calls through its
    module: make_whisper_train_step (CUDA events around each step, its
    metrics and state kept), init_train_state (a host copy of the frozen
    partition, taken as the run starts), WhisperBatcher.batches (the audio
    seconds of each batch, the first batch kept), evaluate_whisper (its
    seconds, WER, decode steps and K2 / K3 / K4 launches, from counter
    snapshots around the call) and _resume (the step, Adam's count and a
    copy of the parameters it loaded)."""

    def __init__(self, torch):
        import ssak_tpu_torch.train.whisper_loop as WL

        self.torch, self.WL = torch, WL
        self.orig = dict(make_whisper_train_step=WL.make_whisper_train_step, init_train_state=WL.init_train_state,
                         evaluate_whisper=WL.evaluate_whisper, _resume=WL._resume)
        self.batches = WL.WhisperBatcher.batches
        self.marks, self.metrics, self.audio_s, self.evals, self.first = [], [], [], [], None
        self.state, self.frozen, self.resumed = None, None, None

    def __enter__(self):
        torch, WL, orig = self.torch, self.WL, self.orig

        def make_step(*a, **kw):
            step = orig["make_whisper_train_step"](*a, **kw)

            def timed(state, batch):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(state, batch)
                end.record()
                self.marks.append((start, end))
                self.metrics.append(out[1])
                self.state = state
                return out

            return timed

        def init_state(model, optimizer, quantized=False):
            from ssak_tpu_torch.models.quant import partition_trainable

            self.frozen = {k: v.detach().cpu() for k, v in partition_trainable(model)[1].items()} if quantized else {}
            return orig["init_train_state"](model, optimizer, quantized=quantized)

        def batches(batcher, rows, seed=None):
            for batch, chunk in self.batches(batcher, rows, seed=seed):
                self.audio_s.append(sum(float(r["duration"]) for r in chunk))
                if self.first is None:
                    self.first = batch
                yield batch, chunk

        def evaluate(*a, **kw):
            before = snapshot()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev = orig["evaluate_whisper"](*a, **kw)
            torch.cuda.synchronize()
            after = snapshot()
            self.evals.append(dict(s=time.perf_counter() - t0, wer=ev["eval_wer"], decode_steps=after[1] - before[1],
                                   launches={k: after[0][k] - before[0][k] for k in after[0]}))
            return ev

        def resume(state, output_dir, device):
            orig["_resume"](state, output_dir, device)
            self.resumed = {"step": state["step"], "opt_count": state["opt_state"]["1"]["0"]["count"],
                            "params": {k: p.detach().clone() for k, p in state["model"].named_parameters()}}

        def snapshot():
            launches, steps = decode_launches()
            return dict(launches), steps

        WL.make_whisper_train_step, WL.init_train_state, WL.evaluate_whisper, WL._resume = \
            make_step, init_state, evaluate, resume
        WL.WhisperBatcher.batches = batches
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.WL, name, fn)
        self.WL.WhisperBatcher.batches = self.batches

    def step_ms(self):
        """Steps 2.. on the card's clock, each from its first enqueued
        operation to its last (an evaluation between two steps is not in it)."""
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.marks[1:]]


def teacher_forced_loss(torch, model, cfg, batch):
    from ssak_tpu_torch.models import whisper as W

    with torch.no_grad():
        af = W.encode(model, batch["mel"], cfg)
        logits = W.decode_train(model, batch["tokens_in"], af, cfg)
        return float(W.cross_entropy_loss(logits, batch["tokens_out"], batch["token_mask"]))


def run_whisper_lora(torch, dev, root, model_dir, train_dir, eval_dir, bits, base):
    """python -m ssak_tpu_torch.train.whisper_loop TRAIN EVAL --base_model
    MODEL_DIR --language en --lora 8 [--load_in_8bit | --load_in_4bit]:
    WFT_STEPS steps of batch WFT_BATCH, an evaluation every WFT_EVAL_STEPS
    steps over WFT_EVAL_SAMPLES files. Checked: every evaluation's K4 bf16
    (and K2 or K3) launches against its decode steps (the training module
    decodes unfused, with bf16 K/V caches at every precision: QLoRA
    quantizes through quantize_params, not load_model), none of them in
    the training steps, no K1, L1 or K4 int8; the frozen base bit for bit as it
    started; adapters-<step>.npz at each evaluation and adapters.npz at the
    end; adapters.npz reloaded with load_lora into a fresh model from the
    directory's tree (`base`: load_whisper's tree and config, read once)
    gives the trained module's teacher-forced loss."""
    import contextlib
    import io

    import numpy as np

    from ssak_tpu_torch.models.convert import whisper_from_tree
    from ssak_tpu_torch.models.lora import load_lora
    from ssak_tpu_torch.models.quant import partition_trainable, quantize_params
    from ssak_tpu_torch.train import whisper_loop

    tag = {0: "whisper large-v3 lora (bf16 base)", 8: "whisper large-v3 qlora int8", 4: "whisper large-v3 qlora int4"}[bits]
    out_dir = os.path.join(root, f"lora{bits}")
    argv = [train_dir, eval_dir, "--base_model", model_dir, "--output_dir", out_dir, "--language", "en", "--lora", "8",
            "--batch_size", str(WFT_BATCH), "--max_steps", str(WFT_STEPS), "--eval_steps", str(WFT_EVAL_STEPS),
            "--max_eval_samples", str(WFT_EVAL_SAMPLES), "--max_duration", "30", "--learning_rate", str(WFT_LR)]
    argv += {0: [], 8: ["--load_in_8bit"], 4: ["--load_in_4bit"]}[bits] + (["--remat"] if WFT_LORA_REMAT else [])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stdout = io.StringIO()
    with WhisperLoopSpy(torch) as spy:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            whisper_loop.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, decode_steps = decode_launches()
        others = {k: v for k, v in kernel_launches().items() if k not in launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if json.loads(stdout.getvalue().strip().splitlines()[-1]) != {"output_dir": out_dir, "steps": WFT_STEPS}:
        raise AssertionError(f"{tag}: the CLI printed {stdout.getvalue()[-300:]!r}")
    steps = [(float(m["loss"]), float(m["grad_norm"])) for m in spy.metrics]
    if len(steps) != WFT_STEPS or not all(math.isfinite(a) and math.isfinite(b) and a > 0 for a, b in steps):
        raise AssertionError(f"{tag}: steps {steps}")
    groups = -(-WFT_EVAL_SAMPLES // WFT_BATCH)
    eval_steps = groups * (WFT_PROMPT + WFT_MAX_TOKENS - 1)
    if len(spy.evals) != WFT_STEPS // WFT_EVAL_STEPS:
        raise AssertionError(f"{tag}: {len(spy.evals)} evaluations")
    want = want_decode(bits, eval_steps, kv_int8=False)
    for ev in spy.evals:
        if ev["decode_steps"] != eval_steps or ev["launches"] != want or not 0 <= ev["wer"]:
            raise AssertionError(f"{tag}: evaluation {ev}, want {eval_steps} decode steps and {want}")
    # the training steps launch none of the decode kernels, and nothing else runs K1 or L1
    if launches != want_decode(bits, decode_steps, kv_int8=False) or decode_steps != eval_steps * len(spy.evals) \
            or any(others.values()):
        raise AssertionError(f"{tag}: run launches {launches} ({decode_steps} decode steps), other kernels {others}")
    model = spy.state["model"]
    trainable, frozen = partition_trainable(model)
    same = frozen.keys() == spy.frozen.keys() and all(torch.equal(frozen[k].cpu(), spy.frozen[k]) for k in frozen)
    if not same or not spy.frozen or not all(k.rsplit(".", 1)[-1] in ("lora_A", "lora_B") for k in trainable):
        raise AssertionError(f"{tag}: the frozen base changed in training, or the trainable set is {sorted(trainable)[:4]}")
    names = sorted(os.listdir(out_dir))
    for want in ["adapters.npz", "trainer_state.json"] + [f"adapters-{s}.npz" for s in range(WFT_EVAL_STEPS, WFT_STEPS + 1,
                                                                                                WFT_EVAL_STEPS)]:
        if want not in names:
            raise AssertionError(f"{tag}: {want} not written ({names})")
    with np.load(os.path.join(out_dir, "adapters.npz")) as z:
        adapters = {k: z[k] for k in z.files}
    if len(adapters) != 3 * 2 * 96 or not all(adapters[k].any() for k in adapters if k.endswith("lora_B")):
        raise AssertionError(f"{tag}: adapters.npz holds {len(adapters)} leaves, or an untrained lora_B")
    # a fresh model from the directory's tree as the CLI sets it up, the adapters loaded from adapters.npz
    params, cfg = base
    fresh = whisper_from_tree(params, dev)
    if bits:
        quantize_params(fresh, bits=bits)
    else:
        fresh = fresh.to(torch.bfloat16)
    load_lora(fresh, adapters)
    want_loss = teacher_forced_loss(torch, model, cfg, spy.first)
    got_loss = teacher_forced_loss(torch, fresh, cfg, spy.first)
    if not (math.isfinite(want_loss) and abs(got_loss - want_loss) <= 1e-6 * abs(want_loss)):
        raise AssertionError(f"{tag}: the reloaded adapters give loss {got_loss}, the trained module {want_loss}")
    step_ms = spy.step_ms()
    res = dict(config=tag, batch_size=WFT_BATCH, window_s=30.0, tokens=int(spy.first["tokens_in"].shape[1]),
               steps=WFT_STEPS, step_ms=sum(step_ms) / len(step_ms), step_ms_each=step_ms,
               train_audio_s_per_s=sum(spy.audio_s[1:WFT_STEPS]) / (sum(step_ms) / 1e3),
               losses=[a for a, _ in steps], grad_norms=[b for _, b in steps], evals=spy.evals,
               eval_decode_steps=eval_steps, run_s=run_s, peak_mem_gib=peak, launches=launches,
               trainable=sum(p.numel() for p in trainable.values()), frozen_tensors=len(frozen),
               reload_loss=got_loss, trained_loss=want_loss)
    log(f"slice {json.dumps(res)}")
    del model, fresh, spy, trainable, frozen
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_whisper_full(torch, dev, root, model_dir, train_dir, base):
    """The full fine-tune (train_whisper, lora_rank 0) of the tree that
    load_whisper reads from the directory (`base`), cut to its first
    WFT_FULL_LAYERS encoder and decoder blocks, widened to f32 masters (a full
    fine-tune of its F16 leaves turns most weights to inf or NaN at the
    first update in both packages: optax's eps rounds to 0 in f16; ROADMAP.md
    §3), bf16 compute, remat=True: WFT_FULL_STEPS steps, the checkpoint,
    then resume=True into a fresh model for one more step. Checked: the
    model that resume loads from the checkpoint equals the trained one bit
    for bit, with the step and Adam's count carried; finite losses; no
    kernel launched (no evaluation)."""
    import numpy as np

    from ssak_tpu_torch.infer.general import _with_tokenizer_ids
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.models.convert import whisper_from_tree
    from ssak_tpu_torch.models.tokenizer import WhisperTokenizer
    from ssak_tpu_torch.text import format_text
    from ssak_tpu_torch.train import whisper_loop

    tag = f"whisper large-v3 full fine-tune (f32 masters, remat, {WFT_FULL_LAYERS}+{WFT_FULL_LAYERS} blocks)"
    out_dir = os.path.join(root, "full")
    _, rows = kaldi_folder_to_manifest(train_dir, max_duration=30.0)
    tok = WhisperTokenizer(model_dir)

    def norm(t):
        return format_text(t, "en", extract_parenthesized=False, safety_checks=False).replace("\n", " ")

    cut = {part: dict(base[0][part], blocks=base[0][part]["blocks"][:WFT_FULL_LAYERS]) for part in ("encoder", "decoder")}
    tree32 = tree_map(lambda a: np.asarray(a, np.float32), dict(base[0], **cut))
    cfg = dataclasses.replace(_with_tokenizer_ids(base[1], tok), remat=True, n_audio_layer=WFT_FULL_LAYERS,
                              n_text_layer=WFT_FULL_LAYERS)

    kw = dict(language="en", learning_rate=1e-5, warmup_steps=1, batch_size=WFT_BATCH, eval_steps=0, seed=69,
              normalize_text=norm, log_interval=1, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = whisper_from_tree(tree32, dev)
    with WhisperLoopSpy(torch) as spy:
        reset_counts()
        t0 = time.perf_counter()
        state, _hist = whisper_loop.train_whisper(model, cfg, tok, rows, [], out_dir, max_steps=WFT_FULL_STEPS, **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = spy.step_ms()
    steps = [(float(m["loss"]), float(m["grad_norm"])) for m in spy.metrics]
    trained = {k: p.detach().clone() for k, p in state["model"].named_parameters()}
    if any(p.dtype != torch.float32 for p in trained.values()):
        raise AssertionError(f"{tag}: the trained parameters are not f32")
    del state, model, spy.state
    gc.collect()
    torch.cuda.empty_cache()
    model = whisper_from_tree(tree32, dev)
    with WhisperLoopSpy(torch) as rspy:
        t0 = time.perf_counter()
        rstate, _ = whisper_loop.train_whisper(model, cfg, tok, rows, [], out_dir, max_steps=WFT_FULL_STEPS + 1,
                                               resume=True, **kw)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        launches = kernel_launches()
    if rspy.resumed is None or rspy.resumed["step"] != WFT_FULL_STEPS or rspy.resumed["opt_count"] != WFT_FULL_STEPS \
            or rspy.resumed["params"].keys() != trained.keys() \
            or not all(torch.equal(rspy.resumed["params"][k], trained[k]) for k in trained):
        raise AssertionError(f"{tag}: resume did not load the trained state (step, Adam count, parameters)")
    rsteps = [(float(m["loss"]), float(m["grad_norm"])) for m in rspy.metrics]
    if rstate["step"] != WFT_FULL_STEPS + 1 or len(rsteps) != 1 or len(steps) != WFT_FULL_STEPS:
        raise AssertionError(f"{tag}: steps {steps} then {rsteps} (step {rstate['step']})")
    if not all(math.isfinite(a) and math.isfinite(b) and a > 0 for a, b in steps + rsteps) or any(launches.values()):
        raise AssertionError(f"{tag}: losses {steps + rsteps}, launches {launches}")
    res = dict(config=tag, batch_size=WFT_BATCH, window_s=30.0, remat=True, layers=WFT_FULL_LAYERS, steps=WFT_FULL_STEPS,
               step_ms=sum(step_ms) / len(step_ms), step_ms_each=step_ms,
               train_audio_s_per_s=sum(spy.audio_s[1:WFT_FULL_STEPS]) / (sum(step_ms) / 1e3),
               losses=[a for a, _ in steps], grad_norms=[b for _, b in steps], resumed_losses=[a for a, _ in rsteps],
               run_s=run_s, resume_run_s=resume_s, peak_mem_gib=peak,
               checkpoint_bytes=sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out_dir) for f in fs),
               launches=launches)
    log(f"slice {json.dumps(res)}")
    del rstate, model, trained, tree32, rspy
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_whisper_finetune(torch, dev, tmp, model_dir):
    """Phase 3's Whisper fine-tuning runs (a)-(d) over the large-v3
    directory; its tree is read once on the host for the checks."""
    from ssak_tpu_torch.models.hf_loader import load_whisper

    train_dir = write_ctc_corpus(os.path.join(tmp, "wft_train"), WFT_FILES, seed=21, seconds=WFT_SECONDS)
    base = load_whisper(model_dir)
    out = {f"whisper_ft_{name}": run_whisper_lora(torch, dev, tmp, model_dir, train_dir, train_dir, bits, base)
           for name, bits in (("lora_bf16", 0), ("qlora_int8", 8), ("qlora_int4", 4))}
    out["whisper_ft_full"] = run_whisper_full(torch, dev, tmp, model_dir, train_dir, base)
    return out


CHARS = "abcdefghijklmnopqrstuvwxyz"


def write_ctc_corpus(root, n, seed, seconds=(10.0, 15.0)):
    """n synthetic 16 kHz wav files of `seconds` (a range; tones + noise)
    with seeded text of a-z and spaces at ~14 chars/s, as a Kaldi dir with
    utt2dur."""
    import numpy as np

    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    scp, text, dur = [], [], []
    for i in range(n):
        secs = float(rng.uniform(*seconds))
        t = np.arange(int(secs * 16000)) / 16000.0
        audio = sum(0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t) for _ in range(3)) + 0.02 * rng.randn(t.size)
        path = os.path.join(root, f"utt{i:03d}.wav")
        save_audio(path, audio.astype(np.float32), 16000)
        words, n_chars = [], int(14 * secs)
        while sum(len(w) + 1 for w in words) < n_chars:
            words.append("".join(rng.choice(list(CHARS), size=rng.randint(2, 9))))
        utt = f"utt{i:03d}"
        scp.append(f"{utt} {path}")
        text.append(f"{utt} {' '.join(words)[:n_chars].strip()}")
        dur.append(f"{utt} {secs:.6f}")
    for name, lines in (("wav.scp", scp), ("text", text), ("utt2dur", dur)):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return root


# CTCTrainer runs of phase 3: wav2vec2-base at the 15 s bucket (the trainer's
# default buckets), and xlsr at the 140 s bucket (6,999 frames), whose
# encoder attention goes through L1 forward and backward. LONG_REMAT: off, from
# the reckoning in PERF.md (about 1.55 GB of saved activations a layer at
# B = 4, 37 GB over 24 layers, a peak of about 45 GiB of the 80 GB).
LONG_REMAT = False
CTC_RUNS = {
    "ctc": dict(config="wav2vec2-base ctc", model="base", files=CTC_FILES, eval_files=CTC_EVAL_FILES, seconds=(10.0, 15.0),
                batch=CTC_BATCH, steps=CTC_STEPS, bucket_s=15.0, buckets=None, remat=False, finalize=True),
    "ctc_long": dict(config="wav2vec2-xlsr ctc, 140 s bucket", model="xlsr", files=16, eval_files=4,
                     seconds=(90.0, 140.0), batch=4, steps=6, bucket_s=140.0, buckets=(140.0,), remat=LONG_REMAT,
                     finalize=False),
}


def check_finalized(torch, dev, run_dir, trainer, cfg, batches_fn, eval_rows):
    """python -m ssak_tpu_torch.train.finalize RUN_DIR: the run's last
    checkpoint exported as a model directory, then load_model(final) on the
    card gives the trainer's final log-probs on one eval batch (1e-5)."""
    from ssak_tpu_torch.infer.general import LoadedModel, ModelType, compute_log_probas, load_model
    from ssak_tpu_torch.train.finalize import finalize_run

    t0 = time.perf_counter()
    final = finalize_run(run_dir)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = load_model(final, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with open(os.path.join(final, "finalize_info.json")) as f:
        step = json.load(f)["step"]
    if step != int(trainer.state["step"]) or m.cfg != cfg:
        raise AssertionError(f"finalized step {step} (trained {int(trainer.state['step'])}) or config {m.cfg} differ")
    batch = next(iter(batches_fn(eval_rows)))[0]
    trained = LoadedModel(ModelType.WAV2VEC2_CTC, trainer.state["model"], cfg, dev, m.tokenizer)
    want, want_fl = compute_log_probas(trained, batch["audio"], batch["audio_lengths"])
    got, got_fl = compute_log_probas(m, batch["audio"], batch["audio_lengths"])
    err = float((got - want).abs().max())
    if not (torch.equal(got_fl, want_fl) and got.shape == want.shape and err <= 1e-5):
        raise AssertionError(f"finalized model's log-probs off the trainer's by {err} (shapes {tuple(got.shape)}, "
                             f"{tuple(want.shape)})")
    size = sum(os.path.getsize(os.path.join(final, f)) for f in os.listdir(final))
    del m
    return dict(step=step, export_s=export_s, load_s=load_s, bytes=size, log_probs_max_abs_err=err,
                batch=list(batch["audio"].shape))


def run_ctc_training(torch, dev, root, run):
    """CTCTrainer at full width (`run`, from CTC_RUNS): bf16 compute over f32
    master weights, frozen feature encoder, the trainer's default
    mask_time_prob, `steps` steps on a seeded Kaldi dir, one eval, a final
    checkpoint, and resume into a fresh trainer; with run["finalize"], the
    run exported by train.finalize and loaded back (check_finalized). Launch
    counters exact: K1 once per step and eval batch; L1's forward 24 x
    (steps x (1 + remat) + eval batches) and each backward kernel 24 x steps
    at >= FLASH_MIN_SEQ frames, none below; every other kernel 0."""
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.models.layers import FLASH_MIN_SEQ
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer
    from ssak_tpu_torch.train.loop import CTCTrainer

    n_steps, B = run["steps"], run["batch"]
    train_dir = write_ctc_corpus(os.path.join(root, "train"), run["files"], seed=1, seconds=run["seconds"])
    eval_dir = write_ctc_corpus(os.path.join(root, "eval"), run["eval_files"], seed=2, seconds=run["seconds"])
    _, train_rows = kaldi_folder_to_manifest(train_dir)
    _, eval_rows = kaldi_folder_to_manifest(eval_dir)
    tok = CTCTokenizer.from_corpus([r["text"] for r in train_rows])
    cfg = wav2vec2.make_config(run["model"], vocab_size=max(32, len(tok)), remat=run["remat"])
    if cfg.vocab_size != 32:
        raise AssertionError(f"vocabulary {cfg.vocab_size} != 32 (tokenizer {len(tok)})")
    frames = wav2vec2.feature_extract_output_length(cfg, int(round(run["bucket_s"] * 16000)))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out_dir = os.path.join(root, "run")
    os.makedirs(out_dir, exist_ok=True)
    tok.save(os.path.join(out_dir, "vocab.json"))  # as python -m ssak_tpu_torch.train.cli writes them
    with open(os.path.join(out_dir, "ssak_config.json"), "w") as f:
        json.dump({"model_type": "wav2vec2_ctc", "config": dataclasses.asdict(cfg)}, f, indent=1)
    kw = dict(learning_rate=1e-4, warmup_steps=2, total_steps=n_steps, batch_size=B, eval_steps=0, device=dev)
    if run["buckets"]:
        kw["buckets"] = run["buckets"]
    trainer = CTCTrainer(cfg, wav2vec2.init_params(cfg, seed=0, device=dev), tok, out_dir, **kw)
    marks, audio_s, eval_ms, label_widths = [], [], [], []
    step_fn, batches_fn, evaluate_fn = trainer.train_step, trainer._batches, trainer.evaluate

    def timed_step(state, batch):
        out = step_fn(state, batch)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return out

    def counted_batches(rows, shuffle_seed=None):
        for item in batches_fn(rows, shuffle_seed=shuffle_seed):
            audio_s.append(item[2])
            label_widths.append(int(item[0]["labels"].shape[1]))
            if item[0]["audio"].shape != (B, int(round(run["bucket_s"] * 16000))):
                raise AssertionError(f"{run['config']}: batch audio {tuple(item[0]['audio'].shape)}")
            yield item

    def timed_eval(rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate_fn(rows)
        eval_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.train_step, trainer._batches, trainer.evaluate = timed_step, counted_batches, timed_eval
    reset_counts()
    t0 = time.perf_counter()
    history = trainer.train(train_rows, eval_rows, max_steps=n_steps, log_interval=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernel_launches()
    steps = [h for h in history if "loss" in h]
    evals = [h for h in history if "eval_wer" in h]
    eval_batches = -(-len(eval_rows) // B)
    flash = frames >= FLASH_MIN_SEQ
    want = {k: 0 for k in launches}
    want["ctc_fused"] = n_steps + eval_batches
    if flash:
        want["flash_attention"] = cfg.num_layers * (n_steps * (1 + cfg.remat) + eval_batches)
        want["flash_attention_bwd_dkv"] = want["flash_attention_bwd_dq"] = cfg.num_layers * n_steps
    tag = run["config"]
    if launches != want:
        raise AssertionError(f"{tag}: launch counters {launches} != expected {want} ({n_steps} steps + {eval_batches} "
                             f"eval batches at {frames} frames, remat {cfg.remat})")
    if [h["step"] for h in steps] != list(range(1, n_steps + 1)):
        raise AssertionError(f"{tag}: logged steps {[h['step'] for h in steps]}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) and h["loss"] > 0 for h in steps):
        raise AssertionError(f"{tag}: non-finite losses or grad norms {steps}")
    if len(evals) != 1 or not (math.isfinite(evals[0]["eval_loss"]) and 0 <= evals[0]["eval_wer"]):
        raise AssertionError(f"{tag}: bad eval {evals}")
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]  # steps 2.. on the card's clock
    peak = torch.cuda.max_memory_allocated() / 2**30
    resumed = CTCTrainer(cfg, wav2vec2.init_params(cfg, seed=1, device=dev), tok, out_dir, **kw)
    if not resumed.resume() or resumed.state["step"] != n_steps:
        raise AssertionError(f"{tag}: resume gave step {resumed.state['step']}, want {n_steps}")
    same = all(torch.equal(a, b) for a, b in zip(trainer.state["model"].parameters(), resumed.state["model"].parameters()))
    if not same:
        raise AssertionError(f"{tag}: resumed parameters differ from the trained ones")
    res = dict(config=tag, batch_size=B, bucket_s=run["bucket_s"], frames=frames, remat=cfg.remat, steps=n_steps,
               label_widths=sorted(set(label_widths)), step_ms=sum(step_ms) / len(step_ms), step_ms_each=step_ms,
               train_audio_s_per_s=sum(audio_s[1:n_steps]) / (sum(step_ms) / 1e3),
               eval_ms=eval_ms[-1], eval_wer=evals[0]["eval_wer"], eval_loss=evals[0]["eval_loss"],
               losses=[h["loss"] for h in steps], grad_norms=[h["grad_norm"] for h in steps], run_s=run_s,
               peak_mem_gib=peak, launches=launches, resumed_step=resumed.state["step"])
    if run["finalize"]:
        res["finalized"] = check_finalized(torch, dev, out_dir, trainer, cfg, batches_fn, eval_rows)
    log(f"slice {json.dumps(res)}")
    del trainer, resumed
    gc.collect()
    torch.cuda.empty_cache()
    return res


SERVE_GROUPS = ((8, 12.0, 28.0), (6, 70.0, 135.0), (2, 200.0, 200.0))  # (files, min s, max s)
SERVE_MODEL = "wav2vec2:xlsr"
BEAM_WIDTH, LM_ORDER = 16, 3


def write_serving_corpus(root, seed=7):
    """The CTC serving corpus as a Kaldi dir: 8 files of 12-28 s (30 s
    bucket), 6 of 70-135 s (one auto-packed batch at the 140 s bucket), 2 of
    200 s (two 140 s chunks each), ids ordered so that each group is
    contiguous (the packer is greedy over consecutive rows). Returns
    (ids, sample counts)."""
    import numpy as np

    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    ids, lens, lines = [], [], []
    for n, lo, hi in SERVE_GROUPS:
        for secs in rng.uniform(lo, hi, n):
            utt = f"utt{len(ids):03d}"
            audio = tones(rng, float(secs))
            path = os.path.join(root, f"{utt}.wav")
            save_audio(path, audio, 16000)
            ids.append(utt)
            lens.append(audio.size)
            lines.append(f"{utt} {path}")
    with open(os.path.join(root, "wav.scp"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return ids, lens


def kaldi_subset(root, src, n):
    """A Kaldi dir holding the first n entries of src's wav.scp."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(src, "wav.scp"), encoding="utf-8") as f:
        lines = f.read().splitlines()[:n]
    with open(os.path.join(root, "wav.scp"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return root


def expected_encoder_frames(lens, frames_of=None):
    """Frames of every encoder call ctc_infer makes over files of `lens`
    samples, in order, from the port's own packing (auto_pack_batches,
    padded_batch_shape) and chunking (chunk_lengths and the buckets).
    frames_of(samples): the family's encoder frames, by default the xlsr
    wav2vec2's conv stack."""
    from ssak_tpu_torch.infer import ctc_infer as CI
    from ssak_tpu_torch.models.wav2vec2 import feature_extract_output_length, make_config

    if frames_of is None:
        cfg = make_config(SERVE_MODEL.split(":")[1])

        def frames_of(n):
            return feature_extract_output_length(cfg, n)

    frames = []
    for batch, _ids in CI.auto_pack_batches((range(n), i) for i, n in enumerate(lens)):
        sizes = [len(a) for a in batch]
        short = [n for n in sizes if n <= CI.MAX_CHUNK_SAMPLES]
        if short:
            frames.append(frames_of(CI.padded_batch_shape(short)[1]))
        for n in sizes:
            if n > CI.MAX_CHUNK_SAMPLES:
                frames += [frames_of(CI._bucket_len(c)) for c in CI.chunk_lengths(n)]
    return frames


class EncoderCalls:
    """Records the frame count of each compute_log_probas call (ctc_infer
    looks it up in infer.general at each call) while installed."""

    def __init__(self):
        from ssak_tpu_torch.infer import general as G

        self.G, self.frames, self.orig = G, [], G.compute_log_probas

    def __enter__(self):
        def call(*a, **kw):
            lp, fl = self.orig(*a, **kw)
            self.frames.append(int(lp.shape[1]))
            return lp, fl

        self.G.compute_log_probas = call
        return self

    def __exit__(self, *exc):
        self.G.compute_log_probas = self.orig


# the graph-vs-eager check of the device beam: the first call's first rows, cut to this many frames
BEAM_CHECK_ROWS, BEAM_CHECK_FRAMES = 2, 256


class BeamCalls:
    """CUDA events around each ctc_beam_search_device call, with the host
    time of its enqueue and the frames it decodes, while installed; the
    first call's inputs are kept for graph_check."""

    def __init__(self, torch):
        from ssak_tpu_torch.decode import ctc_beam as CB

        self.torch, self.CB, self.calls, self.orig = torch, CB, [], CB.ctc_beam_search_device
        self.first = None

    def __enter__(self):
        def call(log_probs, *a, **kw):
            if self.first is None:
                self.first = (log_probs, a, kw)
            ev0, ev1 = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            ev0.record()
            out = self.orig(log_probs, *a, **kw)
            ev1.record()
            self.calls.append((tuple(log_probs.shape), ev0, ev1, (time.perf_counter() - t0) * 1e3))
            return out

        self.CB.ctc_beam_search_device = call
        return self

    def __exit__(self, *exc):
        self.CB.ctc_beam_search_device = self.orig

    def summary(self):
        self.torch.cuda.synchronize()
        return [dict(shape=s, card_ms=a.elapsed_time(b), enqueue_ms=h) for s, a, b, h in self.calls]

    def graph_check(self, tag):
        """The first call's first BEAM_CHECK_ROWS rows, cut to
        BEAM_CHECK_FRAMES frames, through the beam as the main path ran it
        (its step captured as a CUDA graph) and with every step launched
        eagerly: the same tokens and lengths, bit for bit."""
        import numpy as np

        CB, torch = self.CB, self.torch
        log_probs, a, kw = self.first
        lp = log_probs[:BEAM_CHECK_ROWS, :BEAM_CHECK_FRAMES]
        fl = torch.as_tensor(a[0])[:BEAM_CHECK_ROWS].clamp(max=BEAM_CHECK_FRAMES)
        kw = dict(kw, return_async=False)
        graphed = CB.ctc_beam_search_device(lp, fl, *a[1:], **kw)
        loop = CB._beam_loop
        CB._beam_loop = lambda *la, **lk: loop(*la, **lk, graph=False)
        try:
            eager = CB.ctc_beam_search_device(lp, fl, *a[1:], **kw)
        finally:
            CB._beam_loop = loop
        same = all(np.array_equal(x, y) for x, y in zip(graphed, eager))
        res = dict(rows=int(lp.shape[0]), frames=int(lp.shape[1]), identical=same,
                   emitted=[int(n) for n in graphed[1]])
        if not same:
            raise AssertionError(f"{tag}: the graphed device beam differs from the eager one: {graphed} vs {eager}")
        return res


def write_lexicon_lm(root, seed=11, n_words=500, n_sentences=2000, order=LM_ORDER):
    """A seeded lexicon of a-z words and a word n-gram ARPA (a 3-gram by
    default) trained on seeded sentences of them with the port's
    train_ngram_lm."""
    import numpy as np

    from ssak_tpu_torch.decode.lm import train_ngram_lm

    rng = np.random.RandomState(seed)
    words = sorted({"".join(rng.choice(list(CHARS), size=rng.randint(2, 9))) for _ in range(n_words)})
    sentences = [" ".join(rng.choice(words, size=rng.randint(3, 12))) for _ in range(n_sentences)]
    lexicon, arpa = os.path.join(root, "lexicon.txt"), os.path.join(root, f"lm{order}.arpa")
    with open(lexicon, "w", encoding="utf-8") as f:
        f.write("\n".join(words) + "\n")
    train_ngram_lm(sentences, order=order, output_arpa=arpa)
    return lexicon, arpa


def run_ctc_serving(torch, kaldi_dir, ids, lens, mode, model_dir, lexicon=None, arpa=None, quantize_bits=0,
                    texts=None):
    """python -m ssak_tpu_torch.infer.ctc_infer DIR MODEL_DIR on the xlsr
    directory of prepare_serving_dir (xlsr widths, 24 layers, bf16, auto
    packing), greedy or with the device beam (width 16, lexicon, word
    3-gram fused on the card), through ctc_infer; with quantize_bits (8 or
    4, --load_in_8bit / --load_in_4bit) the model is quantized on load and
    its encoder rows (more than 64) dequantize every weight, so K2 and K3
    stay at 0 launches; L1's launches checked against 24 x the encoder
    calls at >= FLASH_MIN_SEQ frames, every other kernel at 0. The
    transcripts go into `texts` when it is given."""
    from ssak_tpu_torch.infer.ctc_infer import ctc_infer
    from ssak_tpu_torch.infer.general import seeded_ctc_tokenizer
    from ssak_tpu_torch.models.layers import FLASH_MIN_SEQ
    from ssak_tpu_torch.models.wav2vec2 import make_config

    cfg = make_config(SERVE_MODEL.split(":")[1], vocab_size=48)
    want_frames = expected_encoder_frames(lens)
    kw = dict(beam_width=BEAM_WIDTH, lexicon_path=lexicon, lm_path=arpa) if mode == "beam" else {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with EncoderCalls() as enc, BeamCalls(torch) as beams:
        t0 = time.perf_counter()
        it = ctc_infer(model_dir, kaldi_dir, output_ids=True, quantize_bits=quantize_bits, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reset_counts()
        out = list(it)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = kernel_launches()
    del it
    tag = f"ctc serving {mode}" + (f" int{quantize_bits}" if quantize_bits else "")
    if texts is not None:
        texts.extend(t for _, t in out)
    if [i for i, _ in out] != ids:
        raise AssertionError(f"{tag}: expected one transcript per file in order, got {[i for i, _ in out]}")
    alphabet = set("".join(seeded_ctc_tokenizer(cfg.vocab_size).vocab)) | {" "}
    if not all(isinstance(t, str) and set(t) <= alphabet for _, t in out):
        raise AssertionError(f"{tag}: transcripts outside the vocabulary: {out[:3]}")
    if enc.frames != want_frames:
        raise AssertionError(f"{tag}: encoder calls at {enc.frames} frames, expected {want_frames}")
    flash_calls = sum(f >= FLASH_MIN_SEQ for f in want_frames)
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.num_layers * flash_calls
    if launches != want or not flash_calls:
        raise AssertionError(f"{tag}: launch counters {launches} != expected {want} "
                             f"({flash_calls} encoder calls at >= {FLASH_MIN_SEQ} frames)")
    beam = beams.summary()
    if mode == "beam" and len(beam) != len(want_frames):
        raise AssertionError(f"{tag}: {len(beam)} device-beam calls for {len(want_frames)} batches")
    audio_s = sum(lens) / 16000.0
    res = dict(config=f"{SERVE_MODEL} {mode}" + (f" (width {BEAM_WIDTH}, lexicon, word {LM_ORDER}-gram)" if kw else "")
               + (f" --load_in_{quantize_bits}bit" if quantize_bits else ""),
               files=len(ids), audio_s=audio_s, encoder_calls=len(enc.frames), encoder_frames=enc.frames,
               flash_encoder_calls=flash_calls, load_s=t1 - t0, run_s=t2 - t1, audio_s_per_s=audio_s / (t2 - t1),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
               nonempty=sum(bool(t) for _, t in out), sample=out[-1][1][:80])
    if beam:
        res["device_beam"] = beam
        res["device_beam_ms_140s_batch"] = [b["card_ms"] for b in beam if b["shape"][1] >= FLASH_MIN_SEQ]
        res["device_beam_graph_vs_eager"] = beams.graph_check(tag)
    log(f"slice {json.dumps(res)}")
    return res


def edit_distance(a, b):
    """Levenshtein distance between two strings, one numpy row per
    character of `a` (insertions by a running minimum)."""
    import numpy as np

    if not a or not b:
        return len(a) + len(b)
    bb = np.array([ord(c) for c in b])
    cols = np.arange(len(b) + 1)
    prev = cols.copy()
    for i, ch in enumerate(a, 1):
        cur = np.empty_like(prev)
        cur[0] = i
        cur[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (bb != ord(ch)))
        prev = np.minimum.accumulate(cur - cols) + cols
    return int(prev[-1])


def cer(refs, hyps):
    """Character error rate of `hyps` against `refs`: edits over reference
    characters, summed over the pairs."""
    chars = sum(len(r) for r in refs)
    return sum(edit_distance(r, h) for r, h in zip(refs, hyps)) / max(1, chars)


HOST_BEAM_FILES, HOST_BEAM_WORKERS, HOST_LM_ORDER = 4, 4, 4


def run_host_beam(torch, root, corpus, ids, lens, model_dir):
    """ctc_infer over the first 4 files of the serving corpus (12-28 s) with
    the lexicon and a word 4-gram (write_lexicon_lm's generator at order 4;
    an order above 3 sends every file to the host prefix beam, width 16),
    in process (num_workers=0) and over 4 spawned workers (num_workers=4):
    the same transcripts; the scorer in use the port's C++ NativeNgramLM,
    in this process and in each of the 4 workers, read once each after the
    pooled decode: its CUDA hidden and uninitialised; no kernel launches
    beyond the encoder's (1,499 frames: no L1)."""
    from ssak_tpu_torch.decode import pool as P
    from ssak_tpu_torch.decode.native_lm import NativeNgramLM, load_lm
    from ssak_tpu_torch.infer.ctc_infer import ctc_infer

    os.makedirs(os.path.join(root, "lm4"), exist_ok=True)
    lexicon, arpa = write_lexicon_lm(os.path.join(root, "lm4"), order=HOST_LM_ORDER)
    if not isinstance(load_lm(arpa), NativeNgramLM):
        raise AssertionError("host beam: load_lm did not give the native scorer")
    sub = kaldi_subset(os.path.join(root, "host_beam"), corpus, HOST_BEAM_FILES)
    states, base = [], P.HostBeamPool

    class RecordingPool(base):  # reads every worker once, after the decode, before the pool closes
        def close(self):
            states.extend(self.worker_states())
            super().close()

    runs = {}
    P.HostBeamPool = RecordingPool
    try:
        for workers in (0, HOST_BEAM_WORKERS):
            gc.collect()
            t0 = time.perf_counter()
            it = ctc_infer(model_dir, sub, output_ids=True, beam_width=BEAM_WIDTH, lexicon_path=lexicon, lm_path=arpa,
                           num_workers=workers)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            reset_counts()
            out = list(it)
            torch.cuda.synchronize()
            runs[workers] = dict(texts=out, load_s=t1 - t0, run_s=time.perf_counter() - t1, launches=kernel_launches(),
                                 pool_workers=len({s["pid"] for s in states}))
            del it
    finally:
        P.HostBeamPool = base
    serial, pooled = runs[0], runs[HOST_BEAM_WORKERS]
    tag = "host beam"
    if [i for i, _ in serial["texts"]] != ids[:HOST_BEAM_FILES] or pooled["texts"] != serial["texts"]:
        raise AssertionError(f"{tag}: pooled transcripts {pooled['texts']} != in-process {serial['texts']}")
    if serial["pool_workers"] or pooled["pool_workers"] != HOST_BEAM_WORKERS or len(states) != HOST_BEAM_WORKERS:
        raise AssertionError(f"{tag}: pool workers in process {serial['pool_workers']}, pooled {pooled['pool_workers']}")
    if not all(s["lm"] == "NativeNgramLM" and not s["cuda_initialized"] and s["cuda_visible_devices"] == ""
               for s in states):
        raise AssertionError(f"{tag}: worker states {states}")
    if any(v for r in runs.values() for v in r["launches"].values()):
        raise AssertionError(f"{tag}: kernel launches {[r['launches'] for r in runs.values()]}, expected none")
    audio_s = sum(lens[:HOST_BEAM_FILES]) / 16000.0
    res = dict(config=f"{SERVE_MODEL} host beam (width {BEAM_WIDTH}, lexicon, word {HOST_LM_ORDER}-gram, "
                      f"NativeNgramLM), in process and over {HOST_BEAM_WORKERS} workers",
               files=HOST_BEAM_FILES, audio_s=audio_s, load_s=serial["load_s"], run_s=serial["run_s"],
               pooled_load_s=pooled["load_s"], pooled_run_s=pooled["run_s"], pool_workers_seen=pooled["pool_workers"],
               worker_states=states, audio_s_per_s=audio_s / serial["run_s"],
               pooled_audio_s_per_s=audio_s / pooled["run_s"], nonempty=sum(bool(t) for _, t in serial["texts"]),
               launches=serial["launches"], sample=serial["texts"][-1][1][:80])
    log(f"slice {json.dumps(res)}")
    return res


STREAM_FILES, STREAM_SECONDS, STREAM_CHUNK = 2, (20.0, 30.0), 4096  # 4,096 int16 samples: 8 kB chunks


def run_streaming(torch, dev, model_dir):
    """python -m ssak_tpu_torch.infer.streaming --model MODEL_DIR on the xlsr
    directory (bf16, 2 s blocks with 0.64 s of left context): the port's
    server on 127.0.0.1:0 in this process, two seeded files of 20-30 s
    streamed in 8 kB int16 chunks through the port's remote_streaming (one
    partial per chunk, then one text; the connection then closes), then
    again by a client that waits for each reply (the LinTO reference
    client's way), which times chunk-to-reply latency; every final text is
    an in-process StreamingCTCDecoder's over the same samples, which also
    gives the ms per 2 s block. No kernel launches (231 frames a block)."""
    import asyncio

    import numpy as np

    from ssak_tpu_torch.infer import websocket as WS
    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.infer.streaming import StreamingCTCDecoder, serve_streaming
    from ssak_tpu_torch.remote.client import array_to_bytes, remote_streaming

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = load_model(model_dir, device=dev)
    load_s = time.perf_counter() - t0
    rng = np.random.RandomState(13)
    audios = [tones(rng, float(s)) for s in rng.uniform(*STREAM_SECONDS, STREAM_FILES)]
    chunks = [[array_to_bytes(a[i : i + STREAM_CHUNK]) for i in range(0, len(a), STREAM_CHUNK)] for a in audios]
    reset_counts()
    want, block_ms = [], []
    for cs in chunks:
        dec = StreamingCTCDecoder(model)
        for c in cs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            if dec.accept_waveform(c):
                torch.cuda.synchronize()
                block_ms.append((time.perf_counter() - t) * 1e3)
        want.append(dec.finalize())

    async def serve_and_stream():
        server = await serve_streaming(model, "127.0.0.1", 0)
        url = f"ws://127.0.0.1:{server.sockets[0].getsockname()[1]}"
        streamed, lockstep, latency = [], [], []
        try:
            for a in audios:
                events = []
                text = await remote_streaming(url, a, chunk_samples=STREAM_CHUNK,
                                              on_partial=lambda p: events.append("partial"),
                                              on_final=lambda t: events.append("text"))
                streamed.append((text, events))
            for cs in chunks:
                replies, closed = [], False
                async with WS.connect(url) as ws:
                    await ws.send(json.dumps({"config": {"sample_rate": 16000}}))
                    for c in cs:
                        t = time.perf_counter()
                        await ws.send(c)
                        replies.append(json.loads(await asyncio.wait_for(ws.recv(), 60)))
                        latency.append((time.perf_counter() - t) * 1e3)
                    await ws.send(json.dumps({"eof": 1}))
                    replies.append(json.loads(await asyncio.wait_for(ws.recv(), 60)))
                    try:
                        await asyncio.wait_for(ws.recv(), 30)
                    except WS.ConnectionClosedOK:
                        closed = True
                lockstep.append((replies, closed))
        finally:
            server.close()
            await server.wait_closed()
        return streamed, lockstep, latency

    t1 = time.perf_counter()
    streamed, lockstep, latency = asyncio.run(serve_and_stream())
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t1
    launches = kernel_launches()
    tag = "streaming"
    for cs, final, (text, events), (replies, closed) in zip(chunks, want, streamed, lockstep):
        if events != ["partial"] * len(cs) + ["text"] or text != final.strip():
            raise AssertionError(f"{tag}: remote_streaming gave {events.count('partial')} partials of {len(cs)} chunks, "
                                 f"events {events[-3:]}, text {text[:60]!r}, in process {final[:60]!r}")
        if (not closed or any(set(r) != {"partial"} for r in replies[:-1]) or len(replies) != len(cs) + 1
                or replies[-1] != {"text": final}):
            raise AssertionError(f"{tag}: lockstep replies {replies[-2:]}, closed {closed}, in process {final[:60]!r}")
    if any(launches.values()):
        raise AssertionError(f"{tag}: kernel launches {launches}, expected none")
    lat = sorted(latency)
    res = dict(config=f"{SERVE_MODEL} streaming (2 s blocks, 0.64 s context, 8 kB chunks)", files=STREAM_FILES,
               audio_s=sum(a.size for a in audios) / 16000.0, chunks=sum(len(cs) for cs in chunks), load_s=load_s,
               served_s=served_s, blocks=len(block_ms), block_ms_mean=sum(block_ms) / len(block_ms),
               block_ms_max=max(block_ms), latency_ms_p50=lat[len(lat) // 2], latency_ms_max=lat[-1],
               nonempty=sum(bool(t) for t in want), launches=launches, sample=want[-1][:80])
    log(f"slice {json.dumps(res)}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


# --- phase 3: NeMo Conformer-CTC Large, written as a .nemo archive ---------------------

# stt_en_conformer_ctc_large's encoder (NeMo examples/asr/conf/conformer/conformer_ctc_bpe.yaml,
# the Large column): 18 layers of d_model 512, 8 heads, FFN x4, depthwise kernel 31, 80 mels,
# "striding" x4 subsampling, rel-pos attention with xscaling; 128 BPE pieces + the blank.
NEMO_LARGE = dict(feat_in=80, n_layers=18, d_model=512, n_heads=8, ff_expansion_factor=4, conv_kernel_size=31)
NEMO_PIECES = 128
NEMO_TRAIN_FILES, NEMO_EVAL_FILES, NEMO_BATCH, NEMO_STEPS = 64, 16, 16, 6
NEMO_SERVE_BEAM = 16


def nemo_vocabulary(n=NEMO_PIECES, seed=0):
    """A SentencePiece-like vocabulary of n pieces: <unk>, the word-start
    mark, the letters and the apostrophe, then seeded 2-4 letter pieces, half
    of them starting a word ('▁th'), as NeMo's BPE vocabularies hold."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pieces = ["<unk>", "▁"] + list(CHARS) + ["'"]
    while len(pieces) < n:
        p = "".join(rng.choice(list(CHARS), size=rng.randint(2, 5)))
        p = "▁" + p if rng.rand() < 0.5 else p
        if p not in pieces:
            pieces.append(p)
    return pieces[:n]


def nemo_model_config_yaml(enc, vocabulary):
    """model_config.yaml of an EncDecCTCModelBPE, written by hand (the card
    host has no YAML package): the sections of NeMo's conformer_ctc_bpe.yaml,
    the encoder's widths from `enc`, the vocabulary as double-quoted pieces."""
    pieces = "\n".join(f"  - {json.dumps(p, ensure_ascii=False)}" for p in vocabulary)
    return f"""# EncDecCTCModelBPE (NeMo examples/asr/conf/conformer/conformer_ctc_bpe.yaml)
sample_rate: 16000
log_prediction: true
ctc_reduction: mean_batch
skip_nan_grad: false
train_ds:
  manifest_filepath: null
  sample_rate: ${{model.sample_rate}}
  batch_size: 16
  shuffle: true
  num_workers: 8
  pin_memory: true
  max_duration: 16.7
  min_duration: 0.1
  is_tarred: false
  tarred_audio_filepaths: null
  shuffle_n: 2048
  bucketing_strategy: synced_randomized
  bucketing_batch_size: null
validation_ds:
  manifest_filepath: null
  sample_rate: ${{model.sample_rate}}
  batch_size: 16
  shuffle: false
  use_start_end_token: false
tokenizer:
  dir: null  # tokenizer.model sits beside the weights in a real archive
  type: bpe
preprocessor:
  _target_: nemo.collections.asr.modules.AudioToMelSpectrogramPreprocessor
  sample_rate: ${{model.sample_rate}}
  normalize: per_feature
  window_size: 0.025
  window_stride: 0.01
  window: hann
  features: {enc["feat_in"]}
  n_fft: 512
  log: true
  frame_splicing: 1
  dither: 1.0e-05
  pad_to: 0
  pad_value: 0.0
spec_augment:
  _target_: nemo.collections.asr.modules.SpectrogramAugmentation
  freq_masks: 2
  time_masks: 10
  freq_width: 27
  time_width: 0.05
encoder:
  _target_: nemo.collections.asr.modules.ConformerEncoder
  feat_in: {enc["feat_in"]}
  feat_out: -1
  n_layers: {enc["n_layers"]}
  d_model: {enc["d_model"]}
  subsampling: striding
  subsampling_factor: 4
  subsampling_conv_channels: -1
  ff_expansion_factor: {enc["ff_expansion_factor"]}
  self_attention_model: rel_pos
  n_heads: {enc["n_heads"]}
  att_context_size: [-1, -1]
  xscaling: true
  untie_biases: true
  pos_emb_max_len: 5000
  conv_kernel_size: {enc["conv_kernel_size"]}
  conv_norm_type: batch_norm
  dropout: 0.1
  dropout_pre_encoder: 0.1
  dropout_emb: 0.0
  dropout_att: 0.1
decoder:
  _target_: nemo.collections.asr.modules.ConvASRDecoder
  feat_in: null
  num_classes: {len(vocabulary)}
  vocabulary:
{pieces}
optim:
  name: adamw
  lr: 2.0
  betas:
  - 0.9
  - 0.98
  weight_decay: 0.001
  sched:
    name: NoamAnnealing
    d_model: ${{model.encoder.d_model}}
    warmup_steps: 10000
    warmup_ratio: null
    min_lr: 1.0e-06
target: nemo.collections.asr.models.ctc_bpe_models.EncDecCTCModelBPE
"""


def nemo_state_dict(enc, n_classes, seed=0):
    """A seeded f32 state dict in NeMo's EncDecCTCModel key layout (torch
    Conv2d / Conv1d / Linear weights, BatchNorm with its running statistics),
    drawn from a torch.Generator: dense N(0, 1/fan_in), norms near 1."""
    import torch

    g = torch.Generator().manual_seed(seed)
    d, k, ff = enc["d_model"], enc["conv_kernel_size"], enc["ff_expansion_factor"] * enc["d_model"]
    dh = d // enc["n_heads"]
    sd = {}

    def rand(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=g) * std + mean

    def lin(pfx, din, dout, bias=True):
        sd[f"{pfx}.weight"] = rand(dout, din, std=din ** -0.5)
        if bias:
            sd[f"{pfx}.bias"] = rand(dout, std=0.02)

    def norm(pfx):
        sd[f"{pfx}.weight"] = rand(d, std=0.05, mean=1.0)
        sd[f"{pfx}.bias"] = rand(d, std=0.05)

    f4 = ((enc["feat_in"] + 1) // 2 + 1) // 2
    sd["encoder.pre_encode.conv.0.weight"] = rand(d, 1, 3, 3, std=1 / 3)
    sd["encoder.pre_encode.conv.0.bias"] = rand(d, std=0.02)
    sd["encoder.pre_encode.conv.2.weight"] = rand(d, d, 3, 3, std=(9 * d) ** -0.5)
    sd["encoder.pre_encode.conv.2.bias"] = rand(d, std=0.02)
    lin("encoder.pre_encode.out", d * f4, d)
    for i in range(enc["n_layers"]):
        p = f"encoder.layers.{i}"
        for name in ("norm_feed_forward1", "norm_self_att", "norm_conv", "norm_feed_forward2", "norm_out"):
            norm(f"{p}.{name}")
        for ffn in ("feed_forward1", "feed_forward2"):
            lin(f"{p}.{ffn}.linear1", d, ff)
            lin(f"{p}.{ffn}.linear2", ff, d)
        for q in ("linear_q", "linear_k", "linear_v", "linear_out"):
            lin(f"{p}.self_attn.{q}", d, d)
        lin(f"{p}.self_attn.linear_pos", d, d, bias=False)
        sd[f"{p}.self_attn.pos_bias_u"] = rand(enc["n_heads"], dh, std=0.1)
        sd[f"{p}.self_attn.pos_bias_v"] = rand(enc["n_heads"], dh, std=0.1)
        sd[f"{p}.conv.pointwise_conv1.weight"] = rand(2 * d, d, 1, std=d ** -0.5)
        sd[f"{p}.conv.pointwise_conv1.bias"] = rand(2 * d, std=0.02)
        sd[f"{p}.conv.depthwise_conv.weight"] = rand(d, 1, k, std=k ** -0.5)
        sd[f"{p}.conv.depthwise_conv.bias"] = rand(d, std=0.02)
        norm(f"{p}.conv.batch_norm")
        sd[f"{p}.conv.batch_norm.running_mean"] = rand(d, std=0.1)
        sd[f"{p}.conv.batch_norm.running_var"] = torch.rand(d, generator=g) + 0.5
        sd[f"{p}.conv.batch_norm.num_batches_tracked"] = torch.tensor(1000)
        sd[f"{p}.conv.pointwise_conv2.weight"] = rand(d, d, 1, std=d ** -0.5)
        sd[f"{p}.conv.pointwise_conv2.bias"] = rand(d, std=0.02)
    sd["decoder.decoder_layers.0.weight"] = rand(n_classes + 1, d, 1, std=d ** -0.5)
    sd["decoder.decoder_layers.0.bias"] = rand(n_classes + 1, std=0.02)
    return sd


def write_nemo_archive(path, enc, vocabulary, seed=0, extracted=False):
    """A NeMo Conformer-CTC archive at `path`: a .nemo tar of
    model_config.yaml (nemo_model_config_yaml) and model_weights.ckpt
    (torch.save of nemo_state_dict), or with `extracted` a directory of the
    two. Returns (state dict, seconds to write, bytes)."""
    import io
    import tarfile

    import torch

    t0 = time.perf_counter()
    sd = nemo_state_dict(enc, len(vocabulary), seed)
    config = nemo_model_config_yaml(enc, vocabulary).encode("utf-8")
    if extracted:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "model_config.yaml"), "wb") as f:
            f.write(config)
        torch.save(sd, os.path.join(path, "model_weights.ckpt"))
        size = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
    else:
        weights = io.BytesIO()
        torch.save(sd, weights)
        with tarfile.open(path, "w") as tar:
            for name, data in (("./model_config.yaml", config), ("./model_weights.ckpt", weights.getbuffer())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
        size = os.path.getsize(path)
    return sd, time.perf_counter() - t0, size


def check_nemo_load(torch, sd, m, enc):
    """The loaded model against the state dict it was written from: every
    dense, conv and norm leaf equal after the layout change, the folded
    BatchNorm to f32 rounding, the parameter count that of the archive less
    the BatchNorm statistics."""
    import numpy as np

    mod = m.module
    checks = {
        "pre_encode.conv.0": (mod.subsampling.conv1.weight, sd["encoder.pre_encode.conv.0.weight"]),
        "pre_encode.out": (mod.subsampling.proj.weight, sd["encoder.pre_encode.out.weight"]),
        "layers.0.linear_q": (mod.blocks[0].attn.query.weight, sd["encoder.layers.0.self_attn.linear_q.weight"]),
        "layers.-1.pos_bias_v": (mod.blocks[-1].attn.pos_bias_v, sd[f"encoder.layers.{enc['n_layers'] - 1}.self_attn.pos_bias_v"]),
        "layers.-1.depthwise": (mod.blocks[-1].conv.depthwise.weight,
                                sd[f"encoder.layers.{enc['n_layers'] - 1}.conv.depthwise_conv.weight"]),
        "decoder": (mod.lm_head.weight, sd["decoder.decoder_layers.0.weight"][:, :, 0]),
    }
    for name, (got, want) in checks.items():
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"nemo archive: {name} did not load as written")
    bn = "encoder.layers.0.conv.batch_norm"
    var = sd[f"{bn}.running_var"].numpy()
    scale = sd[f"{bn}.weight"].numpy() / np.sqrt(var + 1e-5)
    if not np.array_equal(mod.blocks[0].conv.bn.scale.cpu().numpy(), scale.astype(np.float32)):
        raise AssertionError("nemo archive: the folded BatchNorm scale differs")
    stats = sum(v.numel() for k, v in sd.items() if k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    n_params = sum(p.numel() for p in mod.parameters())
    if n_params != sum(v.numel() for v in sd.values()) - stats:
        raise AssertionError(f"nemo archive: {n_params} parameters loaded")
    return n_params


def nemo_frames(cfg, n_samples):
    from ssak_tpu_torch.models.conformer import mel_frame_count, subsampled_length

    return subsampled_length(cfg, mel_frame_count(cfg, n_samples))


def run_nemo_serving(torch, dev, kaldi_dir, ids, lens, mode, archive, cfg, quantize_bits=0, texts=None):
    """python -m ssak_tpu_torch.infer.ctc_infer DIR ARCHIVE on the NeMo
    Conformer-CTC Large archive: greedy, or the device beam (width 16, no
    lexicon or LM: those read character vocabularies), through ctc_infer,
    with quantize_bits quantized on load; the encoder's frames per call
    against the port's packing, every kernel counter at 0 (the Conformer's
    attention stays unfused, as in ssak_tpu, and its quantized dense layers
    dequantize: encoder rows are more than K2 and K3 take). The transcripts
    go into `texts` when it is given."""
    from ssak_tpu_torch.infer.ctc_infer import ctc_infer

    kw = dict(beam_width=NEMO_SERVE_BEAM) if mode == "beam" else {}
    if quantize_bits:
        kw["quantize_bits"] = quantize_bits
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with EncoderCalls() as enc, BeamCalls(torch) as beams:
        t0 = time.perf_counter()
        it = ctc_infer(archive, kaldi_dir, output_ids=True, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reset_counts()
        out = list(it)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = kernel_launches()
    del it
    tag = f"nemo serving {mode}" + (f" int{quantize_bits}" if quantize_bits else "")
    if texts is not None:
        texts.extend(t for _, t in out)
    if [i for i, _ in out] != ids:
        raise AssertionError(f"{tag}: expected one transcript per file in order, got {[i for i, _ in out]}")
    alphabet = set("".join(nemo_vocabulary())) - {"▁"} | {" "}
    if not all(isinstance(t, str) and set(t) <= alphabet for _, t in out):
        raise AssertionError(f"{tag}: transcripts outside the vocabulary: {out[:3]}")
    want_frames = expected_encoder_frames(lens, lambda n: nemo_frames(cfg, n))
    if enc.frames != want_frames:
        raise AssertionError(f"{tag}: encoder calls at {enc.frames} frames, expected {want_frames}")
    if any(launches.values()):
        raise AssertionError(f"{tag}: kernel launches {launches}, expected none")
    beam = beams.summary()
    if mode == "beam" and len(beam) != len(want_frames):
        raise AssertionError(f"{tag}: {len(beam)} device-beam calls for {len(want_frames)} batches")
    audio_s = sum(lens) / 16000.0
    res = dict(config="nemo conformer-ctc large " + mode + (f" (width {NEMO_SERVE_BEAM})" if mode == "beam" else "")
               + (f" --load_in_{quantize_bits}bit" if quantize_bits else ""),
               files=len(ids), audio_s=audio_s, encoder_calls=len(enc.frames), encoder_frames=enc.frames,
               load_s=t1 - t0, run_s=t2 - t1, audio_s_per_s=audio_s / (t2 - t1),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
               nonempty=sum(bool(t) for _, t in out), sample=out[-1][1][:80])
    if beam:
        res["device_beam"] = beam
        res["device_beam_graph_vs_eager"] = beams.graph_check(tag)
    log(f"slice {json.dumps(res)}")
    return res


def run_nemo_training(torch, dev, root, archive):
    """python -m ssak_tpu_torch.train.cli TRAIN VALID --base_model ARCHIVE:
    the NeMo Conformer-CTC Large archive fine-tuned in bf16 over f32 masters
    (family conformer, the archive's vocabulary, text encoded character by
    character), batch 16 at the 15 s bucket (1,501 mel frames, 376 encoder
    frames), 6 steps, one eval, a checkpoint; then resume into a fresh
    trainer, `sak-finalize` the run and load_model the export: the trainer's
    log-probs on an eval batch. K1 launched once a step and once an eval
    batch, V = 129 with the blank last; every other kernel 0."""
    import contextlib
    import io

    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.infer.general import LoadedModel, ModelType, compute_log_probas, load_model
    from ssak_tpu_torch.train import cli, finalize
    from ssak_tpu_torch.train import loop as LOOP

    train_dir = write_ctc_corpus(os.path.join(root, "train"), NEMO_TRAIN_FILES, seed=1)
    eval_dir = write_ctc_corpus(os.path.join(root, "eval"), NEMO_EVAL_FILES, seed=2)
    _, eval_rows = kaldi_folder_to_manifest(eval_dir)
    bucket = 15 * 16000
    marks, audio_s, label_widths, metrics, trained = [], [], [], [], {}
    make_step, batches_fn = LOOP.make_ctc_train_step, LOOP.CTCTrainer._batches

    def timed_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def timed(state, batch):
            out = step(state, batch)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            metrics.append(out[1])  # the CLI's trainer logs every 10th step; every step's loss is read here
            trained["model"] = state["model"]
            return out

        return timed

    def counted_batches(self, rows, shuffle_seed=None):
        for item in batches_fn(self, rows, shuffle_seed=shuffle_seed):
            audio_s.append(item[2])
            label_widths.append(int(item[0]["labels"].shape[1]))
            if item[0]["audio"].shape != (NEMO_BATCH, bucket):
                raise AssertionError(f"nemo training: batch audio {tuple(item[0]['audio'].shape)}")
            yield item

    argv = [train_dir, eval_dir, "--base_model", archive, "--output_dir", os.path.join(root, "runs"),
            "--batch_size", str(NEMO_BATCH), "--max_steps", str(NEMO_STEPS), "--eval_steps", "0", "--warmup_steps", "2",
            "--learning_rate", "1e-4", "--language", "en"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LOOP.make_ctc_train_step, LOOP.CTCTrainer._batches = timed_make_step, counted_batches
    stdout = io.StringIO()
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = kernel_launches()
    finally:
        LOOP.make_ctc_train_step, LOOP.CTCTrainer._batches = make_step, batches_fn
    peak = torch.cuda.max_memory_allocated() / 2**30
    run_dir = json.loads(stdout.getvalue().strip().splitlines()[-1])["run_dir"]
    with open(os.path.join(run_dir, "trainer_state.json")) as f:
        history = json.load(f)["log_history"]
    with open(os.path.join(run_dir, "ssak_config.json")) as f:
        saved = json.load(f)
    steps = [{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])} for m in metrics]
    evals = [h for h in history if "eval_wer" in h]
    eval_batches = -(-len(eval_rows) // NEMO_BATCH)
    want = {k: 0 for k in launches}
    want["ctc_fused"] = NEMO_STEPS + eval_batches
    tag = "nemo conformer-ctc large training"
    if launches != want:
        raise AssertionError(f"{tag}: launch counters {launches} != expected {want}")
    if saved["model_type"] != "conformer_ctc" or saved["config"]["blank_id"] != NEMO_PIECES \
            or saved["config"]["vocab_size"] != NEMO_PIECES + 1:
        raise AssertionError(f"{tag}: run config {saved}")
    if len(steps) != NEMO_STEPS or [h["step"] for h in history if "loss" in h] != [1] or len(evals) != 1:
        raise AssertionError(f"{tag}: steps {steps}, history {history}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) and h["loss"] > 0 for h in steps) \
            or not math.isfinite(evals[0]["eval_loss"]):
        raise AssertionError(f"{tag}: non-finite losses or grad norms {steps} {evals}")
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]  # steps 2.. on the card's clock
    base = load_model(archive, device=dev)
    cfg, tok = base.cfg, base.tokenizer
    resumed = LOOP.CTCTrainer(cfg, base.module, tok, run_dir, batch_size=NEMO_BATCH, family="conformer", device=dev)
    if not resumed.resume() or resumed.state["step"] != NEMO_STEPS:
        raise AssertionError(f"{tag}: resume gave step {resumed.state['step']}, want {NEMO_STEPS}")
    if not all(torch.equal(a, b) for a, b in zip(trained["model"].parameters(), resumed.state["model"].parameters())):
        raise AssertionError(f"{tag}: resumed parameters differ from the trained ones")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        finalize.main([run_dir])
    final = out.getvalue().strip().splitlines()[-1]
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = load_model(final, device=dev)
    torch.cuda.synchronize()
    reload_s = time.perf_counter() - t0
    if m.type != ModelType.CONFORMER_CTC or m.cfg != cfg:
        raise AssertionError(f"{tag}: finalized model {m.type} {m.cfg}")
    batch = next(iter(resumed._batches(eval_rows)))[0]
    want_lp, want_fl = compute_log_probas(LoadedModel(ModelType.CONFORMER_CTC, trained["model"], cfg, dev, tok),
                                          batch["audio"], batch["audio_lengths"])
    got_lp, got_fl = compute_log_probas(m, batch["audio"], batch["audio_lengths"])
    err = float((got_lp - want_lp).abs().max())
    if not (torch.equal(got_fl, want_fl) and err <= 1e-5):
        raise AssertionError(f"{tag}: the export's log-probs off the trainer's by {err}")
    frames = nemo_frames(cfg, bucket)
    res = dict(config=tag, batch_size=NEMO_BATCH, bucket_s=15.0, mel_frames=bucket // 160 + 1, frames=frames,
               steps=NEMO_STEPS, label_widths=sorted(set(label_widths)), step_ms=sum(step_ms) / len(step_ms),
               step_ms_each=step_ms, train_audio_s_per_s=sum(audio_s[1:NEMO_STEPS]) / (sum(step_ms) / 1e3),
               eval_wer=evals[0]["eval_wer"], eval_loss=evals[0]["eval_loss"],
               losses=[h["loss"] for h in steps], grad_norms=[h["grad_norm"] for h in steps], run_s=run_s,
               peak_mem_gib=peak, launches=launches, resumed_step=resumed.state["step"],
               finalized=dict(export_s=export_s, load_s=reload_s, log_probs_max_abs_err=err,
                              bytes=sum(os.path.getsize(os.path.join(final, f)) for f in os.listdir(final))))
    log(f"slice {json.dumps(res)}")
    del resumed, m, base, trained
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_nemo(torch, dev, tmp, serving_corpus):
    """Phase 3's Conformer runs on one NeMo Conformer-CTC Large archive
    (seed 0, NEMO_LARGE, nemo_vocabulary): written, loaded back against what
    was written, served (greedy over the CTC serving corpus, the device beam
    over its files of one chunk) and fine-tuned through the train CLI."""
    from ssak_tpu_torch.infer.general import load_model

    archive = os.path.join(tmp, "stt_conformer_ctc_large.nemo")
    sd, write_s, size = write_nemo_archive(archive, NEMO_LARGE, nemo_vocabulary())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = load_model(archive, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not (m.cfg.vocab_size == NEMO_PIECES + 1 and m.cfg.blank_id == NEMO_PIECES and m.cfg.num_layers == 18
            and m.cfg.d_model == 512 and m.cfg.pos_type == "relpos" and m.tokenizer.word_delimiter == "▁"):
        raise AssertionError(f"nemo archive: config {m.cfg}, delimiter {m.tokenizer.word_delimiter!r}")
    n_params = check_nemo_load(torch, sd, m, NEMO_LARGE)
    archive_res = dict(write_s=write_s, load_s=load_s, bytes=size, parameters=n_params)
    log(f"nemo archive {json.dumps(archive_res)}")
    cfg = m.cfg
    del m, sd
    gc.collect()
    torch.cuda.empty_cache()
    corpus, ids, lens = serving_corpus
    bf16_texts = []
    out = {"nemo_archive": archive_res,
           "nemo_serving_greedy": run_nemo_serving(torch, dev, corpus, ids, lens, "greedy", archive, cfg,
                                                   texts=bf16_texts)}
    for bits in (8, 4):
        texts = []
        res = run_nemo_serving(torch, dev, corpus, ids, lens, "greedy", archive, cfg, quantize_bits=bits, texts=texts)
        res["cer_vs_bf16"] = cer(bf16_texts, texts)
        log(f"nemo serving greedy int{bits}: CER against the bf16 transcripts {res['cer_vs_bf16']}")
        out[f"nemo_serving_int{bits}"] = res
    n_beam = sum(n for n, _lo, hi in SERVE_GROUPS if hi <= 140.0)
    out["nemo_serving_beam"] = run_nemo_serving(torch, dev, kaldi_subset(os.path.join(tmp, "nemo_beam"), corpus, n_beam),
                                                ids[:n_beam], lens[:n_beam], "beam", archive, cfg)
    out["nemo_training"] = run_nemo_training(torch, dev, os.path.join(tmp, "nemo_train"), archive)
    return out


# --- phase 3: corpus ingest into sak-train's wav2vec2 step ------------------------------------

# A Kaldi dir of 24 utterances of 10-15 s under one segments file: 8 FLAC files at 48 kHz (stereo,
# mid/side), 8 sox pipes over 8 kHz WAV files whose paths hold $INGEST_D, each one whole-file
# segment, and 4 16 kHz WAV recordings cut into 2 segments each. MP3 is left out: the card host
# has no libmpg123 (ROADMAP.md, Decisions), so read_mp3 must raise its named error there.
INGEST_FLAC, INGEST_PIPES, INGEST_WAV_RECS = 8, 8, 4
INGEST_BATCH, INGEST_STEPS, INGEST_BPE_VOCAB = 16, 4, 64
INGEST_RESAMPLE = ((44100, 1), (48000, 2), (8000, 2))  # (input rate, rows of 15 s) resampled to 16 kHz
INGEST_MP3 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data_torch", "stereo_44k.mp3")
_CRC16 = []


def _crc16(data):
    """FLAC's frame CRC-16 (polynomial 0x8005, no reflection, init 0)."""
    if not _CRC16:
        for i in range(256):
            c = i << 8
            for _ in range(8):
                c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
            _CRC16.append(c)
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16[(c >> 8) ^ b]
    return c


def _crc8(data):
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def _pack_bits(vals, lens):
    """Fields (value, width) packed MSB first into bytes (widths sum to whole
    bytes; a field of width 0 adds nothing). A field of value 1, as every
    unary code is, sets only its last bit."""
    import numpy as np

    vals, lens = np.asarray(vals, np.uint64), np.asarray(lens, np.int64)
    ends = np.cumsum(lens)
    bits = np.zeros(int(ends[-1]), np.uint8)
    one = (vals == 1) & (lens > 0)
    bits[ends[one] - 1] = 1
    rest = ~one & (lens > 0)
    v, ln, st = vals[rest], lens[rest], (ends - lens)[rest]
    for b in range(int(ln.max()) if ln.size else 0):
        m = ln > b
        bits[st[m] + b] = (v[m] >> (ln[m] - 1 - b).astype(np.uint64)) & np.uint64(1)
    return np.packbits(bits).tobytes()


def flac_bytes(samples, rate, block=4096):
    """A 16-bit FLAC file of integer samples (n, channels): STREAMINFO, then
    frames of `block` samples (the last one shorter, its size in 16 bits),
    2 channels as mid/side, FIXED order-2 subframes with one Rice partition."""
    import numpy as np

    samples = np.asarray(samples, np.int64)
    n, ch = samples.shape
    rate_codes = {8000: 4, 16000: 5, 22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10}
    frames = []
    for fi, at in enumerate(range(0, n, block)):
        x = samples[at : at + block]
        m = len(x)
        chans = [((x[:, 0] + x[:, 1]) >> 1, 16), (x[:, 0] - x[:, 1], 17)] if ch == 2 else [(x[:, c], 16) for c in range(ch)]
        hb = _pack_bits([0x3FFE, 0, 12 if m == block else 7, rate_codes[rate], 10 if ch == 2 else ch - 1, 4, 0],
                        [14, 2, 4, 4, 4, 3, 1])
        if fi < 0x80:  # the frame number, UTF-8 coded
            hb += bytes([fi])
        elif fi < 0x800:
            hb += bytes([0xC0 | (fi >> 6), 0x80 | (fi & 0x3F)])
        else:
            hb += bytes([0xE0 | (fi >> 12), 0x80 | ((fi >> 6) & 0x3F), 0x80 | (fi & 0x3F)])
        if m != block:
            hb += (m - 1).to_bytes(2, "big")
        hb += bytes([_crc8(hb)])
        vals, lens = [], []
        for sig, bps in chans:
            r = sig[2:] - 2 * sig[1:-1] + sig[:-2]
            u = np.where(r >= 0, 2 * r, -2 * r - 1).astype(np.uint64)
            k = min(14, max(0, int(np.log2(float(u.mean()) + 1.0))))
            while k < 14 and int((u >> np.uint64(k)).max()) > 30:
                k += 1
            # subframe header (FIXED, order 2), warm-up, Rice with partition order 0, the parameter
            vals.append(np.array([0x14, sig[0] & ((1 << bps) - 1), sig[1] & ((1 << bps) - 1), 0, k], np.uint64))
            lens.append(np.array([8, bps, bps, 6, 4], np.int64))
            v, ln = np.empty(2 * u.size, np.uint64), np.empty(2 * u.size, np.int64)
            v[0::2], ln[0::2] = 1, (u >> np.uint64(k)).astype(np.int64) + 1  # unary quotient
            v[1::2], ln[1::2] = u & np.uint64((1 << k) - 1), k
            vals.append(v)
            lens.append(ln)
        pad = -int(sum(int(ln.sum()) for ln in lens)) % 8
        vals.append(np.zeros(1, np.uint64))
        lens.append(np.array([pad], np.int64))
        frame = hb + _pack_bits(np.concatenate(vals), np.concatenate(lens))
        frames.append(frame + _crc16(frame).to_bytes(2, "big"))
    info = block.to_bytes(2, "big") * 2 + b"\0" * 6
    info += ((rate << 44) | ((ch - 1) << 41) | (15 << 36) | n).to_bytes(8, "big") + b"\0" * 16
    return b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + info + b"".join(frames)


def write_ingest_corpus(root, seed=21):
    """The ingest run's Kaldi dir (see INGEST_*): recordings, wav.scp,
    segments, text, utt2spk; $INGEST_D names the audio directory. Returns
    (dir, {utterance: kind}, {recording: (samples (n, ch) int or float, rate)})."""
    import numpy as np

    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    audio = os.path.join(root, "audio")
    os.makedirs(audio, exist_ok=True)
    os.environ["INGEST_D"] = audio

    def signal(seconds, rate, ch=1):
        t = np.arange(int(round(seconds * rate)))[:, None] / rate
        x = sum(0.1 * np.sin(2 * np.pi * rng.uniform(100, min(3000, rate / 3), size=ch) * t) for _ in range(3))
        return x + 0.01 * rng.randn(t.shape[0], ch)

    def secs():
        return round(float(rng.uniform(10.0, 14.9)), 3)

    scp, segs, kinds, recs = [], [], {}, {}
    for i in range(INGEST_FLAC):
        d = secs()
        x = np.clip(np.round(signal(d, 48000, 2) * 32768), -32768, 32767).astype(np.int64)
        with open(os.path.join(audio, f"f{i}.flac"), "wb") as f:
            f.write(flac_bytes(x, 48000))
        scp.append(f"f{i} {audio}/f{i}.flac")
        segs.append((f"f{i}_0", f"f{i}", 0.0, d))
        kinds[f"f{i}_0"], recs[f"f{i}"] = "flac", (x, 48000)
    for i in range(INGEST_PIPES):
        d = secs()
        x = signal(d, 8000)[:, 0].astype(np.float32)
        save_audio(os.path.join(audio, f"p{i}.wav"), x, 8000)
        scp.append(f"p{i} sox $INGEST_D/p{i}.wav -t wav -r 16k -b 16 -c 1 - |")
        segs.append((f"p{i}_0", f"p{i}", 0.0, d))
        kinds[f"p{i}_0"], recs[f"p{i}"] = "pipe", (x, 8000)
    for i in range(INGEST_WAV_RECS):
        a, b = secs(), secs()
        x = signal(a + b + 1.0, 16000)[:, 0].astype(np.float32)
        save_audio(os.path.join(audio, f"w{i}.wav"), x, 16000)
        scp.append(f"w{i} {audio}/w{i}.wav")
        segs += [(f"w{i}_0", f"w{i}", 0.2, round(0.2 + a, 3)), (f"w{i}_1", f"w{i}", round(0.7 + a, 3), round(0.7 + a + b, 3))]
        kinds[f"w{i}_0"] = kinds[f"w{i}_1"] = "wav"
        recs[f"w{i}"] = (x, 16000)
    text, spk = [], []
    for utt, rec, _s, _e in segs:
        words = ["".join(rng.choice(list(CHARS), size=rng.randint(2, 9))) for _ in range(rng.randint(20, 30))]
        text.append(f"{utt} {' '.join(words)}")
        spk.append(f"{utt} s{rec}")
    d = os.path.join(root, "kaldi")
    os.makedirs(d, exist_ok=True)
    files = {"wav.scp": scp, "segments": [f"{u} {r} {s:.3f} {e:.3f}" for u, r, s, e in segs], "text": text,
             "utt2spk": spk}
    for name, lines in files.items():
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines[::-1]) + "\n")  # unsorted: check_kaldi_dir sorts
    return d, kinds, recs


def run_ingest(torch, dev, root):
    """Slice 8e on the card host: the corpus above through check_kaldi_dir
    (fix=True writes utt2dur; each utterance's duration within 10 ms of its
    decoded length; recording durations from the C++ header scan and the
    pipes' input headers, exact), the FLAC files decoded by the port's own
    decoder bit for bit to the integers written, `kaldi2manifest manifest`
    and `tar` (iterate_tarred_dataset gives each row's audio, the int16
    rounding of load_audio's, bit for bit), `kaldi2manifest tokenizer
    --type bpe`; then python -m ssak_tpu_torch.train.cli on a seeded
    wav2vec2-base at full width (an HF directory written here) with
    --config ingest.yaml --set max_steps=4 --use_manifest_cache: 4 steps of
    B=16 x 15 s and an evaluation, then the same command again, resumed (one
    step, an evaluation), its manifests read from the cache (the same files,
    not rewritten; the rows of an uncached read). K1 once per step and
    evaluation batch, every other counter 0 (749 frames: no L1). Last,
    resample_torch on the card against the host resampler at 44.1, 48 and
    8 kHz -> 16 kHz (0.02 away from the filter edges), timed."""
    import contextlib
    import io

    import numpy as np

    from ssak_tpu_torch.audio import array_to_bytes, bytes_to_array, load_audio, resample, resample_torch
    from ssak_tpu_torch.audio.flac import read_flac
    from ssak_tpu_torch.audio.mp3 import read_mp3
    from ssak_tpu_torch.data import kaldi as K
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest, load_manifest
    from ssak_tpu_torch.data.tarred import iterate_tarred_dataset
    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer
    from ssak_tpu_torch.tools import kaldi2manifest
    from ssak_tpu_torch.train import cli
    from ssak_tpu_torch.train import loop as LOOP

    tag = "ingest"
    res = dict(config=tag)
    try:
        read_mp3(INGEST_MP3)
        raise AssertionError(f"{tag}: read_mp3 decoded on a host the probe found without libmpg123")
    except RuntimeError as e:
        if "libmpg123" not in str(e):
            raise
        res["mp3"] = "refused by name: no libmpg123"
    t0 = time.perf_counter()
    kaldi, kinds, recs = write_ingest_corpus(root)
    res["corpus_write_s"] = time.perf_counter() - t0
    for rec, (x, rate) in recs.items():
        if rec.startswith("f"):
            got, sr = read_flac(os.path.join(os.environ["INGEST_D"], f"{rec}.flac"))
            if sr != rate or not np.array_equal(got, (x / 32768.0).astype(np.float32)):
                raise AssertionError(f"{tag}: {rec}.flac did not decode to the integers written")

    t0 = time.perf_counter()
    report = K.check_kaldi_dir(kaldi, fix=True)
    res["check_s"] = time.perf_counter() - t0
    if report["removed_utts"] or report["n_utts"] != len(kinds) or not os.path.exists(os.path.join(kaldi, "utt2dur")):
        raise AssertionError(f"{tag}: check_kaldi_dir report {report}")
    t0 = time.perf_counter()
    rec_durs = K.compute_durations(K.parse_wavscp(os.path.join(kaldi, "wav.scp")))
    res["recording_durations_s"] = time.perf_counter() - t0
    for rec, (x, rate) in recs.items():
        if abs(rec_durs[rec] - len(x) / rate) > 1e-9:
            raise AssertionError(f"{tag}: {rec} duration {rec_durs[rec]}, written {len(x) / rate}")
    utt2dur = {k: float(v) for k, v in K.read_keyed_file(os.path.join(kaldi, "utt2dur")).items()}
    _, rows = kaldi_folder_to_manifest(kaldi)
    resample(np.zeros(48, np.float32), 48000, 16000)  # scipy.signal's first import stays out of the timings
    decoded, dec_s, audio_s = {}, {}, {}
    for r in rows:
        t0 = time.perf_counter()
        a = load_audio(r["audio"], start=r["start"], end=r["end"])
        kind = kinds[r["id"]]
        dec_s[kind] = dec_s.get(kind, 0.0) + time.perf_counter() - t0
        audio_s[kind] = audio_s.get(kind, 0.0) + len(a) / 16000
        decoded[r["id"]] = a
        if not abs(utt2dur[r["id"]] - len(a) / 16000) <= 0.01:
            raise AssertionError(f"{tag}: {r['id']} utt2dur {utt2dur[r['id']]} against {len(a) / 16000} s decoded")
    res["decode_s"] = dec_s
    res["decode_s_per_audio_hour"] = {k: dec_s[k] / (audio_s[k] / 3600) for k in dec_s}
    res["audio_s"] = audio_s

    out = os.path.join(root, "nemo")
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        kaldi2manifest.main(["manifest", kaldi, os.path.join(out + ".jsonl")])
        res["manifest_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kaldi2manifest.main(["tar", kaldi, os.path.join(root, "tar"), "--shard_size", "8"])
        res["tar_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kaldi2manifest.main(["tokenizer", os.path.join(root, "bpe"), "--manifest", out + ".jsonl", "--vocab_size",
                             str(INGEST_BPE_VOCAB)])
        res["tokenizer_s"] = time.perf_counter() - t0
    manifest = load_manifest(out + ".jsonl")
    pipes = [m for m in manifest if m["audio_filepath"].startswith("sox $INGEST_D/")]
    if len(manifest) != len(kinds) or len(pipes) != INGEST_PIPES:
        raise AssertionError(f"{tag}: manifest of {len(manifest)} rows, {len(pipes)} pipes kept verbatim")
    seen = 0
    for x, lens, batch_rows in iterate_tarred_dataset(os.path.join(root, "tar"), 8):
        for a, n, r in zip(x, lens, batch_rows):
            if r is None:
                continue
            seen += 1
            if not np.array_equal(a[:n], bytes_to_array(array_to_bytes(decoded[r["id"]]))):
                raise AssertionError(f"{tag}: tarred {r['id']} is not load_audio's int16 rounding")
    with open(os.path.join(root, "bpe", "tokenizer.json"), encoding="utf-8") as f:
        bpe = json.load(f)
    if seen != len(kinds) or len(bpe["model"]["vocab"]) != INGEST_BPE_VOCAB or not bpe["model"]["merges"]:
        raise AssertionError(f"{tag}: {seen} tarred rows, BPE vocabulary {len(bpe['model']['vocab'])}")
    res["bpe_vocab"], res["bpe_merges"] = len(bpe["model"]["vocab"]), len(bpe["model"]["merges"])

    # python -m ssak_tpu_torch.train.cli on a seeded wav2vec2-base directory
    tok = CTCTokenizer.from_corpus([r["text"] for r in rows])
    cfg = wav2vec2.make_config("base", vocab_size=max(32, len(tok)))
    model_dir = os.path.join(root, "w2v2-base")
    res["model_dir_write_s"] = write_wav2vec2_dir(model_dir, wav2vec2.init_params(cfg, seed=0), cfg, tok)
    with open(os.path.join(root, "ingest.yaml"), "w", encoding="utf-8") as f:
        f.write(f"# sak-train on the ingest corpus\nbase_model: {model_dir}\nbatch_size: {INGEST_BATCH}\n"
                f"learning_rate: 1.0e-4\nwarmup_steps: 2\neval_steps: 0\nlanguage: en\noutput_dir: {root}/runs\n")
    argv = [kaldi, kaldi, "--config", os.path.join(root, "ingest.yaml"), "--set", f"max_steps={INGEST_STEPS}",
            "--use_manifest_cache"]
    cache_env = os.environ.get("SSAK_TPU_TORCH_CACHE")
    os.environ["SSAK_TPU_TORCH_CACHE"] = os.path.join(root, "cache")
    make_step, batches_fn = LOOP.make_ctc_train_step, LOOP.CTCTrainer._batches
    marks, shapes = [], set()

    def timed_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def timed(state, batch):
            out = step(state, batch)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            return out

        return timed

    def seen_batches(self, rows_, shuffle_seed=None):
        for item in batches_fn(self, rows_, shuffle_seed=shuffle_seed):
            shapes.add(tuple(item[0]["audio"].shape))
            yield item

    runs = []
    gc.collect()
    torch.cuda.empty_cache()
    LOOP.make_ctc_train_step, LOOP.CTCTrainer._batches = timed_make_step, seen_batches
    try:
        for run in range(2):
            stdout = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout):
                cli.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            run_dir = json.loads(stdout.getvalue().strip().splitlines()[-1])["run_dir"]
            cache = os.path.join(root, "cache", "manifests")
            runs.append(dict(run_s=run_s, launches=kernel_launches(), run_dir=run_dir,
                             cache={f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in sorted(os.listdir(cache))}))
    finally:
        LOOP.make_ctc_train_step, LOOP.CTCTrainer._batches = make_step, batches_fn
        if cache_env is None:
            os.environ.pop("SSAK_TPU_TORCH_CACHE")
        else:
            os.environ["SSAK_TPU_TORCH_CACHE"] = cache_env
    res["train_s"] = sum(r["run_s"] for r in runs)
    eval_batches = -(-len(rows) // INGEST_BATCH)
    with open(os.path.join(runs[1]["run_dir"], "trainer_state.json")) as f:
        state = json.load(f)
    for i, (run, steps) in enumerate(zip(runs, (INGEST_STEPS, 1))):  # the resumed run takes one step past max_steps
        want = {k: 0 for k in run["launches"]}
        want["ctc_fused"] = steps + eval_batches
        if run["launches"] != want:
            raise AssertionError(f"{tag}: run {i} launch counters {run['launches']} != {want}")
    if runs[1]["run_dir"] != runs[0]["run_dir"] or state["global_step"] != INGEST_STEPS + 1:
        raise AssertionError(f"{tag}: resumed run {runs[1]['run_dir']} at step {state['global_step']}")
    if len(runs[0]["cache"]) != 2 or runs[1]["cache"] != runs[0]["cache"]:
        raise AssertionError(f"{tag}: manifest cache {runs[0]['cache']} then {runs[1]['cache']}")
    cached = sorted((load_manifest(os.path.join(root, "cache", "manifests", f)) for f in runs[0]["cache"]), key=len)
    manifest_s = {}
    for use_cache in (False, True):  # the train and valid manifests the CLI reads, parsed, then from the cache
        os.environ["SSAK_TPU_TORCH_CACHE"] = os.path.join(root, "cache")
        t0 = time.perf_counter()
        fresh = sorted((kaldi_folder_to_manifest(kaldi, min_duration=m, max_duration=15.0, seed=69, use_cache=use_cache)[1]
                        for m in (0.1, None)), key=len)
        manifest_s["cached" if use_cache else "uncached"] = time.perf_counter() - t0
        if cache_env is None:
            os.environ.pop("SSAK_TPU_TORCH_CACHE")
        else:
            os.environ["SSAK_TPU_TORCH_CACHE"] = cache_env
        if cached != fresh:
            raise AssertionError(f"{tag}: cached manifests differ from an uncached read (use_cache {use_cache})")
    res["train_manifests_s"] = manifest_s
    frames = wav2vec2.feature_extract_output_length(cfg, 15 * 16000)
    if shapes != {(INGEST_BATCH, 15 * 16000)}:
        raise AssertionError(f"{tag}: batch shapes {shapes}")
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[:INGEST_STEPS - 1], marks[1:INGEST_STEPS])]
    res.update(batch_size=INGEST_BATCH, frames=frames, steps=INGEST_STEPS, eval_batches=eval_batches,
               step_ms=sum(step_ms) / len(step_ms), run_s=[r["run_s"] for r in runs],
               launches=[r["launches"] for r in runs], cache_files=len(runs[0]["cache"]), resumed_step=state["global_step"])

    # resample_torch on the card against the host resampler
    rs = {}
    for rate, rows_n in INGEST_RESAMPLE:
        rng = np.random.RandomState(rate)
        t = np.arange(15 * rate) / rate
        x = np.stack([sum(0.2 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t + rng.uniform(0, 6)) for _ in range(3))
                      .astype(np.float32) for _ in range(rows_n)])  # tones well inside both filters' pass bands
        xd = torch.from_numpy(x).to(dev)
        ms = time_ms(torch, lambda a: resample_torch(a, rate, 16000), [(xd,)], min_iters=3)
        got = resample_torch(xd, rate, 16000).cpu().numpy()
        host = resample(x, rate, 16000, axis=1)
        n = min(host.shape[1], got.shape[1])
        err = float(np.abs(host[:, 100 : n - 100] - got[:, 100 : n - 100]).max())
        if got.shape != (rows_n, int(math.ceil(15 * rate * 16000 / rate))) or not err < 0.02:
            raise AssertionError(f"resample_torch {rate} -> 16000: shape {got.shape}, {err} off the host resampler")
        rs[str(rate)] = dict(rows=rows_n, ms=ms, ms_per_row=ms / rows_n, max_abs_err=err)
        del xd
    res["resample_torch"] = rs
    os.environ.pop("INGEST_D", None)
    log(f"slice {json.dumps(res)}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


# --- phase 3: alignment and training data (slice 8f) -------------------------------------------

# Forced alignment through xlsr: a Kaldi dir of 4 utterances from the serving corpus (two files of
# 90-140 s, one of 200 s and the first 20 s of the other), split by
# python -m ssak_tpu_torch.tools.align_audio_transcript at --max_duration ALIGN_MAX_DURATION. Each
# utterance longer than that runs the encoder once per 140 s chunk, each chunk padded to its bucket;
# the trellis then runs on the card as one CUDA graph replayed per frame.
ALIGN_MAX_DURATION, ALIGN_SHORT_SECONDS, ALIGN_WORDS_PER_SECOND = 30.0, 20.0, 2.2
# sak-train --data_augment on the ingest corpus and its wav2vec2-base directory: B=16 x 15 s
AUG_STEPS, AUG_NOISES, AUG_RIRS = 4, 2, 2
# the voice converter at its defaults (80 mels, hidden 128, 4 blocks, batch 8 x 2 s)
VC_STEPS, VC_CLIPS, VC_CLIP_SECONDS, VC_CONVERT = 20, 4, 6.0, 4
VAD_STEPS, VAD_CLIPS, VAD_SECONDS = 20, 4, 10.0


def _words(rng, seconds):
    return " ".join("".join(rng.choice(list(CHARS), size=rng.randint(2, 9)))
                    for _ in range(max(1, int(seconds * ALIGN_WORDS_PER_SECOND))))


def write_align_corpus(root, corpus, ids, lens, seed=31):
    """The alignment Kaldi dir over the serving corpus's wav files:
    utterances a0, a1 (whole files of 90-140 s), a2 (a whole 200 s file)
    and a3 (the first ALIGN_SHORT_SECONDS of the other 200 s file), under a
    segments file, with random lower-case words (all in the seeded
    vocabulary). Returns (dir, [(utt, recording, start, end)], {recording: seconds})."""
    import numpy as np

    secs = {u: n / 16000 for u, n in zip(ids, lens)}
    long = [u for u in ids if 90.0 <= secs[u] <= 140.0][:2]
    huge = [u for u in ids if secs[u] > 140.0][:2]
    if len(long) < 2 or len(huge) < 2:
        raise AssertionError(f"align: the serving corpus has no two files of 90-140 s and two above 140 s: {secs}")
    rows = [(f"a{k}", u, 0.0, secs[u]) for k, u in enumerate(long + huge[:1])]
    rows.append(("a3", huge[1], 0.0, ALIGN_SHORT_SECONDS))
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    files = {"wav.scp": [f"{rec} {os.path.join(corpus, rec + '.wav')}" for _u, rec, _s, _e in rows],
             "segments": [f"{u} {rec} {s:.3f} {e:.3f}" for u, rec, s, e in rows],
             "text": [f"{u} {_words(rng, e - s)}" for u, _rec, s, e in rows],
             "utt2spk": [f"{u} spk{u}" for u, _rec, _s, _e in rows]}
    for name, lines in files.items():
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return root, rows, {rec: secs[rec] for _u, rec, _s, _e in rows}


def run_align(torch, dev, root, model_dir, corpus, ids, lens):
    """Slice 8f's main path on the card: split_long_audio_kaldifolder over
    the alignment dir with the xlsr directory (bf16): L1 forward 24 times
    per chunk of at least FLASH_MIN_SEQ frames and nothing else; the split
    dir passes check_kaldi_dir and every cut lies inside its utterance.
    Then, for each aligned utterance, the trellis on the card's own
    log-probs: graphed, eager and on the CPU, bit for bit the same trellis
    and path, each timed (host clock, the backtrack and its copy included)."""
    import numpy as np

    from ssak_tpu_torch.align.forced import tokenize_transcript
    from ssak_tpu_torch.audio import load_audio
    from ssak_tpu_torch.data import kaldi as K
    from ssak_tpu_torch.infer import ctc_infer as CI
    from ssak_tpu_torch.infer import general as G
    from ssak_tpu_torch.models.layers import FLASH_MIN_SEQ
    from ssak_tpu_torch.models.wav2vec2 import feature_extract_output_length
    from ssak_tpu_torch.ops.ctc import ctc_alignment_trellis
    from ssak_tpu_torch.text import format_text
    from ssak_tpu_torch.tools import align_audio_transcript as AT

    tag = "align"
    kaldi, rows, rec_secs = write_align_corpus(os.path.join(root, "kaldi"), corpus, ids, lens)
    out = os.path.join(root, "split")
    loaded, load_model = [], G.load_model

    def keep(*a, **kw):
        m = load_model(*a, **kw)
        loaded.append(m)
        return m

    gc.collect()
    torch.cuda.empty_cache()
    G.load_model = keep
    try:
        reset_counts()
        t0 = time.perf_counter()
        report = AT.split_long_audio_kaldifolder(kaldi, out, model_dir, max_duration=ALIGN_MAX_DURATION)
        torch.cuda.synchronize()
        split_s = time.perf_counter() - t0
        launches = kernel_launches()
    finally:
        G.load_model = load_model
    model = loaded[0]
    cfg = model.cfg

    audios, l1_chunks = {}, 0
    for u, rec, s, e in rows:
        if e - s > ALIGN_MAX_DURATION:
            audios[u] = load_audio(os.path.join(corpus, rec + ".wav"), start=s, end=e)
            l1_chunks += sum(feature_extract_output_length(cfg, CI._bucket_len(c)) >= FLASH_MIN_SEQ
                             for c in CI.chunk_lengths(len(audios[u])))
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.num_layers * l1_chunks
    if launches != want:
        raise AssertionError(f"{tag}: launch counters {launches} != {want}")
    again = K.check_kaldi_dir(out, fix=False, compute_utt2dur=False)
    segs = K.parse_segments(os.path.join(out, "segments"))
    text = K.read_keyed_file(os.path.join(out, "text"))
    if report["removed_utts"] or again["removed_utts"] or again["n_utts"] != len(segs) or sorted(text) != sorted(segs):
        raise AssertionError(f"{tag}: check_kaldi_dir {report} then {again}")
    src = {u: (rec, s, e) for u, rec, s, e in rows}
    cuts = {}
    for utt, (rec, s, e) in segs.items():
        base = utt.split("_cut")[0]
        _rec, bs, be = src[base]
        if not (bs - 1e-6 <= s < e <= be + 1e-3 and e <= rec_secs[rec] + 1e-3):
            raise AssertionError(f"{tag}: cut {utt} [{s}, {e}] outside {base} [{bs}, {be}] of {rec}")
        cuts.setdefault(base, []).append((s, e))
    if any(not cuts.get(u) for u in audios) or cuts.get("a3") != [(0.0, ALIGN_SHORT_SECONDS)]:
        raise AssertionError(f"{tag}: cuts {cuts}")

    trellis = {}
    with open(os.path.join(kaldi, "text"), encoding="utf-8") as f:
        transcripts = dict(line.rstrip("\n").split(" ", 1) for line in f)
    for u, audio in audios.items():
        lp = CI.ctc_compute_logits_chunked(model, audio)  # the card's log-probs, copied to the host
        norm = format_text(transcripts[u], "fr", extract_parenthesized=False, safety_checks=False).replace("\n", " ")
        tokens, _chars = tokenize_transcript(norm, model.vocab())
        lp_card = torch.from_numpy(lp).to(dev)
        got, ms = {}, {}
        for name, x, graph in (("graph", lp_card, True), ("eager", lp_card, False), ("cpu", torch.from_numpy(lp), False),
                               ("graph_again", lp_card, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr, path = ctc_alignment_trellis(x, tokens, blank_id=cfg.blank_id, graph=graph)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            got[name] = (tr.cpu(), path)
            del tr
        ref = got["cpu"]
        same = {k: bool(torch.equal(v[0], ref[0]) and torch.equal(v[1], ref[1])) for k, v in got.items() if k != "cpu"}
        if not all(same.values()):
            raise AssertionError(f"{tag}: {u} trellis or path differs from the CPU's on the card's log-probs: {same}")
        T, S = ref[0].shape
        trellis[u] = dict(T=T, S=S, seconds=len(audio) / 16000, ms=ms, bit_identical=same,
                          graph_us_per_frame=ms["graph_again"] * 1e3 / T, eager_us_per_frame=ms["eager"] * 1e3 / T)
        log(f"{tag}: {u} T={T} S={S} trellis ms graphed {ms['graph_again']:.1f} (first {ms['graph']:.1f}), "
            f"eager {ms['eager']:.1f}, CPU {ms['cpu']:.1f}; card = CPU bit for bit")
        del got, lp_card
    res = dict(config=tag, split_s=split_s, launches=launches, utterances_in=len(rows), utterances_out=len(segs),
               cuts={u: len(v) for u, v in cuts.items()}, l1_chunks=l1_chunks, trellis=trellis,
               audio_s=sum(len(a) for a in audios.values()) / 16000)
    log(f"slice {json.dumps(res)}")
    del model, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_augmented_training(torch, dev, root):
    """sak-train --data_augment on the ingest run's corpus and seeded
    wav2vec2-base directory (left in `root` by run_ingest): noise and RIR
    directories of AUG_NOISES and AUG_RIRS WAV files written here; AUG_STEPS
    steps of B=16 x 15 s and an evaluation (whose batches are augmented
    too, as in ssak_tpu). K1 once per step and evaluation batch, nothing
    else; finite losses; the augmentation's host ms per batch (in the
    prefetch thread) and the step ms (CUDA events between steps)."""
    import contextlib
    import io

    import numpy as np

    from ssak_tpu_torch.audio import save_audio
    from ssak_tpu_torch.augment import speech as SA
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.train import cli
    from ssak_tpu_torch.train import loop as LOOP

    tag = "augmented_training"
    rng = np.random.RandomState(51)
    noise, rir = os.path.join(root, "noise"), os.path.join(root, "rir")
    os.makedirs(noise, exist_ok=True)
    os.makedirs(rir, exist_ok=True)
    for i in range(AUG_NOISES):
        t = np.arange(3 * 16000) / 16000
        x = 0.1 * rng.randn(t.size) if i == 0 else 0.2 * np.sin(2 * np.pi * 50 * t) + 0.02 * rng.randn(t.size)
        save_audio(os.path.join(noise, f"n{i}.wav"), x.astype(np.float32), 16000)
    for i in range(AUG_RIRS):
        n = int((0.2 + 0.2 * i) * 16000)
        h = rng.randn(n) * np.exp(-np.arange(n) / (n / 5))
        save_audio(os.path.join(rir, f"r{i}.wav"), (0.9 * h / np.abs(h).max()).astype(np.float32), 16000)
    kaldi, model_dir = os.path.join(root, "kaldi"), os.path.join(root, "w2v2-base")
    os.environ["INGEST_D"] = os.path.join(root, "audio")
    argv = [kaldi, kaldi, "--base_model", model_dir, "--batch_size", "16", "--max_steps", str(AUG_STEPS),
            "--warmup_steps", "2", "--learning_rate", "1.0e-4", "--eval_steps", "0", "--language", "en",
            "--output_dir", os.path.join(root, "aug_runs"), "--data_augment", "--data_augment_noise", noise,
            "--data_augment_rir", rir]
    make_step, augment_batch = LOOP.make_ctc_train_step, SA.SpeechAugment.augment_batch
    marks, aug_s = [], []

    def timed_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def timed(state, batch):
            out = step(state, batch)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            return out

        return timed

    def timed_augment(self, batch):
        t0 = time.perf_counter()
        out = augment_batch(self, batch)
        aug_s.append((time.perf_counter() - t0, len(batch)))
        return out

    gc.collect()
    torch.cuda.empty_cache()
    LOOP.make_ctc_train_step, SA.SpeechAugment.augment_batch = timed_make_step, timed_augment
    try:
        stdout = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = kernel_launches()
        _, valid = kaldi_folder_to_manifest(kaldi, max_duration=15.0)
    finally:
        LOOP.make_ctc_train_step, SA.SpeechAugment.augment_batch = make_step, augment_batch
        os.environ.pop("INGEST_D", None)
    run_dir = json.loads(stdout.getvalue().strip().splitlines()[-1])["run_dir"]
    with open(os.path.join(run_dir, "trainer_state.json")) as f:
        state = json.load(f)
    losses = [h["loss"] for h in state["log_history"] if "loss" in h]
    evals = [h for h in state["log_history"] if "eval_loss" in h]
    eval_batches = -(-len(valid) // 16)
    want = {k: 0 for k in launches}
    want["ctc_fused"] = AUG_STEPS + eval_batches
    if launches != want:
        raise AssertionError(f"{tag}: launch counters {launches} != {want}")
    if state["global_step"] != AUG_STEPS or not losses or not all(math.isfinite(v) for v in losses) or not evals \
            or not all(math.isfinite(h["eval_loss"]) for h in evals):
        raise AssertionError(f"{tag}: step {state['global_step']}, losses {losses}, evaluations {evals}")
    if len(aug_s) != AUG_STEPS + eval_batches:
        raise AssertionError(f"{tag}: {len(aug_s)} augmented batches, {AUG_STEPS} steps + {eval_batches} evaluated")
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[:AUG_STEPS - 1], marks[1:AUG_STEPS])]
    res = dict(config=tag, run_s=run_s, steps=AUG_STEPS, eval_batches=eval_batches, launches=launches,
               losses=losses, eval_loss=evals[-1]["eval_loss"], step_ms=sum(step_ms) / len(step_ms),
               augment_ms_per_batch=1e3 * sum(s for s, _n in aug_s) / len(aug_s),
               augment_ms_per_row=1e3 * sum(s for s, _n in aug_s) / sum(n for _s, n in aug_s))
    log(f"slice {json.dumps(res)}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _voice(rng, seconds, sr=16000):
    """A harmonic voice-like signal: a wandering pitch, five harmonics, a syllable envelope."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(100, 220) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(0.25 / k * np.sin(k * phase) for k in range(1, 6)) * (0.55 + 0.45 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.003 * rng.randn(t.size)).astype(np.float32)


def run_vc(torch, dev, root):
    """The voice converter on the card: train_voice_converter at its
    defaults for VC_STEPS steps (finite losses), vc_forward card against
    the CPU on a 10 s clip's log-mel (the net's delta, out - x - voice,
    within 1e-4 of its largest value: the identity residual does not set
    the scale), griffin_lim
    card against the CPU (32 iterations, correlation >= 0.999), and
    convert_kaldi_dir over VC_CONVERT utterances of 10-15 s (the output
    passes check_kaldi_dir; each wav as long as its input, sample for sample)."""
    import copy

    import numpy as np

    from ssak_tpu_torch.audio import load_audio, save_audio
    from ssak_tpu_torch.augment import vc as VC
    from ssak_tpu_torch.data import kaldi as K

    tag = "voice_conversion"
    rng = np.random.RandomState(61)
    clips = [_voice(rng, VC_CLIP_SECONDS) for _ in range(VC_CLIPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, losses = VC.train_voice_converter(clips, steps=VC_STEPS, device=dev, log_every=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if len(losses) != VC_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: losses {losses}")
    cpu_model = copy.deepcopy(model).cpu()
    x = _voice(rng, 10.0)
    with torch.no_grad():
        mel = VC.audio_to_logmel(torch.from_numpy(x).to(dev), model.n_mels)
        got = VC.vc_forward(model, mel).cpu()
        want = VC.vc_forward(cpu_model, mel.cpu())
        delta = want.double() - mel.cpu().double() - cpu_model.voice.double()
        fwd_err = float((got.double() - want.double()).abs().max() / delta.abs().max())
        re, im = VC.stft(torch.from_numpy(x).to(dev))
        mag = torch.sqrt(re**2 + im**2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gl_card = VC.griffin_lim(mag, x.size, iters=32)
        torch.cuda.synchronize()
        gl_ms = (time.perf_counter() - t0) * 1e3
        gl_again = VC.griffin_lim(mag, x.size, iters=32)
        t0 = time.perf_counter()
        gl_cpu = VC.griffin_lim(mag.cpu(), x.size, iters=32)
        gl_cpu_ms = (time.perf_counter() - t0) * 1e3
    gl_corr = float(np.corrcoef(gl_card.cpu().numpy(), gl_cpu.numpy())[0, 1])
    gl_repeat = bool(torch.equal(gl_card, gl_again))
    if not fwd_err <= 1e-4 or not gl_corr >= 0.999 or not gl_repeat:
        raise AssertionError(f"{tag}: vc_forward {fwd_err} of the delta's max off the CPU, "
                             f"griffin_lim correlation {gl_corr}, bit-identical on repeat {gl_repeat}")

    kaldi = os.path.join(root, "vc_in")
    os.makedirs(kaldi, exist_ok=True)
    n_in = {}
    with open(os.path.join(kaldi, "wav.scp"), "w", encoding="utf-8") as fw, \
            open(os.path.join(kaldi, "text"), "w", encoding="utf-8") as ft:
        for i in range(VC_CONVERT):
            a = _voice(rng, float(rng.uniform(10.0, 15.0)))
            save_audio(os.path.join(kaldi, f"v{i}.wav"), a, 16000)
            n_in[f"v{i}"] = a.size
            fw.write(f"v{i} {kaldi}/v{i}.wav\n")
            ft.write(f"v{i} {_words(rng, 3)}\n")
    npz = os.path.join(root, "voice.npz")
    VC.save_vc(model, npz)
    out = os.path.join(root, "vc_out")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    VC.convert_kaldi_dir(kaldi, [npz], out, device=dev)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    report = K.check_kaldi_dir(out, fix=False, compute_utt2dur=False)
    lengths = {u: load_audio(os.path.join(out, "wavs", f"vc0_{u}.wav")).size for u in n_in}
    if report["removed_utts"] or report["n_utts"] != VC_CONVERT or lengths != n_in:
        raise AssertionError(f"{tag}: check_kaldi_dir {report}; lengths {lengths} against {n_in}")
    res = dict(config=tag, train_s=train_s, train_ms_per_step=1e3 * train_s / VC_STEPS, losses=[losses[0], losses[-1]],
               vc_forward_delta_rel_err=fwd_err, griffin_lim_corr=gl_corr, griffin_lim_ms=gl_ms, griffin_lim_cpu_ms=gl_cpu_ms,
               griffin_lim_bit_identical_on_repeat=gl_repeat, convert_s=convert_s,
               convert_audio_s=sum(n_in.values()) / 16000)
    log(f"slice {json.dumps(res)}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_vad(torch, dev):
    """The NN VAD on the card: train_nn_vad for VAD_STEPS steps on VAD_CLIPS
    clips of VAD_SECONDS (energy-bootstrapped labels), speech_probs card
    against the CPU (1e-4), the segments of get_vad_segments(method="nn")."""
    import copy

    import numpy as np

    from ssak_tpu_torch.align import nn_vad as NV
    from ssak_tpu_torch.align.vad import get_vad_segments

    tag = "nn_vad"
    rng = np.random.RandomState(71)

    def bursts():
        x = 0.002 * rng.randn(int(VAD_SECONDS * 16000)).astype(np.float32)
        for _ in range(6):
            a = rng.randint(0, x.size - 24000)
            n = rng.randint(4000, 24000)
            x[a : a + n] += _voice(rng, n / 16000 + 0.01)[:n]
        return x

    clips = [bursts() for _ in range(VAD_CLIPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = NV.train_nn_vad(clips, steps=VAD_STEPS, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    cpu_model = copy.deepcopy(model).cpu()
    x = bursts()
    t0 = time.perf_counter()
    got = NV.speech_probs(model, x)
    probs_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = NV.speech_probs(cpu_model, x)
    probs_cpu_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(got - want).max())
    segs = get_vad_segments(x, method="nn", nn_params=model)
    if not err <= 1e-4 or got.shape != (int(VAD_SECONDS * 100),) or not np.isfinite(got).all():
        raise AssertionError(f"{tag}: speech_probs {err} off the CPU, shape {got.shape}")
    res = dict(config=tag, train_s=train_s, train_ms_per_step=1e3 * train_s / VAD_STEPS, probs_max_abs_err=err,
               speech_probs_ms=probs_ms, speech_probs_cpu_ms=probs_cpu_ms, frames=int(got.size), segments=len(segs))
    log(f"slice {json.dumps(res)}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


# --- phase 3: the host-only modules (slice 8i) -------------------------------------------------

HOST_MIN_SECONDS = 90.0  # the classified file: at least this long, so the encoder runs >= FLASH_MIN_SEQ frames (L1)
HOST_GENDER_FILES = 8  # predict_gender_kaldi_dir over the serving corpus's first 8 files (12-28 s; the line's 20 s)
L1_FWD_KERNEL = "fwd_kernel"  # L1 forward's __global__ in csrc/flash_attention.cu, as the trace names it


def run_host_modules(torch, dev, root, model_dir, corpus, ids, lens, card):
    """Slice 8i on the card: the xlsr directory loaded once (timed) with a
    seeded two-class classifier head; utils.gender.classify_speech on one
    serving-corpus file of >= 90 s, untraced and then inside
    utils.monitoring.profile_trace and annotate("host_modules.classify"):
    L1 forward exactly once a layer in each call and no other kernel, the
    probabilities finite and summing to 1 within 1e-6, the trace's JSON
    holding the annotated region and >= 24 L1 forward kernels;
    device_memory_stats("cuda") after the traced call: its peak > 0, <= the
    card's memory, equal to torch.cuda.max_memory_allocated; utils.flops.
    peak_flops beside the card's name and power limit (989e12 on an H100
    SXM); predict_gender_kaldi_dir over the serving corpus's first files,
    on the host, timed."""
    import numpy as np

    from ssak_tpu_torch.audio import load_audio
    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.models import layers as L
    from ssak_tpu_torch.models.layers import FLASH_MIN_SEQ
    from ssak_tpu_torch.models.wav2vec2 import feature_extract_output_length
    from ssak_tpu_torch.utils.flops import peak_flops
    from ssak_tpu_torch.utils.gender import classify_speech, predict_gender_kaldi_dir
    from ssak_tpu_torch.utils.monitoring import annotate, device_memory_stats, profile_trace

    tag = "host_modules"
    t_line = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = load_model(model_dir, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model.module.classifier = L.linear_init(torch.Generator().manual_seed(8), model.cfg.hidden_size, 2).to(dev)
    i = max((j for j, n in enumerate(lens) if HOST_MIN_SECONDS * 16000 <= n <= 140 * 16000), key=lambda j: lens[j])
    audio = load_audio(os.path.join(corpus, ids[i] + ".wav"))
    frames = int(feature_extract_output_length(model.cfg, len(audio)))
    if frames < FLASH_MIN_SEQ:
        raise AssertionError(f"{tag}: {ids[i]} gives {frames} frames, under L1's {FLASH_MIN_SEQ}")
    classify_speech(model, audio)  # first call: allocator and library warm-up
    want = {k: 0 for k in kernel_launches()}
    want["flash_attention"] = model.cfg.num_layers

    def classify():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = classify_speech(model, audio)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kernel_launches()
        p = np.array(list(probs.values()), np.float64)
        if launches != want:
            raise AssertionError(f"{tag}: launch counters {launches} != {want}")
        if list(probs) != ["m", "f"] or not np.isfinite(p).all() or abs(p.sum() - 1.0) > 1e-6:
            raise AssertionError(f"{tag}: probabilities {probs}")
        return probs, secs, launches

    probs, untraced_s, _ = classify()
    torch.cuda.reset_peak_memory_stats(dev)
    with profile_trace(os.path.join(root, "trace")) as tr:
        with annotate("host_modules.classify"):
            traced_probs, traced_s, launches = classify()
    mem = device_memory_stats("cuda")
    max_alloc = torch.cuda.max_memory_allocated(dev)
    if not 0 < mem["peak_bytes_in_use"] <= mem["bytes_limit"] or mem["peak_bytes_in_use"] != max_alloc:
        raise AssertionError(f"{tag}: device_memory_stats {mem}, max_memory_allocated {max_alloc}")
    if any(abs(traced_probs[k] - probs[k]) > 1e-6 for k in probs):
        raise AssertionError(f"{tag}: traced probabilities {traced_probs} against untraced {probs}")
    with open(tr.path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    regions = [e for e in events if e.get("name") == "host_modules.classify"]
    l1_events = [e for e in events if e.get("cat") == "kernel" and L1_FWD_KERNEL in e.get("name", "")]
    if not regions or len(l1_events) < model.cfg.num_layers:
        raise AssertionError(f"{tag}: trace {tr.path}: {len(regions)} annotated regions, {len(l1_events)} L1 kernels")
    peak = peak_flops()
    name = torch.cuda.get_device_name(0)
    if peak is None or ("H100 80GB HBM3" in name and peak != 989e12):
        raise AssertionError(f"{tag}: peak_flops {peak} on {name}")
    n = min(HOST_GENDER_FILES, len(ids))
    gender_dir = kaldi_subset(os.path.join(root, "gender"), corpus, n)
    t0 = time.perf_counter()
    s2g = predict_gender_kaldi_dir(gender_dir, output_path=os.path.join(gender_dir, "spk2gender"))
    gender_s = time.perf_counter() - t0
    if sorted(s2g) != sorted(ids[:n]) or set(s2g.values()) - {"m", "f"}:
        raise AssertionError(f"{tag}: spk2gender {s2g}")
    res = dict(config=tag, load_s=load_s, file=ids[i], seconds=len(audio) / 16000, frames=frames, probs=probs,
               untraced_s=untraced_s, traced_s=traced_s, launches=launches, trace_bytes=os.path.getsize(tr.path),
               trace_events=len(events), trace_l1_kernels=len(l1_events),
               trace_l1_device_ms=sum(e.get("dur", 0) for e in l1_events) / 1e3, memory=mem,
               max_memory_allocated=max_alloc, peak_flops=peak, card=card,
               gender=dict(files=n, audio_s=sum(lens[:n]) / 16000, seconds=gender_s,
                           genders={g: sum(v == g for v in s2g.values()) for g in "mf"}))
    res["line_s"] = time.perf_counter() - t_line
    log(f"{tag}: classify_speech over {res['seconds']:.1f} s ({frames} frames): untraced {untraced_s:.3f} s, traced "
        f"{traced_s:.3f} s; peak_flops {peak:.4g} on {card}")
    log(f"slice {json.dumps(res)}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


# --- phase 3: parallel/ (slice 8g) ----------------------------------------------------------

PROBE_BYTES = 7001 * 1024 * 4  # one row-parallel f32 partial product of xlsr at the 140 s bucket
# f32 elements of a row-parallel partial of large-v3 on 4 files: a decode step's (4 x 1 x 1,280) and the encoder's
# (4 x 1,500 x 1,280)
PROBE_WHISPER_STEP, PROBE_WHISPER_ENCODER = 4 * 1280, 4 * 1500 * 1280


def _dist_rank(rank, world, init_file, backend, fn, args, out):
    """One spawned rank: join the process group through the port's
    init_distributed (a file rendezvous) on cuda:0 (every rank shares the
    one card), run fn(torch, rank, world,
    *args) and put (rank, result) on `out`; the group is torn down after."""
    import torch
    import torch.distributed as dist

    from ssak_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"file://{init_file}", world, rank, backend=backend, device=torch.device("cuda", 0))
    try:
        out.put((rank, fn(torch, rank, world, *args)))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world, backend, *args, timeout=600):
    """fn on `world` spawned processes over `backend`, all on the one card;
    returns the ranks' results in rank order. A rank that fails, hangs past
    `timeout` or returns nothing fails the run (every rank is then killed)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_rdv_")
    procs = [ctx.Process(target=_dist_rank, args=(r, world, os.path.join(tmp, "rdv"), backend, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.perf_counter() + timeout
    try:
        while len(results) < world:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise AssertionError(f"spawned ranks: no result from {sorted(set(range(world)) - set(results))} in {timeout} s")
            try:
                rank, res = out.get(timeout=min(left, 5.0))
                results[rank] = res
            except Exception:  # queue.Empty: look at the ranks, then wait again
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"spawned ranks: a rank exited with {dead}") from None
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"spawned ranks: a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]


def _probe_ops(torch, dist, rank, world):
    """{name: fn} of each collective this slice may use, on CUDA tensors of
    the shared card; each fn raises if the result is wrong."""
    dev = torch.device("cuda", 0)

    def all_reduce(dtype):
        x = torch.full((1024,), float(rank + 1), dtype=dtype, device=dev)
        dist.all_reduce(x)
        assert float(x[0]) == world * (world + 1) / 2, float(x[0])

    def all_gather(dtype):
        x = torch.full((4, 8), float(rank), dtype=dtype, device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        assert [float(p[0, 0]) for p in parts] == [float(r) for r in range(world)]

    def all_gather_into_tensor():
        x = torch.full((4,), float(rank), device=dev)
        y = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(y, x)
        assert float(y[-1]) == world - 1

    def broadcast():
        x = torch.full((16,), float(rank + 7), device=dev)
        dist.broadcast(x, 0)
        assert float(x[0]) == 7.0

    def send_recv():
        x = torch.full((16,), float(rank), device=dev)
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world), dist.P2POp(dist.irecv, y, (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        assert float(y[0]) == (rank - 1) % world

    def all_to_all():
        x = [torch.full((4,), float(rank * world + j), device=dev) for j in range(world)]
        y = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_to_all(y, x)
        assert [float(t[0]) for t in y] == [float(j * world + rank) for j in range(world)]

    def reduce_scatter():
        x = torch.ones(4 * world, device=dev)
        y = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(y, x)
        assert float(y[0]) == world

    def device_mesh():
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        x = torch.ones(8, device=dev)
        dist.all_reduce(x, group=mesh["model"].get_group())
        assert float(x[0]) == world

    def all_reduce_ms(numel, n=5):
        x = torch.ones(numel, device=dev)
        for _ in range(2):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    return {"all_reduce_f32": lambda: all_reduce(torch.float32), "all_reduce_bf16": lambda: all_reduce(torch.bfloat16),
            "all_gather_f32": lambda: all_gather(torch.float32), "all_gather_bf16": lambda: all_gather(torch.bfloat16),
            "all_gather_into_tensor": all_gather_into_tensor, "broadcast": broadcast, "device_mesh": device_mesh,
            "all_reduce_ms": lambda: all_reduce_ms(PROBE_BYTES // 4),
            "all_reduce_ms_whisper_step": lambda: all_reduce_ms(PROBE_WHISPER_STEP, 50),
            "all_reduce_ms_whisper_encoder": lambda: all_reduce_ms(PROBE_WHISPER_ENCODER),
            "reduce_scatter": reduce_scatter, "all_to_all": all_to_all, "send_recv": send_recv}


def _probe_rank(rank, world, init_file, backend, names, out):
    """One probing rank: each op of `names` in turn, (rank, name, True or
    its value, or the error it raised) put on `out` as it ends. An op the
    backend cannot stage may abort the process: the parent sees which."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=30))
    ops = _probe_ops(torch, dist, rank, world)
    for name in names:
        try:
            res = ops[name]()
            torch.cuda.synchronize()
            out.put((rank, name, True if res is None else res))
        except Exception as e:  # the probe records what the backend refuses
            out.put((rank, name, f"{type(e).__name__}: {str(e)[:160]}"))
            if "timed out" in str(e).lower():
                break
    dist.destroy_process_group()


def _probe_world(world, backend, names, timeout=90):
    """{op: outcome} over `world` spawned ranks, rank 0's outcome (and
    whether every rank saw the same). Where a rank dies inside an op, that
    op reads 'aborted the process' and the ops after it run in new ranks."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    res, todo = {}, list(names)
    while todo:
        out = ctx.Queue()
        tmp = tempfile.mkdtemp(prefix="ssak_smoke_rdv_")
        procs = [ctx.Process(target=_probe_rank, args=(r, world, os.path.join(tmp, "rdv"), backend, todo, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        seen, deadline = {}, time.perf_counter() + timeout
        try:
            while (time.perf_counter() < deadline and not all(p.exitcode is not None for p in procs)
                   and not any(p.exitcode not in (None, 0) for p in procs)):
                try:
                    rank, name, val = out.get(timeout=1.0)
                    seen.setdefault(name, {})[rank] = val
                except Exception:  # queue.Empty: look at the ranks again
                    pass
            while not out.empty():
                rank, name, val = out.get()
                seen.setdefault(name, {})[rank] = val
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
            shutil.rmtree(tmp, ignore_errors=True)
        done = [n for n in todo if len(seen.get(n, {})) == world]
        for n in done:
            vals = seen[n]
            res[n] = vals[0] if n.startswith("all_reduce_ms") or all(v == vals[0] for v in vals.values()) else vals
        rest = [n for n in todo if n not in seen or len(seen[n]) < world]
        if rest:
            res[rest[0]] = f"aborted the process (exit codes {[p.exitcode for p in procs]})"
            rest = rest[1:]
        todo = rest
    return res


PROBE_OPS = ("all_reduce_f32", "all_reduce_bf16", "all_gather_f32", "all_gather_bf16", "all_gather_into_tensor",
             "broadcast", "device_mesh", "all_reduce_ms", "all_reduce_ms_whisper_step", "all_reduce_ms_whisper_encoder",
             "reduce_scatter", "all_to_all", "send_recv")


def probe_collectives(torch):
    """What the card's process groups carry: two gloo ranks sharing the card
    (NCCL refuses two ranks on one device), each collective tried on CUDA
    tensors, f32 all_reduces timed (PROBE_BYTES, and large-v3's partials of
    a decode step and of the encoder on 4 files); and one NCCL world of
    1 (this process). Returns {"gloo": {op: outcome}, "nccl_world1": ..., "tp_world": 2
    where gloo passed all_reduce f32 and all_gather, else 1}."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    gloo = _probe_world(2, "gloo", PROBE_OPS)
    tmp = _world1(torch, "probe")  # NCCL at world size 1, in this process
    try:
        nccl = {}
        for name, fn in _probe_ops(torch, dist, 0, 1).items():
            try:
                res = fn()
                torch.cuda.synchronize()
                nccl[name] = True if res is None else res
            except Exception as e:  # the probe records what the backend refuses
                nccl[name] = f"{type(e).__name__}: {str(e)[:160]}"
    finally:
        _end_world1(tmp)
    ok = gloo.get("all_reduce_f32") is True and gloo.get("all_gather_f32") is True
    out = {"gloo": gloo, "nccl_world1": nccl, "tp_world": 2 if ok else 1, "seconds": time.perf_counter() - t0}
    log(f"parallel probe: {json.dumps(out)}")
    return out


def _world1(torch, kind):
    """A process group of one rank over NCCL for this process (a file
    rendezvous): the port's parallel code at world size 1."""
    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix=f"ssak_smoke_{kind}_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}", rank=0, world_size=1)
    return tmp


def _end_world1(tmp):
    import torch.distributed as dist

    dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)


TP_BATCH = 2  # files a batch in the tp_serving runs: 2 x 2 ranks of about 8 GiB each share the card at once


def _parallel_rank(torch, rank, world, model_dir, subset, files, sp_index, backend):
    """One rank of the tp_serving / sp_serving runs on the shared card: the
    xlsr directory loaded, ctc_log_probs_sp of one 140 s row over ('data',
    'seq') = (1, world); then shard_model over ('data', 'model') = (1,
    world) and each file's log-probs (ctc_compute_logits_chunked); then
    ctc_infer(..., tensor_parallel=world) over the Kaldi dir in batches of
    TP_BATCH files, its kernel launches counted. Rank 0 returns its
    log-probs."""
    import numpy as np

    from ssak_tpu_torch.audio import load_audio
    from ssak_tpu_torch.infer.ctc_infer import MAX_CHUNK_SAMPLES, ctc_compute_logits_chunked, ctc_infer
    from ssak_tpu_torch.infer.general import load_model, shard_model
    from ssak_tpu_torch.parallel.mesh import make_mesh
    from ssak_tpu_torch.parallel.sequence import ctc_log_probs_sp

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    model = load_model(model_dir, device=dev)
    load_s = time.perf_counter() - t0
    audio = [load_audio(f) for f in files]
    row = np.zeros((1, MAX_CHUNK_SAMPLES), np.float32)
    row[0, : audio[sp_index].size] = audio[sp_index]
    reset_counts()
    seq = make_mesh(data=1, model=world, names=("data", "seq"), device_type="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        lp_sp, fl_sp = ctc_log_probs_sp(model.module, torch.from_numpy(row).to(dev), model.cfg, seq,
                                        lengths=torch.tensor([audio[sp_index].size], device=dev))
    torch.cuda.synchronize()
    sp_s = time.perf_counter() - t0
    sp_launches = kernel_launches()
    shard_model(model, mesh=make_mesh(data=1, model=world, device_type="cuda"))
    local_heads = model.cfg.num_heads // model.module.encoder.blocks[0].attn.tp_size
    tp_cut = _tp_cut_faults(model.module, model.cfg, world)
    lps = [ctc_compute_logits_chunked(model, a) for a in audio]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    texts = list(ctc_infer(model_dir, subset, batch_size=TP_BATCH, tensor_parallel=world, device=dev,
                           dist_backend=backend, output_ids=True))
    torch.cuda.synchronize()
    tp_s = time.perf_counter() - t0
    out = dict(rank=rank, texts=texts, launches=kernel_launches(), sp_launches=sp_launches, tp_s=tp_s, sp_s=sp_s,
               load_s=load_s, local_heads=local_heads, tp_cut_faults=tp_cut,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if rank == 0:
        out["lps"] = lps
        out["lp_sp"] = lp_sp[0, : int(fl_sp[0])].float().cpu().numpy()
    return out


def _tp_cut_faults(module, cfg, world):
    """What shard_model failed to cut on a rank of `world`: every block's
    attention on num_heads / world heads with query / key / value
    column-parallel (out / world rows) and out row-parallel (in / world
    columns), fc1 column- and fc2 row-parallel the same way, lm_head
    column-parallel with its logits gathered. [] where all of it holds."""
    D, Fd, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    want = {"query": ("col", (D // world, D)), "key": ("col", (D // world, D)), "value": ("col", (D // world, D)),
            "out": ("row", (D, D // world)), "fc1": ("col", (Fd // world, D)), "fc2": ("row", (D, Fd // world))}
    faults = []
    for i, blk in enumerate(module.encoder.blocks):
        if blk.attn.tp_size != world or cfg.num_heads // blk.attn.tp_size != cfg.num_heads // world:
            faults.append(f"block {i}: attention tp_size {blk.attn.tp_size}, want {world}")
        for name, lin in (("query", blk.attn.query), ("key", blk.attn.key), ("value", blk.attn.value),
                          ("out", blk.attn.out), ("fc1", blk.mlp.fc1), ("fc2", blk.mlp.fc2)):
            mode = getattr(lin.tp, "mode", None)
            if (mode, tuple(lin.weight.shape)) != want[name]:
                faults.append(f"block {i} {name}: {mode} {tuple(lin.weight.shape)}, want {want[name]}")
    head = module.lm_head
    if (getattr(head.tp, "mode", None), tuple(head.weight.shape)) != ("gather", (V // world, D)):
        faults.append(f"lm_head: {getattr(head.tp, 'mode', None)} {tuple(head.weight.shape)}, want gather "
                      f"{(V // world, D)}")
    return faults


def _corr(a, b):
    import numpy as np

    return float(np.corrcoef(np.asarray(a).ravel(), np.asarray(b).ravel())[0, 1])


def run_tp_serving(torch, dev, root, model_dir, corpus, ids, lens, probe):
    """tp_serving and sp_serving: the xlsr directory over 4 files of the
    serving corpus (2 of 70-140 s at 7,001 frames, 2 of 12-28 s; batches
    of TP_BATCH files), on 2 gloo ranks sharing the card (the run fails
    where the probe found gloo short of all_reduce f32 or all_gather: one
    rank would cut nothing). Once through python -m torch.distributed.run
    -m ssak_tpu_torch.infer.ctc_infer --tensor_parallel 2, once through
    spawned ranks (_parallel_rank), the two at once. Held: every rank holds
    num_heads / 2 heads and the layers cut as the rules say
    (_tp_cut_faults); L1 forward on every rank, 24 a
    140 s encoder call, nothing else; rank 0's log-probs of each file
    correlated >= 0.999 with the unsharded bf16 model's; the sequence-
    parallel log-probs of a 140 s row (unfused attention over gathered keys,
    no kernel) >= 0.999 with compute_log_probas's (L1). Logged: the CER of
    each route against the unsharded transcripts, seconds, peak GiB."""
    import numpy as np

    from ssak_tpu_torch.audio import load_audio
    from ssak_tpu_torch.infer.ctc_infer import MAX_CHUNK_SAMPLES, ctc_compute_logits_chunked, padded_batch_shape
    from ssak_tpu_torch.infer.general import compute_log_probas, decode_log_probas, load_model
    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.models.layers import FLASH_MIN_SEQ

    gc.collect()
    torch.cuda.empty_cache()  # 2 + 2 ranks share the card with this process
    parent_gib = torch.cuda.memory_allocated() / 2**30
    world = probe["tp_world"]
    if world < 2:
        raise AssertionError(f"parallel probe: gloo on the card did not carry all_reduce f32 and all_gather, so "
                             f"tensor parallelism would run on one rank, where sharding cuts nothing: {probe['gloo']}")
    backend = "gloo"
    longs = [i for i, n in enumerate(lens) if 70 * 16000 <= n <= 140 * 16000][:2]
    shorts = [i for i, n in enumerate(lens) if 12 * 16000 <= n <= 28 * 16000][:2]
    sel = sorted(longs + shorts, key=lambda i: ids[i])  # a Kaldi dir is read in utterance order
    sp_index = sel.index(longs[0])
    with open(os.path.join(corpus, "wav.scp"), encoding="utf-8") as f:
        scp = dict(line.split(" ", 1) for line in f.read().splitlines())
    subset = os.path.join(root, "tp")
    os.makedirs(subset, exist_ok=True)
    with open(os.path.join(subset, "wav.scp"), "w", encoding="utf-8") as f:
        f.write("".join(f"{ids[i]} {scp[ids[i]]}\n" for i in sel))
    files = [scp[ids[i]] for i in sel]
    sel_lens = [lens[i] for i in sel]
    cfg = wav2vec2.make_config(SERVE_MODEL.split(":")[1])
    frames = [wav2vec2.feature_extract_output_length(cfg, padded_batch_shape(sel_lens[i : i + TP_BATCH], TP_BATCH)[1])
              for i in range(0, len(sel_lens), TP_BATCH)]  # batches of TP_BATCH files in utterance order
    long_calls = sum(fr >= FLASH_MIN_SEQ for fr in frames)

    model = load_model(model_dir, device=dev)
    model_heads = model.cfg.num_heads
    audio = [load_audio(p) for p in files]
    with torch.no_grad():
        ref_lps = [ctc_compute_logits_chunked(model, a) for a in audio]
        row = np.zeros((1, MAX_CHUNK_SAMPLES), np.float32)
        row[0, : audio[sp_index].size] = audio[sp_index]
        lp, fl = compute_log_probas(model, row, [audio[sp_index].size])
        ref_sp = lp[0, : int(fl[0])].float().cpu().numpy()
    ref_texts = [decode_log_probas(model, torch.from_numpy(lp)[None], [lp.shape[0]])[0] for lp in ref_lps]
    del model, lp
    gc.collect()
    torch.cuda.empty_cache()

    # the torchrun route runs beside the spawned ranks (its own process group on the same card): their
    # seconds overlap and are logged as such
    out_txt = os.path.join(root, "tp_torchrun.txt")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(world), "-m",
           "ssak_tpu_torch.infer.ctc_infer", subset, model_dir, "--tensor_parallel", str(world), "--dist_backend",
           backend, "--batch_size", str(TP_BATCH), "--output", out_txt]
    t0 = time.perf_counter()
    run = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn_ranks(_parallel_rank, world, backend, model_dir, subset, files, sp_index, backend, timeout=600)
        spawn_s = time.perf_counter() - t0
        _out, err = run.communicate(timeout=600)
    finally:
        if run.poll() is None:
            run.kill()
            run.communicate()
    torchrun_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"torchrun ctc_infer --tensor_parallel {world} failed:\n{err[-4000:]}")
    with open(out_txt, encoding="utf-8") as f:
        torchrun = [line.split(" ", 1) for line in f.read().splitlines()]
    if [u for u, _t in torchrun] != [ids[i] for i in sel]:
        raise AssertionError(f"torchrun ctc_infer wrote ids {[u for u, _t in torchrun]}, want {[ids[i] for i in sel]}")
    faults = {r["rank"]: r["tp_cut_faults"] for r in ranks if r["tp_cut_faults"]}
    if faults or any(r["local_heads"] != model_heads // world for r in ranks):
        raise AssertionError(f"shard_model on {world} ranks: local heads {[r['local_heads'] for r in ranks]} (want "
                             f"{model_heads // world}); layers not cut as the rules say: {faults}")
    want_l1 = 24 * long_calls
    for r in ranks:
        want = {k: 0 for k in r["launches"]}
        want["flash_attention"] = want_l1
        if r["launches"] != want or not want_l1 or any(r["sp_launches"].values()):
            raise AssertionError(f"tp rank {r['rank']}: launches {r['launches']} (want {want}), SP launches "
                                 f"{r['sp_launches']} (want none)")
    r0 = ranks[0]
    corr = [_corr(a, b) for a, b in zip(r0["lps"], ref_lps)]
    corr_sp = _corr(r0["lp_sp"], ref_sp)
    if [u for u, _t in r0["texts"]] != [ids[i] for i in sel] or any(r["texts"] for r in ranks[1:]):
        raise AssertionError(f"spawned ranks' transcripts: {[[u for u, _t in r['texts']] for r in ranks]}")
    texts = [t for _u, t in r0["texts"]]
    res = dict(world=world, backend=backend, probe_tp_world=probe["tp_world"], files=len(sel),
               seconds=[round(n / 16000, 2) for n in sel_lens], encoder_frames=frames, local_heads=r0["local_heads"],
               sp_seconds=round(sel_lens[sp_index] / 16000, 2),
               l1_launches_per_rank=[r["launches"]["flash_attention"] for r in ranks], log_prob_correlation=corr,
               cer_vs_unsharded=cer(ref_texts, texts), cer_torchrun_vs_unsharded=cer(ref_texts, [t for _u, t in torchrun]),
               torchrun_equals_spawned=[t for _u, t in torchrun] == texts, torchrun_s=torchrun_s, spawn_s=spawn_s,
               ctc_infer_s=[r["tp_s"] for r in ranks], load_s=[r["load_s"] for r in ranks],
               peak_gib=[r["peak_gib"] for r in ranks], parent_allocated_gib=parent_gib,
               sp=dict(seq=world, frames=int(ref_sp.shape[0]), correlation=corr_sp, s=[r["sp_s"] for r in ranks]))
    log(f"parallel tp_serving / sp_serving: {json.dumps(res)}")
    if min(corr) < 0.999 or corr_sp < 0.999 or len(texts) != len(sel):
        raise AssertionError(f"tp / sp serving out of tolerance: {res}")
    return res


PAR_BATCH, PAR_SECONDS = 8, 15.0  # wav2vec2-base training runs of the parallel slice: B=8 x 15 s (749 frames)


def _par_batch(torch, dev, seed, B=PAR_BATCH, seconds=PAR_SECONDS, U=120, V=32):
    import numpy as np

    rng = np.random.RandomState(seed)
    n = int(seconds * 16000)
    lens = np.full(B, n, np.int32)
    lens[1::2] = n - 16000 * rng.randint(1, 5, B // 2)
    audio = np.stack([tones(rng, seconds)[:n] for _ in range(B)]).astype(np.float32)
    audio[np.arange(n)[None, :] >= lens[:, None]] = 0
    lab_len = rng.randint(U // 2, U, B).astype(np.int32)
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    labels[np.arange(U)[None, :] >= lab_len[:, None]] = 0
    return {k: torch.from_numpy(v).to(dev) for k, v in
            dict(audio=audio, audio_lengths=lens, labels=labels, label_lengths=lab_len).items()}


def run_moe_training(torch, dev):
    """moe_training: a seeded wav2vec2-base (d=768, 12 layers, FFN 3,072)
    with 4 experts, top 2, capacity 1.25, sharded by WAV2VEC2_MOE_RULES
    over a ('data', 'expert') mesh of one NCCL rank and stepped through
    shard_train_step(make_ctc_train_step(moe_aux_weight=0.01)), B=8 x 15 s
    (S = 5,992 tokens, C = 3,752), 4 steps. Held: K1 4 launches and
    nothing else, finite losses. Logged: step ms (2-4), peak GiB, the
    dropped share of (token, choice) pairs per layer."""
    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.parallel.mesh import make_mesh, shard_params
    from ssak_tpu_torch.parallel.moe import capacity
    from ssak_tpu_torch.parallel.sharding import WAV2VEC2_MOE_RULES
    from ssak_tpu_torch.train import steps as TS

    tmp = _world1(torch, "moe")
    try:
        cfg = wav2vec2.make_config("base", num_experts=4, moe_top_k=2)
        model = wav2vec2.init_params(cfg, seed=0, device=dev)
        mesh = make_mesh(data=1, model=1, names=("data", "expert"), device_type="cuda")
        shard_params(model, mesh, WAV2VEC2_MOE_RULES, num_heads=cfg.num_heads)
        batch = _par_batch(torch, dev, seed=41)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt = TS.make_optimizer(learning_rate=1e-4, warmup_steps=1, total_steps=10)
        state = TS.init_train_state(model, opt)
        step = TS.shard_train_step(TS.make_ctc_train_step(cfg, opt, moe_aux_weight=0.01), mesh)
        reset_counts()
        marks, metrics = [], []
        for _ in range(4):
            state, m = step(state, batch)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            metrics.append(m)
        torch.cuda.synchronize()
        launches = kernel_launches()
        losses = [float(m["loss"]) for m in metrics]
        frames = wav2vec2.feature_extract_output_length(cfg, int(PAR_SECONDS * 16000))
        S = PAR_BATCH * frames
        dropped = [float(1.0 - b.moe.last_route[1].float().mean()) for b in model.encoder.blocks]
        step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        res = dict(experts=cfg.num_experts, top_k=cfg.moe_top_k, tokens=S, capacity=capacity(S, 4, 2, 1.25),
                   frames=frames, losses=losses, grad_norms=[float(m["grad_norm"]) for m in metrics],
                   step_ms=sum(step_ms) / len(step_ms), step_ms_each=step_ms,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, dropped_share_per_layer=dropped,
                   launches=launches)
        log(f"parallel moe_training: {json.dumps(res)}")
        want = {k: 0 for k in launches}
        want["ctc_fused"] = 4
        if launches != want or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"moe_training: launches {launches} (want {want}) or losses {losses}")
        del state, model, step
        return res
    finally:
        _end_world1(tmp)
        gc.collect()
        torch.cuda.empty_cache()


def run_pp_training(torch, dev):
    """pp_training: make_pp_ctc_train_step at wav2vec2-base widths over a
    ('data', 'pipe') mesh of one NCCL rank, 2 microbatches, B=8 x 15 s, 3
    steps. Held: K1 3 launches and nothing else; the first step's loss
    within 1e-2 (relative) of the unpipelined forward's on the same batch
    and weights (bf16: microbatches of 4 rows)."""
    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.ops.ctc_fused import ctc_loss_fast
    from ssak_tpu_torch.parallel.mesh import make_mesh
    from ssak_tpu_torch.parallel.pipeline import make_pp_ctc_train_step, shard_pp_params
    from ssak_tpu_torch.train import steps as TS

    tmp = _world1(torch, "pp")
    try:
        cfg = wav2vec2.make_config("base")
        model = wav2vec2.init_params(cfg, seed=1, device=dev)
        batch = _par_batch(torch, dev, seed=42)
        with torch.no_grad():
            lp, fl = wav2vec2.ctc_log_probs(model, batch["audio"], cfg, batch["audio_lengths"])
            dense_loss = float(ctc_loss_fast(lp, fl, batch["labels"], batch["label_lengths"]))
        del lp
        mesh = make_mesh(data=1, model=1, names=("data", "pipe"), device_type="cuda")
        shard_pp_params(model, mesh)
        opt = TS.make_optimizer(learning_rate=1e-4, warmup_steps=1, total_steps=10)
        state = TS.init_train_state(model, opt)
        step = make_pp_ctc_train_step(cfg, opt, mesh, n_microbatches=2)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        marks, metrics = [], []
        for _ in range(3):
            state, m = step(state, batch)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            metrics.append(m)
        torch.cuda.synchronize()
        launches = kernel_launches()
        losses = [float(m["loss"]) for m in metrics]
        step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        rel = abs(losses[0] - dense_loss) / abs(dense_loss)
        res = dict(pipe=1, microbatches=2, losses=losses, dense_first_loss=dense_loss, first_loss_rel=rel,
                   step_ms=sum(step_ms) / len(step_ms), step_ms_each=step_ms,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)
        log(f"parallel pp_training: {json.dumps(res)}")
        want = {k: 0 for k in launches}
        want["ctc_fused"] = 3
        if launches != want or rel > 1e-2 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"pp_training out of tolerance: {res}")
        del state, model, step
        return res
    finally:
        _end_world1(tmp)
        gc.collect()
        torch.cuda.empty_cache()


def check_moe_train_step_card_vs_cpu(torch, dev):
    """One MoE wav2vec2 train step on the card and on the CPU in f32 from
    the same weights: base widths (d=768, FFN 3,072, 4 experts, top 2), 2
    layers, batch 2 x 4 s. Loss to 1e-4 relative and grad_norm to 1e-3, as
    the dense f32 steps; every layer routes the same tokens to the same
    experts and keeps the same ones."""
    import numpy as np

    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.models.convert import wav2vec2_from_tree, wav2vec2_to_tree
    from ssak_tpu_torch.train import steps as TS

    cfg = wav2vec2.make_config("base", num_layers=2, num_experts=4, moe_top_k=2, dtype="float32")
    tree = wav2vec2_to_tree(wav2vec2.init_params(cfg, seed=8))
    rng = np.random.RandomState(4)
    n = 64000
    lens = np.array([n, 48000], np.int32)
    audio = (0.1 * rng.randn(2, n)).astype(np.float32)
    audio[np.arange(n)[None, :] >= lens[:, None]] = 0
    lab_len = np.array([50, 40], np.int32)
    labels = rng.randint(1, 32, (2, 64)).astype(np.int32)
    labels[np.arange(64)[None, :] >= lab_len[:, None]] = 0
    out = {}
    for where in ("cpu", dev):
        batch = {k: torch.from_numpy(v.copy()).to(where) for k, v in
                 dict(audio=audio, audio_lengths=lens, labels=labels, label_lengths=lab_len).items()}
        opt = TS.make_optimizer(learning_rate=1e-4, warmup_steps=1, total_steps=10)
        state = TS.init_train_state(wav2vec2_from_tree(tree, where), opt)
        state, m = TS.make_ctc_train_step(cfg, opt, moe_aux_weight=0.01)(state, batch)
        routes = [tuple(t.cpu() for t in b.moe.last_route) for b in state["model"].encoder.blocks]
        out[str(where)] = (m["loss"].item(), m["grad_norm"].item(), routes)
        del state
    (lc, gc_, rc), (lg, gg, rg) = out["cpu"], out[str(dev)]
    same = [bool(torch.equal(a[1], b[1]) and torch.equal(a[0][a[1]], b[0][b[1]])) for a, b in zip(rg, rc)]
    res = dict(loss_rel=abs(lg - lc) / abs(lc), grad_norm_rel=abs(gg - gc_) / abs(gc_), same_routing_per_layer=same,
               kept_share=[float(r[1].float().mean()) for r in rg], card=[lg, gg], cpu=[lc, gc_])
    log(f"moe train step card vs cpu: {json.dumps(res)}")
    if not (res["loss_rel"] <= 1e-4 and res["grad_norm_rel"] <= 1e-3 and all(same)):
        raise AssertionError(f"moe train step card vs cpu out of tolerance: {res}")
    return res


# --- phase 3: Whisper tensor-parallel decode (slice 8h) --------------------------------------------

WTP_FILES, WTP_ACC_FILES = 4, 2  # greedy over 4 files of 29 s; --accurate over 2 of 20 s; long-form over 1 of 70 s
WTP_TOKENS = [50258, 50364, 440, 1000, 25000, 7]  # teacher-forced: sot, no_timestamps, then text ids
WTP_LAYERS = 2  # the accurate and long-form runs' depth (+ as many encoder blocks): a tp step costs ~20 ms a layer


def wtp_mel(torch):
    """The teacher-forced input of whisper_tp: two 30 s rows of seeded tones, (2, 128, 3000) on the CPU."""
    import numpy as np

    from ssak_tpu_torch.ops.logmel import log_mel_spectrogram

    rng = np.random.RandomState(11)
    return log_mel_spectrogram(torch.from_numpy(np.stack([tones(rng, 30.0) for _ in range(2)])), n_mels=128)


def _scp_paths(kaldi_dir):
    with open(os.path.join(kaldi_dir, "wav.scp"), encoding="utf-8") as f:
        return [line.split(" ", 1)[1] for line in f.read().splitlines()]


class K4Heads:
    """Records the heads (H of q (B, H, Dh)) of every K4 call that
    models.layers makes while installed."""

    def __init__(self):
        from ssak_tpu_torch.models import layers as L

        self.L, self.orig, self.heads = L, L.flash_decode_attention, set()

    def __enter__(self):
        def call(q, *a, **kw):
            self.heads.add(int(q.shape[1]))
            return self.orig(q, *a, **kw)

        self.L.flash_decode_attention = call
        return self

    def __exit__(self, *exc):
        self.L.flash_decode_attention = self.orig


class ShardedModels:
    """Keeps each model that infer.general.shard_model shards (whisper_infer
    calls it through the module) while installed."""

    def __init__(self):
        from ssak_tpu_torch.infer import general

        self.general, self.orig, self.models = general, general.shard_model, []

    def __enter__(self):
        def call(model, *a, **kw):
            self.models.append(model)
            return self.orig(model, *a, **kw)

        self.general.shard_model = call
        return self

    def __exit__(self, *exc):
        self.general.shard_model = self.orig


def _wtp_run(torch, fn):
    """fn() with the counters at 0, the K4 heads and the tokenizer's
    decode calls recorded: (its result, launches, decode steps, K4 heads,
    the decoded ids in order, seconds)."""
    torch.cuda.synchronize()
    reset_counts()
    with K4Heads() as heads, Decodes() as decodes:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    launches, steps = decode_launches()
    return out, dict(launches=launches, steps=steps, k4_heads=sorted(heads.heads),
                     ids=[ids for ids, _ in decodes.calls], s=sec)


def _wtp_cut(m):
    """How shard_model cut a Whisper model on this rank: the heads of every
    attention, the embedding's rows, whether any q/k/v was fused."""
    enc, dec, cfg = m.module.encoder, m.module.decoder, m.cfg
    return dict(heads=sorted({cfg.n_text_head // b.attn.tp_size for b in dec.blocks}
                             | {cfg.n_text_head // b.cross_attn.tp_size for b in dec.blocks}
                             | {cfg.n_audio_head // b.attn.tp_size for b in enc.blocks}),
                embedding_rows=int(dec.token_embedding.shape[0]), vocab_tp=getattr(dec.vocab_tp, "mode", None),
                fused=any(hasattr(b.attn, "qkv") for b in dec.blocks))


def _whisper_tp_rank(torch, rank, world, model_dir, dir22, kaldi4, kaldi_acc, long_audio):
    """One rank of whisper_tp on the shared card. At full depth: greedy bf16
    through whisper_infer(tensor_parallel=world) over the 4 files, then the
    model it sharded (10 heads and 25,933 embedding rows a rank) teacher-
    forced on wtp_mel; int8 greedy through whisper_infer(quantize_bits=8,
    tensor_parallel=world). On the 2 + 2-block directory in bf16, sharded by
    shard_model: the --accurate chain (beam 5, best_of 5, the temperature
    fallback) over 2 files and the long-form seek loop over a 70 s file at
    T = 0 (whisper_infer's path for a long file without --accurate), 32
    tokens a window; the same directory in f32, sharded, its decode_train
    logits. Each run's launches, decode steps, K4 heads and decoded ids."""
    from ssak_tpu_torch.audio import load_audio
    from ssak_tpu_torch.infer.general import load_model, shard_model
    from ssak_tpu_torch.infer.whisper_infer import transcribe_longform_batch, whisper_infer, whisper_transcribe_batch
    from ssak_tpu_torch.models import whisper as W

    dev = torch.device("cuda", 0)
    kw = dict(tensor_parallel=world, dist_backend="gloo", device=dev, max_tokens=MAX_TOKENS, output_ids=True)
    out = {"rank": rank}
    for run, bits in (("greedy", 0), ("int8", 8)):
        t0 = time.perf_counter()
        with ShardedModels() as sharded:
            it = whisper_infer(model_dir, kaldi4, quantize_bits=bits, **kw)
        out[f"{run}_load_s"] = time.perf_counter() - t0
        texts, out[run] = _wtp_run(torch, lambda: list(it))
        m = sharded.models[0]
        out[run].update(texts=texts, cut=_wtp_cut(m))
        if run == "greedy":
            out["sharded"] = teacher_forced_logits(torch, m.module, m.cfg, wtp_mel(torch).to(dev), WTP_TOKENS).numpy()
        del it, m, sharded
        gc.collect()
        torch.cuda.empty_cache()

    m = load_model(dir22, device=dev)
    m.module.to(torch.bfloat16)
    shard_model(m, model_axis=world)
    acc = [load_audio(f) for f in _scp_paths(kaldi_acc)]
    with DecodeCalls() as rec:
        _, out["accurate"] = _wtp_run(torch, lambda: whisper_transcribe_batch(
            m, acc, beam_size=5, best_of=5, temperature_fallback=True, max_tokens=MAX_TOKENS))
    out["accurate"].update(decode_calls=rec.calls, cut=_wtp_cut(m))
    with DecodeCalls() as rec:
        lf, out["longform"] = _wtp_run(torch, lambda: transcribe_longform_batch(m, [long_audio], temperatures=(0.0,),
                                                                                max_tokens=MAX_TOKENS))
    out["longform"].update(decode_calls=len(rec.calls), segments=len(lf[0]["segments"]), cut=_wtp_cut(m))
    del m
    m = load_model(dir22, device=dev)
    m.module.float()
    cfg = dataclasses.replace(m.cfg, dtype="float32")
    shard_model(m, model_axis=world)
    x = wtp_mel(torch).to(dev)
    toks = torch.tensor([WTP_TOKENS] * x.shape[0], device=dev)
    with torch.inference_mode():
        out["f32_22"] = W.decode_train(m.module, toks, W.encode(m.module, x, cfg), cfg).float().cpu().numpy()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if rank:
        del out["sharded"], out["f32_22"]
    return out


def run_whisper_tp(torch, dev, root, model_dir, corpus, acc_dir, bf16_texts, whole):
    """whisper_tp: Whisper large-v3 served tensor-parallel by 2 gloo ranks
    sharing the card (NCCL refuses two ranks on one device; the times say
    nothing of NVLink), spawned (_whisper_tp_rank): greedy bf16 and int8
    over 4 files of 29 s (32 tokens) at full width and depth (32 + 32
    blocks, 10 heads and 25,933 embedding rows a rank in bf16); --accurate
    over 2 files of 20 s and long-form over one of 70 s on a directory of
    large-v3's widths cut to WTP_LAYERS + WTP_LAYERS blocks (a step of two
    ranks sharing the card costs ~0.64 s at full depth). Beside them, python
    -m torch.distributed.run -m ssak_tpu_torch.infer.whisper_infer
    --tensor_parallel 2 --dist_backend gloo on that cut directory (the CLI
    decodes ssak_tpu's 224-token budget). Held: K4 bf16 on 10 heads, 2 a
    layer and decode step on every rank, nothing else in bf16; K2 8 and K4
    int8 2 a layer and step on 20 heads in int8 (the quantized units
    whole, only the embedding cut); both ranks decode the same ids in every
    run; the full-depth sharded teacher-forced logits correlate >= 0.999
    with the whole model's on the card (`whole`, prepare_whisper_dir's);
    the cut model in f32, sharded on the card, within 1e-4 of its largest
    logit of the port unsharded on the CPU; the CLI's rank 0 writes one
    line a file. Logged: agreement with the single-card bf16 transcripts
    of the same files, seconds, peak GiB."""
    import numpy as np

    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.models import whisper as W

    t_start = time.perf_counter()
    world = 2
    kaldi4 = kaldi_subset(os.path.join(root, "wtp4"), corpus, WTP_FILES)
    kaldi_acc = kaldi_subset(os.path.join(root, "wtp_acc"), acc_dir, WTP_ACC_FILES)
    long_audio = tones(np.random.RandomState(5), LF_SECONDS)  # run_longform's first file
    dir22 = os.path.join(root, "whisper-large-v3-cut")
    cfg22 = W.make_config("large-v3", n_audio_layer=WTP_LAYERS, n_text_layer=WTP_LAYERS)
    write_whisper_dir(dir22, seeded_tree(cfg22, seed=1), cfg22)
    cpu = load_model(dir22, device="cpu")
    cpu.module.float()
    cpu_cfg = dataclasses.replace(cpu.cfg, dtype="float32")
    with torch.inference_mode():
        x = wtp_mel(torch)
        ref22 = W.decode_train(cpu.module, torch.tensor([WTP_TOKENS] * 2), W.encode(cpu.module, x, cpu_cfg),
                               cpu_cfg).numpy()
    del cpu
    gc.collect()
    prep_s = time.perf_counter() - t_start

    out_txt = os.path.join(root, "wtp_torchrun.txt")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(world), "-m",
           "ssak_tpu_torch.infer.whisper_infer", kaldi4, dir22, "--tensor_parallel", str(world), "--dist_backend",
           "gloo", "--output", out_txt]
    t0 = time.perf_counter()
    run = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn_ranks(_whisper_tp_rank, world, "gloo", model_dir, dir22, kaldi4, kaldi_acc, long_audio,
                            timeout=600)
        spawn_s = time.perf_counter() - t0
        _out, err = run.communicate(timeout=600)
    finally:
        if run.poll() is None:
            run.kill()
            run.communicate()
    torchrun_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"torchrun whisper_infer --tensor_parallel {world} failed:\n{err[-4000:]}")
    with open(out_txt, encoding="utf-8") as f:
        cli_lines = [line.split(" ", 1) for line in f.read().splitlines()]
    want_ids = [os.path.basename(f)[:-4] for f in _scp_paths(kaldi4)]
    if [u for u, *_t in cli_lines] != want_ids:
        raise AssertionError(f"torchrun whisper_infer wrote ids {[u for u, *_t in cli_lines]}, want {want_ids}")

    runs = (("greedy", 0, 32), ("int8", 8, 32), ("accurate", 0, WTP_LAYERS), ("longform", 0, WTP_LAYERS))
    faults = []
    for r in ranks:
        for run_name, bits, layers in runs:
            got, cut = r[run_name], r[run_name]["cut"]
            want = want_decode(bits, got["steps"], layers=layers)
            heads = [20] if bits else [TP_HEADS]
            if got["launches"] != want or not got["steps"] or got["k4_heads"] != heads:
                faults.append(f"rank {r['rank']} {run_name}: launches {got['launches']} (want {want}, "
                              f"{got['steps']} steps), K4 heads {got['k4_heads']} (want {heads})")
            # bf16: every attention on 10 heads; int8: quantized units whole (20 heads); the embedding cut in both
            if (cut["heads"] != ([20] if bits else [TP_HEADS]) or cut["fused"] or cut["vocab_tp"] != "vocab"
                    or cut["embedding_rows"] != 51866 // world):
                faults.append(f"rank {r['rank']} {run_name}: cut {cut}")
    for run_name, *_ in runs:
        if ranks[0][run_name]["ids"] != ranks[1][run_name]["ids"] or not ranks[0][run_name]["ids"]:
            faults.append(f"{run_name}: the ranks decoded different ids")
    for run_name in ("greedy", "int8"):
        if [u for u, _t in ranks[0][run_name]["texts"]] != want_ids or ranks[1][run_name]["texts"]:
            faults.append(f"{run_name}: rank 0 yields {[u for u, _t in ranks[0][run_name]['texts']]}, rank 1 "
                          f"{len(ranks[1][run_name]['texts'])} items")
    r0 = ranks[0]
    corr = _corr(r0["sharded"], whole.numpy())
    err22 = float(np.abs(r0["f32_22"] - ref22).max())
    tol22 = 1e-4 * float(np.abs(ref22).max())
    tp_texts = [t for _u, t in r0["greedy"]["texts"]]
    names = [n for n, *_ in runs]
    res = dict(world=world, backend="gloo", local_heads=TP_HEADS, embedding_rows=r0["greedy"]["cut"]["embedding_rows"],
               files=dict(greedy=WTP_FILES, int8=WTP_FILES, accurate=WTP_ACC_FILES, longform=1),
               layers={n: layers for n, _b, layers in runs},
               decode_steps={k: r0[k]["steps"] for k in names},
               launches_per_rank={k: [r[k]["launches"] for r in ranks] for k in names},
               run_s={k: [r[k]["s"] for r in ranks] for k in names},
               step_ms={k: 1e3 * r0[k]["s"] / r0[k]["steps"] for k in names},
               greedy_audio_s_per_s=WTP_FILES * FILE_SECONDS / r0["greedy"]["s"],
               accurate_decode_calls=r0["accurate"]["decode_calls"], longform_decode_calls=r0["longform"]["decode_calls"],
               longform_segments=r0["longform"]["segments"], load_s=[r["greedy_load_s"] for r in ranks],
               int8_load_s=[r["int8_load_s"] for r in ranks], teacher_forced_correlation=corr, f32_cut_max_err=err22,
               f32_cut_tol=tol22, greedy_texts_equal_single_card=sum(a == b for a, b in zip(tp_texts, bf16_texts)),
               peak_gib=[r["peak_gib"] for r in ranks], prep_s=prep_s, spawn_s=spawn_s, torchrun_s=torchrun_s,
               seconds=time.perf_counter() - t_start)
    log(f"slice whisper_tp {json.dumps(res)}")
    if faults or not corr >= 0.999 or not err22 <= tol22:
        raise AssertionError(f"whisper_tp: {faults}; correlation {corr} (>= 0.999), f32 cut model max|err| {err22} "
                             f"(<= {tol22})")
    return res


# --- phase 4: the whole path, card against CPU -----------------------------------


def seeded_tree(cfg, seed=0):
    """An ssak_tpu-layout Whisper parameter tree with numpy leaves (dense
    kernels (in, out), conv kernels (K, Cin, Cout)), random from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def lin(d_in, d_out, bias=True):
        p = {"kernel": (rng.standard_normal((d_in, d_out), dtype=np.float32) / np.float32(math.sqrt(d_in)))}
        if bias:
            p["bias"] = (rng.standard_normal(d_out, dtype=np.float32) * np.float32(0.02))
        return p

    def ln(d):
        return {"scale": 1 + 0.1 * rng.standard_normal(d, dtype=np.float32), "bias": 0.1 * rng.standard_normal(d, dtype=np.float32)}

    def attn(d):
        return {"query": lin(d, d), "key": lin(d, d, bias=False), "value": lin(d, d), "out": lin(d, d)}

    def block(d, cross):
        p = {"attn_ln": ln(d), "attn": attn(d), "mlp_ln": ln(d), "mlp": {"fc1": lin(d, 4 * d), "fc2": lin(4 * d, d)}}
        if cross:
            p["cross_attn_ln"], p["cross_attn"] = ln(d), attn(d)
        return p

    def conv(k, c_in, c_out):
        return {"kernel": rng.standard_normal((k, c_in, c_out), dtype=np.float32) / np.float32(math.sqrt(k * c_in)),
                "bias": np.zeros(c_out, np.float32)}

    d = cfg.n_audio_state
    return {
        "encoder": {"conv1": conv(3, cfg.n_mels, d), "conv2": conv(3, d, d),
                    "blocks": [block(d, False) for _ in range(cfg.n_audio_layer)], "ln_post": ln(d)},
        "decoder": {"token_embedding": rng.standard_normal((cfg.n_vocab, d), dtype=np.float32) * np.float32(0.02),
                    "positional_embedding": rng.standard_normal((cfg.n_text_ctx, d), dtype=np.float32) * np.float32(0.01),
                    "blocks": [block(d, True) for _ in range(cfg.n_text_layer)], "ln": ln(d)},
    }


def teacher_forced_logits(torch, model, cfg, mel, tokens):
    from ssak_tpu_torch.models import whisper as W

    with torch.inference_mode():
        af = W.encode(model, mel, cfg)
        kv = W.precompute_cross_kv(model, af, cfg)
        caches = W.init_cache(cfg, mel.shape[0], device=mel.device, model=model)
        out = []
        for pos, tok in enumerate(tokens):
            token = torch.full((mel.shape[0], 1), tok, dtype=torch.int64, device=mel.device)
            logits, caches = W._decode_step(model, token, pos, caches, kv, cfg)
            out.append(logits.float().cpu())
    return torch.stack(out)


def check_card_vs_cpu(torch, dev):
    import numpy as np

    from ssak_tpu_torch.models import whisper as W
    from ssak_tpu_torch.models.convert import whisper_from_tree
    from ssak_tpu_torch.models.quant import quantize_params
    from ssak_tpu_torch.ops.logmel import log_mel_spectrogram

    cfg32 = W.make_config("large-v3", n_audio_layer=2, n_text_layer=2, dtype="float32")
    tree = seeded_tree(cfg32)
    rng = np.random.RandomState(1)
    audio = torch.from_numpy((0.1 * rng.randn(2, 480000)).astype(np.float32))
    mel = log_mel_spectrogram(audio, n_mels=cfg32.n_mels)
    tokens = [cfg32.sot, cfg32.no_timestamps, 440, 1000, 25000, 7]
    res = {}
    for bits in (0, 8, 4):
        cpu_model = whisper_from_tree(tree, "cpu")
        card_model = whisper_from_tree(tree, dev)
        cfg_cpu, cfg_card = cfg32, dataclasses.replace(cfg32, dtype="bfloat16")
        if bits:
            quantize_params(cpu_model, bits=bits)
            quantize_params(card_model, bits=bits)
            cfg_cpu = dataclasses.replace(cfg_cpu, kv_int8=True)
            cfg_card = dataclasses.replace(cfg_card, kv_int8=True)
        else:
            card_model.to(torch.bfloat16)
        W.fuse_decode_qkv(card_model)
        ref = teacher_forced_logits(torch, cpu_model, cfg_cpu, mel, tokens)
        got = teacher_forced_logits(torch, card_model, cfg_card, mel.to(dev), tokens)
        if not (torch.isfinite(got).all() and got.shape == ref.shape == (len(tokens), 2, cfg32.n_vocab)):
            raise AssertionError(f"card logits bad: shape {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        corr = float(np.corrcoef(got.flatten().numpy(), ref.flatten().numpy())[0, 1])
        need = 0.99 if bits else 0.999
        tag = {0: "bf16", 8: "int8", 4: "int4"}[bits]
        log(f"card vs cpu {tag}: correlation {corr:.6f} (need >= {need}), max|diff| {float((got - ref).abs().max()):.4g}")
        if not corr >= need:
            raise AssertionError(f"card vs cpu {tag}: correlation {corr} < {need}")
        res[tag] = corr
        if bits == 4:
            res["int4_window"] = check_window_card_vs_cpu(torch, cpu_model, card_model, cfg_cpu, cfg_card, mel, need)
        del cpu_model, card_model
        gc.collect()
    return res


def check_window_card_vs_cpu(torch, cpu_model, card_model, cfg_cpu, cfg_card, mel, need):
    """decode_window at T = 0 on the int4 weights, card against CPU: the
    long-form prompt buffer without timestamps (P = 226, sot sequence
    [sot, no_timestamps]) with one bare and one conditioned prompt. The
    no-speech probe logits (at sot) and the logits the first token is
    sampled from (at no_timestamps) must correlate as the teacher-forced
    ones do; the
    no-speech probabilities (a softmax entry of the probe) are printed
    beside each other and held to 25% of each other: in an f32 config K3
    still rounds x and the weights to bf16, and the CPU's dequantize path
    does not, so exact agreement is not expected."""
    import numpy as np

    from ssak_tpu_torch.models import whisper as W

    sot_seq = [cfg_cpu.sot, cfg_cpu.no_timestamps]
    P = cfg_cpu.n_text_ctx // 2 + len(sot_seq)
    buf = np.full((2, P), cfg_cpu.eot, np.int32)
    cond = [cfg_cpu.sot_prev] + list(np.random.RandomState(2).randint(0, cfg_cpu.eot, min(40, P - 3))) + sot_seq
    buf[0, -2:] = sot_seq
    buf[1, P - len(cond):] = cond
    plen = np.array([2, len(cond)], np.int32)
    out = {}
    for where, model, cfg in (("cpu", cpu_model, cfg_cpu), ("card", card_model, cfg_card)):
        m = mel.to(next(model.parameters()).device)
        with torch.inference_mode():
            last, probe = W.window_prompt_forward(model, m, buf, plen, cfg, len(sot_seq))[:2]
        toks, lengths, lp, nsp = W.decode_window(model, m, buf, plen, cfg, sot_distance=len(sot_seq), max_tokens=4)
        out[where] = (last.float().cpu(), probe.float().cpu(), nsp.float().cpu(), toks.cpu())
    (lc, pc, nc, tc), (lg, pg, ng, tg) = out["cpu"], out["card"]
    corr_first = float(np.corrcoef(lg.flatten().numpy(), lc.flatten().numpy())[0, 1])
    corr_probe = float(np.corrcoef(pg.flatten().numpy(), pc.flatten().numpy())[0, 1])
    nsp_rel = float(((ng - nc).abs() / nc.abs().clamp(min=1e-30)).max())
    res = dict(first_step_correlation=corr_first, probe_correlation=corr_probe, no_speech_card=ng.tolist(),
               no_speech_cpu=nc.tolist(), no_speech_rel=nsp_rel, tokens_card=tg.tolist(), tokens_cpu=tc.tolist())
    log(f"card vs cpu int4 decode_window: {json.dumps(res)}")
    if not (corr_first >= need and corr_probe >= need and nsp_rel <= 0.25 and torch.isfinite(lg).all()):
        raise AssertionError(f"card vs cpu int4 decode_window out of tolerance: {res}")
    return res


SERVE_PARITY_LAYERS = 1  # 2 until the tensor-parallel Whisper run came (the script's time limit)


def check_ctc_serving_card_vs_cpu(torch, dev):
    """CTC log-probs of one 140 s row (a 135 s file padded to the bucket,
    7,001 frames) on the card against the CPU, same seeded weights: xlsr
    widths at SERVE_PARITY_LAYERS layers in bf16, the dtype in which the
    card's encoder attention goes through L1 (one launch a layer) while the
    CPU runs the unfused
    attention; a spy on layers._can_flash asserts each attention call's
    route. The valid frames' log-probs must correlate >= 0.999; the share
    of frames with the same argmax is reported."""
    import numpy as np

    from ssak_tpu_torch.infer.ctc_infer import MAX_CHUNK_SAMPLES
    from ssak_tpu_torch.models import layers as L
    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.ops import flash_attention as L1

    cfg = wav2vec2.make_config("xlsr", num_layers=SERVE_PARITY_LAYERS, vocab_size=48)
    audio = tones(np.random.RandomState(9), 135.0)
    x = np.zeros((1, MAX_CHUNK_SAMPLES), np.float32)
    x[0, : audio.size] = audio
    out = {}
    routes = []  # (device, compute dtype, q dtype, q shape, routed to L1) of each attention call
    can_flash = L._can_flash

    def route_spy(q, dtype):
        routed = can_flash(q, dtype)
        routes.append((str(q.device), str(dtype), str(q.dtype), tuple(q.shape), routed))
        return routed

    for where in ("cpu", dev):
        model = wav2vec2.init_params(cfg, seed=0, device=where)
        n0 = L1.LAUNCHES["flash_attention"]
        L._can_flash = route_spy
        try:
            with torch.no_grad():
                lp, fl = wav2vec2.ctc_log_probs(model, torch.from_numpy(x).to(where), cfg,
                                                torch.tensor([audio.size], device=where))
        finally:
            L._can_flash = can_flash
        out[str(where)] = (lp.float().cpu(), int(fl[0]), L1.LAUNCHES["flash_attention"] - n0)
        del model, lp
        gc.collect()
    (cpu_lp, cpu_fl, cpu_l1), (card_lp, card_fl, card_l1) = out["cpu"], out[str(dev)]
    # every attention call's route: the CPU's unfused, the card's through L1
    want_routes = [("cpu", False)] * cfg.num_layers + [(str(dev), True)] * cfg.num_layers
    if [(r[0], r[4]) for r in routes] != want_routes:
        raise AssertionError(f"ctc card vs cpu: attention routes {routes}, want (device, routed) {want_routes}")
    if not (cpu_fl == card_fl == wav2vec2.feature_extract_output_length(cfg, audio.size) and cpu_l1 == 0
            and card_l1 == cfg.num_layers and card_lp.shape == (1, 7001, 48) and torch.isfinite(card_lp).all()):
        raise AssertionError(f"ctc card vs cpu: frames {cpu_fl}/{card_fl}, L1 launches cpu {cpu_l1} card {card_l1}, "
                             f"shape {tuple(card_lp.shape)}; attention routes {routes}")
    a, b = card_lp[0, :card_fl], cpu_lp[0, :cpu_fl]
    corr = float(np.corrcoef(a.flatten().numpy(), b.flatten().numpy())[0, 1])
    res = dict(frames=card_fl, correlation=corr, argmax_agreement=float((a.argmax(-1) == b.argmax(-1)).float().mean()),
               max_abs_diff=float((a - b).abs().max()), l1_launches=card_l1)
    log(f"ctc serving card vs cpu (xlsr widths, {cfg.num_layers} layers, bf16, 140 s row): {json.dumps(res)}")
    if not corr >= 0.999:
        raise AssertionError(f"ctc serving card vs cpu: correlation {corr} < 0.999")
    return res


DENSE_SHAPE = (4, 6999, 1024, 4096)  # (B, T, d_in, d_out): xlsr's FFN up-projection at the 140 s bucket


def bf16_steps(torch, got, ref):
    """|got - ref| in bf16 steps at |ref|, at no less than 2^-12 of the
    largest |ref| (an output near zero is a cancelled sum whose last f32
    bits span several of its own steps; tests/test_torch_dense_rounding.py)."""
    ref, got = ref.float(), got.float()
    exp = torch.floor(torch.log2(torch.maximum(ref.abs(), 2.0**-12 * ref.abs().max())))
    return (got - ref).abs() / torch.exp2(exp - 7)


def check_dense_card_vs_cpu(torch, dev):
    """layers.dense in bf16 with an f32 bias at xlsr widths (x 4 x 6,999 x
    1,024 -> 4,096, weights N(0, 1/1,024), bias N(0, 0.25)): the card's
    (one GEMM with an f32 result, then one pass that adds the bias and
    rounds on the store) against the port on the CPU (the bf16 operands
    widened to f32) and against the f64 product of the bf16 operands plus
    the bias, rounded once; each equal in >= 99.9% of the outputs and the
    rest one bf16 step apart; bit for bit the same product with the f32
    sum cast afterwards (the form dense keeps for autograd), and timed
    beside it, the parent's form (a bf16 product
    rounded to bf16, the bias added, rounded again) and the bf16 product
    alone, in this call."""
    from ssak_tpu_torch.models import layers as L

    B, T, D, N = DENSE_SHAPE
    g = torch.Generator().manual_seed(21)
    x = torch.randn(B, T, D, generator=g)
    w = torch.randn(N, D, generator=g) / math.sqrt(D)
    b = torch.randn(N, generator=g) * 0.5
    bf = torch.bfloat16
    lin = L.Linear(w.to(dev, bf), b.to(dev))
    xb = x.to(dev, bf)
    y_card = L.dense(xb, lin, bf)
    y_cpu = L.dense(x, L.Linear(w, b), bf).to(dev)
    wb = lin.weight.t()
    y_f64 = (torch.matmul(xb.double(), wb.double()) + lin.bias.double()).to(bf)
    res = dict(shape=list(DENSE_SHAPE))
    for name, ref in (("cpu", y_cpu), ("f64", y_f64)):
        steps = bf16_steps(torch, y_card, ref)
        res[f"equal_share_vs_{name}"] = float((steps == 0).float().mean())
        res[f"max_steps_vs_{name}"] = float(steps.max())
    del y_cpu, y_f64

    def twice(xx, ww, bb):  # the parent's dense: the bf16 product rounded, the bias added, rounded again
        return (torch.matmul(xx, ww).to(torch.float32) + bb).to(bf)

    def add_then_cast(xx, ww, bb):  # one rounding too, but the f32 sum written and read back before the cast
        return (L.matmul_f32(xx, ww) + bb).to(bf)

    res["equal_to_add_then_cast"] = bool(torch.equal(y_card, add_then_cast(xb, wb, lin.bias)))
    args = [(xb, wb, lin.bias)]
    res["ms"] = time_ms(torch, lambda xx, ww, bb: L.dense(xx, lin, bf), args)
    res["add_then_cast_ms"] = time_ms(torch, add_then_cast, args)
    res["parent_twice_ms"] = time_ms(torch, twice, args)
    res["bf16_product_ms"] = time_ms(torch, torch.matmul, [(xb, wb)])
    x2 = xb.reshape(-1, D)
    res["mm_f32_out_ms"] = time_ms(torch, lambda a, ww: torch.mm(a, ww, out_dtype=torch.float32), [(x2, wb)])
    res["addmm_f32_out_ms"] = time_ms(torch, lambda a, ww, bb: torch.addmm(bb, a, ww, out_dtype=torch.float32),
                                      [(x2, wb, lin.bias)])
    res["bound_ms"], res["bound_by"] = bound(2 * (B * T * D + D * N + B * T * N) + 4 * N, 2 * B * T * D * N)
    log(f"dense bf16 card vs cpu and f64 (xlsr widths, B=4 x 6,999): {json.dumps(res)}")
    for name in ("cpu", "f64"):
        if not (res[f"equal_share_vs_{name}"] >= 0.999 and res[f"max_steps_vs_{name}"] <= 1.0):
            raise AssertionError(f"dense card vs {name}: {res}")
    if not torch.isfinite(y_card.float()).all() or not res["equal_to_add_then_cast"]:
        raise AssertionError(f"dense: non-finite outputs on the card, or not the f32 sum cast once: {res}")
    return res


# the depth of the quantized and the long-bucket train-step parity checks: their CPU passes at 6,749 and
# 4,999 frames are cut from 2 layers to 1 for the script's time limit (PERF.md)
QUANT_PARITY_LAYERS, LONG_STEP_LAYERS = 1, 1


def check_quantized_ctc_card_vs_cpu(torch, dev):
    """CTC log-probs of one 140 s row (7,001 frames) of a quantized model
    (--load_in_8bit and --load_in_4bit: models.quant.quantize_params on the
    CPU, the same payloads moved to the card) at xlsr widths and
    QUANT_PARITY_LAYERS layers in bf16, L1 on each and K2 and K3 at 0 (the encoder rows
    dequantize): int8 on the card against the port on the CPU, correlation
    >= 0.99 (PERF.md §2's int8 / int4 limit); int8 and int4 on the card
    against the unquantized bf16 model there, reported. The int4
    dequantize is held card against CPU by the Whisper int4 logits above;
    a second CPU pass at 140 s would cost ~18 s of the script's limit."""
    import copy

    import numpy as np

    from ssak_tpu_torch.infer.ctc_infer import MAX_CHUNK_SAMPLES
    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.models.quant import quantize_params

    cfg = wav2vec2.make_config("xlsr", num_layers=QUANT_PARITY_LAYERS, vocab_size=48)
    audio = tones(np.random.RandomState(9), 135.0)
    x = np.zeros((1, MAX_CHUNK_SAMPLES), np.float32)
    x[0, : audio.size] = audio
    n = torch.tensor([audio.size])

    def run(model, where):
        with torch.no_grad():
            lp, fl = wav2vec2.ctc_log_probs(model, torch.from_numpy(x).to(where), cfg, n.to(where))
        return lp[0, : int(fl[0])].float().cpu()

    def corr(a, b):
        return float(np.corrcoef(a.flatten().numpy(), b.flatten().numpy())[0, 1])

    bf16_card = run(wav2vec2.init_params(cfg, seed=0, device=dev), dev)
    out = {}
    for bits in (8, 4):
        cpu_model = quantize_params(wav2vec2.init_params(cfg, seed=0, device="cpu"), bits=bits)
        card_model = copy.deepcopy(cpu_model).to(dev)
        reset_counts()
        card = run(card_model, dev)
        torch.cuda.synchronize()
        launches = kernel_launches()
        res = dict(frames=card.shape[0], correlation_vs_bf16_card=corr(card, bf16_card),
                   argmax_agreement_vs_bf16_card=float((card.argmax(-1) == bf16_card.argmax(-1)).float().mean()),
                   launches=launches)
        cpu = card
        if bits == 8:
            cpu = run(cpu_model, "cpu")
            res.update(correlation=corr(card, cpu), max_abs_diff=float((card - cpu).abs().max()),
                       argmax_agreement=float((card.argmax(-1) == cpu.argmax(-1)).float().mean()))
        del cpu_model, card_model
        gc.collect()
        torch.cuda.empty_cache()
        log(f"quantized ctc {'card vs cpu' if bits == 8 else 'on the card'} (int{bits}, xlsr widths, "
            f"{QUANT_PARITY_LAYERS} layer{'s' * (QUANT_PARITY_LAYERS > 1)}, bf16, "
            f"140 s row): {json.dumps(res)}")
        want = {k: 0 for k in launches}
        want["flash_attention"] = cfg.num_layers
        frames = wav2vec2.feature_extract_output_length(cfg, audio.size)
        if launches != want or card.shape != (frames, 48) or cpu.shape != card.shape or not torch.isfinite(card).all():
            raise AssertionError(f"quantized ctc int{bits}: launches {launches} != {want}, shape {tuple(card.shape)}")
        if bits == 8 and not res["correlation"] >= 0.99:
            raise AssertionError(f"quantized ctc int{bits} card vs cpu: correlation {res['correlation']} < 0.99")
        out[f"int{bits}"] = res
    return out


def check_train_step_card_vs_cpu(torch, dev):
    """Two wav2vec2 train steps on the card and on the CPU in f32 from the
    same weights: large widths (d=1024, stable layer norm, conv bias, remat),
    2 layers, batch 4 x 4 s with one batch-pad dummy row, mask_time_prob 0.
    Loss to 1e-4 relative and grad_norm to 1e-3 (f32 sums in other orders
    over ~100 M terms). Parameters: Adam divides each entry by its own
    gradient scale, so an entry whose gradient is a near-zero difference of
    large terms may move either way (at most 2 lr apart after two steps).
    Measured on an H100: loss 7e-8, grad_norm 4e-6, parameters at most
    0.36 lr apart with 1.2e-4 of them beyond lr/100; held to lr, to a
    median of 1e-7 and to a share of 1e-3 beyond lr/100."""
    import numpy as np

    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.models.convert import wav2vec2_from_tree, wav2vec2_to_tree
    from ssak_tpu_torch.train import steps as TS

    lr = 1e-4
    cfg = wav2vec2.make_config("large", num_layers=2, remat=True, dtype="float32")
    tree = wav2vec2_to_tree(wav2vec2.init_params(cfg, seed=7))
    rng = np.random.RandomState(3)
    n = 64000
    lens = np.array([n, 50000, 40000, 1], np.int32)
    audio = (0.1 * rng.randn(4, n)).astype(np.float32)
    audio[np.arange(n)[None, :] >= lens[:, None]] = 0
    lab_len = np.array([60, 45, 30, 0], np.int32)
    labels = rng.randint(1, 32, (4, 64)).astype(np.int32)
    labels[np.arange(64)[None, :] >= lab_len[:, None]] = 0
    out = {}
    for where in ("cpu", dev):
        batch = {k: torch.from_numpy(v.copy()).to(where) for k, v in
                 dict(audio=audio, audio_lengths=lens, labels=labels, label_lengths=lab_len).items()}
        opt = TS.make_optimizer(learning_rate=lr, warmup_steps=1, total_steps=10)
        state = TS.init_train_state(wav2vec2_from_tree(tree, where), opt)
        step = TS.make_ctc_train_step(cfg, opt, mask_time_prob=0.0)
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        out[str(where)] = (metrics, wav2vec2_to_tree(state["model"]))
        del state
    (cpu_m, cpu_p), (card_m, card_p) = out["cpu"], out[str(dev)]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card_m, cpu_m))
    gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(card_m, cpu_m))

    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(leaves(card_p), leaves(cpu_p))])
    moved = max(float(np.abs(a - b).max()) for a, b in zip(leaves(cpu_p), leaves(tree)))
    far = float((diffs > lr / 100).mean())
    res = dict(loss_rel=loss_rel, grad_norm_rel=gn_rel, param_max_abs=float(diffs.max()),
               param_median_abs=float(np.median(diffs)), param_share_beyond_lr_100=far, param_max_move=moved,
               card=card_m, cpu=cpu_m)
    log(f"train step card vs cpu: {json.dumps(res)}")
    if not (loss_rel <= 1e-4 and gn_rel <= 1e-3 and diffs.max() <= lr and np.median(diffs) <= 1e-7
            and far <= 1e-3 and moved > 0):
        raise AssertionError(f"train step card vs cpu out of tolerance: {res}")
    return res


def check_long_train_step_card_vs_cpu(torch, dev):
    """One bf16 train step at xlsr widths, LONG_STEP_LAYERS layers, remat, B = 2 at the
    100 s bucket (1,600,000 samples, 4,999 frames) with rows of 100 s and
    70 s, from the same seeded weights: on the card the encoder attention
    goes through L1's forward (twice a layer: remat recomputes it) and both
    backward kernels; on the CPU through the unfused attention. Valid frames
    see the same keys on both routes, and the CTC loss reads only those.
    bf16 rounds at other places on each: the loss to 1e-2 relative, the grad
    norm to 2e-2 relative, and the cosine of the flattened gradients (the
    optimizer's input, summed in f64) >= 0.99."""
    import numpy as np

    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.ops import flash_attention as L1
    from ssak_tpu_torch.train import steps as TS

    cfg = wav2vec2.make_config("xlsr", num_layers=LONG_STEP_LAYERS, remat=True)
    n = 100 * 16000
    rng = np.random.RandomState(12)
    lens = np.array([n, 70 * 16000], np.int32)
    audio = np.zeros((2, n), np.float32)
    for i, m in enumerate(lens):
        audio[i, :m] = tones(rng, m / 16000.0)
    lab_len = np.array([1400, 980], np.int32)  # ~14 chars/s
    labels = rng.randint(1, 32, (2, 2048)).astype(np.int32)
    labels[np.arange(2048)[None, :] >= lab_len[:, None]] = 0
    out = {}
    for where in ("cpu", dev):
        batch = {k: torch.from_numpy(v.copy()).to(where) for k, v in
                 dict(audio=audio, audio_lengths=lens, labels=labels, label_lengths=lab_len).items()}
        opt = TS.make_optimizer(learning_rate=1e-4, warmup_steps=0, total_steps=10, schedule="constant")
        grads = {}

        class Capture:  # the optimizer, keeping the gradients it is given
            init = staticmethod(opt.init)

            @staticmethod
            def update(gr, state, params, norm_fn=None):
                grads.update({k: v.detach().float().cpu() for k, v in gr.items()})
                return opt.update(gr, state, params, norm_fn)

        state = TS.init_train_state(wav2vec2.init_params(cfg, seed=3, device=where), Capture)
        step = TS.make_ctc_train_step(cfg, Capture, mask_time_prob=0.0)
        n0 = dict(L1.LAUNCHES)
        state, m = step(state, batch)
        launched = {k: L1.LAUNCHES[k] - n0[k] for k in n0}
        out[str(where)] = (m["loss"].item(), m["grad_norm"].item(),
                           torch.cat([grads[k].ravel() for k in sorted(grads)]).double(), launched)
        del state, batch, grads
        gc.collect()
    (cpu_loss, cpu_gn, cpu_g, cpu_l1), (card_loss, card_gn, card_g, card_l1) = out["cpu"], out[str(dev)]
    want_card = {"flash_attention": 2 * cfg.num_layers, "flash_attention_bwd_dkv": cfg.num_layers,
                 "flash_attention_bwd_dq": cfg.num_layers}
    if any(cpu_l1.values()) or card_l1 != want_card:
        raise AssertionError(f"long train step card vs cpu: L1 launches cpu {cpu_l1}, card {card_l1} (want {want_card})")
    cos = float(torch.dot(card_g, cpu_g) / (card_g.norm() * cpu_g.norm()))
    res = dict(frames=wav2vec2.feature_extract_output_length(cfg, n), loss_card=card_loss, loss_cpu=cpu_loss,
               loss_rel=abs(card_loss - cpu_loss) / abs(cpu_loss), grad_norm_card=card_gn, grad_norm_cpu=cpu_gn,
               grad_norm_rel=abs(card_gn - cpu_gn) / abs(cpu_gn), grad_cosine=cos, l1_launches=card_l1)
    log(f"long train step card vs cpu (xlsr widths, {LONG_STEP_LAYERS} layer{'s' * (LONG_STEP_LAYERS > 1)}, remat, bf16, "
        f"B=2 at the 100 s bucket): {json.dumps(res)}")
    if not (res["loss_rel"] <= 1e-2 and res["grad_norm_rel"] <= 2e-2 and cos >= 0.99 and math.isfinite(card_loss)):
        raise AssertionError(f"long train step card vs cpu out of tolerance: {res}")
    return res


NEMO_PARITY = dict(NEMO_LARGE, n_layers=2)  # Large widths at 2 layers


def check_nemo_card_vs_cpu(torch, dev, root):
    """A NeMo archive at Large widths and 2 layers (write_nemo_archive, seed
    3) loaded on the card and on the CPU, in f32: the log-probs of a 30 s row
    (the 30 s bucket, 751 frames) and of a 140 s row (a 135 s file padded to
    the 140 s bucket, 3,501 frames) must correlate >= 0.9999 over the valid
    frames, with the same frame counts; max |err| logged."""
    import numpy as np

    from ssak_tpu_torch.infer import ctc_infer as CI
    from ssak_tpu_torch.infer.general import compute_log_probas, load_model

    archive = os.path.join(root, "parity.nemo")
    write_nemo_archive(archive, NEMO_PARITY, nemo_vocabulary(), seed=3)
    models = {}
    for where in ("cpu", dev):
        m = load_model(archive, device=where)
        m.cfg = dataclasses.replace(m.cfg, dtype="float32")
        models[str(where)] = m
    rng = np.random.RandomState(13)
    res = {}
    for secs in (30.0, 135.0):
        audio = tones(rng, secs)
        x = CI._padded([audio], CI._bucket_len(audio.size))
        out = {}
        for where, m in models.items():
            lp, fl = compute_log_probas(m, x, [audio.size])
            out[where] = (lp.float().cpu()[0, : int(fl[0])], int(fl[0]), lp.shape[1])
        (a, fa, ta), (b, fb, tb) = out[str(dev)], out["cpu"]
        corr = float(np.corrcoef(a.flatten().numpy(), b.flatten().numpy())[0, 1])
        r = dict(frames=fa, padded_frames=ta, correlation=corr, max_abs_err=float((a - b).abs().max()),
                 argmax_agreement=float((a.argmax(-1) == b.argmax(-1)).float().mean()))
        res[f"{secs:.0f}s"] = r
        if not (fa == fb == nemo_frames(models["cpu"].cfg, audio.size) and ta == tb and corr >= 0.9999
                and torch.isfinite(a).all()):
            raise AssertionError(f"nemo card vs cpu, {secs} s row: {r} (frames cpu {fb}, padded {tb})")
    log(f"nemo conformer card vs cpu (Large widths, 2 layers, f32): {json.dumps(res)}")
    del models
    gc.collect()
    return res


def check_nemo_train_step_card_vs_cpu(torch, dev, root):
    """Two f32 Conformer train steps (family conformer) on the card and on the
    CPU from the same archive (Large widths, 2 layers, seed 3): batch 4 x 4 s
    with one batch-pad dummy row, labels in [0, 128) with the blank 128,
    mask_time_prob 0. As for wav2vec2: the loss to 1e-4 relative, the grad
    norm to 1e-3, every parameter within lr of the CPU's."""
    import numpy as np

    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.models.convert import conformer_to_tree
    from ssak_tpu_torch.train import steps as TS

    lr = 1e-4
    archive = os.path.join(root, "parity.nemo")
    rng = np.random.RandomState(4)
    n = 64000
    lens = np.array([n, 50000, 40000, 1], np.int32)
    audio = np.zeros((4, n), np.float32)
    for i, m in enumerate(lens[:3]):
        audio[i, :m] = tones(rng, m / 16000.0)
    lab_len = np.array([50, 40, 30, 0], np.int32)
    labels = rng.randint(0, NEMO_PIECES, (4, 64)).astype(np.int32)
    labels[np.arange(64)[None, :] >= lab_len[:, None]] = 0
    out = {}
    for where in ("cpu", dev):
        m = load_model(archive, device=where)
        cfg = dataclasses.replace(m.cfg, dtype="float32")
        batch = {k: torch.from_numpy(v.copy()).to(where) for k, v in
                 dict(audio=audio, audio_lengths=lens, labels=labels, label_lengths=lab_len).items()}
        opt = TS.make_optimizer(learning_rate=lr, warmup_steps=1, total_steps=10)
        state = TS.init_train_state(m.module, opt)
        step = TS.make_ctc_train_step(cfg, opt, mask_time_prob=0.0, family="conformer")
        metrics = []
        for _ in range(2):
            state, mt = step(state, batch)
            metrics.append((mt["loss"].item(), mt["grad_norm"].item()))
        out[str(where)] = (metrics, conformer_to_tree(state["model"]))
        del state, m
    (cpu_m, cpu_p), (card_m, card_p) = out["cpu"], out[str(dev)]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card_m, cpu_m))
    gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(card_m, cpu_m))

    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(leaves(card_p), leaves(cpu_p))])
    res = dict(loss_rel=loss_rel, grad_norm_rel=gn_rel, param_max_abs=float(diffs.max()),
               param_median_abs=float(np.median(diffs)), param_share_beyond_lr_100=float((diffs > lr / 100).mean()),
               card=card_m, cpu=cpu_m)
    log(f"nemo conformer train step card vs cpu (Large widths, 2 layers, f32): {json.dumps(res)}")
    if not (loss_rel <= 1e-4 and gn_rel <= 1e-3 and diffs.max() <= lr and all(math.isfinite(v) for v, _ in card_m)):
        raise AssertionError(f"nemo conformer train step card vs cpu out of tolerance: {res}")
    return res


def check_whisper_train_steps_card_vs_cpu(torch, dev):
    """One partitioned Whisper train step on the card and on the CPU in f32
    from the same weights (large-v3 widths, 2 + 2 layers, seeded_tree seed
    5): rank-8 adapters on attention query / value (add_lora from a CPU
    generator, B set to 0.01 N(0, 1) so that A has a gradient), over the
    f32 base (--lora) and over its int8 quantization (--load_in_8bit
    --lora), batch 2 x 30 s windows of tones, 64 teacher-forced tokens, lr
    at its peak from the first step. As for the CTC steps: the loss to 1e-4
    relative, the grad norm to 1e-3; the frozen base unchanged on both. The
    adapters' gradients (one backward before the step) agree to 1e-3 of
    their largest entry, as the grad norm does, and each updated adapter
    lies within lr of the CPU's wherever the two gradients have the same
    sign. Adam's first update is about lr times the gradient's sign: an
    entry whose gradient lies within that gradient noise may take either
    sign on the two devices (over the int8 base, whose dequantized (in,
    out) weights take other cuBLAS products than the f32 base's transposed
    ones, 5 of 245,760 entries did, with gradients of at most 1.7e-8
    against a largest of 2.2e-2), so such entries are counted, at most 1
    in 10,000, and held to 2 lr."""
    import numpy as np

    from ssak_tpu_torch.models import whisper as W
    from ssak_tpu_torch.models.convert import whisper_from_tree
    from ssak_tpu_torch.models.lora import add_lora, extract_lora, load_lora
    from ssak_tpu_torch.models.quant import partition_trainable, quantize_params
    from ssak_tpu_torch.ops.logmel import log_mel_spectrogram
    from ssak_tpu_torch.train import steps as TS

    lr = 1e-4
    cfg = W.make_config("large-v3", n_audio_layer=2, n_text_layer=2, dtype="float32")
    tree = seeded_tree(cfg, seed=5)
    rng = np.random.RandomState(6)
    audio = np.stack([tones(rng, 30.0) for _ in range(2)])
    mel = log_mel_spectrogram(torch.from_numpy(audio), n_mels=cfg.n_mels)
    U = 64
    tokens = rng.randint(0, 50257, (2, U + 1))
    mask = np.ones((2, U), np.float32)
    mask[0, :3], mask[1, 40:] = 0, 0
    res = {}
    for bits in (0, 8):
        out = {}
        for where in ("cpu", dev):
            model = whisper_from_tree(tree, where)
            add_lora(model, rank=8, generator=torch.Generator().manual_seed(0))
            b_rng = np.random.RandomState(7)
            load_lora(model, {k: (0.01 * b_rng.standard_normal(v.shape)).astype(np.float32)
                              for k, v in sorted(extract_lora(model).items()) if k.endswith("lora_B")})
            if bits:
                quantize_params(model, bits=bits)
            opt = TS.make_optimizer(learning_rate=lr, warmup_steps=0, total_steps=10)
            state = TS.init_train_state(model, opt, quantized=True)
            batch = {"mel": mel.to(where), "tokens_in": torch.from_numpy(tokens[:, :-1]).to(where),
                     "tokens_out": torch.from_numpy(tokens[:, 1:]).to(where), "token_mask": torch.from_numpy(mask).to(where)}
            start, frozen0 = partition_trainable(model)
            af = W.encode(model, batch["mel"], cfg)
            W.cross_entropy_loss(W.decode_train(model, batch["tokens_in"], af, cfg), batch["tokens_out"],
                                 batch["token_mask"]).backward()
            grads = {k: p.grad.detach().cpu() for k, p in start.items()}
            start = {k: v.detach().cpu().clone() for k, v in start.items()}
            frozen0 = {k: v.clone() for k, v in frozen0.items()}
            del af
            state, m = TS.make_whisper_train_step(cfg, opt, quantized=True)(state, batch)
            trainable, frozen = partition_trainable(state["model"])
            if not all(torch.equal(frozen[k], frozen0[k]) for k in frozen0) or frozen.keys() != frozen0.keys():
                raise AssertionError(f"whisper train step card vs cpu: the frozen base moved on {where}")
            out[str(where)] = ((m["loss"].item(), m["grad_norm"].item()), {k: v.detach().cpu() for k, v in trainable.items()},
                               start, grads)
            del state, model, frozen0, trainable, frozen
            gc.collect()
        (cpu_m, cpu_p, cpu_start, cpu_g), (card_m, card_p, _, card_g) = out["cpu"], out[str(dev)]
        loss_rel = abs(card_m[0] - cpu_m[0]) / abs(cpu_m[0])
        gn_rel = abs(card_m[1] - cpu_m[1]) / abs(cpu_m[1])
        names = sorted(cpu_p)
        g_cpu = torch.cat([cpu_g[k].flatten() for k in names])
        g_card = torch.cat([card_g[k].flatten() for k in names])
        diff = torch.cat([(card_p[k] - cpu_p[k]).abs().flatten() for k in names])
        moved = float(torch.cat([(cpu_p[k] - cpu_start[k]).abs().flatten() for k in names]).max())
        g_err = float((g_card - g_cpu).abs().max())
        flipped = torch.sign(g_card) != torch.sign(g_cpu)
        tag = "int8" if bits else "f32"
        res[f"lora_{tag}"] = r = dict(
            loss_rel=loss_rel, grad_norm_rel=gn_rel, grad_max_abs_err=g_err, grad_max_abs=float(g_cpu.abs().max()),
            adapter_max_abs=float(diff.max()), adapter_max_abs_same_sign=float(diff[~flipped].max()),
            sign_flips=int(flipped.sum()), flipped_grad_max_abs=float(g_cpu[flipped].abs().max()) if flipped.any() else 0.0,
            adapter_entries=int(diff.numel()), adapter_max_move=moved, adapters=len(names), card=card_m, cpu=cpu_m)
        log(f"whisper lora train step card vs cpu ({tag} base, large-v3 widths, 2+2 layers, f32): {json.dumps(r)}")
        # A and B on query and value of 6 attention sites (2 encoder, 2 decoder self, 2 cross)
        if not (loss_rel <= 1e-4 and gn_rel <= 1e-3 and g_err <= 1e-3 * r["grad_max_abs"] and len(names) == 24
                and r["adapter_max_abs_same_sign"] <= lr and r["adapter_max_abs"] <= 2 * lr and moved > 0
                and r["sign_flips"] <= 1e-4 * diff.numel()
                and math.isfinite(card_m[0])):
            raise AssertionError(f"whisper lora train step card vs cpu ({tag}) out of tolerance: {r}")
    return res


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    try:
        from ssak_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the ssak_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; tf32 off")
    log(f"card: {card}; dense bf16 peak {card_peak():.4g} FLOP/s (utils.flops.peak_flops)")
    matplotlib = importlib.util.find_spec("matplotlib") is not None
    log(f"matplotlib on this host: {'found' if matplotlib else 'not found'} (importlib.util.find_spec)")

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s for {sorted(paths)}")
    for name, (_sec, report) in _build.build_log.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "C7515" in line:  # C7515: ptxas serialised wgmmas
                log(f"  {name}: {line.strip()}")
    # K2's, K3's, K4's and L1's ptxas reports (this run's, or kept beside a library built before) show no
    # spills, and L1 forward's no serialised wgmma (C7515, or any other reason ptxas gives for it)
    for name in ("int8_matmul", "int4_matmul", "flash_decode", "flash_attention", "flash_attention_bwd"):
        if name not in _build.build_log:
            raise AssertionError(f"{name}: no ptxas report beside its library")
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", _build.build_log[name][1])
        if not spills or any(a != "0" or b != "0" for a, b in spills):
            raise AssertionError(f"{name} spills registers: {spills}")
    report = _build.build_log["flash_attention"][1]
    if "C7515" in report or "are serialized" in report:
        raise AssertionError(f"flash_attention: ptxas serialised its wgmmas:\n{report}")
    # ptxas may also serialise them without a word: then every HGMMA in the SASS carries gsb0 and is
    # waited on at once. In L1's kernels at most half of each function's HGMMAs may end a batch.
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in ("flash_attention", "flash_attention_bwd"):
        sass = subprocess.run([cuobjdump, "-sass", paths[name]], capture_output=True, text=True, check=True,
                              timeout=120).stdout
        counts = hgmma_batching(sass)
        if not counts or any(2 * gsb > n for n, gsb in counts.values()):
            raise AssertionError(f"{name}: serialised wgmma in the SASS (HGMMAs, of them with gsb0): {counts}")
        log(f"  {name}: HGMMAs and batch ends (gsb0) per function {sorted(counts.values())}")

    log("phase 2: kernels against their plain versions")
    k2_rows, k2_err = check_matmul_int8(torch, dev)
    k3_rows, k3_err = check_matmul_int4(torch, dev)
    fd_rows = {v: check_flash_decode(torch, dev, v == "int8") for v in ("bf16", "int8")}
    k1_rows, k1_err = check_ctc_fused(torch, dev)
    k1_conformer = check_ctc_fused_conformer(torch, dev)
    k1_rows.append(k1_conformer)
    k1_err = max(k1_err, k1_conformer["max_abs_err"])
    l1_rows, l1_err, l1_short, l1_training = check_flash_attention(torch, dev)
    bwd_rows, bwd_err, bwd_pairs = check_flash_attention_bwd(torch, dev)

    log("phase 3: large-v3 transcription from an HF directory (greedy bf16, int8, int4; int4 accurate; int4 "
        "long-form; tensor-parallel over two gloo ranks: greedy bf16 and int8, accurate, long-form, the CLI under "
        "torchrun); large-v3 fine-tuning from that directory (LoRA over bf16, int8 and int4 bases; the full fine-tune, "
        "checkpoint and resume); wav2vec2-base CTC training, finalized and reloaded; wav2vec2-xlsr CTC serving from an HF directory "
        "(greedy in bf16, int8 and int4; device beam with lexicon and word LM; host beam with a word 4-gram in process "
        "and over 4 workers; streaming over WebSocket); NeMo Conformer-CTC Large from a .nemo archive (greedy in bf16, "
        "int8 and int4, and device beam serving; fine-tuning through the train CLI, finalized and reloaded); "
        "wav2vec2-xlsr CTC training at the 140 s bucket; corpus ingest (FLAC, sox pipes, segments; check_kaldi_dir, "
        "manifest, tar, BPE) into the train CLI's wav2vec2-base step with --config, --set and the manifest cache; "
        "alignment and training data (long Kaldi utterances split by CTC forced alignment through xlsr; the train CLI "
        "with --data_augment; the voice converter trained and run over a Kaldi dir; the NN VAD); parallel/ (a probe "
        "of the card's process groups; tensor-parallel and sequence-parallel xlsr serving over ranks sharing the card, "
        "through torchrun and spawned ranks; MoE wav2vec2-base training through shard_train_step; GPipe training); the "
        "host-only modules (classify_speech through L1 inside profile_trace, device memory, the card's peak, speaker "
        "genders)")
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_")
    try:
        model_dir = os.path.join(tmp, "whisper-large-v3")
        whole = {}
        dirs = {"whisper_large_v3": prepare_whisper_dir(torch, dev, model_dir, keep=whole)}
        corpus = os.path.join(tmp, "corpus")
        ids = write_corpus(corpus)
        whisper_texts = []
        slices = {r["config"]: r for r in (run_slice(torch, corpus, ids, b, model_dir, whisper_texts if b == 0 else None)
                                           for b in (0, 8, 4))}
        acc_dir = os.path.join(tmp, "accurate")
        slices["int4_accurate"] = run_accurate(torch, acc_dir, write_corpus(acc_dir, ACC_FILES, ACC_SECONDS, seed=3),
                                               model_dir)
        slices["int4_longform"] = run_longform(torch, model_dir)
        slices["whisper_tp"] = run_whisper_tp(torch, dev, tmp, model_dir, corpus, acc_dir, whisper_texts,
                                              whole.pop("teacher_forced"))
        slices.update(run_whisper_finetune(torch, dev, tmp, model_dir))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_ctc_")
    try:
        slices["ctc"] = run_ctc_training(torch, dev, tmp, CTC_RUNS["ctc"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_serve_")
    try:
        model_dir = os.path.join(tmp, "xlsr")
        dirs["wav2vec2_xlsr"] = prepare_serving_dir(torch, dev, model_dir)
        corpus = os.path.join(tmp, "corpus")
        ids, lens = write_serving_corpus(corpus)
        bf16_texts = []
        slices["ctc_serving_greedy"] = run_ctc_serving(torch, corpus, ids, lens, "greedy", model_dir, texts=bf16_texts)
        for bits in (8, 4):
            texts = []
            res = run_ctc_serving(torch, corpus, ids, lens, "greedy", model_dir, quantize_bits=bits, texts=texts)
            res["cer_vs_bf16"] = cer(bf16_texts, texts)
            log(f"ctc serving greedy int{bits}: CER against the bf16 transcripts {res['cer_vs_bf16']}")
            slices[f"ctc_serving_int{bits}"] = res
        n_beam = sum(n for n, _lo, hi in SERVE_GROUPS if hi <= 140.0)  # the files of one chunk at most
        lexicon, arpa = write_lexicon_lm(tmp)
        slices["ctc_serving_beam"] = run_ctc_serving(torch, kaldi_subset(os.path.join(tmp, "beam"), corpus, n_beam),
                                                     ids[:n_beam], lens[:n_beam], "beam", model_dir, lexicon, arpa)
        slices["ctc_host_beam"] = run_host_beam(torch, tmp, corpus, ids, lens, model_dir)
        slices["ctc_streaming"] = run_streaming(torch, dev, model_dir)
        align = {"split": run_align(torch, dev, os.path.join(tmp, "align"), model_dir, corpus, ids, lens)}
        parallel = {"probe": probe_collectives(torch)}
        parallel["tp_serving"] = run_tp_serving(torch, dev, tmp, model_dir, corpus, ids, lens, parallel["probe"])
        slices["host_modules"] = run_host_modules(torch, dev, os.path.join(tmp, "host"), model_dir, corpus, ids, lens,
                                                  card)
        shutil.rmtree(model_dir)
        nemo = run_nemo(torch, dev, tmp, (corpus, ids, lens))
        dirs["nemo_conformer_ctc_large"] = nemo.pop("nemo_archive")
        slices.update(nemo)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_long_")
    try:
        slices["ctc_long"] = run_ctc_training(torch, dev, tmp, CTC_RUNS["ctc_long"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_ingest_")
    try:
        slices["ingest"] = run_ingest(torch, dev, tmp)
        align["augment"] = run_augmented_training(torch, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_vc_")
    try:
        align["vc"] = run_vc(torch, dev, tmp)
        align["vad"] = run_vad(torch, dev)
        slices["align"] = align
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    parallel["moe_training"] = run_moe_training(torch, dev)
    parallel["pp_training"] = run_pp_training(torch, dev)
    slices["parallel"] = parallel
    log(f"slice parallel {json.dumps(parallel)}")

    log("phase 4: card against CPU, large-v3 widths at 2+2 layers (bf16, int8, int4); wav2vec2 large widths at 2 "
        "layers (train steps); xlsr widths at 1 layer (CTC log-probs of a 140 s row in bf16, in int8 and int4; "
        "a bf16 train step at the 100 s bucket); a bf16 dense at B=4 x 6,999; NeMo Conformer-CTC Large widths at 2 layers, "
        "f32 (log-probs of a 30 s and a 140 s row; train steps); "
        "Whisper LoRA and int8 QLoRA train steps at large-v3 widths, 2+2 layers, f32; an MoE wav2vec2 train step at "
        "base widths, 2 layers, f32")
    corr = check_card_vs_cpu(torch, dev)
    train_parity = check_train_step_card_vs_cpu(torch, dev)
    serving_parity = check_ctc_serving_card_vs_cpu(torch, dev)
    quantized_parity = check_quantized_ctc_card_vs_cpu(torch, dev)
    dense_parity = check_dense_card_vs_cpu(torch, dev)
    long_step_parity = check_long_train_step_card_vs_cpu(torch, dev)
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_nemo_")
    try:
        nemo_parity = check_nemo_card_vs_cpu(torch, dev, tmp)
        nemo_step_parity = check_nemo_train_step_card_vs_cpu(torch, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    whisper_step_parity = check_whisper_train_steps_card_vs_cpu(torch, dev)
    moe_step_parity = check_moe_train_step_card_vs_cpu(torch, dev)

    def head(rows, **shape):
        return next(r for r in rows if all(r[k] == v for k, v in shape.items()))

    def wtp(kernel, runs):  # whisper_tp's launches of `kernel` over its runs and ranks
        return sum(rank[kernel] for r in runs for rank in slices["whisper_tp"]["launches_per_rank"][r])

    kernels = []
    specs = [
        ("matmul_int8", "ssak_tpu_torch/csrc/int8_matmul.cu", "ssak_tpu/ops/int8_matmul.py:45",
         k2_rows, k2_err, dict(M=24, K=1280, N=5120),
         slices["int8"]["launches"]["matmul_int8"] + slices["whisper_ft_qlora_int8"]["launches"]["matmul_int8"]
         + wtp("matmul_int8", ("int8",))),
        ("matmul_int4", "ssak_tpu_torch/csrc/int4_matmul.cu", "ssak_tpu/ops/int8_matmul.py:117",
         k3_rows, k3_err, dict(M=32, K=1280, N=5120),
         slices["int4_accurate"]["launches"]["matmul_int4"] + slices["int4_longform"]["launches"]["matmul_int4"]
         + slices["whisper_ft_qlora_int4"]["launches"]["matmul_int4"]),
        ("flash_decode_bf16", "ssak_tpu_torch/csrc/flash_decode.cu", "ssak_tpu/ops/flash_decode.py:38",
         *fd_rows["bf16"], dict(B=24, H=20, T=1500, range="0:1499"),
         slices["bf16"]["launches"]["flash_decode_bf16"] + sum(slices[f"whisper_ft_{r}"]["launches"]["flash_decode_bf16"]
                                                               for r in ("lora_bf16", "qlora_int8", "qlora_int4"))
         + wtp("flash_decode_bf16", ("greedy", "accurate", "longform"))),
        ("flash_decode_int8", "ssak_tpu_torch/csrc/flash_decode.cu", "ssak_tpu/ops/flash_decode.py:58",
         *fd_rows["int8"], dict(B=24, H=20, T=1500, range="0:1499"),
         slices["int8"]["launches"]["flash_decode_int8"] + wtp("flash_decode_int8", ("int8",))),
        ("ctc_fused", "ssak_tpu_torch/csrc/ctc_fused.cu", "ssak_tpu/ops/ctc_pallas.py:29",
         k1_rows, k1_err, dict(V=32, T=749),
         slices["ctc"]["launches"]["ctc_fused"] + slices["ctc_long"]["launches"]["ctc_fused"]
         + slices["nemo_training"]["launches"]["ctc_fused"] + sum(r["ctc_fused"] for r in slices["ingest"]["launches"])
         + slices["align"]["augment"]["launches"]["ctc_fused"] + parallel["moe_training"]["launches"]["ctc_fused"]
         + parallel["pp_training"]["launches"]["ctc_fused"]),
        ("flash_attention", "ssak_tpu_torch/csrc/flash_attention.cu", "ssak_tpu/models/layers.py:290",
         l1_rows, l1_err, dict(B=1, T=7001),
         sum(slices[k]["launches"]["flash_attention"] for k in ("ctc_serving_greedy", "ctc_serving_int8",
                                                                  "ctc_serving_int4", "ctc_serving_beam", "ctc_long"))
         + slices["align"]["split"]["launches"]["flash_attention"]
         + sum(parallel["tp_serving"]["l1_launches_per_rank"]) + slices["host_modules"]["launches"]["flash_attention"]),
        ("flash_attention_bwd_dkv", "ssak_tpu_torch/csrc/flash_attention_bwd.cu",
         "ssak_tpu/models/layers.py:290 -> jax/experimental/pallas/ops/tpu/flash_attention.py:941 _flash_attention_bwd_dkv",
         bwd_rows["dkv"], max(bwd_err["dk"], bwd_err["dv"]), dict(B=1, T=6999),
         slices["ctc_long"]["launches"]["flash_attention_bwd_dkv"]),
        ("flash_attention_bwd_dq", "ssak_tpu_torch/csrc/flash_attention_bwd.cu",
         "ssak_tpu/models/layers.py:290 -> jax/experimental/pallas/ops/tpu/flash_attention.py:1287 _flash_attention_bwd_dq",
         bwd_rows["dq"], bwd_err["dq"], dict(B=1, T=6999), slices["ctc_long"]["launches"]["flash_attention_bwd_dq"]),
    ]
    for name, source, replaces, rows, err, shape, launches in specs:
        h = head(rows, **shape)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=launches,
            max_abs_err=err, ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"], bound_by=h["bound_by"],
            library_ms=h["library_ms"], max_err=err, kernel_ms=h["ms"], shape=shape, shapes=rows,
        ))
    log("summary " + json.dumps({"slices": slices, "model_dirs": dirs, "matplotlib": matplotlib,
                                 "card_vs_cpu_correlation": corr, "train_step_card_vs_cpu": train_parity,
                                 "ctc_serving_card_vs_cpu": serving_parity, "long_train_step_card_vs_cpu": long_step_parity,
                                 "quantized_ctc_card_vs_cpu": quantized_parity, "dense_card_vs_cpu": dense_parity,
                                 "nemo_card_vs_cpu": nemo_parity, "nemo_train_step_card_vs_cpu": nemo_step_parity,
                                 "whisper_train_step_card_vs_cpu": whisper_step_parity,
                                 "moe_train_step_card_vs_cpu": moe_step_parity,
                                 "flash_attention_30s_bucket": l1_short, "flash_attention_training_launch": l1_training,
                                 "flash_attention_bwd_pairs": bwd_pairs}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
