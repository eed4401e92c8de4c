#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (ssak_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):
  1. build   compile csrc/*.cu with nvcc for sm_90a (one process per source)
  2. kernels each kernel's wrapper at the main path's shapes against its
             plain PyTorch version on the card, with CUDA-event timings of
             the kernel, the plain version and one library call, and the
             least time the card could take (bytes or operations bound);
             K1 at the 140 s bucket also against the same recursion in
             f64; L1's backward (dK/dV and dQ) through autograd,
             bit-identical on repeat
  3. slices  seeded Whisper large-v3 greedy transcription of synthetic wav
             files listed in a Kaldi dir, bf16, --load_in_8bit and
             --load_in_4bit; the --load_in_4bit --accurate chain (beam 5,
             best_of 5, temperature fallback) over a Kaldi dir of short
             files; the int4 long-form seek loop over 70 s files (full
             temperature chain, best_of 5, 32-token windows); then
             wav2vec2-base CTC training at full width (CTCTrainer, batch 32
             of 15 s, 8 steps, eval, checkpoint, resume) on a seeded Kaldi
             dir of 64 wavs; then wav2vec2-xlsr CTC serving at full width
             through ctc_infer over a Kaldi dir of 16 files (30 s, 140 s
             and chunked 200 s audio), greedy, and with the device beam
             (width 16, lexicon, word 3-gram) over the 14 files of one
             chunk; then wav2vec2-xlsr CTC training at full width and depth
             at the 140 s bucket (CTCTrainer, batch 4 x 6,999 frames, 6
             steps, eval, checkpoint, resume; L1 forward and backward on
             every layer); each with the kernels' launch counters checked
             against the path exactly (on the accurate and long-form paths,
             against the decode steps the port counts; on CTC serving, L1
             against 24 x the encoder calls at >= 4096 frames)
  4. parity  teacher-forced Whisper logits of the port on the card against
             the port on the CPU in f32 (large-v3 widths, 2+2 layers; bf16,
             int8 and int4 weights), the int4 window decode's no-speech and
             first-step logits card against CPU, and two wav2vec2 train
             steps card against CPU in f32 (large widths, 2 layers, remat),
             and CTC log-probs of a 140 s row card (through L1) against CPU
             in bf16 (xlsr widths, 2 layers), same weights; one bf16 train
             step at the 100 s bucket (xlsr widths, 2 layers, remat), the
             card through L1 forward and backward, the CPU unfused

TF32 is off for the whole run (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 = False): f32 products on the card are full
f32, as on the CPU. The line before the last is the card's name and power
limit from nvidia-smi; before it, one JSON line lists every ported kernel.
The last line is {"ok": true, "device": {...}}.
"""

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

MAX_TOKENS = 32
N_FILES = 24
FILE_SECONDS = 29.0
ACC_FILES, ACC_SECONDS = 8, 20.0  # the accurate chain's Kaldi dir: one window batch of 8 (x 5 beams = 40 rows)
LF_FILES, LF_SECONDS = 4, 70.0  # long-form: 3 windows a file, 4 rows (x 5 candidates = 20 rows)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM
CTC_FILES, CTC_EVAL_FILES, CTC_BATCH, CTC_STEPS = 64, 32, 32, 8
L2_BYTES = 50 * 2**20
SPIN_CYCLES = 100_000_000  # about 50 ms at the H100's clock: longer than queueing 64 calls


T_START = time.perf_counter()


def log(msg):
    print(f"[chip_smoke {time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def bound(n_bytes, n_flops, peak=BF16_FLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


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
    from ssak_tpu_torch.models.quant import quantize_kernel
    from ssak_tpu_torch.ops import int8_matmul as IM

    g = torch.Generator(device=dev).manual_seed(1)
    rows, worst = [], 0.0
    shapes = [(m, k, n) for m in (24, 40) for (k, n) in ((1280, 1280), (1280, 5120), (5120, 1280))]
    for M, K, N in shapes + [(5, 1280, 1288)]:  # last: odd M and a partial 64-column tile
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
        sets = [(x, q8.clone(), scale.clone()) for _ in range(n_copies(K * N))]
        wdq = [(x, a[1].to(torch.bfloat16), a[2]) for a in sets]  # the dequantized bf16 weight
        row = dict(
            M=M, K=K, N=N, max_abs_err=err,
            ms=time_ms(torch, IM.matmul_int8, sets),
            plain_ms=time_ms(torch, IM.matmul_int8_reference, sets),
            library_ms=time_ms(torch, lambda a, w, s: torch.matmul(a, w) * s, wdq),
        )
        row["bound_ms"], row["bound_by"] = bound(M * K * 2 + K * N + N * 4 + M * N * 4, 2 * M * K * N)
        rows.append(row)
        log(f"matmul_int8 {row}")
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
    Checked at every M from 1 to 64 (every register-blocking width MR =
    ceil(M/8) the kernel instantiates, full and partial row groups, hence
    every row count the fallback and seek loops can reach), plus odd M with
    a partial column tile and a contraction of 4 chunks; timed at the row
    counts of phase 3's int4 paths (int4_rows). Both compute exact products
    of bf16 values in f32; only the order of the sums differs: 1e-4 of
    max|y|."""
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
            sets = [(x, q4.clone(), scale.clone()) for _ in range(n_copies(K * N // 2))]
            wdq = [(x, dequantize_int4(a[1], a[2], torch.bfloat16)) for a in sets]
            row = dict(
                M=M, K=K, N=N, splits=IM.int4_split_plan(K // 2, N)[0], max_abs_err=err,
                ms=time_ms(torch, IM.matmul_int4, sets),
                plain_ms=time_ms(torch, IM.matmul_int4_reference, sets),
                library_ms=time_ms(torch, torch.matmul, wdq),
            )
            # packed weights + block scales + x read once, y written once
            row["bound_ms"], row["bound_by"] = bound(K * N // 2 + (K // 64) * N * 4 + M * K * 2 + M * N * 4, 2 * M * K * N)
            rows.append(row)
            log(f"matmul_int4 {row}")
            del sets, wdq
        log(f"matmul_int4 K={K} N={N} splits={IM.int4_split_plan(K // 2, N)[0]}: checked at M={min(ms)}..{max(ms)}, "
            f"max|err| {site_err}")
        worst = max(worst, site_err)
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


def check_flash_decode(torch, dev, int8):
    import torch.nn.functional as F

    from ssak_tpu_torch.ops import flash_decode as FD

    g = torch.Generator(device=dev).manual_seed(2 + int8)
    H, Dh = 20, 64
    rows, worst = [], 0.0
    for B in (24, 40):
        for T in (448, 1500):
            q, kv = _rand_kv(torch, g, dev, B, H, Dh, T, int8)
            # ragged ranges for the check; the timed call uses the main
            # path's full cross-attention range
            lo = torch.randint(0, T // 4, (B,), generator=g, device=dev, dtype=torch.int32)
            hi = torch.randint(T // 2, T, (B,), generator=g, device=dev, dtype=torch.int32)
            lo[0], hi[0] = 0, T - 1
            lo[1], hi[1] = 5, 5
            args = (q, kv[0], kv[1], lo, hi) + tuple(kv[2:])
            out = FD.flash_decode_attention(*args)
            ref = FD.flash_decode_reference(*args)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not err <= 2e-2:
                raise AssertionError(f"flash_decode int8={int8} B={B} T={T}: max|err| {err} > 2e-2")
            worst = max(worst, err)
            full_lo = torch.zeros(B, dtype=torch.int32, device=dev)
            full_hi = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
            elt = 1 if int8 else 2
            kv_bytes = 2 * B * H * Dh * T * elt + (2 * B * H * T * 2 if int8 else 0)
            sets = [(q, *(a.clone() for a in kv[:2]), full_lo, full_hi, *(a.clone() for a in kv[2:]))
                    for _ in range(n_copies(kv_bytes))]
            # library yardstick: SDPA on bf16 K/V in (B, H, T, Dh), range mask
            mask = torch.ones(B, 1, 1, T, dtype=torch.bool, device=dev)
            if int8:
                kb = (kv[0].float() * kv[2].float()).to(torch.bfloat16)
                vb = (kv[1].float() * kv[3].float()).to(torch.bfloat16)
            else:
                kb, vb = kv
            lib_sets = [(q[:, :, None], kb.transpose(-1, -2).contiguous(), vb.transpose(-1, -2).contiguous(), mask)
                        for _ in range(n_copies(2 * B * H * Dh * T * 2))]
            row = dict(
                B=B, T=T, max_abs_err=err,
                ms=time_ms(torch, FD.flash_decode_attention, sets),
                plain_ms=time_ms(torch, FD.flash_decode_reference, sets),
                library_ms=time_ms(torch, lambda a, k, v, m: F.scaled_dot_product_attention(a, k, v, attn_mask=m, scale=1.0), lib_sets),
            )
            row["bound_ms"], row["bound_by"] = bound(kv_bytes + B * H * Dh * (2 + 4) + 8 * B, 4 * B * H * Dh * T)
            rows.append(row)
            log(f"flash_decode_{'int8' if int8 else 'bf16'} {row}")
            del sets, lib_sets
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
    with (V=1024), and xlsr training's 140 s bucket (B=4, T=6,999, S=4,097,
    65.8 KB of shared memory); checked only, U=512 (S=1025 states, more than a
    block's 1024 threads) with labels outside the vocabulary. Loss to 1e-5
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
    4.1e-3, norm 1.4e-4, frame sums 7e-7 from the witness."""
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
            log(f"ctc_fused V={V} U={U} S={S}: loss rel err {loss_rel}, grad max|err| {err}")
            continue
        del grad, ref_grad
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
            chain_steps=2 * T - 1, live_states=live, **extra,
        )
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


def _qkv(torch, g, dev, B, T, H=16, Dh=64):
    return [torch.randn(B, T, H, Dh, generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]


def check_flash_attention(torch, dev):
    """L1 against its plain version on the card, all T rows (pad rows
    included): the 140 s bucket (T = 7,001) with one full row and with rows
    of 7,001 and 3,000 frames; T = 4,096 without lengths (the no-mask path);
    a row of length 0 beside a full one at an odd T; Dh = 128 and 256; and
    q/k/v read through the strides of one fused (B, T, 3D) projection. The
    plain version computes the same masked softmax with p rounded to bf16
    against the global row max, the kernel against a running max: held to
    2e-2 of max|out|. Timed at B = 6 and 1 (T = 7,001) against the plain
    version (B = 1 only: at B = 6 its logits need about 56 GB) and SDPA in
    bf16 with a (B, 1, 1, T) key-padding mask; and at the 30 s bucket
    (B = 32, T = 1,499) against the plain version and the unfused attention
    the encoder runs there (layers.attention), for the FLASH_MIN_SEQ
    question only."""
    import torch.nn.functional as F

    from ssak_tpu_torch.models import layers as L
    from ssak_tpu_torch.ops import flash_attention as L1

    g = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    cases = [
        dict(B=1, T=7001, lengths=[7001]),
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
        ref = L1.flash_self_attention_reference(q, k, v, lens)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = 2e-2 * float(ref.float().abs().max())
        if not (torch.isfinite(out).all() and out.shape == q.shape and err <= tol):
            raise AssertionError(f"flash_attention {c}: max|err| {err} > {tol} (finite {bool(torch.isfinite(out).all())})")
        worst = max(worst, err)
        log(f"flash_attention {c}: max|err| {err:.3g} (limit {tol:.3g})")
        del q, k, v, out, ref
    rows = []
    for B in (6, 1):
        T, H, Dh = 7001, 16, 64
        q, k, v = _qkv(torch, g, dev, B, T)
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        mask = torch.ones(B, 1, 1, T, dtype=torch.bool, device=dev)
        sets = [(q, k, v, lens)]
        row = dict(B=B, T=T, H=H, Dh=Dh, ms=time_ms(torch, L1.flash_self_attention, sets, min_iters=10),
                   library_ms=time_ms(torch, lambda a, b, c, m: F.scaled_dot_product_attention(
                       a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2), attn_mask=m), [(q, k, v, mask)],
                       min_iters=10),
                   plain_ms=time_ms(torch, L1.flash_self_attention_reference, sets, min_iters=3) if B == 1 else None)
        # q, k, v read once and out written once; 4*B*H*T^2*Dh operations
        row["bound_ms"], row["bound_by"] = bound(4 * B * T * H * Dh * 2, 4 * B * H * T * T * Dh)
        row["tflops"] = 4 * B * H * T * T * Dh / (row["ms"] * 1e-3) / 1e12
        rows.append(row)
        log(f"flash_attention {row}")
        del q, k, v, sets
    B, T = 32, 1499
    q, k, v = _qkv(torch, g, dev, B, T)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    short = dict(B=B, T=T, ms=time_ms(torch, L1.flash_self_attention, [(q, k, v, lens)], min_iters=10),
                 plain_ms=time_ms(torch, L1.flash_self_attention_reference, [(q, k, v, lens)], min_iters=3),
                 unfused_ms=time_ms(torch, lambda a, b, c, m: L.attention(a, b, c, mask=m), [(q, k, v, mask)],
                                    min_iters=3))
    log(f"flash_attention at the 30 s bucket (FLASH_MIN_SEQ question, routing unchanged): {short}")
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return rows, worst, short


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
    and l written against the forward without, at B = 4."""
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


def want_decode(bits, steps):
    """Launches of a Whisper decode run of `steps` cached steps: 8 dense per
    decoder layer x 32 layers through K2 (int8) or K3 (int4), 32 self + 32
    cross attention sites through K4."""
    return {
        "matmul_int8": 256 * steps if bits == 8 else 0,
        "matmul_int4": 256 * steps if bits == 4 else 0,
        "flash_decode_int8": 64 * steps if bits else 0,
        "flash_decode_bf16": 0 if bits else 64 * steps,
    }


def check_transcripts(tag, out, ids, cfg, max_tokens):
    if [i for i, _ in out] != ids:
        raise AssertionError(f"{tag}: expected one transcript per file in order, got {[i for i, _ in out]}")
    for i, text in out:
        toks = [int(x) for x in text.split()]
        if not all(0 <= x < cfg.n_vocab for x in toks) or len(toks) > max_tokens:
            raise AssertionError(f"{tag}: bad transcript for {i}: {text!r}")


def run_slice(torch, kaldi_dir, ids, quantize_bits):
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
    it = whisper_infer(None, kaldi_dir, seeded_test_config="whisper:large-v3", quantize_bits=quantize_bits,
                       max_tokens=MAX_TOKENS, output_ids=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reset_counts()
    out = list(it)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches, counted = decode_launches()
    del it
    tag = {0: "bf16", 8: "int8", 4: "int4"}[quantize_bits]
    check_transcripts(tag, out, ids, cfg, MAX_TOKENS)
    want = want_decode(quantize_bits, steps)
    if launches != want or counted != steps:
        raise AssertionError(f"{tag}: launch counters {launches} != expected {want} ({steps} decode steps, {counted} counted)")
    audio_s = len(ids) * FILE_SECONDS
    res = dict(config=tag, files=len(ids), batch_size=batch, decode_steps=steps, load_s=t1 - t0, run_s=t2 - t1,
               audio_s_per_s=audio_s / (t2 - t1), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, sample=out[0][1][:80])
    log(f"slice {json.dumps(res)}")
    return res


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


def run_accurate(torch, kaldi_dir, ids):
    """python -m ssak_tpu_torch.infer.whisper_infer DIR m --seeded_test_config
    whisper:large-v3 --load_in_4bit --accurate, through whisper_infer, with
    the token budget cut to MAX_TOKENS: beam 5 at T = 0, then sampled
    best-of-5 at each fallback temperature for the windows that fail."""
    from ssak_tpu_torch.infer.whisper_infer import auto_window_batch, whisper_infer
    from ssak_tpu_torch.models.whisper import make_config

    cfg = make_config("large-v3")
    batch = auto_window_batch(cfg, 4, beam_size=5, best_of=5)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with DecodeCalls() as rec:
        t0 = time.perf_counter()
        it = whisper_infer(None, kaldi_dir, seeded_test_config="whisper:large-v3", quantize_bits=4, beam_size=5,
                           best_of=5, temperature_fallback=True, max_tokens=MAX_TOKENS, output_ids=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reset_counts()
        out = list(it)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches, steps = decode_launches()
    del it
    check_transcripts("int4 accurate", out, ids, cfg, MAX_TOKENS)
    want = want_decode(4, steps)
    if launches != want or not steps:
        raise AssertionError(f"int4 accurate: launch counters {launches} != expected {want} ({steps} decode steps)")
    if not rec.calls or rec.calls[0][:2] != ("beam_decode", 0.0):
        raise AssertionError(f"int4 accurate: decode calls {rec.calls} do not start with beam search at T=0")
    res = dict(config="int4 accurate (beam 5, best_of 5, fallback)", files=len(ids), file_s=ACC_SECONDS,
               batch_size=batch, decode_steps=steps, decode_calls=rec.calls,
               fallback_temperatures=sorted({t for _, t, _ in rec.calls if t > 0}), load_s=t1 - t0, run_s=t2 - t1,
               audio_s_per_s=len(ids) * ACC_SECONDS / (t2 - t1), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, sample=out[0][1][:80])
    log(f"slice {json.dumps(res)}")
    return res


def run_longform(torch):
    """transcribe_longform_batch on the seeded int4 large-v3 (as
    --load_in_4bit loads it) over LF_FILES files of LF_SECONDS (tones +
    noise): timestamps, conditioning, the full temperature chain with
    best_of 5, the no-speech skip, windows cut to MAX_TOKENS tokens."""
    import numpy as np

    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.infer.whisper_infer import transcribe_longform_batch
    from ssak_tpu_torch.models.whisper import fuse_decode_qkv

    rng = np.random.RandomState(5)
    audios = [tones(rng, LF_SECONDS) for _ in range(LF_FILES)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = load_model(None, seeded_test_config="whisper:large-v3", quantize_bits=4)
    fuse_decode_qkv(m.module)
    with DecodeCalls() as rec:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = transcribe_longform_batch(m, audios, best_of=5, max_tokens=MAX_TOKENS)
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
    res = dict(config="int4 long-form (full temperature chain, best_of 5)", files=LF_FILES, file_s=LF_SECONDS,
               max_tokens=MAX_TOKENS, seek_iterations=sum(1 for _, t, _ in rec.calls if t == 0.0),
               decode_window_calls=len(rec.calls), windows_per_call=sorted({r for _, _, r in rec.calls}),
               temperatures_used=sorted({sg["temperature"] for r in results for sg in r["segments"]}),
               segments=[len(r["segments"]) for r in results], decode_steps=steps, run_s=t1 - t0,
               audio_s_per_s=LF_FILES * LF_SECONDS / (t1 - t0), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, sample=results[0]["text"][:80])
    log(f"slice {json.dumps(res)}")
    del m
    return res


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
                batch=CTC_BATCH, steps=CTC_STEPS, bucket_s=15.0, buckets=None, remat=False),
    "ctc_long": dict(config="wav2vec2-xlsr ctc, 140 s bucket", model="xlsr", files=16, eval_files=4,
                     seconds=(90.0, 140.0), batch=4, steps=6, bucket_s=140.0, buckets=(140.0,), remat=LONG_REMAT),
}


def run_ctc_training(torch, dev, root, run):
    """CTCTrainer at full width (`run`, from CTC_RUNS): bf16 compute over f32
    master weights, frozen feature encoder, the trainer's default
    mask_time_prob, `steps` steps on a seeded Kaldi dir, one eval, a final
    checkpoint, and resume into a fresh trainer. Launch counters exact: K1
    once per step and eval batch; L1's forward 24 x (steps x (1 + remat) +
    eval batches) and each backward kernel 24 x steps at >= FLASH_MIN_SEQ
    frames, none below; every other kernel 0."""
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


def expected_encoder_frames(lens):
    """Frames of every encoder call ctc_infer makes over files of `lens`
    samples, in order, from the port's own packing (auto_pack_batches,
    padded_batch_shape) and chunking (chunk_lengths and the buckets)."""
    from ssak_tpu_torch.infer import ctc_infer as CI
    from ssak_tpu_torch.models.wav2vec2 import feature_extract_output_length, make_config

    cfg = make_config(SERVE_MODEL.split(":")[1])
    frames = []
    for batch, _ids in CI.auto_pack_batches((range(n), i) for i, n in enumerate(lens)):
        sizes = [len(a) for a in batch]
        short = [n for n in sizes if n <= CI.MAX_CHUNK_SAMPLES]
        if short:
            frames.append(feature_extract_output_length(cfg, CI.padded_batch_shape(short)[1]))
        for n in sizes:
            if n > CI.MAX_CHUNK_SAMPLES:
                frames += [feature_extract_output_length(cfg, CI._bucket_len(c)) for c in CI.chunk_lengths(n)]
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


class BeamCalls:
    """CUDA events around each ctc_beam_search_device call, with the host
    time of its enqueue and the frames it decodes, while installed."""

    def __init__(self, torch):
        from ssak_tpu_torch.decode import ctc_beam as CB

        self.torch, self.CB, self.calls, self.orig = torch, CB, [], CB.ctc_beam_search_device

    def __enter__(self):
        def call(log_probs, *a, **kw):
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


def write_lexicon_lm(root, seed=11, n_words=500, n_sentences=2000):
    """A seeded lexicon of a-z words and a word 3-gram ARPA trained on
    seeded sentences of them with the port's train_ngram_lm."""
    import numpy as np

    from ssak_tpu_torch.decode.lm import train_ngram_lm

    rng = np.random.RandomState(seed)
    words = sorted({"".join(rng.choice(list(CHARS), size=rng.randint(2, 9))) for _ in range(n_words)})
    sentences = [" ".join(rng.choice(words, size=rng.randint(3, 12))) for _ in range(n_sentences)]
    lexicon, arpa = os.path.join(root, "lexicon.txt"), os.path.join(root, "lm3.arpa")
    with open(lexicon, "w", encoding="utf-8") as f:
        f.write("\n".join(words) + "\n")
    train_ngram_lm(sentences, order=LM_ORDER, output_arpa=arpa)
    return lexicon, arpa


def run_ctc_serving(torch, kaldi_dir, ids, lens, mode, lexicon=None, arpa=None):
    """python -m ssak_tpu_torch.infer.ctc_infer DIR m --seeded_test_config
    wav2vec2:xlsr (xlsr widths, 24 layers, bf16, auto packing), greedy or
    with the device beam (width 16, lexicon, word 3-gram fused on the
    card), through ctc_infer; L1's launches checked against 24 x the
    encoder calls at >= FLASH_MIN_SEQ frames, every other kernel at 0."""
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
        it = ctc_infer(None, kaldi_dir, seeded_test_config=SERVE_MODEL, output_ids=True, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reset_counts()
        out = list(it)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = kernel_launches()
    del it
    tag = f"ctc serving {mode}"
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
    res = dict(config=f"{SERVE_MODEL} {mode}" + (f" (width {BEAM_WIDTH}, lexicon, word {LM_ORDER}-gram)" if kw else ""),
               files=len(ids), audio_s=audio_s, encoder_calls=len(enc.frames), encoder_frames=enc.frames,
               flash_encoder_calls=flash_calls, load_s=t1 - t0, run_s=t2 - t1, audio_s_per_s=audio_s / (t2 - t1),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
               nonempty=sum(bool(t) for _, t in out), sample=out[-1][1][:80])
    if beam:
        res["device_beam"] = beam
        res["device_beam_ms_140s_batch"] = [b["card_ms"] for b in beam if b["shape"][1] >= FLASH_MIN_SEQ]
    log(f"slice {json.dumps(res)}")
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
        caches = W.init_cache(cfg, mel.shape[0], device=mel.device)
        out = []
        for pos, tok in enumerate(tokens):
            token = torch.full((mel.shape[0], 1), tok, dtype=torch.int64, device=mel.device)
            logits, caches = W._decode_step(model, token, pos, caches, kv, cfg)
            out.append(logits.float().cpu())
    return torch.stack(out)


def check_card_vs_cpu(torch, dev):
    import dataclasses

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


def check_ctc_serving_card_vs_cpu(torch, dev):
    """CTC log-probs of one 140 s row (a 135 s file padded to the bucket,
    7,001 frames) on the card against the CPU, same seeded weights: xlsr
    widths at 2 layers in bf16, the dtype in which the card's encoder
    attention goes through L1 (2 launches) while the CPU runs the unfused
    attention; a spy on layers._can_flash asserts each attention call's
    route. The valid frames' log-probs must correlate >= 0.999; the share
    of frames with the same argmax is reported."""
    import numpy as np

    from ssak_tpu_torch.infer.ctc_infer import MAX_CHUNK_SAMPLES
    from ssak_tpu_torch.models import layers as L
    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.ops import flash_attention as L1

    cfg = wav2vec2.make_config("xlsr", num_layers=2, vocab_size=48)
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
    log(f"ctc serving card vs cpu (xlsr widths, 2 layers, bf16, 140 s row): {json.dumps(res)}")
    if not corr >= 0.999:
        raise AssertionError(f"ctc serving card vs cpu: correlation {corr} < 0.999")
    return res


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

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]

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
    """One bf16 train step at xlsr widths, 2 layers, remat, B = 2 at the
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

    cfg = wav2vec2.make_config("xlsr", num_layers=2, remat=True)
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
            def update(gr, state, params):
                grads.update({k: v.detach().float().cpu() for k, v in gr.items()})
                return opt.update(gr, state, params)

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
    log(f"long train step card vs cpu (xlsr widths, 2 layers, remat, bf16, B=2 at the 100 s bucket): {json.dumps(res)}")
    if not (res["loss_rel"] <= 1e-2 and res["grad_norm_rel"] <= 2e-2 and cos >= 0.99 and math.isfinite(card_loss)):
        raise AssertionError(f"long train step card vs cpu out of tolerance: {res}")
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
    log(f"card: {card}")

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s for {sorted(paths)}")
    for name, (_sec, report) in _build.build_log.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 2: kernels against their plain versions")
    k2_rows, k2_err = check_matmul_int8(torch, dev)
    k3_rows, k3_err = check_matmul_int4(torch, dev)
    fd_rows = {v: check_flash_decode(torch, dev, v == "int8") for v in ("bf16", "int8")}
    k1_rows, k1_err = check_ctc_fused(torch, dev)
    l1_rows, l1_err, l1_short = check_flash_attention(torch, dev)
    bwd_rows, bwd_err, bwd_pairs = check_flash_attention_bwd(torch, dev)

    log("phase 3: seeded large-v3 transcription (greedy bf16, int8, int4; int4 accurate; int4 long-form); "
        "wav2vec2-base CTC training; wav2vec2-xlsr CTC serving (greedy; device beam with lexicon and word LM); "
        "wav2vec2-xlsr CTC training at the 140 s bucket")
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_")
    try:
        ids = write_corpus(tmp)
        slices = {r["config"]: r for r in (run_slice(torch, tmp, ids, b) for b in (0, 8, 4))}
        acc_dir = os.path.join(tmp, "accurate")
        slices["int4_accurate"] = run_accurate(torch, acc_dir, write_corpus(acc_dir, ACC_FILES, ACC_SECONDS, seed=3))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    slices["int4_longform"] = run_longform(torch)
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_ctc_")
    try:
        slices["ctc"] = run_ctc_training(torch, dev, tmp, CTC_RUNS["ctc"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_serve_")
    try:
        ids, lens = write_serving_corpus(tmp)
        slices["ctc_serving_greedy"] = run_ctc_serving(torch, tmp, ids, lens, "greedy")
        n_beam = sum(n for n, _lo, hi in SERVE_GROUPS if hi <= 140.0)  # the files of one chunk at most
        lexicon, arpa = write_lexicon_lm(tmp)
        slices["ctc_serving_beam"] = run_ctc_serving(torch, kaldi_subset(os.path.join(tmp, "beam"), tmp, n_beam),
                                                     ids[:n_beam], lens[:n_beam], "beam", lexicon, arpa)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="ssak_smoke_long_")
    try:
        slices["ctc_long"] = run_ctc_training(torch, dev, tmp, CTC_RUNS["ctc_long"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    log("phase 4: card against CPU, large-v3 widths at 2+2 layers (bf16, int8, int4); wav2vec2 large widths at 2 "
        "layers (train steps); xlsr widths at 2 layers (CTC log-probs of a 140 s row; a bf16 train step at the 100 s "
        "bucket)")
    corr = check_card_vs_cpu(torch, dev)
    train_parity = check_train_step_card_vs_cpu(torch, dev)
    serving_parity = check_ctc_serving_card_vs_cpu(torch, dev)
    long_step_parity = check_long_train_step_card_vs_cpu(torch, dev)

    def head(rows, **shape):
        return next(r for r in rows if all(r[k] == v for k, v in shape.items()))

    kernels = []
    specs = [
        ("matmul_int8", "ssak_tpu_torch/csrc/int8_matmul.cu", "ssak_tpu/ops/int8_matmul.py:45",
         k2_rows, k2_err, dict(M=24, K=1280, N=5120), slices["int8"]["launches"]["matmul_int8"]),
        ("matmul_int4", "ssak_tpu_torch/csrc/int4_matmul.cu", "ssak_tpu/ops/int8_matmul.py:117",
         k3_rows, k3_err, dict(M=32, K=1280, N=5120),
         slices["int4_accurate"]["launches"]["matmul_int4"] + slices["int4_longform"]["launches"]["matmul_int4"]),
        ("flash_decode_bf16", "ssak_tpu_torch/csrc/flash_decode.cu", "ssak_tpu/ops/flash_decode.py:38",
         *fd_rows["bf16"], dict(B=24, T=1500), slices["bf16"]["launches"]["flash_decode_bf16"]),
        ("flash_decode_int8", "ssak_tpu_torch/csrc/flash_decode.cu", "ssak_tpu/ops/flash_decode.py:58",
         *fd_rows["int8"], dict(B=24, T=1500), slices["int8"]["launches"]["flash_decode_int8"]),
        ("ctc_fused", "ssak_tpu_torch/csrc/ctc_fused.cu", "ssak_tpu/ops/ctc_pallas.py:29",
         k1_rows, k1_err, dict(V=32, T=749),
         slices["ctc"]["launches"]["ctc_fused"] + slices["ctc_long"]["launches"]["ctc_fused"]),
        ("flash_attention", "ssak_tpu_torch/csrc/flash_attention.cu", "ssak_tpu/models/layers.py:290",
         l1_rows, l1_err, dict(B=1, T=7001),
         slices["ctc_serving_greedy"]["launches"]["flash_attention"]
         + slices["ctc_serving_beam"]["launches"]["flash_attention"] + slices["ctc_long"]["launches"]["flash_attention"]),
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
    log("summary " + json.dumps({"slices": slices, "card_vs_cpu_correlation": corr, "train_step_card_vs_cpu": train_parity,
                                 "ctc_serving_card_vs_cpu": serving_parity, "long_train_step_card_vs_cpu": long_step_parity,
                                 "flash_attention_30s_bucket": l1_short, "flash_attention_bwd_pairs": bwd_pairs}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
