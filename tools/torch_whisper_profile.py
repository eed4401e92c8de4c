#!/usr/bin/env python3
"""Where the time goes in the port's Whisper decode paths, on one CUDA card.

    python3 tools/torch_whisper_profile.py [--configs bf16 int8 int4] [--batch 24] [--max_tokens 32]
                                           [--step_pos 0 200] [--root DIR] [--ab_parent DIR --pairs 6]
                                           [--ab_leaves --configs int8 int4 --pairs 4]

For each configuration: a seeded large-v3 model prepared as whisper_infer
prepares it (bf16 cast, or int8 / int4 quantization; fused decoder q/k/v
where not quantized), a batch of 30 s windows of random audio, then
  - phase times with CUDA events: log-mel, encoder, cross-attention K/V,
    one decode step (mean of 8, at positions 0-7 and from each further
    --step_pos P at P..P+7), and the whole greedy_decode; beside the
    encoder and the decode step, the host time to enqueue them;
  - the host time of one call of K4's wrapper (flash_decode_attention) at
    the step's self-attention (the 448-slot cache, range [0, 7]) and
    cross-attention (1,500 keys) shapes, 256 calls queued behind a spin
    kernel;
  - those 8 decode steps, then one greedy_decode, under torch.profiler:
    the device busy share (union of kernel intervals / wall time), the
    time the host was blocked on a full command queue, K4's device time
    and launches, and device time by kernel name (top 12). A busy share
    near 1 means the card is the bottleneck; well below 1 with no blocked
    time, the host is;
  - int4 only, the decoders of --accurate and of long-form, timed and
    traced the same way: beam_decode (8 windows x 5 beams), sample_decode
    at T = 0.6 with best_of 5 (8 windows x 5 candidates), and
    decode_window at T = 0.6 with best_of 5 over 4 windows with
    timestamps and the long-form prompt buffer (P = 225, bare prompt).
Prints one JSON object per configuration. --root DIR profiles another
checkout's package (e.g. the parent commit unpacked with `git archive`)
with this script. --ab_parent DIR [--pairs N] runs only k4_ab: greedy
decoding and K4's wrapper with this tree's K4 and with DIR's, in one
process on one model, N pairs alternating which goes first. --ab_leaves
[--pairs N] runs only leaves_ab: chip_smoke.py's seeded large-v3 tree,
quantized (int8 / int4 only), built once with f32 leaves and once with the
leaves rounded to f16 (what an F16 checkpoint directory loads), each
without and with chip_smoke.py's byte-level tokenizer, then N rounds of
chip_smoke.py's greedy slice (its 24-file corpus through whisper_infer's
batching, prefetch and transcripts) over every side in a rotating order,
and of greedy_decode alone on one batch of windows. Numbers are only
meaningful on the card; the script refuses to run without one.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _events(torch, fn):
    """(device ms between events around fn, host ms to enqueue fn, fn's result)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    t0 = time.perf_counter()
    out = fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), host_ms, out


def _wrapper_host_us(torch, FD, q, kv, lo, hi, n=256):
    """Host us of one K4 wrapper call, n calls queued behind a spin kernel
    (so the command queue never stalls the host)."""
    args = (q, kv["k8"], kv["v8"], lo, hi, kv["ks"], kv["vs"]) if "k8" in kv else (q, kv["k"], kv["v"], lo, hi)
    FD.flash_decode_attention(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        FD.flash_decode_attention(*args)
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def _parent_flash_decode(parent):
    """DIR's ops/flash_decode module loaded beside this tree's, bound to
    DIR's own _build (so to DIR's csrc/flash_decode.cu)."""
    import importlib.util

    ops = os.path.join(os.path.abspath(parent), "ssak_tpu_torch", "ops")
    mods = {}
    for name in ("_build", "flash_decode"):
        spec = importlib.util.spec_from_file_location(f"parent_{name}", os.path.join(ops, name + ".py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    mods["flash_decode"]._build = mods["_build"]
    return mods["flash_decode"]


def k4_ab(torch, bits, batch, max_tokens, parent, pairs):
    """K4, kernel and wrapper, of this tree against DIR's in one process on
    one model: `pairs` pairs of greedy_decode runs (ms, CUDA-synchronized
    wall time) and of the wrapper's host us at the decode step's self- and
    cross-attention shapes, alternating which side runs first. Only the
    decoder's calls of flash_decode_attention change sides."""
    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.models import layers as L
    from ssak_tpu_torch.models import whisper as W
    from ssak_tpu_torch.ops import flash_decode as FD
    from ssak_tpu_torch.ops.logmel import log_mel_spectrogram

    sides = {"change": FD, "parent": _parent_flash_decode(parent)}
    m = load_model(None, seeded_test_config="whisper:large-v3", quantize_bits=bits)
    if not bits:
        m.module.to(torch.bfloat16)
    W.fuse_decode_qkv(m.module)
    cfg, model = m.cfg, m.module
    prompt = [cfg.sot, cfg.no_timestamps]
    g = torch.Generator(device="cuda").manual_seed(0)
    audio = torch.randn(batch, 480000, generator=g, device="cuda") * 0.1
    res = {"config": {0: "bf16", 8: "int8", 4: "int4"}[bits], "batch": batch, "max_tokens": max_tokens,
           "card": torch.cuda.get_device_name(0), "order": [],
           "greedy_decode_ms": {k: [] for k in sides}, "wrapper_host_us": {k: {"self": [], "cross": []} for k in sides}}
    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, cfg.n_mels)
        af = W.encode(model, mel, cfg)
        kv = W.precompute_cross_kv(model, af, cfg)
        caches = W.init_cache(cfg, batch, device="cuda")
        H = cfg.n_text_head
        qk = (torch.randn(batch, H, cfg.n_text_state // H, generator=g, device="cuda") * 0.125).to(torch.bfloat16)
        zero = torch.zeros(batch, dtype=torch.int32, device="cuda")
        own = L.flash_decode_attention
        try:
            for side in sides.values():  # warm-up: builds, first launches
                L.flash_decode_attention = side.flash_decode_attention
                W.greedy_decode(model, mel, cfg, prompt, max_tokens=2)
            for i in range(pairs):
                order = ("change", "parent") if i % 2 == 0 else ("parent", "change")
                res["order"].append(order[0])
                for who in order:
                    L.flash_decode_attention = sides[who].flash_decode_attention
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    W.greedy_decode(model, mel, cfg, prompt, max_tokens=max_tokens)
                    torch.cuda.synchronize()
                    res["greedy_decode_ms"][who].append((time.perf_counter() - t0) * 1e3)
                    host = res["wrapper_host_us"][who]
                    host["self"].append(_wrapper_host_us(torch, sides[who], qk, caches[0], zero, zero + 7))
                    host["cross"].append(_wrapper_host_us(torch, sides[who], qk, kv[0], zero, zero + af.shape[1] - 1))
        finally:
            L.flash_decode_attention = own
    del m, model, kv, caches
    torch.cuda.empty_cache()
    return res


def leaves_ab(torch, bits, rounds, preset="large-v3", device="cuda"):
    """f32 against f16 leaves, and no tokenizer against chip_smoke.py's,
    on one seeded tree in one process (see the module docstring), TF32 off
    as in chip_smoke.py. Returns wall ms of each slice run and of each
    greedy_decode per side, in run order, and the dtypes of each side's
    parameters."""
    import dataclasses
    import tempfile

    import numpy as np

    import chip_smoke as CS
    from ssak_tpu_torch.data.dataset import to_audio_batches
    from ssak_tpu_torch.infer import whisper_infer as WI
    from ssak_tpu_torch.infer.general import LoadedModel, ModelType, _with_tokenizer_ids
    from ssak_tpu_torch.models import whisper as W
    from ssak_tpu_torch.models.convert import whisper_from_tree
    from ssak_tpu_torch.models.quant import quantize_params
    from ssak_tpu_torch.models.tokenizer import WhisperTokenizer
    from ssak_tpu_torch.ops.logmel import log_mel_spectrogram

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(W.make_config(preset), kv_int8=True)
    tree = CS.seeded_tree(cfg)
    root = tempfile.mkdtemp(prefix="leaves_ab_")
    CS.write_byte_level_vocab(root)
    tok = WhisperTokenizer(root)
    kaldi = os.path.join(root, "corpus")
    ids = CS.write_corpus(kaldi)
    modules, sides = {}, {}
    for leaf in ("f32", "f16"):
        src = tree if leaf == "f32" else CS.tree_map(lambda a: a.astype(np.float16), tree)
        module = whisper_from_tree(src, device)
        del src
        quantize_params(module, bits=bits)
        W.fuse_decode_qkv(module)
        modules[leaf] = module
        sides[leaf] = LoadedModel(ModelType.WHISPER, module, cfg, device, None)
        sides[leaf + "+tokenizer"] = LoadedModel(ModelType.WHISPER, module, _with_tokenizer_ids(cfg, tok), device, tok)
    del tree
    batch = WI.auto_window_batch(cfg, bits)
    options = dict(language=None, max_tokens=CS.MAX_TOKENS, beam_size=0, temperature_fallback=False, best_of=1)
    g = torch.Generator(device=device).manual_seed(0)
    audio = torch.randn(batch, cfg.n_audio_ctx * 320, generator=g, device=device) * 0.1
    names = list(sides)
    res = {"config": {8: "int8", 4: "int4"}[bits], "batch": batch, "files": len(ids), "max_tokens": CS.MAX_TOKENS,
           "card": torch.cuda.get_device_name(0) if device == "cuda" else device, "order": [],
           "param_dtypes": {k: sorted({str(p.dtype) for p in m.parameters()}) for k, m in modules.items()},
           "slice_ms": {k: [] for k in names}, "greedy_decode_ms": {k: [] for k in modules}}

    def run_slice(model):
        batches = to_audio_batches(kaldi, batch_size=batch, sample_rate=16000, output_ids=True,
                                   io_threads=min(4, os.cpu_count() or 2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = list(WI._transcripts(model, batches, options, True))
        torch.cuda.synchronize()
        if [i for i, _ in out] != ids:
            raise AssertionError("leaves_ab: one transcript per file, in order")
        return (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, cfg.n_mels)
        prompt = [cfg.sot, cfg.no_timestamps]
        for name in names:  # warm-up
            run_slice(sides[name])
        for i in range(rounds):
            order = names[i % len(names):] + names[: i % len(names)]
            res["order"].append(order)
            for name in order:
                res["slice_ms"][name].append(run_slice(sides[name]))
            for leaf in (("f32", "f16") if i % 2 == 0 else ("f16", "f32")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                W.greedy_decode(modules[leaf], mel, cfg, prompt, max_tokens=CS.MAX_TOKENS)
                torch.cuda.synchronize()
                res["greedy_decode_ms"][leaf].append((time.perf_counter() - t0) * 1e3)
    del sides, modules
    torch.cuda.empty_cache()
    return res


def profile(torch, bits, batch, max_tokens, step_pos=()):
    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.models import whisper as W
    from ssak_tpu_torch.ops import flash_decode as FD
    from ssak_tpu_torch.ops.logmel import log_mel_spectrogram

    import numpy as np

    m = load_model(None, seeded_test_config="whisper:large-v3", quantize_bits=bits)
    if not bits:
        m.module.to(torch.bfloat16)
    W.fuse_decode_qkv(m.module)
    cfg, model = m.cfg, m.module
    prompt = [cfg.sot, cfg.no_timestamps]
    g = torch.Generator(device="cuda").manual_seed(0)
    audio = torch.randn(batch, 480000, generator=g, device="cuda") * 0.1
    W.greedy_decode(model, log_mel_spectrogram(audio, cfg.n_mels), cfg, prompt, max_tokens=2)  # warm-up
    torch.cuda.synchronize()
    res = {"config": {0: "bf16", 8: "int8", 4: "int4"}[bits], "batch": batch, "max_tokens": max_tokens,
           "card": torch.cuda.get_device_name(0)}
    with torch.inference_mode():
        res["logmel_ms"], _, mel = _events(torch, lambda: log_mel_spectrogram(audio, cfg.n_mels))
        res["encode_ms"], res["encode_enqueue_ms"], af = _events(torch, lambda: W.encode(model, mel, cfg))
        res["cross_kv_ms"], _, kv = _events(torch, lambda: W.precompute_cross_kv(model, af, cfg))
        caches = W.init_cache(cfg, batch, device="cuda")
        tok = torch.full((batch, 1), cfg.sot, dtype=torch.int64, device="cuda")
        n = 8
        ms, host, _ = _events(torch, lambda: [W._decode_step(model, tok, p, caches, kv, cfg) for p in range(n)])
        res["decode_step_ms"], res["decode_step_enqueue_ms"] = ms / n, host / n
        H = cfg.n_text_head
        qk = (torch.randn(batch, H, cfg.n_text_state // H, generator=g, device="cuda") * 0.125).to(torch.bfloat16)
        zero = torch.zeros(batch, dtype=torch.int32, device="cuda")
        res["k4_wrapper_host_us"] = {
            "self": _wrapper_host_us(torch, FD, qk, caches[0], zero, zero + n - 1),
            "cross": _wrapper_host_us(torch, FD, qk, kv[0], zero, zero + af.shape[1] - 1),
        }
        res["greedy_decode_ms"], _, _ = _events(torch, lambda: W.greedy_decode(model, mel, cfg, prompt, max_tokens=max_tokens))
        windows = {
            "decode_steps": lambda: [W._decode_step(model, tok, p, caches, kv, cfg) for p in range(n)],
            "greedy_decode": lambda: W.greedy_decode(model, mel, cfg, prompt, max_tokens=max_tokens),
        }
        for p0 in step_pos:
            steps = lambda p0=p0: [W._decode_step(model, tok, p, caches, kv, cfg) for p in range(p0, p0 + n)]
            ms, host, _ = _events(torch, steps)
            res[f"decode_step_ms_at_{p0}"], res[f"decode_step_enqueue_ms_at_{p0}"] = ms / n, host / n
            windows[f"decode_steps_at_{p0}"] = steps
        if bits == 4:
            P = cfg.n_text_ctx // 2 + 1
            buf = np.full((4, P), cfg.eot, np.int32)
            buf[:, -1] = cfg.sot
            accurate = {
                "beam_decode": lambda: W.beam_decode(model, mel[:8], cfg, prompt, beam_size=5, max_tokens=max_tokens),
                "sample_decode_best_of": lambda: W.sample_decode(model, mel[:8], cfg, prompt, 1, temperature=0.6,
                                                                 max_tokens=max_tokens, best_of=5),
                "decode_window_best_of": lambda: W.decode_window(model, mel[:4], buf, [1] * 4, cfg, sot_distance=1,
                                                                 max_tokens=max_tokens, with_timestamps=True,
                                                                 temperature=0.6, seed=1, best_of=5),
            }
            for name, fn in accurate.items():
                n0 = W.DECODE_STEPS["n"]
                res[name + "_ms"], _, _ = _events(torch, fn)
                res[name + "_steps"] = W.DECODE_STEPS["n"] - n0
            windows.update(accurate)
        for name, fn in windows.items():
            res[name] = _trace(torch, fn)
    del m, model, kv, caches
    torch.cuda.empty_cache()
    return res


def _trace(torch, fn):
    """Run fn under torch.profiler: wall ms, the device's busy ms (union of
    the kernel and copy intervals on the card), its busy share, the ms the
    host spent blocked on a full command queue (CUPTI's "Command Buffer
    Full" records: the card was behind), and the top kernels by device ms."""
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
    k4 = [(ms, c) for k, (ms, c) in by_name.items() if "flash_decode" in k]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / 1e3 / wall_ms,
            "host_blocked_on_full_queue_ms": blocked_us / 1e3, "n_device_events": len(spans),
            "k4_ms": sum(ms for ms, _ in k4), "k4_launches": sum(c for _, c in k4),
            "top_kernels": [{"name": k[:90], "ms": ms, "count": c} for ms, c, k in rows[:12]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=["bf16", "int8", "int4"], choices=["bf16", "int8", "int4"])
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--max_tokens", type=int, default=32)
    ap.add_argument("--step_pos", type=int, nargs="*", default=[], help="also time and trace 8 decode steps from each")
    ap.add_argument("--root", default="", help="profile this checkout's ssak_tpu_torch instead")
    ap.add_argument("--ab_parent", default="", help="instead, K4 of this tree against DIR's, alternating (k4_ab)")
    ap.add_argument("--ab_leaves", action="store_true", help="instead, f32 against f16 leaves (leaves_ab)")
    ap.add_argument("--pairs", type=int, default=6)
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_whisper_profile: no CUDA device", file=sys.stderr)
        return 3
    for c in args.configs:
        if args.ab_leaves:
            if c != "bf16":  # bf16 casts every leaf to bf16
                print(json.dumps(leaves_ab(torch, {"int8": 8, "int4": 4}[c], args.pairs)), flush=True)
            continue
        if args.ab_parent:
            bits = {"bf16": 0, "int8": 8, "int4": 4}[c]
            print(json.dumps(k4_ab(torch, bits, args.batch, args.max_tokens, args.ab_parent, args.pairs)), flush=True)
            continue
        print(json.dumps(profile(torch, {"bf16": 0, "int8": 8, "int4": 4}[c], args.batch, args.max_tokens,
                                 args.step_pos)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
