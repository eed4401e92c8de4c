#!/usr/bin/env python3
"""Where the time goes inside K4, the flash-decode kernel, on one CUDA card.

    python3 tools/torch_flash_decode_variants.py [--plans 1:16:2:8,2:8:2] [--parent DIR] [--ranges 127,223]

Builds csrc/flash_decode.cu as it is and cut-down copies of it, each with
nvcc into build/flash_decode_variants/, by turning off the source's
switches (kCopies, kLogits, kSoftmax, kPV, kV), and times every copy with CUDA events on the
same plan and inputs at chip_smoke.py's phase-2 shapes (H = 20, Dh = 64; B
= 24 and 40 at T = 448 and 1,500 on the full range; the self-attention
range [0, 31] of the 448-slot cache at B = 24 in bf16 and 40 in int8), both
variants (bf16, int8):
  - kernel      the kernel as it is (checked against the plain version
                first, within 2e-2 and, in every (batch, head) row, 1e-2
                of the row's largest output: chip_smoke.py's limits);
  - loads_only  the bulk copies of K, V and the scales and their waits, the
                cluster barriers and the stores: no arithmetic;
  - no_work     launch, mbarrier set-up, cluster barriers and stores: the
                floor of this design;
  - k_only      K's copies, the logits, their exchange and the softmax: no V;
  - no_logits, no_softmax, no_pv
                the kernel without one pass's arithmetic (its copies, waits
                and barriers stay).
Beside them: the bound (the bytes of the keys in range over 3.35 TB/s),
SDPA with the same range mask (the library call chip_smoke.py times), and,
with --plans, the kernel on other flash_decode_plan splits
(cluster:seg_rows:stages[:warps], 0 for the plan's own choice). --ranges
N,... adds the self-attention ranges [0, N] of the 448-slot cache at B =
24 and 40 in both variants (a decode step at position N). With --parent DIR (a checkout, e.g. the parent
commit unpacked with `git archive`), DIR's own kernel is timed through DIR's
own wrapper at the same shapes, in a process of its own before and after
this tree's. The cut-down copies compute nothing useful; only their times
mean anything. Prints the card and one JSON object per shape; refuses to
run without a card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

MATH = ("constexpr bool kLogits = true;", "constexpr bool kSoftmax = true;", "constexpr bool kPV = true;")
VARIANTS = {
    "kernel": (),
    "loads_only": MATH,
    "no_work": ("constexpr bool kCopies = true;",) + MATH,
    "k_only": ("constexpr bool kV = true;",),
    "no_logits": MATH[:1],
    "no_softmax": MATH[1:2],
    "no_pv": MATH[2:],
}
SHAPES = [(B, T, 0, T - 1) for B in (24, 40) for T in (448, 1500)]
SELF_ATTN = {"bf16": (24, 448, 0, 31), "int8": (40, 448, 0, 31)}
H, DH = 20, 64


def build(root):
    """{variant: {"bf16": fn, "int8": fn}} of root's csrc/flash_decode.cu,
    one nvcc per variant, all started together."""
    from ssak_tpu_torch.ops import _build

    with open(os.path.join(root, "ssak_tpu_torch", "csrc", "flash_decode.cu")) as f:
        src = f.read()
    out_dir = os.path.join(root, "build", "flash_decode_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, off in VARIANTS.items():
        text = src
        for old in off:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/flash_decode.cu once")
            text = text.replace(old, old.replace("true;", "false;"))
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        handle = ctypes.CDLL(lib)
        fns[name] = {}
        for variant, n_ptr in (("bf16", 6), ("int8", 8)):
            fn = getattr(handle, f"ssak_flash_decode_{variant}")
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 10 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name][variant] = fn
    return fns


def inputs(torch, C, dev, variant, B, T, t_lo, t_hi, seed):
    """q, the caches (copies enough to exceed L2), the range, SDPA's inputs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    int8 = variant == "int8"
    q, kv = C._rand_kv(torch, g, dev, B, H, DH, T, int8)
    lo = torch.full((B,), t_lo, dtype=torch.int32, device=dev)
    hi = torch.full((B,), t_hi, dtype=torch.int32, device=dev)
    elt = 1 if int8 else 2
    kv_bytes = 2 * B * H * DH * T * elt + (2 * B * H * T * 2 if int8 else 0)
    sets = [(q, *(a.clone() for a in kv[:2]), lo, hi, *(a.clone() for a in kv[2:])) for _ in range(C.n_copies(kv_bytes))]
    return sets


def agrees(out, ref):
    """Within chip_smoke.py's limits for K4: 2e-2, and 1e-2 of each (batch,
    head) row's largest output."""
    rel = float(((out - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max())
    return float((out - ref).abs().max()) <= 2e-2 and rel <= 1e-2


def time_tree(torch, C, FD, dev, variant, shape, seed, fns=None, plans=()):
    """{name: ms} of this process's ssak_tpu_torch kernel at one shape:
    `kernel` through the wrapper, and with `fns` the cut-down copies and
    the plans given."""
    B, T, t_lo, t_hi = shape
    sets = inputs(torch, C, dev, variant, B, T, t_lo, t_hi, seed)
    out = FD.flash_decode_attention(*sets[0])
    ref = FD.flash_decode_reference(*sets[0])
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not agrees(out, ref):
        raise AssertionError(f"flash_decode_{variant} B={B} T={T} [{t_lo}, {t_hi}]: disagrees (max|err| {err})")
    row = {"max_abs_err": err, "kernel_ms": C.time_ms(torch, FD.flash_decode_attention, sets)}
    if fns is None:
        return row
    saved = dict(FD._fns)
    try:
        plan = FD.flash_decode_plan(B, H, DH, T, variant)
        row["plan"] = {k: plan[k] for k in ("cluster", "seg_rows", "stages", "warps", "smem", "ctas_per_sm",
                                             "clusters", "sites_per_cluster", "vec")}
        for name in VARIANTS:
            if name == "kernel":
                continue
            FD._fns[variant] = fns[name][variant]
            row[f"{name}_ms"] = C.time_ms(torch, FD.flash_decode_attention, sets)
        FD._fns[variant] = fns["kernel"][variant]
        for spec in plans:
            name = ":".join(str(x or 0) for x in spec)
            try:
                p = FD.flash_decode_plan(B, H, DH, T, variant, *spec)
            except ValueError as e:
                row[f"plan_{name}"] = str(e)
                continue
            out = FD.flash_decode_attention(*sets[0], plan=p)
            torch.cuda.synchronize()
            if not agrees(out, ref):
                raise AssertionError(f"flash_decode_{variant} plan {name} disagrees with the plain version")
            row[f"plan_{name}_ms"] = C.time_ms(torch, lambda *a: FD.flash_decode_attention(*a, plan=p), sets)
    finally:
        FD._fns.clear()
        FD._fns.update(saved)
    return row


def library_ms(torch, C, dev, variant, shape, seed):
    import torch.nn.functional as F

    B, T, t_lo, t_hi = shape
    first = inputs(torch, C, dev, variant, B, T, t_lo, t_hi, seed)[0]
    q, k, v, sc = *first[:3], first[5:]
    if sc:
        k = (k.float() * sc[0].float()).to(torch.bfloat16)
        v = (v.float() * sc[1].float()).to(torch.bfloat16)
    mask = torch.zeros(B, 1, 1, T, dtype=torch.bool, device=dev)
    mask[..., t_lo:t_hi + 1] = True
    sets = [(q[:, :, None], k.transpose(-1, -2).contiguous(), v.transpose(-1, -2).contiguous(), mask)
            for _ in range(C.n_copies(2 * B * H * DH * T * 2))]
    return C.time_ms(torch, lambda a, kk, vv, m: F.scaled_dot_product_attention(a, kk, vv, attn_mask=m, scale=1.0), sets)


def shapes(ranges=()):
    for variant in ("bf16", "int8"):
        for shape in SHAPES + [SELF_ATTN[variant]]:
            yield variant, shape
        for n in ranges:
            for B in (24, 40):
                yield variant, (B, 448, 0, n)


def run_parent(parent, ranges):
    """{(variant, shape): ms} of DIR's kernel, timed in a process of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(parent))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", os.path.abspath(parent), "--kernel_only",
                          "--ranges", ",".join(map(str, ranges))],
                         capture_output=True, text=True, env=env, cwd=os.path.abspath(parent), timeout=900)
    if res.returncode:
        raise RuntimeError(f"the parent's run failed:\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    rows = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    return {(r["variant"], tuple(r["shape"])): r["kernel_ms"] for r in rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", default="", help="comma-separated cluster:seg_rows:stages[:warps] plans to time as well")
    ap.add_argument("--parent", default="", help="a checkout whose own kernel is timed before and after this tree's")
    ap.add_argument("--ranges", default="", help="comma-separated N: also time the self-attention ranges [0, N] of T = 448")
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    ap.add_argument("--kernel_only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_decode_variants: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as C
    from ssak_tpu_torch.ops import flash_decode as FD

    dev = torch.device("cuda", 0)
    ranges = [int(n) for n in args.ranges.split(",") if n]
    if args.kernel_only:  # a process timing one checkout's kernel through its own wrapper
        for i, (variant, shape) in enumerate(shapes(ranges)):
            row = time_tree(torch, C, FD, dev, variant, shape, seed=40 + i)
            print(json.dumps({"variant": variant, "shape": shape, **row}), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    plans = [tuple(int(x) or None for x in p.split(":")) for p in args.plans.split(",") if p]
    before = run_parent(args.parent, ranges) if args.parent else {}
    fns = build(args.root)
    rows = []
    for i, (variant, shape) in enumerate(shapes(ranges)):
        row = {"variant": variant, "B": shape[0], "T": shape[1], "range": f"{shape[2]}:{shape[3]}"}
        row.update(time_tree(torch, C, FD, dev, variant, shape, seed=40 + i, fns=fns, plans=plans))
        row["library_ms"] = library_ms(torch, C, dev, variant, shape, seed=40 + i)
        B, T, t_lo, t_hi = shape
        n, elt = t_hi - t_lo + 1, 1 if variant == "int8" else 2
        in_range = 2 * B * H * DH * n * elt + (2 * B * H * n * 2 if variant == "int8" else 0)
        row["bound_ms"], row["bound_by"] = C.bound(in_range + B * H * DH * (2 + 4) + 8 * B, 4 * B * H * DH * n)
        rows.append(row)
        torch.cuda.empty_cache()
    after = run_parent(args.parent, ranges) if args.parent else {}
    for (variant, shape), row in zip(shapes(ranges), rows):
        if args.parent:
            row["parent_ms"] = [before[variant, tuple(shape)], after[variant, tuple(shape)]]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
