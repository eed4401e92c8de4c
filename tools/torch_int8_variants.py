#!/usr/bin/env python3
"""Where the time goes inside K2 (the int8 dequant-matmul) or K3 (the int4
one), on one CUDA card.

    python3 tools/torch_int8_variants.py [--kernel int8|int4]

Builds csrc/int8_matmul.cu (or csrc/int4_matmul.cu) as it is and three
cut-down copies of it, each with nvcc into build/int8_variants/<kernel>/,
and times all four with CUDA events at the shapes chip_smoke.py times (K2:
M = 24, 40; K3: M = 40, 32, 24, 20, the rows of phase 3's int4 paths; each
at the Whisper large-v3 decoder's (K, N) = (1280, 1280), (1280, 5120),
(5120, 1280)), on the same plan and inputs (the two kernels share the loop
that the anchors below cut):
  - kernel        the kernel as it is;
  - no_work       no loads and no products: the launch, the cluster's sum
                  and the epilogue (the floor of this design);
  - loads_only    every cp.async stage issued and waited for, no products;
  - compute_only  the products on whatever the shared memory holds, no loads.
Beside them: one PyTorch copy of the weight bytes (a read and a write of
the int8 or packed int4 weights, a yardstick of what a plain memory-bound
kernel takes at this size) and the library call chip_smoke.py times (K2:
bf16 weight matmul times the scale; K3: matmul on the dequantized bf16
weight). The cut-down copies compute nothing useful; only their times mean
anything. Prints the card and one JSON object per shape; refuses to run
without a card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

NO_LOADS = ("        if (s < steps) load_stage(s, s);", "        if (false) load_stage(s, s);")
NO_REFILL = ("            if (i - 1 + slots < steps) load_stage(i - 1 + slots, prev);", "")
NO_LOOP = ("i < steps; ++i, prev", "i < 0; ++i, prev")
NO_PRODUCTS = ("        const unsigned char* st = smem + slot * L::SLOT;",
               "        if (true) continue;\n        const unsigned char* st = smem + slot * L::SLOT;")
VARIANTS = {
    "kernel": (),
    "no_work": (NO_LOADS, NO_LOOP),
    "loads_only": (NO_PRODUCTS,),
    "compute_only": (NO_LOADS, NO_REFILL),
}
SITES = ((1280, 1280), (1280, 5120), (5120, 1280))


def build(kernel):
    """{variant: ctypes function} of csrc/<kernel>_matmul.cu, one nvcc per
    variant, all started together."""
    from ssak_tpu_torch.ops import _build

    with open(os.path.join(ROOT, "ssak_tpu_torch", "csrc", f"{kernel}_matmul.cu")) as f:
        src = f.read()
    out_dir = os.path.join(ROOT, "build", "int8_variants", kernel)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the anchor {old.strip()!r} is not in csrc/{kernel}_matmul.cu once")
            text = text.replace(old, new)
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
        fn = getattr(ctypes.CDLL(lib), f"ssak_{kernel}_matmul")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=["int8", "int4"], default="int8")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_int8_variants: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as C
    from ssak_tpu_torch.models.quant import dequantize_int4, quantize_kernel
    from ssak_tpu_torch.ops import _build
    from ssak_tpu_torch.ops import int8_matmul as IM

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    int4 = args.kernel == "int4"
    fns = build(args.kernel)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4 if int4 else 1)
    rows_m = sorted(set(C.int4_rows()), reverse=True) if int4 else (24, 40)
    for M, K, N in [(m, k, n) for m in rows_m for (k, n) in SITES]:
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        w, scale = quantize_kernel(torch.randn(K, N, generator=g, device=dev) * 0.05, bits=4 if int4 else 8)
        sets = [(x, w.clone(), scale.clone()) for _ in range(C.n_copies(w.numel()))]
        block_n, splits, per = (IM.int4_plan if int4 else IM.int8_plan)(M, K, N)
        row = dict(kernel=args.kernel, M=M, K=K, N=N, block_n=block_n, splits=splits)
        for name, fn in fns.items():
            def call(a, w, s, fn=fn):
                y = torch.empty((M, N), dtype=torch.float32, device=dev)
                _build.check(fn(a.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), M, K, N, block_n, splits, per,
                                _build.stream_ptr(dev)), name)
                return y
            row[name + "_us"] = C.time_ms(torch, call, sets) * 1e3
        dst = torch.empty_like(w)
        row["weight_copy_us"] = C.time_ms(torch, lambda a, w, s: dst.copy_(w), sets) * 1e3
        if int4:
            wdq = [(x, dequantize_int4(a[1], a[2], torch.bfloat16)) for a in sets]
            row["library_us"] = C.time_ms(torch, torch.matmul, wdq) * 1e3
        else:
            wdq = [(x, a[1].to(torch.bfloat16), a[2]) for a in sets]
            row["library_us"] = C.time_ms(torch, lambda a, w, s: torch.matmul(a, w) * s, wdq) * 1e3
        print(json.dumps(row), flush=True)
        del sets, wdq
    return 0


if __name__ == "__main__":
    sys.exit(main())
