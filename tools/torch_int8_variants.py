#!/usr/bin/env python3
"""Where the time goes inside K2 (the int8 dequant-matmul), on one CUDA card.

    python3 tools/torch_int8_variants.py

Builds csrc/int8_matmul.cu as it is and three cut-down copies of it, each
with nvcc into build/int8_variants/, and times all four with CUDA events at
the six shapes chip_smoke.py times (M = 24, 40 at the Whisper large-v3
decoder's (K, N) = (1280, 1280), (1280, 5120), (5120, 1280)), on the same
plan and inputs:
  - kernel        the kernel as it is;
  - no_work       no loads and no products: the launch, the cluster's two
                  syncs and the epilogue (the floor of this design);
  - loads_only    every cp.async stage issued and waited for, no products;
  - compute_only  the products on whatever the shared memory holds, no loads.
Beside them: one PyTorch copy of the weight bytes (a read and a write of
K*N bytes, a yardstick of what a plain memory-bound kernel takes at this
size) and the library call chip_smoke.py times (bf16 weight matmul times
the scale). The cut-down copies compute nothing useful; only their times
mean anything. Prints the card and one JSON object per shape; refuses to
run without a card.
"""

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
SHAPES = [(m, k, n) for m in (24, 40) for (k, n) in ((1280, 1280), (1280, 5120), (5120, 1280))]


def build(src):
    """{variant: ctypes function}, one nvcc per variant, all started together."""
    from ssak_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "int8_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the anchor {old.strip()!r} is not in csrc/int8_matmul.cu once")
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
        fn = ctypes.CDLL(lib).ssak_int8_matmul
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_int8_variants: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as C
    from ssak_tpu_torch.models.quant import quantize_kernel
    from ssak_tpu_torch.ops import _build
    from ssak_tpu_torch.ops import int8_matmul as IM

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with open(os.path.join(ROOT, "ssak_tpu_torch", "csrc", "int8_matmul.cu")) as f:
        fns = build(f.read())
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        q8, scale = quantize_kernel(torch.randn(K, N, generator=g, device=dev) * 0.05)
        sets = [(x, q8.clone(), scale.clone()) for _ in range(C.n_copies(K * N))]
        block_n, splits, per = IM.int8_plan(M, K, N)
        row = dict(M=M, K=K, N=N, block_n=block_n, splits=splits)
        for name, fn in fns.items():
            def call(a, w, s, fn=fn):
                y = torch.empty((M, N), dtype=torch.float32, device=dev)
                _build.check(fn(a.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), M, K, N, block_n, splits, per,
                                _build.stream_ptr(dev)), name)
                return y
            row[name + "_us"] = C.time_ms(torch, call, sets) * 1e3
        dst = torch.empty_like(q8)
        row["weight_copy_us"] = C.time_ms(torch, lambda a, w, s: dst.copy_(w), sets) * 1e3
        wdq = [(x, a[1].to(torch.bfloat16), a[2]) for a in sets]
        row["library_us"] = C.time_ms(torch, lambda a, w, s: torch.matmul(a, w) * s, wdq) * 1e3
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
