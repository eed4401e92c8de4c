#!/usr/bin/env python3
"""Where the time goes inside L1's backward kernels (dK/dV and dQ), on one
CUDA card.

    python3 tools/torch_flash_bwd_variants.py [--plans 64:2,64:3,32:3]

Builds csrc/flash_attention_bwd.cu as it is and cut-down copies of it, each
with nvcc into build/flash_bwd_variants/, by turning off the source's
switches (kLoads, kProducts, kElementwise) or two of its design choices
(kPingPong, OWN_REGS), and times both kernels of every copy with CUDA
events on the same plan and inputs at chip_smoke.py's phase-2 shapes (T =
6,999, H = 16, Dh = 64, B = 4 and 1, full rows):
  - kernel           the kernels as they are;
  - products_only    the wgmma products and the TMA ring, no exp, ds or mask
                     (P and dS are the raw S and dP, packed);
  - loads_only       the TMA ring, its barriers and the output stores: no
                     products, no elementwise work;
  - no_work          the own rows' load and the stores only (the floor of
                     this design: launch, prologue, epilogue);
  - no_pingpong      the kernels with the two consumer warpgroups issuing
                     their products whenever they are ready, not in turns;
  - own_from_shared  the kernels with the own rows' A operand read by wgmma
                     from shared memory, as at Dh = 128 and 256, instead of
                     held in registers.
Beside them: SDPA's backward with a key-padding mask (the library call
chip_smoke.py times), and, with --plans, the kernels on other
flash_bwd_plan tilings (walk:stages). The cut-down copies compute nothing
useful; only their times mean anything. Prints the card and one JSON
object per shape; refuses to run without a card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

OWN_REGS = "static constexpr bool OWN_REGS = D == 64;"
VARIANTS = {
    "kernel": (),
    "products_only": ("constexpr bool kElementwise = true;",),
    "loads_only": ("constexpr bool kProducts = true;", "constexpr bool kElementwise = true;"),
    "no_work": ("constexpr bool kLoads = true;", "constexpr bool kProducts = true;",
                "constexpr bool kElementwise = true;"),
    "no_pingpong": ("constexpr bool kPingPong = true;",),
    "own_from_shared": (OWN_REGS,),
}


def build():
    """{variant: {"dkv": fn, "dq": fn}} of csrc/flash_attention_bwd.cu, one
    nvcc per variant, all started together."""
    from ssak_tpu_torch.ops import _build

    with open(os.path.join(ROOT, "ssak_tpu_torch", "csrc", "flash_attention_bwd.cu")) as f:
        src = f.read()
    out_dir = os.path.join(ROOT, "build", "flash_bwd_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, off in VARIANTS.items():
        text = src
        for old in off:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/flash_attention_bwd.cu once")
            new = old.replace("D == 64;", "false;") if old == OWN_REGS else old.replace("true;", "false;")
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
        handle = ctypes.CDLL(lib)
        fns[name] = {}
        for kernel, n_out in (("dkv", 2), ("dq", 1)):
            fn = getattr(handle, f"ssak_flash_attention_bwd_{kernel}")
            fn.argtypes = ([ctypes.c_void_p] * (8 + n_out) + [ctypes.c_int] * 4
                           + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float] + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[name][kernel] = fn
    return fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", default="", help="comma-separated walk:stages plans to time the kernels on as well")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as C
    from ssak_tpu_torch.ops import flash_attention as L1

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fns = build()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(10)
    extra = [tuple(int(x) for x in p.split(":")) for p in args.plans.split(",") if p]
    saved = dict(L1._fns)
    try:
        for B in (4, 1):
            T, H, Dh = 6999, 16, 64
            q, k, v, do = (torch.randn(B, T, H, Dh, generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
            lens = torch.full((B,), T, dtype=torch.int32, device=dev)
            with torch.no_grad():
                o, m, l = L1._flash_forward(q, k, v, lens, None, stats=True)
                di = L1.attention_di(o, do)
            sets = [(q, k, v, do, m, l, di, lens)]
            plan = L1.flash_bwd_plan(B, T, H, Dh)
            row = dict(B=B, T=T, H=H, Dh=Dh, plan={n: (p["walk"], p["stages"]) for n, p in plan.items()})

            def timed(variant, kernel, p):
                L1._fns[kernel] = fns[variant][kernel]
                fn = L1.flash_attention_bwd_dkv if kernel == "dkv" else L1.flash_attention_bwd_dq
                return C.time_ms(torch, lambda *a: fn(*a, plan=p), sets, min_iters=10)

            for variant in fns:
                for kernel in ("dkv", "dq"):
                    row[f"{kernel}_{variant}_ms"] = timed(variant, kernel, plan)
            for walk, stages in extra:
                try:
                    p = L1.flash_bwd_plan(B, T, H, Dh, walk=walk, stages=stages)
                except ValueError as e:
                    row[f"plan_{walk}:{stages}"] = str(e)
                    continue
                for kernel in ("dkv", "dq"):
                    row[f"{kernel}_{walk}:{stages}_ms"] = timed("kernel", kernel, p)
            mask = torch.ones(B, 1, 1, T, dtype=torch.bool, device=dev)
            lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
            row["library_ms"] = C.time_ms(torch, lambda: torch.autograd.grad(lo, (lq, lk, lv), do.transpose(1, 2),
                                                                             retain_graph=True), [()], min_iters=10)
            for kernel, units in (("dkv", 8), ("dq", 6)):
                row[f"{kernel}_tflops"] = units * B * H * T * T * Dh / (row[f"{kernel}_kernel_ms"] * 1e-3) / 1e12
            print(json.dumps(row), flush=True)
            del q, k, v, do, o, m, l, di, sets, lq, lk, lv, lo
            torch.cuda.empty_cache()
    finally:
        L1._fns.clear()
        L1._fns.update(saved)
    return 0


if __name__ == "__main__":
    sys.exit(main())
