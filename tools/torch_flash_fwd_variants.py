#!/usr/bin/env python3
"""Where the time goes inside L1's forward kernel, on one CUDA card.

    python3 tools/torch_flash_fwd_variants.py [--stages 2,3] [--parent DIR]

Builds csrc/flash_attention.cu as it is and cut-down copies of it, each
with nvcc into build/flash_fwd_variants/, by turning off the source's
switches (kLoads, kProducts, kSoftmax, kPingPong) or one of its design
choices (WGS_64, the consumer warpgroups at Dh = 64), and times every copy
with CUDA events on the same plan and inputs at chip_smoke.py's phase-2
shapes (H = 16, Dh = 64, full rows: B = 1 and 6 at T = 7,001; B = 4 at T =
6,999 with m and l written, the training launch; B = 32 at T = 1,499, the
30 s bucket):
  - kernel        the kernel as it is;
  - products_only the wgmma products and the TMA ring, no max, exp, mask or
                  row sums (P is the raw S, packed);
  - exp_only      the TMA ring, the max, exp, mask and row sums on made-up
                  logits, no products;
  - loads_only    the TMA ring, its barriers and the output stores: no
                  products, no softmax;
  - no_work       Q's load and the stores only (the floor of this design:
                  launch, prologue, epilogue);
  - no_pingpong   the kernel with the consumer warpgroups issuing their
                  products whenever they are ready, not in turns;
  - two_consumers the kernel with two consumer warpgroups (128 query rows a
                  CTA, 224 registers each) instead of three (192, 160).
Beside them: SDPA with a (B, 1, 1, T) key-padding mask (the library call
chip_smoke.py times), the exponentials reckoned at 16 a clock per SM (132
SMs, 1.98 GHz), and, with --stages, the kernel on other ring depths of
flash_fwd_plan. With --parent DIR (a checkout, e.g. the parent
unpacked with `git archive`), that tree's own forward is timed at the same
shapes before and after this tree's, in another process. The cut-down
copies compute nothing useful; only their times mean anything. Prints the
card and one JSON object per shape; refuses to run without a card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def off(*switches):
    return tuple((f"constexpr bool {s} = true;", f"constexpr bool {s} = false;") for s in switches)


VARIANTS = {  # (old, new) source texts, and the query rows a CTA where they differ from the plan's
    "kernel": ((), None),
    "products_only": (off("kSoftmax"), None),
    "exp_only": (off("kProducts"), None),
    "loads_only": (off("kProducts", "kSoftmax"), None),
    "no_work": (off("kLoads", "kProducts", "kSoftmax"), None),
    "no_pingpong": (off("kPingPong"), None),
    "two_consumers": ((("constexpr int WGS_64 = 3;", "constexpr int WGS_64 = 2;"),), 128),
}
SHAPES = ((1, 7001, False), (6, 7001, False), (4, 6999, True), (32, 1499, False))  # B, T, m and l written


def build():
    """{variant: fn} of csrc/flash_attention.cu's entry point, one nvcc per
    variant, all started together."""
    from ssak_tpu_torch.ops import _build

    with open(os.path.join(ROOT, "ssak_tpu_torch", "csrc", "flash_attention.cu")) as f:
        src = f.read()
    out_dir = os.path.join(ROOT, "build", "flash_fwd_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (edits, _rows) in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/flash_attention.cu once")
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
        fn = ctypes.CDLL(lib).ssak_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _inputs(torch, dev, B, T, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, T, 16, 64, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    return q, k, v, torch.full((B,), T, dtype=torch.int32, device=dev)


def kernel_only(root):
    """The forward of the checkout at `root` (this tree's, or a parent's), {"B:T": ms} at SHAPES."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as C
    from ssak_tpu_torch.ops import flash_attention as L1

    dev = torch.device("cuda", 0)
    out = {}
    for B, T, stats in SHAPES:
        args = _inputs(torch, dev, B, T, 12)
        with torch.no_grad():
            out[f"{B}:{T}"] = C.time_ms(torch, lambda *a: L1._flash_forward(*a, None, stats=stats), [args],
                                        min_iters=10)
        del args
        torch.cuda.empty_cache()
    return out


def run_parent(parent):
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--kernel_only", os.path.abspath(parent)],
                         capture_output=True, text=True, cwd=os.path.abspath(parent), timeout=900,
                         env=dict(os.environ, PYTHONPATH=os.path.abspath(parent)))
    if res.returncode:
        raise RuntimeError(f"the parent's run failed:\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", default="", help="comma-separated ring depths to time the kernel on as well")
    ap.add_argument("--parent", default="", help="a checkout whose own forward is timed before and after this tree's")
    ap.add_argument("--kernel_only", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 3
    if args.kernel_only:
        print(json.dumps(kernel_only(args.kernel_only)), flush=True)
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from ssak_tpu_torch.ops import flash_attention as L1

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    before = run_parent(args.parent) if args.parent else {}
    fns = build()
    dev = torch.device("cuda", 0)
    extra = [int(x) for x in args.stages.split(",") if x]
    rows = []
    saved = dict(L1._fns)
    try:
        for B, T, stats in SHAPES:
            H, Dh = 16, 64
            sets = [_inputs(torch, dev, B, T, 12)]
            plan = L1.flash_fwd_plan(B, T, H, Dh)
            row = dict(B=B, T=T, H=H, Dh=Dh, stats=stats, plan=(plan["rows"], plan["bn"], plan["stages"]))

            def timed(variant, p):
                rows = VARIANTS[variant][1]
                if rows:  # the same plan on another CTA shape
                    tiles = -(-T // rows)
                    p = dict(p, rows=rows, warpgroups=rows // 64, threads=128 * (rows // 64 + 1), tiles=tiles,
                             smem=L1._fwd_smem(Dh, rows, p["bn"], p["stages"]), grid=(tiles, H, B))
                L1._fns["fwd"] = fns[variant]
                with torch.no_grad():
                    return C.time_ms(torch, lambda *a: L1._flash_forward(*a, None, stats=stats, plan=p), sets,
                                     min_iters=10)

            for variant in fns:
                row[f"{variant}_ms"] = timed(variant, plan)
            for stages in extra:
                name = f"stages{stages}"
                try:
                    p = L1.flash_fwd_plan(B, T, H, Dh, stages=stages)
                except ValueError as e:
                    row[f"plan_{name}"] = str(e)
                    continue
                row[f"{name}_ms"] = timed("kernel", p)
            L1._fns.clear()
            L1._fns.update(saved)
            q, k, v, _ = sets[0]
            mask = torch.ones(B, 1, 1, T, dtype=torch.bool, device=dev)
            row["library_ms"] = C.time_ms(torch, lambda a, b, c, m: F.scaled_dot_product_attention(
                a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2), attn_mask=m), [(q, k, v, mask)], min_iters=10)
            Tp = L1.padded_len(T)
            row["bound_ms"], row["bound_by"] = C.bound(4 * B * T * H * Dh * 2, 4 * B * H * T * T * Dh)
            row["ex2_reckoned_ms"] = B * H * T * Tp / (132 * 16 * 1.98e9) * 1e3
            row["tflops"] = 4 * B * H * T * T * Dh / (row["kernel_ms"] * 1e-3) / 1e12
            rows.append(row)
            del q, k, v, sets
            torch.cuda.empty_cache()
    finally:
        L1._fns.clear()
        L1._fns.update(saved)
    after = run_parent(args.parent) if args.parent else {}
    for row in rows:
        key = f"{row['B']}:{row['T']}"
        if args.parent:
            row["parent_ms"] = [before[key], after[key]]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
