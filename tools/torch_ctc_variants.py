#!/usr/bin/env python3
"""Where the time goes inside K1 (the fused CTC forward-backward), on one
CUDA card.

    python3 tools/torch_ctc_variants.py [--plans 1:1,1:2,4:1,8:1]

Builds csrc/ctc_fused.cu as it is and four cut-down copies of it, each with
nvcc into build/ctc_variants/, by turning off the source's switches (kSweeps,
kCollect, kEmissions, kMerge), and times all five with CUDA events on the
same plan and inputs at the two shapes chip_smoke.py times with V = 32:
wav2vec2-base training's (B=32, T=749, S=513) and xlsr's 140 s bucket (B=4,
T=6,999, S=4,097):
  - kernel        the call as it is: the sweeps, then the collect pass;
  - sweeps_only   the alpha and beta sweeps, no collect pass;
  - collect_only  the collect pass alone (on whatever the scratches hold);
  - no_emissions  the sweeps with no lp ring and no emission reads;
  - no_work       the sweeps' barriers and halo exchanges only: no merge, no
                  emissions, no scratch stores (the floor of this design).
Beside them: F.ctc_loss forward and backward (the library call chip_smoke.py
times), and, with --plans, the kernel on other plans than ctc_plan's
(cluster:states a thread). The cut-down copies compute nothing useful; only
their times mean anything. Prints the card and one JSON object per shape;
refuses to run without a card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

VARIANTS = {
    "kernel": (),
    "sweeps_only": ("kCollect",),
    "collect_only": ("kSweeps",),
    "no_emissions": ("kCollect", "kEmissions"),
    "no_work": ("kCollect", "kEmissions", "kMerge"),
}


def build():
    """{variant: ctypes function} of csrc/ctc_fused.cu, one nvcc per variant,
    all started together."""
    from ssak_tpu_torch.ops import _build

    with open(os.path.join(ROOT, "ssak_tpu_torch", "csrc", "ctc_fused.cu")) as f:
        src = f.read()
    out_dir = os.path.join(ROOT, "build", "ctc_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, off in VARIANTS.items():
        text = src
        for sw in off:
            old = f"constexpr bool {sw} = true;"
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the switch {old!r} is not in csrc/ctc_fused.cu once")
            text = text.replace(old, f"constexpr bool {sw} = false;")
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
        fn = ctypes.CDLL(lib).ssak_ctc_fused
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def forced_plan(K1, S, cluster, kpt):
    """(cluster, threads, kpt): the kernel's ranges at another cluster size,
    `kpt` states a thread."""
    widest = max(hi - lo for lo, hi in K1.ctc_ranges(S, cluster))
    return cluster, -(-(-(-widest // kpt)) // 32) * 32, kpt


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", default="", help="comma-separated cluster:kpt plans to time the kernel on as well")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_ctc_variants: no CUDA device", file=sys.stderr)
        return 3
    import chip_smoke as C
    from ssak_tpu_torch.ops import _build
    from ssak_tpu_torch.ops import ctc_fused as K1

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fns = build()
    dev = torch.device("cuda", 0)
    extra = [tuple(int(x) for x in p.split(":")) for p in args.plans.split(",") if p]
    for long in (False, True):
        if long:
            lp, t_len, labels, lab_len = C.ctc_long_case(torch, dev, seed=140)
        else:
            lp, t_len, labels, lab_len = C.ctc_case(torch, dev, 32, seed=32 + 256)
        B, T, V = lp.shape
        S = 2 * labels.shape[1] + 1
        labels = labels.contiguous()
        loss = torch.empty(B, device=dev)
        grad = torch.empty(B, T, V, device=dev)
        alpha = torch.empty(B, T, S, device=dev)
        beta = torch.empty(B, T, S, device=dev)
        sets = [(lp.clone(),) for _ in range(C.n_copies(B * T * V * 4))]
        iters = 3 if long else 20
        plan = K1.ctc_plan(B, T, S, V)[:3]
        row = dict(B=B, T=T, S=S, V=V, plan=plan)

        def run(fn, p, name):
            def call(x):
                _build.check(fn(x.data_ptr(), labels.data_ptr(), t_len.data_ptr(), lab_len.data_ptr(), loss.data_ptr(),
                                grad.data_ptr(), alpha.data_ptr(), beta.data_ptr(), B, T, S, V, 0, 1, *p,
                                _build.stream_ptr(dev)), name)
            return C.time_ms(torch, call, sets, min_iters=iters)

        for name, fn in fns.items():
            row[name + "_ms"] = run(fn, plan, name)
        for c, k in extra:
            p = forced_plan(K1, S, c, k)
            if p[1] > K1.CTC_MAX_THREADS or (c > 1 and S // c < 2):
                continue
            row[f"kernel_{c}:{k}_ms"] = run(fns["kernel"], p, f"plan {p}")
        row["us_per_step"] = row["kernel_ms"] * 1e3 / T
        row["no_work_us_per_step"] = row["no_work_ms"] * 1e3 / T
        lib_in = lp.transpose(0, 1).contiguous()
        lib_len = t_len.clamp(min=1)

        def library(x):
            x = x.detach().requires_grad_(True)
            F.ctc_loss(x, labels, lib_len, lab_len, blank=0, reduction="sum", zero_infinity=True).backward()
            return x.grad

        row["library_ms"] = C.time_ms(torch, library, [(lib_in.clone(),) for _ in range(2)], min_iters=iters // 2 + 1)
        print(json.dumps(row), flush=True)
        del sets, alpha, beta
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
