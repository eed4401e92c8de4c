"""Plotting: WER breakdowns and training convergence curves (counterpart
of ssak_tpu.eval.plots: `plot_wer`, `get_log_history`,
`plot_convergence_curve`).

Plots are drawn on the host after a run, with matplotlib (Agg) imported
inside each plotting function, as ssak_tpu does: nothing on the card's
path needs it, and where it is not installed a plotting call raises
ImportError naming it.
"""

import json
import os


def plot_wer(results, names=None, output: str = None, show: bool = False):
    """results: one result dict from compute_wer or a list of them."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    if isinstance(results, dict):
        results = [results]
    names = names or [f"sys{i}" for i in range(len(results))]
    keys = ["wer", "sub", "del", "ins"]
    x = np.arange(len(results))
    width = 0.2
    fig, ax = plt.subplots(figsize=(1.5 + 1.2 * len(results), 4))
    for k, key in enumerate(keys):
        vals = [100 * r[key] for r in results]
        bars = ax.bar(x + (k - 1.5) * width, vals, width, label=key.upper())
        if key == "wer":
            for i, r in enumerate(results):
                if "ci" in r:
                    ax.errorbar(
                        x[i] - 1.5 * width, 100 * r["wer"],
                        yerr=[[100 * (r["wer"] - r["ci"]["low"])], [100 * (r["ci"]["high"] - r["wer"])]],
                        fmt="none", ecolor="black", capsize=3,
                    )
    ax.set_xticks(x)
    ax.set_xticklabels(names)
    ax.set_ylabel("%")
    ax.legend()
    fig.tight_layout()
    if output:
        fig.savefig(output, dpi=120)
    if show:
        plt.show()
    plt.close(fig)
    return output


def get_log_history(run_dir: str):
    """Parse trainer_state.json log history (works on both our runs and HF
    Trainer runs — same schema)."""
    path = run_dir if run_dir.endswith(".json") else os.path.join(run_dir, "trainer_state.json")
    with open(path, encoding="utf-8") as f:
        state = json.load(f)
    return state.get("log_history", [])


def plot_convergence_curve(run_dirs, labels=None, output: str = None, metric: str = "eval_wer"):
    """Loss + eval-metric curves for one or more runs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(run_dirs, str):
        run_dirs = [run_dirs]
    labels = labels or [os.path.basename(os.path.normpath(d)) for d in run_dirs]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    for d, lbl in zip(run_dirs, labels):
        hist = get_log_history(d)
        tr = [(e["step"], e["loss"]) for e in hist if "loss" in e]
        ev = [(e["step"], e[metric]) for e in hist if metric in e]
        if tr:
            ax1.plot(*zip(*tr), label=lbl)
        if ev:
            ax2.plot(*zip(*ev), marker="o", label=lbl)
    ax1.set_xlabel("step"); ax1.set_ylabel("train loss"); ax1.legend()
    ax2.set_xlabel("step"); ax2.set_ylabel(metric); ax2.legend()
    fig.tight_layout()
    if output:
        fig.savefig(output, dpi=120)
    plt.close(fig)
    return output
