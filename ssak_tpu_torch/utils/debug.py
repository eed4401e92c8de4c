"""Debug visualizations for logits and alignments (counterpart of
ssak_tpu.utils.debug: `plot_logits`). matplotlib is imported inside the
function: where it is absent, the call raises ImportError naming it."""

import os
import tempfile

import numpy as np


def plot_logits(log_probs, vocab=None, output: str = None, top_k: int = 8):
    """Heatmap of CTC log-probs over time + per-frame argmax strip."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lp = np.asarray(log_probs)
    if lp.ndim == 3:
        lp = lp[0]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 5), height_ratios=[4, 1], sharex=True)
    ax1.imshow(lp.T, aspect="auto", origin="lower", interpolation="nearest")
    ax1.set_ylabel("token id")
    best = lp.argmax(-1)
    ax2.step(np.arange(len(best)), best, where="mid", linewidth=0.8)
    ax2.set_xlabel("frame")
    ax2.set_ylabel("argmax")
    if vocab is not None:
        counts = {}
        for b in best:
            counts[b] = counts.get(b, 0) + 1
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:top_k]
        ax1.set_title(" ".join(f"{vocab[i]!r}:{c}" for i, c in top if i < len(vocab)))
    fig.tight_layout()
    output = output or os.path.join(tempfile.gettempdir(), "ssak_logits.png")
    fig.savefig(output, dpi=110)
    plt.close(fig)
    return output
