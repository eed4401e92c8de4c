"""CTC loss (differentiable by autograd) and greedy decode.

Counterpart of ssak_tpu.ops.ctc: the log-domain forward recursion as a
loop over time, vectorized over (batch, 2U+1) states, with the same
semantics as the scan there (`zero_infinity`, reductions 'mean' / 'sum' /
'none'). Autograd replays the loop for the gradient; the train step uses
the fused forward-backward instead (ops.ctc_fused, kernel K1). The
alignment trellis comes with the port of `align/`.
"""

import torch
import torch.nn.functional as F

LOG_EPS = -1e30


def _interleave_blanks(labels, blank_id):
    """(B, U) -> (B, 2U+1) extended label sequence with blanks."""
    B, U = labels.shape
    ext = torch.full((B, 2 * U + 1), blank_id, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def ctc_loss(log_probs, logit_lengths, labels, label_lengths, blank_id: int = 0, zero_infinity: bool = True,
             reduction: str = "mean"):
    """CTC negative log-likelihood.

    log_probs: (B, T, V) log-softmax outputs. logit_lengths: (B,) valid
    frames. labels: (B, U) padded targets. label_lengths: (B,).
    reduction: 'mean' (per-row nll / max(1, label_length), then the batch
    mean), 'sum', 'none'."""
    B, T, V = log_probs.shape
    U = labels.shape[1]
    S = 2 * U + 1
    labels = labels.long()
    ext = _interleave_blanks(labels, blank_id)
    ext_shift2 = F.pad(ext, (2, 0), value=blank_id)[:, :S]
    allow_skip = (ext != blank_id) & (ext != ext_shift2)
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(B, T, S))  # (B, T, S)

    s_idx = torch.arange(S, device=log_probs.device)[None, :]
    eps = torch.full((B, S), LOG_EPS, dtype=log_probs.dtype, device=log_probs.device)
    valid_state = s_idx < (2 * label_lengths.long()[:, None] + 1)
    alpha = torch.where(valid_state & (s_idx < 2), emit[:, 0], eps)
    active_t = logit_lengths.long()[:, None]
    for t in range(1, T):
        prev1 = F.pad(alpha, (1, 0), value=LOG_EPS)[:, :S]
        prev2 = torch.where(allow_skip, F.pad(alpha, (2, 0), value=LOG_EPS)[:, :S], eps)
        stacked = torch.stack([alpha, prev1, prev2], dim=0)
        m = stacked.max(dim=0).values
        merged = m + torch.log(torch.exp(stacked - m[None]).sum(dim=0))
        merged = torch.where(m <= LOG_EPS / 2, eps, merged)
        new_alpha = torch.where(valid_state, merged + emit[:, t], eps)
        alpha = torch.where(t < active_t, new_alpha, alpha)

    last = 2 * label_lengths.long()
    idx1 = last.clamp(0, S - 1)
    idx2 = (last - 1).clamp(0, S - 1)
    a1 = alpha.gather(1, idx1[:, None])[:, 0]
    a2 = alpha.gather(1, idx2[:, None])[:, 0]
    m = torch.maximum(a1, a2)
    nll = -(m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)))

    if zero_infinity:
        feasible = (logit_lengths >= label_lengths) & (label_lengths > 0)
        nll = torch.where(feasible & torch.isfinite(nll) & (nll < -LOG_EPS / 2), nll, 0.0)

    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return (nll / label_lengths.clamp(min=1).to(nll.dtype)).mean()


def ctc_greedy_decode(log_probs, logit_lengths, blank_id: int = 0):
    """Greedy CTC: argmax, collapse repeats, drop blanks.

    Returns (tokens (B, T) padded with -1, lengths (B,)); host code trims
    with lengths."""
    B, T, V = log_probs.shape
    best = torch.argmax(log_probs, dim=-1)  # first maximum, as jnp.argmax
    t_idx = torch.arange(T, device=log_probs.device)[None, :]
    in_range = t_idx < logit_lengths[:, None]
    prev = F.pad(best, (1, 0), value=blank_id)[:, :T]
    keep = (best != blank_id) & (best != prev) & in_range
    order = torch.where(keep, t_idx, T + t_idx)  # kept first, in time order
    perm = torch.argsort(order, dim=1, stable=True)
    tokens = torch.gather(torch.where(keep, best, -1), 1, perm)
    return tokens, keep.sum(dim=1)
