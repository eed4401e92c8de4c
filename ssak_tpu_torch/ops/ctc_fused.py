"""Fused CTC forward-backward (kernel K1): per-row loss and its gradient.

Counterpart of ssak_tpu.ops.ctc_pallas (the Pallas kernel `_ctc_kernel`
launched by `_run_kernel`, exposed through `ctc_loss_pallas` and
`ctc_loss_fast`). The loss of a train step is the classic CTC
forward-backward: the alpha recursion gives the log-likelihood, a beta
sweep gives d loss / d log_probs analytically, and both come out of one
call, so autograd never replays the recursion. The CUDA kernels are in
`csrc/ctc_fused.cu` (its header says what bounds them and how they are laid
out): the alpha and beta sweeps of every row at once, each over a
thread-block cluster that `ctc_plan` sizes, then a collect pass that forms
the gradient in a fixed order. `ctc_fused_reference` is the plain PyTorch
version of the same function, used for CPU tensors and by the on-card
comparison.

Gradient identity (log domain, beta excluding the emission at t):
  gamma[t, s] = alpha[t, s] + beta[t, s],  g[t, s] = exp(gamma[t, s] - ll)
  d loss / d log_probs[t, v] = -sum_{s: ext[s] = v} g[t, s] / sum_s g[t, s]
The denominator is 1 in exact arithmetic; ssak_tpu's kernel leaves it out.
In f32 at T of 5,000-7,000 frames (|alpha| about 1e4, one ulp 1e-3) the
rounding of gamma - ll gives each frame a scale error of up to about 1%,
which the division removes (the kernel's header says more).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from ssak_tpu_torch.ops import _build

NEG = -1e30
# calls that launched the kernels, counted by the wrapper: one per call,
# though a call launches two kernels (the sweeps, then the collect pass)
LAUNCHES = {"ctc_fused": 0}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100
CTC_SMS = 132  # the H100's SMs: the sweeps' CTAs should not exceed them
CTC_MAX_CLUSTER = 8  # portable cluster size
CTC_MAX_THREADS = 1024
CTC_KPTS = (1, 2, 4, 8)  # states a thread (csrc/ctc_fused.cu instantiations)
CTC_STATES_PER_CTA = 1024  # a sweep of at most this many states runs on one CTA
CTC_SPLIT_STATES = 512  # a longer one is split into ranges of about this many, where the SMs allow
CTC_RING = 8  # lp rows in flight per sweep CTA
CTC_PIECE = 32  # states per piece of a class sum in the collect pass
CTC_MAX_S = 65535  # states are 16-bit indices in the collect pass
_fns = None


def _prepare(labels, blank_id: int):
    """(B, U) labels -> extended labels ext (B, S = 2U+1), blanks interleaved,
    and allow (B, S): 1 where the s-2 -> s skip is allowed. int32 both."""
    B, U = labels.shape
    S = 2 * U + 1
    ext = torch.full((B, S), blank_id, dtype=torch.int32, device=labels.device)
    ext[:, 1::2] = labels.to(torch.int32)
    ext_shift2 = F.pad(ext, (2, 0), value=blank_id)[:, :S]
    allow = ((ext != blank_id) & (ext != ext_shift2)).to(torch.int32)
    return ext, allow


def _lse3(a, b, c):
    m = torch.maximum(a, torch.maximum(b, c))
    merged = m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))
    return torch.where(m <= NEG / 2, torch.full_like(merged, NEG), merged)


def _zero_infinity(loss, grad, logit_lengths, label_lengths):
    """Rows that cannot be aligned (or have no target) get loss 0 and grad 0."""
    feasible = (logit_lengths >= label_lengths) & (label_lengths > 0)
    ok = feasible & torch.isfinite(loss) & (loss < -NEG / 2)
    return torch.where(ok, loss, 0.0), torch.where(ok[:, None, None], grad, 0.0)


def ctc_fused_reference(log_probs, logit_lengths, labels, label_lengths, blank_id: int = 0, zero_infinity: bool = True,
                        dtype=torch.float32):
    """Plain version of the kernel (ssak_tpu's `_fwd_impl`, each frame's
    gradient divided by its sum): log_probs (B, T, V), logit_lengths (B,),
    labels (B, U), label_lengths (B,) -> (loss (B,), grad (B, T, V)) in
    `dtype` (f32, as the kernel computes; f64 gives a witness of the f32
    rounding). Label lengths are clamped to [0, U], as the kernel does; a
    label outside [0, V) emits 0 and gets no gradient (the Pallas kernel's
    one-hot product)."""
    lp = log_probs.to(dtype)
    B, T, V = lp.shape
    ext, allow = _prepare(labels, blank_id)
    S = ext.shape[1]
    in_vocab = ((ext >= 0) & (ext < V))[:, None, :]
    ext64 = ext.long().clamp(0, V - 1)
    emit = torch.where(in_vocab, torch.gather(lp, 2, ext64[:, None, :].expand(B, T, S)), 0.0)  # (B, T, S)
    s_idx = torch.arange(S, device=lp.device)[None, :]
    L = label_lengths.long().clamp(0, (S - 1) // 2)
    t_len = logit_lengths.long()[:, None]
    valid = s_idx < 2 * L[:, None] + 1
    skip = allow.bool()
    neg = torch.full((B, S), NEG, dtype=dtype, device=lp.device)

    a = torch.where((s_idx < 2) & valid, emit[:, 0], neg)
    alphas = [a]
    for t in range(1, T):
        p1 = F.pad(a, (1, 0), value=NEG)[:, :S]
        p2 = torch.where(skip, F.pad(a, (2, 0), value=NEG)[:, :S], neg)
        new = torch.where(valid, _lse3(a, p1, p2) + emit[:, t], neg)
        a = torch.where(t < t_len, new, a)
        alphas.append(a)
    alpha = torch.stack(alphas, dim=1)

    end1 = 2 * L
    end2 = (2 * L - 1).clamp(min=0)
    a1 = a.gather(1, end1[:, None])[:, 0]
    a2 = a.gather(1, end2[:, None])[:, 0]
    m = torch.maximum(a1, a2)
    ll = m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m))

    beta = torch.where(valid & ((s_idx == end1[:, None]) | (s_idx == end2[:, None])), 0.0, neg)
    skip_n2 = F.pad(skip, (0, 2), value=False)[:, 2:]
    contrib = torch.zeros(B, T, S, dtype=dtype, device=lp.device)
    for t in range(T - 1, -1, -1):
        live = t < t_len
        contrib[:, t] = torch.where(live, -torch.exp(alpha[:, t] + beta - ll[:, None]), 0.0)
        be = beta + emit[:, t]
        n1 = F.pad(be, (0, 1), value=NEG)[:, 1:]
        n2 = torch.where(skip_n2, F.pad(be, (0, 2), value=NEG)[:, 2:], neg)
        merged = torch.where(valid, _lse3(be, n1, n2), neg)
        beta = torch.where(live, merged, beta)
    z = -contrib.sum(dim=2, keepdim=True)  # each frame's posterior mass, every state included
    grad = torch.zeros(B, T, V, dtype=dtype, device=lp.device)
    grad.scatter_add_(2, ext64[:, None, :].expand(B, T, S), torch.where(in_vocab, contrib, 0.0))
    grad = torch.where(z > 0, grad / torch.where(z > 0, z, 1.0), 0.0)
    loss = -ll
    if zero_infinity:
        loss, grad = _zero_infinity(loss, grad, logit_lengths, label_lengths)
    return loss, grad


def _kernel():
    global _fns
    if _fns is None:
        lib = _build.library("ctc_fused")
        fn = lib.ssak_ctc_fused
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns = fn
    return _fns


def ctc_ranges(S: int, cluster: int) -> tuple:
    """The states [lo, hi) of each CTA of a sweep's cluster, as the kernel
    cuts them: CTA r takes [r*S // cluster, (r+1)*S // cluster)."""
    return tuple((r * S // cluster, (r + 1) * S // cluster) for r in range(cluster))


def sweep_smem_bytes(S: int, V: int, cluster: int) -> int:
    """Shared memory of one sweep CTA (csrc/ctc_fused.cu): four mbarriers
    (the ring's two halves, the halo of each buffer), then two copies of the
    widest range with two halo slots a side (rounded up to 4 words) and a
    ring of CTC_RING lp rows of V rounded up to 4."""
    widest = -(-S // cluster)
    return 32 + 4 * (2 * ((widest + 4 + 3) // 4 * 4) + CTC_RING * ((V + 3) // 4 * 4))


def collect_smem_bytes(S: int, V: int) -> int:
    """Shared memory of one collect block: g (S f32), the class offsets and
    piece offsets (V+1 int32 each), the piece sums (NP f32), 32 warp sums,
    the states in class order (S u16) and each piece's class (NP u16), with
    NP = ceil(S / CTC_PIECE) + V."""
    n_pieces = -(-S // CTC_PIECE) + V
    return 6 * S + 8 * (V + 1) + 6 * n_pieces + 128


@functools.lru_cache(maxsize=None)
def ctc_plan(B: int, T: int, S: int, V: int) -> tuple:
    """(cluster, threads, kpt, ranges) of the sweeps: the 2B sweeps (alpha and
    beta of each row) each run on a cluster of `cluster` CTAs of `threads`
    threads, a thread holding up to `kpt` states; `ranges` are the CTAs'
    states (ctc_ranges). A sweep of at most CTC_STATES_PER_CTA states runs on
    one CTA (a cluster's per-step exchange costs more than it saves there); a
    longer one on the cluster that gives each CTA at most CTC_SPLIT_STATES,
    up to 8, as long as the 2B x cluster CTAs fit the SMs, and never a
    smaller one than 1024 threads of 8 states allow. Measured on an H100 at
    the 140 s bucket (S = 4,097): 8 CTAs of 512 states took 4.0 ms, 5 of 820
    4.9 (tools/torch_ctc_variants.py --plans). Raises ValueError for a shape
    the kernels cannot take."""
    if min(B, T, S, V) < 1:
        raise ValueError(f"ctc_plan: empty shape B={B} T={T} S={S} V={V}")
    need = -(-S // (CTC_MAX_THREADS * CTC_KPTS[-1]))
    want = 1 if S <= CTC_STATES_PER_CTA else min(CTC_MAX_CLUSTER, -(-S // CTC_SPLIT_STATES))
    while want > need and 2 * B * want > CTC_SMS:
        want -= 1
    cluster = max(need, want)
    if cluster > CTC_MAX_CLUSTER or S > CTC_MAX_S:
        raise ValueError(f"ctc_plan: S={S} states exceed what a cluster of {CTC_MAX_CLUSTER} CTAs takes")
    ranges = ctc_ranges(S, cluster)
    widest = max(hi - lo for lo, hi in ranges)
    kpt = next(k for k in CTC_KPTS if -(-widest // k) <= CTC_MAX_THREADS)
    per_cta = -(-widest // kpt)  # threads that hold the widest range
    threads = -(-per_cta // 32) * 32
    for what, n in (("a sweep CTA", sweep_smem_bytes(S, V, cluster)), ("a collect block", collect_smem_bytes(S, V))):
        if n > SMEM_LIMIT:
            raise ValueError(f"ctc_plan: S={S} states and V={V} classes need {n} bytes of shared memory in {what} "
                             f"(at most {SMEM_LIMIT})")
    return cluster, threads, kpt, ranges


def ctc_fused(log_probs, logit_lengths, labels, label_lengths, blank_id: int = 0, zero_infinity: bool = True):
    """(loss (B,), grad (B, T, V)) of the CTC negative log-likelihood.

    CPU tensors take the plain version; CUDA tensors launch the kernels or
    raise (a label width or vocabulary that `ctc_plan` cannot take, a
    mismatch of shapes or devices, a refused launch)."""
    if log_probs.ndim != 3 or labels.ndim != 2:
        raise ValueError(f"ctc_fused: want log_probs (B, T, V) and labels (B, U), got {tuple(log_probs.shape)}, {tuple(labels.shape)}")
    B, T, V = log_probs.shape
    U = labels.shape[1]
    if labels.shape[0] != B or logit_lengths.shape != (B,) or label_lengths.shape != (B,):
        raise ValueError("ctc_fused: batch sizes of log_probs, labels and the lengths differ")
    if T < 1:
        raise ValueError("ctc_fused: log_probs has no frames")
    devices = {log_probs.device, logit_lengths.device, labels.device, label_lengths.device}
    if len(devices) != 1:
        raise ValueError(f"ctc_fused: tensors on different devices {devices}")
    if log_probs.device.type == "cpu":
        return ctc_fused_reference(log_probs, logit_lengths, labels, label_lengths, blank_id, zero_infinity)
    if log_probs.device.type != "cuda":
        raise ValueError(f"ctc_fused: unsupported device {log_probs.device}")
    S = 2 * U + 1
    cluster, threads, kpt, _ = ctc_plan(B, T, S, V)
    if not 0 <= blank_id < V:
        raise ValueError(f"ctc_fused: blank_id {blank_id} outside the vocabulary of {V}")
    lp = log_probs.detach().to(torch.float32).contiguous()
    labs = labels.to(torch.int32).contiguous()  # the kernels build the extended labels (`_prepare`) themselves
    t_lens = logit_lengths.to(torch.int32).contiguous()
    lab_lens = label_lengths.to(torch.int32).contiguous()
    loss = torch.empty(B, dtype=torch.float32, device=lp.device)
    grad = torch.empty(B, T, V, dtype=torch.float32, device=lp.device)
    alpha = torch.empty(B, T, S, dtype=torch.float32, device=lp.device)  # scratch: the alpha sweeps' rows
    beta = torch.empty(B, T, S, dtype=torch.float32, device=lp.device)  # scratch: the beta sweeps' rows
    rc = _kernel()(lp.data_ptr(), labs.data_ptr(), t_lens.data_ptr(), lab_lens.data_ptr(), loss.data_ptr(),
                   grad.data_ptr(), alpha.data_ptr(), beta.data_ptr(), B, T, S, V, blank_id, int(bool(zero_infinity)),
                   cluster, threads, kpt, _build.stream_ptr(lp.device))
    _build.check(rc, "ctc_fused")
    LAUNCHES["ctc_fused"] += 1
    return loss, grad  # zero_infinity applied by the collect pass (`_zero_infinity`'s rule)


class CTCFusedLoss(torch.autograd.Function):
    """Per-row CTC loss whose backward is the gradient the forward already
    computed (counterpart of ssak_tpu's `ctc_loss_pallas` custom VJP)."""

    @staticmethod
    def forward(ctx, log_probs, logit_lengths, labels, label_lengths, blank_id=0, zero_infinity=True):
        loss, grad = ctc_fused(log_probs.detach(), logit_lengths, labels, label_lengths, blank_id, zero_infinity)
        ctx.save_for_backward(grad)
        ctx.lp_dtype = log_probs.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return (grad * g[:, None, None]).to(ctx.lp_dtype), None, None, None, None, None


def ctc_loss_fast(log_probs, logit_lengths, labels, label_lengths, blank_id: int = 0, zero_infinity: bool = True,
                  reduction: str = "mean"):
    """CTC loss through the fused forward-backward on both devices (the
    kernel on CUDA, its plain version on the CPU). reduction: 'mean'
    (per-row nll / max(1, label_length), then the batch mean, dummies
    included), 'sum' or 'none'."""
    nll = CTCFusedLoss.apply(log_probs, logit_lengths, labels, label_lengths, blank_id, zero_infinity)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction != "mean":
        raise ValueError(f"unknown reduction {reduction!r}")
    return (nll / label_lengths.clamp(min=1).to(nll.dtype)).mean()
