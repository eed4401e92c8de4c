"""K1's launch plan (ssak_tpu_torch.ops.ctc_fused.ctc_plan) and a CPU
emulation of what csrc/ctc_fused.cu does with it.

The kernel runs the alpha and the beta sweep of every row at once, each over
a cluster of CTAs that split the S states into the plan's contiguous ranges
and pass the two states at a range's edge to the neighbour's halo slots every
step; a collect pass then forms the gradient with no atomics, summing each
class's states in pieces in a fixed order. The card alone runs the kernel;
here the same ranges, halos and sums are emulated step by step in f32 and
held against the plain version, `ctc_fused_reference`, so that an error in
the halo or `allow`-at-the-edge logic shows without a card. chip_smoke.py
holds the kernel itself against the plain version on the card."""

import numpy as np
import pytest
import torch

from ssak_tpu_torch.ops import ctc_fused as K1

NEG = K1.NEG
SMS = 132  # the H100's SMs


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests are small and many: one intra-op thread beside the other
    pytest workers, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_plan(B, T, S, V, plan):
    cluster, threads, kpt, ranges = plan
    assert 1 <= cluster <= K1.CTC_MAX_CLUSTER
    assert ranges == K1.ctc_ranges(S, cluster) and len(ranges) == cluster
    # every state exactly once, in order, by one CTA
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    widths = [hi - lo for lo, hi in ranges]
    # a halo is two states wide, so both come from the immediate neighbour
    assert min(widths) >= (2 if cluster > 1 else 1)
    assert kpt in K1.CTC_KPTS and 32 <= threads <= 1024 and threads % 32 == 0
    assert threads * kpt >= max(widths) and (threads - 32) * kpt < max(widths)
    assert K1.sweep_smem_bytes(S, V, cluster) <= K1.SMEM_LIMIT
    assert K1.collect_smem_bytes(S, V) <= K1.SMEM_LIMIT
    need = -(-S // (1024 * 8))
    if cluster > need:  # more CTAs than the least only where the SMs hold them
        assert 2 * B * cluster <= SMS
    if S <= K1.CTC_STATES_PER_CTA:
        assert cluster == 1


@pytest.mark.parametrize("V", [32, 48, 1024])
def test_ctc_plan_covers_every_state_once_within_the_card(V):
    """S = 1 ... 2 * 16,384 + 1 at B = 1, 4, 32 (uncached: the plan itself)."""
    plan = K1.ctc_plan.__wrapped__
    for B in (1, 4, 32):
        for S in range(1, 2 * 16384 + 2):
            _check_plan(B, 10, S, V, plan(B, 10, S, V))


def test_ctc_plan_at_the_timed_shapes():
    """wav2vec2-base (S = 513): one CTA a sweep, 64 sweeps; the U = 512 case
    (S = 1,025: 2 CTAs, as 64 sweeps of 3 would not fit 132 SMs) and the 140 s
    bucket (S = 4,097: 8 CTAs of 512 states) split over a cluster."""
    assert K1.ctc_plan(32, 749, 513, 32)[:3] == (1, 544, 1)
    assert K1.ctc_plan(32, 749, 513, 1024)[:3] == (1, 544, 1)
    assert K1.ctc_plan(32, 749, 1025, 32)[:3] == (2, 544, 1)
    cluster, threads, kpt, ranges = K1.ctc_plan(4, 6999, 4097, 32)
    assert (cluster, threads, kpt) == (8, 544, 1) and [hi - lo for lo, hi in ranges] == [512] * 7 + [513]
    for args in ((32, 749, 513, 32), (32, 749, 1025, 32), (4, 6999, 4097, 32)):
        _check_plan(*args, K1.ctc_plan(*args))


@pytest.mark.parametrize("B,T,S,V", [(1, 5, 0, 32), (0, 5, 13, 32), (1, 5, 2 * 32768 + 1, 32), (1, 5, 65535, 1024)])
def test_ctc_plan_refuses_what_the_kernels_cannot_take(B, T, S, V):
    with pytest.raises(ValueError, match="ctc_plan"):
        K1.ctc_plan(B, T, S, V)


# --- the emulation ---------------------------------------------------------------


def _lse3(a, b, c):
    """The kernel's merge: the maximum's own term is 1."""
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    m, x = torch.maximum(hi, c), torch.minimum(hi, c)
    r = m + torch.log(1 + torch.exp(x - m) + torch.exp(lo - m))
    return torch.where(m <= NEG / 2, torch.full_like(r, NEG), r)


def _sweep(lp, ext, allow, t_len, L, ranges, bwd):
    """The rows one sweep writes, (T, S) f32 (NaN where it writes none): each
    CTA computes its range from its own buffer, a range with two halo slots a
    side, and passes its two edge states to the neighbour's halo (alpha to
    the right, beta to the left) after every step."""
    T, V = lp.shape
    S = ext.shape[0]
    n_valid, t_end = 2 * L + 1, max(0, min(t_len, T))
    out = torch.full((T, S), float("nan"))
    t_first = t_end - 1 if bwd else 0
    if t_first < 0:
        return out
    nsteps = t_first if bwd else max(1, t_end) - 1
    in_vocab = (ext >= 0) & (ext < V)

    def emit(t):
        return torch.where(in_vocab, lp[t, ext.long().clamp(0, V - 1)], 0.0)

    s_all = torch.arange(S)
    valid = s_all < n_valid
    skip = torch.cat([allow[2:], torch.zeros(2, dtype=allow.dtype)]).bool() if bwd else allow.bool()

    def exchange(values):
        """values: each CTA's own states -> buffers with halos as the kernel fills them."""
        bufs = []
        for (lo, hi), v in zip(ranges, values):
            buf = torch.full((hi - lo + 4,), NEG)
            buf[2:-2] = v
            bufs.append(buf)
        for r in range(len(ranges)):
            if not bwd and r + 1 < len(ranges):
                bufs[r + 1][0:2] = values[r][-2:]  # states hi-2, hi-1 into slots 0, 1 of rank r+1
            if bwd and r > 0:
                bufs[r - 1][-2:] = values[r][:2]  # states lo, lo+1 into the right halo of rank r-1
        return bufs

    if bwd:
        e1, e2 = 2 * L, max(2 * L - 1, 0)
        first = torch.where(valid & ((s_all == e1) | (s_all == e2)), 0.0, NEG)
        out[t_first] = torch.where(valid, first, float("nan"))
        first = torch.where(valid, first + emit(t_first), NEG)
    else:
        first = torch.where((s_all < 2) & valid, emit(0), NEG)
        out[0] = torch.where(valid, first, float("nan"))
    bufs = exchange([first[lo:hi] for lo, hi in ranges])
    for i in range(nsteps):
        f = t_first - 1 - i if bwd else 1 + i
        em = emit(f)
        values = []
        for (lo, hi), buf in zip(ranges, bufs):
            n = hi - lo
            sk, va, e = skip[lo:hi], valid[lo:hi], em[lo:hi]
            if bwd:
                nb = torch.where(va, _lse3(buf[2:n + 2], buf[3:n + 3], torch.where(sk, buf[4:n + 4], NEG)), NEG)
                out[f, lo:hi] = torch.where(va, nb, float("nan"))
                values.append(torch.where(va, nb + e, NEG))
            else:
                a = torch.where(va, _lse3(buf[2:n + 2], buf[1:n + 1], torch.where(sk, buf[0:n], NEG)) + e, NEG)
                out[f, lo:hi] = torch.where(va, a, float("nan"))
                values.append(a)
        bufs = exchange(values)
    return out


def _collect(alpha, beta, ext, t_len, L, V, piece, threads=256):
    """(loss, grad (T, V)) as the collect pass forms them: ll from alpha's last
    row, each frame's mass as per-thread strided sums reduced within a warp
    by butterfly and across warps in order, each class summed in pieces of
    `piece` states (the live in-vocabulary states in class order, stable),
    then its pieces in order."""
    T, S = alpha.shape
    n_valid, t_end = 2 * L + 1, max(0, min(t_len, T))
    t_last = max(1, t_end) - 1
    a1, a2 = alpha[t_last, 2 * L], alpha[t_last, max(2 * L - 1, 0)]
    m = torch.maximum(a1, a2)
    ll = m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m))
    ext_l = ext.tolist()
    members = [[] for _ in range(V)]
    for s in range(n_valid):
        if 0 <= ext_l[s] < V:
            members[ext_l[s]].append(s)
    grad = torch.zeros(T, V)
    for t in range(t_end):
        g = torch.exp(alpha[t, :n_valid] + beta[t, :n_valid] - ll)
        part = torch.zeros(threads)
        for k in range(0, n_valid, threads):
            chunk = g[k:k + threads]
            part[:len(chunk)] += chunk
        part = part.view(-1, 32)
        for o in (16, 8, 4, 2, 1):
            part = part + part[:, torch.arange(32) ^ o]
        z = torch.zeros(())
        for w in range(part.shape[0]):
            z = z + part[w, 0]
        for v in range(V):
            acc = torch.zeros(())
            for k in range(0, len(members[v]), piece):
                p = torch.zeros(())
                for s in members[v][k:k + piece]:
                    p = p + g[s]
                acc = acc + p
            grad[t, v] = -acc / z if z > 0 else 0.0
    return -ll, grad


def _ext_allow(labels, blank=0):
    """The extended labels as the kernels build them from the labels
    (`ext_at`, `allow_at`): the blank at even s, label (s-1)/2 at odd s, the
    skip allowed at a label that is neither the blank nor the one before."""
    B, U = labels.shape
    ext = torch.full((B, 2 * U + 1), blank, dtype=torch.int32)
    allow = torch.zeros(B, 2 * U + 1, dtype=torch.int32)
    for s in range(1, 2 * U + 1, 2):
        e = labels[:, s >> 1]
        ext[:, s] = e
        allow[:, s] = ((e != blank) & ((e != labels[:, (s >> 1) - 1]) if s >= 2 else True)).int()
    return ext, allow


def _emulate(lp, t_len, labels, lab_len, cluster, piece=K1.CTC_PIECE, zero_infinity=True):
    B, T, V = lp.shape
    ext, allow = _ext_allow(labels)
    S = ext.shape[1]
    ranges = K1.ctc_ranges(S, cluster)
    losses, grads = [], []
    for b in range(B):
        L = max(0, min(int(lab_len[b]), (S - 1) // 2))
        args = (lp[b], ext[b], allow[b], int(t_len[b]), L, ranges)
        alpha, beta = _sweep(*args, bwd=False), _sweep(*args, bwd=True)
        loss, grad = _collect(alpha, beta, ext[b], int(t_len[b]), L, V, piece)
        # the collect pass's zero_infinity: an unalignable row, or one whose loss is not finite, is dropped
        ok = int(t_len[b]) >= int(lab_len[b]) > 0 and bool(torch.isfinite(loss)) and float(loss) < -NEG / 2
        if zero_infinity and not ok:
            loss, grad = torch.zeros(()), torch.zeros_like(grad)
        losses.append(loss)
        grads.append(grad)
    return torch.stack(losses), torch.stack(grads)


@pytest.mark.parametrize("seed", range(4))
def test_kernel_extended_labels_match_prepare(seed):
    """The kernels build ext and allow from the labels themselves; they are
    `_prepare`'s, blanks, repeats and labels outside the vocabulary included."""
    rng = np.random.RandomState(seed)
    labels = torch.from_numpy(rng.randint(-1, 5, (5, 1 + seed * 3)).astype(np.int32))
    for want, got in zip(K1._prepare(labels, 0), _ext_allow(labels)):
        assert torch.equal(want, got)
    for want, got in zip(K1._prepare(labels, 2), _ext_allow(labels, blank=2)):
        assert torch.equal(want, got)


def _case(seed, V, B=6, T=24, U=6):
    """tests/test_torch_ctc.py's inputs: ragged frame lengths, a batch-pad
    dummy, an infeasible row, repeated labels, a row longer than the rest."""
    rng = np.random.RandomState(seed)
    lp = torch.log_softmax(torch.from_numpy((2 * rng.randn(B, T, V)).astype(np.float32)), -1)
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    labels[2, :4] = labels[2, 0]
    lab_len = np.array([U, 4, 4, 0, U, 3], np.int32)[:B]
    t_len = np.array([T, 17, 12, -1, 4, 9], np.int32)[:B]
    return lp, torch.from_numpy(t_len), torch.from_numpy(labels), torch.from_numpy(lab_len)


def _agrees(lp, t_len, labels, lab_len, cluster, piece=K1.CTC_PIECE, zero_infinity=True):
    loss, grad = _emulate(lp, t_len, labels, lab_len, cluster, piece, zero_infinity)
    ref_loss, ref_grad = K1.ctc_fused_reference(lp, t_len, labels, lab_len, zero_infinity=zero_infinity)
    # the same recursion in f32; the merge's order of terms and the order of
    # the gradient's sums differ
    np.testing.assert_allclose(loss.numpy(), ref_loss.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), ref_grad.numpy(), rtol=0, atol=2e-5)
    assert (loss[lab_len > 0] != 0).any()


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 6])
@pytest.mark.parametrize("V", [32, 300])
def test_split_sweeps_and_collect_match_the_plain_version(V, cluster):
    """S = 13 over clusters of 1-6 CTAs (ranges of 2-13 states, ragged where
    6 does not divide 13)."""
    _agrees(*_case(V, V), cluster)


@pytest.mark.parametrize("cluster", [2, 4, 7])
def test_split_sweeps_on_a_ragged_label_width(cluster):
    """S = 15 (U = 7): ranges of 7/8, 3/4 and 2/3 states; out-of-vocabulary
    labels at a range's edge emit 0 and get no gradient."""
    lp, t_len, _, lab_len = _case(17, 32)
    labels = torch.from_numpy(np.random.RandomState(3).randint(1, 32, (6, 7)).astype(np.int32))
    labels[0, 3], labels[5, 0] = 32, -1  # state 7 (an edge at cluster 2) and state 1
    lab_len = lab_len.clone()
    lab_len[0] = 7
    _agrees(lp, t_len, labels, lab_len, cluster)


@pytest.mark.parametrize("cluster,piece", [(3, 32), (8, 32), (8, 4)])
def test_split_sweeps_and_pieces_over_long_classes(cluster, piece):
    """S = 161 in 3 or 8 ranges, V = 5: the blank holds 81 states and each
    label about 20, so a class takes several pieces of 32 (or of 4); repeated
    labels turn the skip off at the ranges' edges."""
    rng = np.random.RandomState(29)
    B, T, V, U = 3, 60, 5, 80
    lp = torch.log_softmax(torch.from_numpy((2 * rng.randn(B, T, V)).astype(np.float32)), -1)
    labels = torch.from_numpy(rng.randint(1, V, (B, U)).astype(np.int32))
    labels[1, 20:40] = 2
    t_len = torch.tensor([60, 55, 41], dtype=torch.int32)
    lab_len = torch.tensor([U, 50, 20], dtype=torch.int32)
    _agrees(lp, t_len, labels, lab_len, cluster, piece)


def test_split_sweeps_without_zero_infinity():
    """zero_infinity=False keeps every row's loss and gradient, the
    infeasible row's (about 1e30) included, as the plain version does."""
    lp, t_len, labels, lab_len = _case(5, 32)
    keep = torch.tensor([0, 1, 2, 4, 5])  # the feasible rows and the infeasible one; no dummy
    _agrees(lp[keep], t_len[keep], labels[keep], lab_len[keep], 3, zero_infinity=False)
