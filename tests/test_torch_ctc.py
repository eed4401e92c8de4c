"""The port's CTC ops (ssak_tpu_torch.ops.ctc, ops.ctc_fused = kernel K1)
against the JAX package on the CPU.

K1's plain version (the function the CUDA kernel computes, which the
wrapper takes for CPU tensors) is held against ssak_tpu's Pallas kernel in
interpret mode, `_fwd_impl(interpret=True)`, as tests/test_ops_pallas.py
runs it; the CUDA kernel itself is held against the same plain version on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.ops.ctc import ctc_greedy_decode as jax_greedy
from ssak_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from ssak_tpu.ops.ctc_pallas import _fwd_impl
from ssak_tpu_torch.ops import ctc_fused as K1
from ssak_tpu_torch.ops.ctc import ctc_greedy_decode, ctc_loss


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the plain version's recursion is
    thousands of tiny ops a row, on which torch's pool spins beside the
    other test workers (test_long_rows_gradient_matches_an_f64_witness took
    610 s with 8 threads and 8 s with one on an 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, V, B=6, T=24, U=6):
    """Ragged frame lengths, a batch-pad dummy (label length 0, frame length
    -1), an infeasible row (more labels than frames), repeated labels (no
    skip transition) and a row longer than its neighbours."""
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(B, T, V)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    labels[2, :4] = labels[2, 0]  # repeats
    lab_len = np.array([U, 4, 4, 0, U, 3], np.int32)[:B]
    t_len = np.array([T, 17, 12, -1, 4, 9], np.int32)[:B]  # row 4: 6 labels in 4 frames
    return logits, lp, t_len, labels, lab_len


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("V", [32, 300])
def test_plain_version_matches_pallas_interpret(V):
    _, lp, t_len, labels, lab_len = _case(V, V)
    ref_loss, ref_grad = _fwd_impl(jnp.asarray(lp), jnp.asarray(t_len), jnp.asarray(labels), jnp.asarray(lab_len),
                                   0, True, interpret=True)
    before = dict(K1.LAUNCHES)
    loss, grad = K1.ctc_fused(*_t(lp, t_len, labels, lab_len))
    assert K1.LAUNCHES == before, "a CPU tensor must take the plain version, not count a launch"
    ref_loss, ref_grad = np.asarray(ref_loss), np.asarray(ref_grad)
    # the port divides each frame's gradient by its posterior mass, which is
    # 1 in exact arithmetic and which the Pallas kernel leaves out: here it
    # is within 1e-4 of 1, and the Pallas gradient gets the same division
    mass = -ref_grad.sum(-1, keepdims=True)
    live = mass[..., 0] != 0
    assert np.abs(mass[live] - 1).max() <= 1e-4
    ref_grad = np.where(mass != 0, ref_grad / np.where(mass != 0, mass, 1), 0)
    # the same log-domain recursion in f32; only expf/logf rounding and the
    # order of the gradient's per-class sums differ
    np.testing.assert_allclose(loss.numpy(), ref_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=0, atol=2e-5)
    # the dummy and the infeasible row are zeroed; frames past t_len carry no gradient
    assert loss[3] == 0 and loss[4] == 0 and not grad[3].any() and not grad[4].any()
    assert not grad[1, 17:].any() and grad[1, :17].abs().sum() > 0


def test_plain_version_without_zero_infinity_keeps_finite_rows():
    _, lp, t_len, labels, lab_len = _case(3, 32)
    ok = np.array([0, 1, 2, 5])
    ref_loss, ref_grad = _fwd_impl(jnp.asarray(lp[ok]), jnp.asarray(t_len[ok]), jnp.asarray(labels[ok]),
                                   jnp.asarray(lab_len[ok]), 0, False, interpret=True)
    loss, grad = K1.ctc_fused_reference(*_t(lp[ok], t_len[ok], labels[ok], lab_len[ok]), blank_id=0, zero_infinity=False)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=2e-5)


def test_plain_version_out_of_vocabulary_labels_match_pallas():
    """A label outside [0, V) emits 0 and gets no gradient, as the Pallas
    kernel's one-hot product gives it (the CUDA kernel reads nothing out
    of the row for it)."""
    _, lp, t_len, labels, lab_len = _case(13, 32)
    labels[0, 1], labels[5, 0] = 32, -1
    ref_loss, ref_grad = _fwd_impl(jnp.asarray(lp), jnp.asarray(t_len), jnp.asarray(labels), jnp.asarray(lab_len),
                                   0, True, interpret=True)
    loss, grad = K1.ctc_fused(*_t(lp, t_len, labels, lab_len))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=0, atol=2e-5)
    assert loss[0] > 0 and loss[5] > 0


def test_gradient_rows_sum_to_minus_one_on_valid_frames():
    """sum_v dL/dlogp[t, v] = -(posterior mass at t) = -1 for t < t_len."""
    _, lp, t_len, labels, lab_len = _case(5, 32)
    _, grad = K1.ctc_fused(*_t(lp, t_len, labels, lab_len))
    for b in (0, 1, 2, 5):
        np.testing.assert_allclose(grad[b, : t_len[b]].sum(-1).numpy(), -1.0, atol=1e-4)


def test_long_rows_gradient_matches_an_f64_witness():
    """At 4,000 frames (|alpha| about 1e4, one f32 ulp 1e-3) the f32
    recursion's rounding scales each frame's posteriors by up to about 1%;
    the plain version divides each frame by its own mass, so its gradient
    keeps to the same recursion in f64: every frame sums to -1 within 1e-5,
    the gradient within 1e-3 absolute and its norm within 1e-4 relative
    (measured: 4e-4 and 2e-5 at 6,999 frames)."""
    rng = np.random.RandomState(21)
    T, V, U = 4000, 32, 1200
    lp = torch.log_softmax(torch.from_numpy(0.3 * rng.randn(1, T, V).astype(np.float32)), -1)
    args = _t(np.array([T], np.int32), rng.randint(1, V, (1, U)).astype(np.int32), np.array([U], np.int32))
    loss, grad = K1.ctc_fused_reference(lp, *args)
    ref_loss, ref_grad = K1.ctc_fused_reference(lp, *args, dtype=torch.float64)
    assert grad.dtype == torch.float32 and ref_grad.dtype == torch.float64
    np.testing.assert_allclose(grad.sum(-1).numpy(), -1.0, atol=1e-5)
    np.testing.assert_allclose(loss.double().numpy(), ref_loss.numpy(), rtol=1e-6)
    np.testing.assert_allclose(grad.double().numpy(), ref_grad.numpy(), atol=1e-3)
    assert abs(float(grad.double().norm() / ref_grad.norm()) - 1) <= 1e-4


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_and_autograd_grad_match_jax(reduction):
    logits, _, t_len, labels, lab_len = _case(7, 32)

    def jloss(x):
        out = jax_ctc_loss(jax.nn.log_softmax(x, -1), jnp.asarray(t_len), jnp.asarray(labels), jnp.asarray(lab_len),
                           reduction=reduction)
        return out.sum()

    ref, ref_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    out = ctc_loss(torch.log_softmax(x, -1), *_t(t_len, labels, lab_len), reduction=reduction).sum()
    out.backward()
    # same recursion in f32 on both sides; autograd and jax.grad replay it
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), atol=1e-5)


def test_ctc_loss_fast_gradient_matches_the_scan():
    """The fused loss (K1's plain version on the CPU) under autograd gives the
    scan loss and its autograd gradient w.r.t. logits."""
    logits, _, t_len, labels, lab_len = _case(11, 32)
    x1 = torch.from_numpy(logits).requires_grad_(True)
    x2 = torch.from_numpy(logits.copy()).requires_grad_(True)
    a = K1.ctc_loss_fast(torch.log_softmax(x1, -1), *_t(t_len, labels, lab_len))
    b = ctc_loss(torch.log_softmax(x2, -1), *_t(t_len, labels, lab_len))
    a.backward()
    b.backward()
    np.testing.assert_allclose(a.item(), b.item(), rtol=1e-6)
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), atol=1e-6)
    for red in ("sum", "none"):
        np.testing.assert_allclose(K1.ctc_loss_fast(torch.log_softmax(x1, -1), *_t(t_len, labels, lab_len), reduction=red).detach().numpy(),
                                   ctc_loss(torch.log_softmax(x2, -1), *_t(t_len, labels, lab_len), reduction=red).detach().numpy(),
                                   rtol=1e-6)


def test_greedy_decode_matches_jax():
    rng = np.random.RandomState(2)
    lp = rng.randn(4, 30, 9).astype(np.float32)
    lp[0, 5:9] = lp[0, 4]  # repeats collapse
    lens = np.array([30, 11, 0, 25], np.int32)
    jt, jl = jax_greedy(jnp.asarray(lp), jnp.asarray(lens))
    tt, tl = ctc_greedy_decode(*_t(lp, lens))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_prepare_matches_jax():
    from ssak_tpu.ops.ctc_pallas import _prepare

    labels = np.array([[3, 3, 5, 0], [1, 2, 2, 2]], np.int32)
    je, ja = _prepare(jnp.asarray(labels), None, 0)
    te, ta = K1._prepare(torch.from_numpy(labels), 0)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_wrapper_checks_inputs():
    lp = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError, match="batch sizes"):
        K1.ctc_fused(lp, torch.ones(3, dtype=torch.int32), torch.zeros(2, 2, dtype=torch.int32), torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        K1.ctc_fused(lp[0], torch.ones(2, dtype=torch.int32), torch.zeros(2, 2, dtype=torch.int32), torch.ones(2, dtype=torch.int32))
    # the shared memory of a sweep CTA: 4 mbarriers, two copies of its range
    # with two halo slots a side (rounded up to 4 words) and a ring of 8 lp
    # rows; of a collect block: g, the class and piece offsets, the piece
    # sums, 32 warp sums, the states in class order (u16) and the pieces'
    # classes (u16)
    assert K1.sweep_smem_bytes(513, 32, 1) == 32 + (2 * 520 + 8 * 32) * 4
    assert K1.sweep_smem_bytes(4097, 32, 5) == 32 + (2 * 824 + 8 * 32) * 4
    assert K1.collect_smem_bytes(513, 32) == 6 * 513 + 8 * 33 + 6 * (17 + 32) + 128
    assert K1.collect_smem_bytes(2 * 16384 + 1, 1024) <= K1.SMEM_LIMIT
    with pytest.raises(ValueError, match="ctc_plan"):
        K1.ctc_plan(1, 10, 2 * 32768 + 1, 32)


def test_cuda_tensors_never_reach_the_plain_version():
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel (CUDA) or raises, never a silent fallback."""
    lp = torch.zeros(2, 5, 4, device="meta")
    ints = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K1.ctc_fused(lp, torch.ones(2, **ints), torch.zeros(2, 2, **ints), torch.ones(2, **ints))
    with pytest.raises(ValueError, match="different devices"):
        K1.ctc_fused(torch.zeros(2, 5, 4), torch.ones(2, **ints), torch.zeros(2, 2, dtype=torch.int32),
                     torch.ones(2, dtype=torch.int32))
