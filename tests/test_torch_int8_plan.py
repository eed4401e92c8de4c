"""K2's tiling plan (ssak_tpu_torch.ops.int8_matmul.int8_plan) and the
wrapper's domain, on the CPU. The CUDA kernel (csrc/int8_matmul.cu) takes
the plan as given: a grid of column tiles x K slices, the slices of one tile
summed in one thread-block cluster, so the plan alone decides whether the
launch fills the card and whether every slice is one the kernel can run.
The kernel itself is held against its plain version on the card by
chip_smoke.py."""

import pytest
import torch

from ssak_tpu_torch.ops import int8_matmul as IM

SMS = 132  # the H100's streaming multiprocessors

# the decoder denses of Whisper large-v3 that route through K2 (self q/k/v/o
# and cross q/o at 1280 x 1280, fc1 1280 x 5120, fc2 5120 x 1280), a partial
# column tile with 8-byte weight rows, and the widths of later paths
KN = [(1280, 1280), (1280, 5120), (5120, 1280), (1280, 1288)]
KN += [(k, n) for k in (1024, 4096) for n in (1024, 4096)]


@pytest.mark.parametrize("M", [1, 5, 24, 40, 64])
@pytest.mark.parametrize("K,N", KN)
def test_int8_plan_fills_the_card_with_slices_the_kernel_runs(M, K, N):
    block_n, splits, per = IM.int8_plan(M, K, N)
    assert block_n == IM.INT8_BN
    assert 1 <= splits <= IM.INT8_MAX_SPLITS, "the slices of a tile form one cluster of at most 8 blocks"
    slices = IM.int8_slices(K, splits)
    assert len(slices) == splits
    assert all(hi > lo for lo, hi in slices), f"an empty slice in {slices}"
    # whole stages: every slice starts on a stage and all but the last end on one
    assert all(lo % IM.INT8_KSTEP == 0 for lo, _ in slices)
    assert all(hi % IM.INT8_KSTEP == 0 for _, hi in slices[:-1])
    # the slices cover K exactly, in order, without overlap
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    # k_per_split is the longest slice in whole stages: it sizes the ring
    assert per % IM.INT8_KSTEP == 0 and per - IM.INT8_KSTEP < max(hi - lo for lo, hi in slices) <= per
    tiles = -(-N // block_n)
    if tiles * min(IM.INT8_MAX_SPLITS, K // IM.INT8_KSTEP) >= SMS:
        assert tiles * splits >= SMS, f"{tiles} tiles x {splits} splits leave SMs idle"
    if tiles * splits > IM.INT8_MAX_BLOCKS and splits > 1:
        assert tiles * (splits - 1) < SMS, f"{splits} splits where fewer fill the SMs"


def test_int8_plan_at_the_decoder_shapes():
    """The grids the source note of csrc/int8_matmul.cu gives: 160 blocks at
    each of 1280 x 1280, 1280 x 5120 and 5120 x 1280 (N/64 alone: 20, 80,
    20), each block's slice at most 5 stages of 128 rows."""
    assert IM.int8_plan(24, 1280, 1280) == (64, 8, 256)
    assert IM.int8_plan(24, 1280, 5120) == (64, 2, 640)
    assert IM.int8_plan(24, 5120, 1280) == (64, 8, 640)


@pytest.mark.parametrize("M,K,N", [(0, 1280, 1280), (65, 1280, 1280), (24, 1284, 1280), (24, 1280, 1284)])
def test_int8_plan_refuses_what_the_kernel_does_not_take(M, K, N):
    with pytest.raises(ValueError, match="int8_plan"):
        IM.int8_plan(M, K, N)


def test_int8_plan_is_independent_of_m():
    """The weight bytes bound the kernel, so the grid is the same at every
    row count: M changes only how many 16-row groups each block multiplies."""
    for K, N in KN:
        assert len({IM.int8_plan(M, K, N) for M in range(1, IM.MAX_M + 1)}) == 1


def test_matmul_int8_still_refuses_off_the_plain_path():
    """A tensor that is neither on the CPU nor on a CUDA card raises before
    any plan is made; bad shapes and types raise on every device."""
    q8 = torch.zeros(1280, 1280, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        IM.matmul_int8(torch.zeros(65, 1280, device="meta"), q8, torch.ones(1280, device="meta"))
    with pytest.raises(ValueError, match="bad shapes"):
        IM.matmul_int8(torch.zeros(4, 1288), torch.zeros(1280, 1280, dtype=torch.int8), torch.ones(1280))
    with pytest.raises(ValueError, match="scale has"):
        IM.matmul_int8(torch.zeros(4, 1280), torch.zeros(1280, 1280, dtype=torch.int8), torch.ones(1288))
    with pytest.raises(TypeError):
        IM.matmul_int8(torch.zeros(4, 1280), torch.zeros(1280, 1280, dtype=torch.int8), torch.ones(1280).double())
