"""K3's tiling plan (ssak_tpu_torch.ops.int8_matmul.int4_plan) and the
wrapper's domain, on the CPU. The CUDA kernel (csrc/int4_matmul.cu) takes
the plan as given: a grid of column tiles x K slices, the slices of one tile
summed in one thread-block cluster, each slice a run of whole stages of two
64-row scale blocks. So the plan alone decides how long a block's walk over
its slice is and whether every slice is one the kernel can run. The kernel itself
is held against its plain version on the card by chip_smoke.py."""

import pytest
import torch

from ssak_tpu_torch.models.quant import INT4_BLOCK
from ssak_tpu_torch.ops import int8_matmul as IM

# the decoder denses of Whisper large-v3 that route through K3 (self q/k/v/o
# and cross q/o at 1280 x 1280, fc1 1280 x 5120, fc2 5120 x 1280), a partial
# column tile with 8-byte packed rows, a one-stage and a half-stage
# contraction, and the widths of later paths
KN = [(1280, 1280), (1280, 5120), (5120, 1280), (1280, 1288), (128, 256), (64, 8), (192, 640)]
KN += [(k, n) for k in (1024, 4096) for n in (1024, 4096)]


@pytest.mark.parametrize("M", [1, 3, 20, 32, 40, 64])
@pytest.mark.parametrize("K,N", KN)
def test_int4_plan_gives_slices_the_kernel_runs(M, K, N):
    block_n, splits, per = IM.int4_plan(M, K, N)
    assert block_n == IM.INT4_BN
    assert 1 <= splits <= IM.INT8_MAX_SPLITS, "the slices of a tile form one cluster of at most 8 blocks"
    assert -(-N // block_n) * splits <= IM.INT8_MAX_BLOCKS or splits == 1
    slices = IM.int4_slices(K, splits)
    assert len(slices) == splits
    assert all(hi > lo for lo, hi in slices), f"an empty slice in {slices}"
    # whole stages: every slice starts on a stage and all but the last end on one
    assert all(lo % IM.INT4_KSTEP == 0 for lo, _ in slices)
    assert all(hi % IM.INT4_KSTEP == 0 for _, hi in slices[:-1])
    # the slices cover K exactly, in order, without overlap
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    # k_per_split is the longest slice in whole stages: it sizes the ring
    assert per % IM.INT4_KSTEP == 0 and per - IM.INT4_KSTEP < max(hi - lo for lo, hi in slices) <= per


@pytest.mark.parametrize("K,N", KN)
def test_int4_plan_takes_the_shortest_slices_with_the_fewest_splits(K, N):
    """A block walks its slice stage after stage, so the time of the launch
    follows the longest slice. No other split count within the same limits
    (clusters of at most 8, grids of at most 160 blocks) gives a shorter
    longest slice, and none with fewer splits an equally short one: at the
    same slice length, fewer blocks leave no SM with two and make the
    cluster's sum cheaper."""
    _, splits, per = IM.int4_plan(1, K, N)
    T = -(-K // IM.INT4_KSTEP)
    tiles = -(-N // IM.INT4_BN)
    allowed = [s for s in range(1, min(IM.INT8_MAX_SPLITS, T) + 1) if tiles * s <= IM.INT8_MAX_BLOCKS] or [1]
    longest = {s: max(hi - lo for lo, hi in IM.int4_slices(K, s)) for s in allowed}
    assert longest[splits] == min(longest.values())
    assert all(longest[s] > longest[splits] for s in allowed if s < splits)
    assert per == -(-T // splits) * IM.INT4_KSTEP


@pytest.mark.parametrize("K,N", KN)
def test_int4_slices_keep_every_scale_block_whole(K, N):
    """A stage is two whole 64-row scale blocks, so every slice boundary is
    a scale-block boundary: each block's 64 rows (32 packed rows) and its
    one scale row lie in one slice."""
    assert IM.INT4_KSTEP % INT4_BLOCK == 0 and INT4_BLOCK == 2 * IM.INT4_SUB
    _, splits, _ = IM.int4_plan(1, K, N)
    slices = IM.int4_slices(K, splits)
    assert all(lo % INT4_BLOCK == 0 and hi % INT4_BLOCK == 0 for lo, hi in slices)
    owner = [next(r for r, (lo, hi) in enumerate(slices) if lo <= k < hi) for k in range(K)]
    for b in range(K // INT4_BLOCK):
        assert len(set(owner[b * INT4_BLOCK:(b + 1) * INT4_BLOCK])) == 1, f"scale block {b} straddles two slices"


def test_int4_plan_at_the_decoder_shapes():
    """The grids the source note of csrc/int4_matmul.cu gives: 5 x 20, 2 x
    80 and 8 x 20 (100, 160 and 160 blocks) at 1280 x 1280, 1280 x 5120 and
    5120 x 1280, each block's slice 2, 5 and 5 stages of 128 rows. At 1280 x
    1280, 5 splits leave 32 SMs idle: on the H100 they were faster than 8
    (160 blocks) with the same 2-stage slices."""
    assert IM.int4_plan(32, 1280, 1280) == (64, 5, 256)
    assert IM.int4_plan(32, 1280, 5120) == (64, 2, 640)
    assert IM.int4_plan(32, 5120, 1280) == (64, 8, 640)
    # the ragged shapes chip_smoke.py checks: a partial column tile, one stage
    assert IM.int4_plan(5, 1280, 1288) == (64, 5, 256)
    assert IM.int4_plan(3, 128, 256) == (64, 1, 128)


@pytest.mark.parametrize("M,K,N", [(0, 1280, 1280), (65, 1280, 1280), (24, 1312, 1280), (24, 32, 1280),
                                   (24, 1280, 1284), (24, 1280, 0)])
def test_int4_plan_refuses_what_the_kernel_does_not_take(M, K, N):
    with pytest.raises(ValueError, match="int4_plan"):
        IM.int4_plan(M, K, N)


def test_int4_plan_is_independent_of_m():
    """The weight bytes bound the kernel, so the grid is the same at every
    row count: M changes only how many 16-row groups each block multiplies."""
    for K, N in KN:
        assert len({IM.int4_plan(M, K, N) for M in range(1, IM.MAX_M + 1)}) == 1


def test_matmul_int4_still_refuses_off_the_plain_path():
    """A tensor that is neither on the CPU nor on a CUDA card raises before
    any plan is made; bad shapes, scales and types raise on every device."""
    q4 = torch.zeros(640, 1280, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        IM.matmul_int4(torch.zeros(65, 1280, device="meta"), q4, torch.ones(20, 1, 1280, device="meta"))
    with pytest.raises(ValueError, match="bad shapes"):
        IM.matmul_int4(torch.zeros(4, 1288), torch.zeros(640, 1280, dtype=torch.int8), torch.ones(20, 1, 1280))
    with pytest.raises(ValueError, match="scale must be"):
        IM.matmul_int4(torch.zeros(4, 1280), torch.zeros(640, 1280, dtype=torch.int8), torch.ones(20, 2, 1280))
    with pytest.raises(ValueError, match="do not divide"):
        IM.matmul_int4(torch.zeros(4, 1280), torch.zeros(640, 1280, dtype=torch.int8), torch.ones(3, 1, 1280))
    with pytest.raises(TypeError):
        IM.matmul_int4(torch.zeros(4, 1280), torch.zeros(640, 1280, dtype=torch.int8), torch.ones(20, 1, 1280).double())
    with pytest.raises(TypeError):
        IM.matmul_int4(torch.zeros(4, 1280), torch.zeros(640, 1280, dtype=torch.int32), torch.ones(20, 1, 1280))
