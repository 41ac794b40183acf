"""The launch plans of K2 (``bce_plan``) and K3 (``seq_ce_plan``), on the CPU.

The plans are computed in Python and passed to the CUDA entries, so the
rules that pick a layout are checked here without a card. Imports no JAX.
"""

import pytest

from mmvae_torch.ops import kernels

H100 = kernels.H100_SMS
# (N, D) of the row reductions the port runs or checks: MNIST, MultiMNIST
# and CelebA eval rows, the large check, CelebA's image rows in each
# fold, fewer rows than SMs at an odd D, D not a multiple of 4, one row.
BCE_SHAPES = [(200, 784), (200, 2500), (128, 12288), (21888, 1), (8192, 784),
              (37, 1000), (16, 50001), (128, 12290), (1, 12288), (6, 3), (1, 0)]
SEQ_SHAPES = [(200, 5, 13), (2048, 8, 5003), (4096, 32, 23), (37, 7, 13),
              (3, 40, 1001), (5, 3, 31), (4, 0, 7), (3, 1, 2), (9, 9, 64), (9, 9, 65)]


@pytest.mark.parametrize("shape", BCE_SHAPES)
def test_bce_plan_is_a_valid_launch(shape):
    """Threads a multiple of 32 up to 1024; a cluster of 1-8 blocks a row
    with exactly N * split blocks; a grid-strided layout within 4096."""
    n, d = shape
    plan = kernels.bce_plan(n, d)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert 1 <= plan.split <= 8
    if plan.layout == kernels.BCE_SPLIT:
        assert plan.blocks == n * plan.split
    else:
        assert plan.split == 1 and 1 <= plan.blocks <= 4096
        rows_a_block = plan.threads // (32 if plan.layout == kernels.BCE_WARP else 1)
        assert plan.blocks == min(-(-n // rows_a_block), 4096)


def test_bce_plan_fills_the_card_with_celeba_image_rows():
    """128 rows of 12,288: a block of 512 threads a row, 128 blocks (a warp
    a row gave 16 blocks); a cluster would put two blocks on most SMs."""
    assert kernels.bce_plan(128, 12288) == kernels.BcePlan(kernels.BCE_SPLIT, 512, 1, 128)


@pytest.mark.parametrize("shape", [(200, 784), (200, 2500), (528, 784)])
def test_bce_plan_gives_eval_rows_a_block_each(shape):
    """The MNIST and MultiMNIST eval rows: a block of 256 threads a row."""
    n, d = shape
    assert kernels.bce_plan(n, d) == kernels.BcePlan(kernels.BCE_SPLIT, 256, 1, n)


@pytest.mark.parametrize("shape", [(16, 50001), (1, 12288), (60, 4096), (37, 1000)])
def test_bce_plan_splits_few_rows_over_clusters(shape):
    """Rows that fill less than half the SMs: clusters of up to 8 blocks a
    row, as many as keep one block an SM."""
    n, d = shape
    plan = kernels.bce_plan(n, d)
    assert plan.layout == kernels.BCE_SPLIT and plan.split > 1
    assert plan.blocks <= H100 and (plan.split == 8 or 2 * plan.blocks > H100)
    assert kernels.bce_plan(n, d, sms=8 * n).split == 8
    assert kernels.bce_plan(n, d, sms=n).split == 1


@pytest.mark.parametrize(
    "shape, layout",
    [((8192, 784), kernels.BCE_WARP), ((1056, 784), kernels.BCE_WARP),
     ((1055, 784), kernels.BCE_SPLIT), ((8192, 2048), kernels.BCE_SPLIT),
     ((8192, 2047), kernels.BCE_WARP)],
)
def test_bce_plan_takes_a_warp_a_row_only_for_many_short_rows(shape, layout):
    """A warp a row from 8 rows an SM on, for rows under 2048 elements."""
    assert kernels.bce_plan(*shape).layout == layout


def test_bce_plan_attribute_rows():
    """CelebA's attributes, rows of D = 1, take a thread a row."""
    plan = kernels.bce_plan(21888, 1)
    assert plan.layout == kernels.BCE_THREAD
    assert plan.blocks * plan.threads >= 21888


@pytest.mark.parametrize("shape", SEQ_SHAPES)
def test_seq_ce_plan_is_a_valid_launch(shape):
    """A block per example; a power-of-two group of lanes a token row,
    at most 12 logits a lane below a whole warp; up to 8 warps (32 when
    the examples are fewer than the SMs), no more than the example's
    tokens fill."""
    n, s, v = shape
    plan = kernels.seq_ce_plan(n, s, v)
    cap = 32 if n < H100 else 8
    assert plan.blocks == n
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.lanes == 32 or -(-v // plan.lanes) <= 12
    assert 1 <= plan.warps <= cap
    assert plan.warps == cap or plan.warps * 32 // plan.lanes >= s
    assert plan.warps == 1 or (plan.warps - 1) * 32 // plan.lanes < s


def test_seq_ce_plan_large_vocabulary_takes_a_warp_per_token():
    assert kernels.seq_ce_plan(2048, 8, 5003) == kernels.SeqCePlan(32, 8, 2048)


@pytest.mark.parametrize(
    "shape, plan",
    [((200, 5, 13), (16, 3, 200)), ((4096, 32, 23), (2, 2, 4096)),
     ((3, 40, 1001), (32, 32, 3))],
)
def test_seq_ce_plan_small_calls_and_small_vocabularies(shape, plan):
    """MultiMNIST's eval, 1,000 tokens of 13 symbols: 16 lanes a token, the
    example's 5 tokens in 3 warps. The synthetic CUB vocabulary, 131,072
    tokens of 23: 2 lanes a token, 32 tokens in 2 warps. Three examples
    of 40 tokens: a block of 32 warps each."""
    assert kernels.seq_ce_plan(*shape) == kernels.SeqCePlan(*plan)


@pytest.mark.parametrize(
    "lib, fn, n_args, plan_type",
    [("row_reduce", "bce_rows", 7, kernels.BcePlan),
     ("seq_ce", "seq_ce_rows", 8, kernels.SeqCePlan)],
)
def test_plans_fill_the_c_signatures(lib, fn, n_args, plan_type):
    """The wrapper passes its arguments, the plan's fields and the stream:
    the ctypes signature has a slot for each, all ints."""
    sig = kernels._SIGNATURES[lib][fn]
    assert len(sig) == n_args + len(plan_type._fields) + 1
    assert all(t is kernels._i32 for t in sig[n_args:-1])
