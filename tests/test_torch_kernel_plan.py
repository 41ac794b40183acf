"""The launch plans of K2 (``bce_plan``), K3 (``seq_ce_plan``), K4
(``conv_plan``) and the fused PoE + KL (``poe_kl_plan``), on the CPU.

The plans are computed in Python and passed to the CUDA entries, so the
rules that pick a layout are checked here without a card. Imports no JAX.
"""

import numpy as np
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
# (B, H, W, C) of K4: CelebA eval, the probe, a ragged batch, an odd
# grayscale size, a large batch, widths off the 32-pixel tile, every C,
# long rows, one pixel.
CONV_SHAPES = [(64, 64, 64, 3), (256, 64, 64, 3), (37, 64, 64, 3), (5, 25, 25, 1),
               (600, 64, 64, 3), (4, 30, 70, 3), (3, 20, 90, 3), (2, 10, 66, 3),
               (6, 32, 40, 1), (6, 32, 40, 2), (6, 32, 40, 4), (3, 9, 300, 2),
               (2, 7, 1100, 4), (1, 1, 1, 3)]
# (T, B, M, L) of the fused PoE + KL: the CelebA, MultiMNIST and MNIST
# eval batches, CelebA's ragged check at an odd L, a batch of one, more
# rows than SMs, one term of one expert, more terms than a block has warps.
POE_SHAPES = [(20, 64, 19, 100), (3, 100, 2, 256), (3, 100, 2, 64), (20, 10, 19, 37),
              (3, 1, 2, 64), (20, 200, 19, 100), (1, 1, 1, 1), (40, 2, 3, 8)]


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


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_plan_fits_the_shared_memory_it_asks_for(shape):
    """The block's shared memory holds the f32 weights and bias and each
    warp's 4 staged rows, and two blocks fit in the 227 KB of an SM; a
    staged row holds the lead, the 66 columns, and the last lane's float4
    window of 10 columns (4 pixels x 4 taps at stride 2)."""
    b, h, w, c = shape
    plan = kernels.conv_plan(b, h, w, c)
    lead, stride = (-c) % 4, kernels.conv_row_floats(c)
    assert stride % 4 == 0 and stride >= lead + kernels.CONV_TILE_COLS * c
    last_window_end = 8 * c * 7 + 4 * -(-(lead + 10 * c) // 4)
    assert last_window_end <= stride
    need = 4 * (16 * c * kernels.CONV_OUT + kernels.CONV_OUT + plan.warps * 4 * stride)
    assert plan.smem == need and kernels.CONV_BLOCKS_PER_SM * plan.smem <= 227 * 1024
    assert 1 <= plan.warps <= kernels.CONV_MAX_WARPS


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("blocks_per_sm", [1, 2])
def test_conv_plan_covers_every_output_once(shape, blocks_per_sm):
    """The units the grid's warps walk (warp i takes units i, i + step, ...,
    step = blocks x warps; unit u is chunk u % n_chunks of output row
    (u // n_chunks) % h_out of image u // (n_chunks * h_out), as the kernel
    decodes it) cover every output pixel exactly once."""
    b, h, w, c = shape
    plan = kernels.conv_plan(b, h, w, c, blocks_per_sm=blocks_per_sm)
    h_out, w_out = -(-h // 2), -(-w // 2)
    n_chunks = -(-w_out // kernels.CONV_TILE_W)
    units = kernels.conv_units(b, h, w)
    assert units == b * h_out * n_chunks
    assert plan.blocks * plan.warps <= units + plan.warps - 1  # no block without a unit
    covered = np.zeros((b, h_out, n_chunks * kernels.CONV_TILE_W), dtype=np.int64)
    step = plan.blocks * plan.warps
    for first in range(step):
        for u in range(first, units, step):
            chunk, rest = u % n_chunks, u // n_chunks
            lo = chunk * kernels.CONV_TILE_W
            covered[rest // h_out, rest % h_out, lo:lo + kernels.CONV_TILE_W] += 1
    assert np.all(covered[..., :w_out] == 1)


def test_conv_plan_keeps_every_sm_busy_at_the_celeba_eval_shape():
    """(64, 64, 64, 3): 2,048 units, a warp each; 256 blocks of 8 warps on
    the 132 SMs, no SM without a block and none with more than 2, at most
    16 units an SM (the best split of 2,048 over 132 SMs)."""
    plan = kernels.conv_plan(64, 64, 64, 3)
    assert kernels.conv_units(64, 64, 64) == 2048
    assert H100 <= plan.blocks <= 2 * H100
    assert plan.warps * -(-plan.blocks // H100) == -(-2048 // H100)
    small = kernels.conv_plan(64, 64, 64, 3, sms=16)
    assert small.blocks == 16 * kernels.CONV_BLOCKS_PER_SM


@pytest.mark.parametrize(
    "shape, warps, blocks",
    [((37, 64, 64, 3), 4, 296), ((3, 64, 64, 3), 4, 24), ((256, 64, 64, 3), 8, 264),
     ((64, 64, 64, 3), 8, 256)],
)
def test_conv_plan_spreads_small_batches(shape, warps, blocks):
    """A ragged batch (1,184 units) takes blocks of 4 warps: 3 blocks, 12
    units, on the busiest SM, where blocks of 8 put 16 on some SMs and 8
    on most; 3 images spread over 24 SMs, not 12. A batch of more units
    than the grid's warps, or one that splits as evenly either way,
    keeps blocks of 8."""
    assert kernels.conv_plan(*shape)[:2] == (warps, blocks)


@pytest.mark.parametrize(
    "lib, fn, n_args, plan_type",
    [("row_reduce", "bce_rows", 7, kernels.BcePlan),
     ("seq_ce", "seq_ce_rows", 8, kernels.SeqCePlan),
     ("conv_s2", "conv4x4s2_swish", 9, kernels.ConvPlan),
     ("poe_kl", "poe_kl", 11, kernels.PoeKlPlan),
     ("poe_kl", "poe_kl_bwd", 15, kernels.PoeKlBwdPlan)],
)
def test_plans_fill_the_c_signatures(lib, fn, n_args, plan_type):
    """The wrapper passes its arguments, the plan's fields and the stream:
    the ctypes signature has a slot for each, all ints."""
    sig = kernels._SIGNATURES[lib][fn]
    assert len(sig) == n_args + len(plan_type._fields) + 1
    assert all(t is kernels._i32 for t in sig[n_args:-1])


def test_probe_sources_stay_out_of_the_default_build():
    """Every bound library has a source and every source a binding; the
    launch-floor probe is no source of the port's own, so ``build()``
    and the ported paths never compile or load it."""
    assert set(kernels._SIGNATURES) == set(kernels.SOURCES) | set(kernels.PROBE_SOURCES)
    assert not set(kernels.SOURCES) & set(kernels.PROBE_SOURCES)
    assert "empty_launch" in kernels._SIGNATURES["launch_floor"]
    assert all(src.is_file() for src in kernels._ALL_SOURCES.values())


def _poe_covered(t: int, b: int, plan) -> np.ndarray:
    """How often each (term, batch row) is taken, as the kernel decodes the
    grid: block i is batch row i // groups and term group i % groups, the
    group's terms start at (i % groups) * terms, and its warps walk them
    with a stride of the block's warps."""
    groups = -(-t // plan.terms)
    covered = np.zeros((t, b), dtype=np.int64)
    for block in range(plan.blocks):
        row, t0 = block // groups, (block % groups) * plan.terms
        t_end = min(t, t0 + plan.terms)
        for warp in range(plan.warps):
            for term in range(t0 + warp, t_end, plan.warps):
                covered[term, row] += 1
    return covered


@pytest.mark.parametrize("shape", POE_SHAPES)
@pytest.mark.parametrize("groups", [None, 1, 2, 3, 64])
def test_poe_kl_plan_covers_every_term_once(shape, groups):
    """Every (t, b) is taken by exactly one warp of the grid; the block's
    shared memory is its two slabs and its terms' weights, within 48 KB;
    a block has a warp a term, up to 32."""
    t, b, m, l = shape
    plan = kernels.poe_kl_plan(t, b, m, l, groups=groups)
    assert np.all(_poe_covered(t, b, plan) == 1)
    assert plan.smem == 4 * (2 * m * l + plan.terms * m) <= 48 * 1024
    assert plan.warps == min(plan.terms, 32) and 1 <= plan.terms <= t
    assert plan.blocks == b * -(-t // plan.terms)


@pytest.mark.parametrize(
    "shape, plan",
    [((20, 64, 19, 100), (10, 10, 128)), ((3, 100, 2, 256), (3, 3, 100)),
     ((3, 100, 2, 64), (3, 3, 100)), ((20, 200, 19, 100), (20, 20, 200)),
     ((20, 10, 19, 37), (2, 2, 100))],
)
def test_poe_kl_plan_splits_terms_to_fill_the_card(shape, plan):
    """CelebA's 64 rows take 2 groups of 10 terms, 128 blocks on 132 SMs;
    100 rows or more take one group; 10 rows take 10 groups."""
    assert kernels.poe_kl_plan(*shape)[:3] == plan


def test_poe_kl_plan_refuses_a_slab_above_48kb():
    """40 experts x 200 latents are 64,000 bytes of slab: refused, with no
    fallback; 30 x 200 fit."""
    with pytest.raises(ValueError, match="shared memory"):
        kernels.poe_kl_plan(41, 8, 40, 200)
    assert kernels.poe_kl_plan(31, 8, 30, 200).smem <= 48 * 1024


@pytest.mark.parametrize(
    "shape, smem",
    [((3, 100, 2, 64), 4 * (128 + 6 + 576)), ((3, 100, 2, 256), 4 * (512 + 6 + 2304)),
     ((20, 64, 19, 100), 4 * (1900 + 380 + 6000))],
)
def test_poe_kl_bwd_plan_is_a_block_a_batch_row(shape, smem):
    """The backward's plan at the MNIST train and the three eval shapes: a
    block of whole warps per batch row, with the row's precisions, the
    term weights and three (T x L) term arrays in shared memory."""
    plan = kernels.poe_kl_bwd_plan(*shape)
    assert plan.blocks == shape[1] and plan.smem == smem <= 48 * 1024
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024


def test_poe_kl_bwd_plan_refuses_above_48kb():
    """30 terms of 100 latents take 36 KB of term arrays and 19 experts 7.6
    KB of precisions, 45,880 bytes: taken; 40 terms are refused."""
    assert kernels.poe_kl_bwd_plan(30, 8, 19, 100).smem == 45880
    with pytest.raises(ValueError, match="shared memory"):
        kernels.poe_kl_bwd_plan(40, 8, 19, 100)
