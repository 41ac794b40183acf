"""The launch plans of K2 (``bce_plan``; ``bce_inner_plan`` and
``tile_rows`` at its b-major map over examples of several rows), K3 (``seq_ce_plan``), K4
(``conv_plan``), the fused PoE + KL (``poe_kl_plan``) and the backward
kernels of K2 (``bce_grad_plan``), K3 (``seq_ce_grad_plan``), K4
(``conv_bwd_plan``; ``conv_dx_plan``, its input gradient) and the fused
PoE + KL (``poe_kl_bwd_plan``), on the CPU.

The plans are computed in Python and passed to the CUDA entries, so the
rules that pick a layout are checked here without a card. Imports no JAX.
"""

import numpy as np
import pytest
import torch

from mmvae_torch.ops import kernels

H100 = kernels.H100_SMS
# (N, D) of the row reductions the port runs or checks: MNIST, MultiMNIST
# and CelebA eval rows, the large check, CelebA's image rows in each
# fold, fewer rows than SMs at an odd D, D not a multiple of 4, one row.
# The mixture objectives' decode-all rows: MNIST mopoe's (300, 784), CelebA
# mopoe's image (1280, 12288) and attribute (23040, 1) rows.
BCE_SHAPES = [(200, 784), (200, 2500), (128, 12288), (21888, 1), (8192, 784),
              (37, 1000), (16, 50001), (128, 12290), (1, 12288), (6, 3), (1, 0),
              (300, 784), (1280, 12288), (23040, 1)]
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
              (3, 1, 2, 64), (20, 200, 19, 100), (1, 1, 1, 1), (40, 2, 3, 8),
              (2, 100, 2, 64)]


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
     ("conv_s2", "conv4x4s2_swish_bwd", 15, kernels.ConvBwdPlan),
     ("poe_kl", "poe_kl", 11, kernels.PoeKlPlan),
     ("poe_kl", "poe_kl_bwd", 15, kernels.PoeKlBwdPlan),
     ("seq_ce", "seq_ce_rows_grad", 9, kernels.SeqCeGradPlan),
     ("row_reduce", "bce_rows_grad", 8, kernels.BceGradPlan),
     ("row_reduce", "bce_rows_inner", 7, kernels.BceInnerPlan)],
)
def test_plans_fill_the_c_signatures(lib, fn, n_args, plan_type):
    """The wrapper passes its arguments, the code of its data's type where
    it reads f32 or bf16 data (K2's and its VJP's targets, the operands of
    K4's backward), the plan's fields and the stream: the ctypes signature
    has a slot for each, all ints."""
    sig = kernels._SIGNATURES[lib][fn]
    dtype_code = int(fn in _TAKE_A_DTYPE_CODE)
    assert len(sig) == n_args + dtype_code + len(plan_type._fields) + 1
    assert all(t is kernels._i32 for t in sig[n_args:-1])


# The launches that take the code of their data's type before the plan.
_TAKE_A_DTYPE_CODE = ("bce_rows", "bce_rows_inner", "bce_rows_grad", "conv4x4s2_swish_bwd")


def test_conv_bwd_signature_takes_the_gradient_strides_as_64_bits():
    """K4's backward reads its upstream gradient through four element
    strides, int64 slots after the four input pointers."""
    sig = kernels._SIGNATURES["conv_s2"]["conv4x4s2_swish_bwd"]
    assert sig[:4] == [kernels._ptr] * 4 and sig[4:8] == [kernels._i64] * 4


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_bwd_plan_fits_the_shared_memory_it_asks_for(shape):
    """A block stages the weights as the first product's A fragments (hi
    and lo, 2 m-tiles x 2 C k steps x 32 lanes x 8 floats), a tile's 2
    rows + 2 input rows split into TF32 hi and lo planes (the forward's
    row layout, each row padded to 4 past a multiple of 32 floats) and the
    next tile's raw copy of them; at the end the same memory
    holds 16 C x 32 sums a pair of warps and 32 for each lane quarter of a
    pair. It asks for just that, and two blocks fit in the 227 KB of an
    SM."""
    b, h, w, c = shape
    plan = kernels.conv_bwd_plan(b, h, w, c)
    assert plan.warps in (4, 8) and plan.rows in (2, 4)
    k = 16 * c
    row = kernels.conv_bwd_row_floats(c)
    assert row >= kernels.conv_row_floats(c) >= (-c) % 4 + kernels.CONV_TILE_COLS * c
    assert row % 32 == 4  # 16-byte copies stay aligned; fragment loads miss no bank
    weights = 2 * (k // 8) * 32 * 8
    sums = plan.warps // 2 * k * 32 + 2 * plan.warps * 32
    raw = (2 * plan.rows + 2) * kernels.conv_row_floats(c)
    assert plan.smem == 4 * max(weights + 2 * (2 * plan.rows + 2) * row + raw, sums)
    assert 2 * plan.smem <= 227 * 1024


def _bwd_tile_origin(t: int, n_chunks: int, row_tiles: int, rows: int) -> tuple[int, int, int]:
    """Image, first output row and first output column of tile ``t``, as
    the kernel decodes it."""
    chunk, rest = t % n_chunks, t // n_chunks
    return rest // row_tiles, (rest % row_tiles) * rows, chunk * kernels.CONV_TILE_W


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_bwd_plan_covers_every_output_once(shape):
    """The blocks walk the tiles with the grid's stride and every block has
    one; each output pixel, whose g * swish' term enters the sums once, is
    taken exactly once, ragged row tails and a last tile with fewer rows
    included; within a tile, the warps' (m-tile, 16-pixel group) units
    take every (channel, pixel) once, a group as two n-tiles of its even
    and its odd pixels."""
    b, h, w, c = shape
    plan = kernels.conv_bwd_plan(b, h, w, c)
    h_out, w_out = -(-h // 2), -(-w // 2)
    n_chunks = -(-w_out // kernels.CONV_TILE_W)
    row_tiles = -(-h_out // plan.rows)
    tiles = kernels.conv_bwd_tiles(b, h, w, plan.rows)
    assert tiles == b * row_tiles * n_chunks and 1 <= plan.blocks <= tiles
    covered = np.zeros((b, row_tiles * plan.rows, n_chunks * kernels.CONV_TILE_W), np.int64)
    for block in range(plan.blocks):
        for t in range(block, tiles, plan.blocks):
            n, oy0, ox0 = _bwd_tile_origin(t, n_chunks, row_tiles, plan.rows)
            covered[n, oy0:oy0 + plan.rows, ox0:ox0 + kernels.CONV_TILE_W] += 1
    assert np.all(covered == 1)
    pixels = kernels.CONV_TILE_W * plan.rows
    units = np.zeros((32, pixels), np.int64)
    for warp in range(plan.warps):
        for jg in range(warp // 2, pixels // 16, plan.warps // 2):
            for e in range(2):  # n-tile e: column n is pixel 16 jg + 2 n + e
                cols = [16 * jg + 2 * n + e for n in range(8)]
                units[16 * (warp % 2):16 * (warp % 2) + 16, cols] += 1
    assert np.all(units == 1)


def test_conv_bwd_plan_at_the_celeba_train_shape():
    """(64, 64, 64, 3): 512 tiles of 4 x 32 pixels over 2 blocks of 8
    warps an SM, 16 warps, which the launch bound (128 registers a thread)
    and the shared memory let stay resident together; 264 rows of 49 x 32
    partial sums. A card of 16 SMs takes 32 blocks, a single pixel one."""
    plan = kernels.conv_bwd_plan(64, 64, 64, 3)
    assert plan.rows == 4 and kernels.conv_bwd_tiles(64, 64, 64, plan.rows) == 512
    assert plan.blocks == 2 * H100 and plan.warps == 8
    assert plan.warps * plan.blocks // H100 >= 16
    assert 65536 // (32 * plan.warps * plan.blocks // H100) >= 128
    assert plan.blocks // H100 * plan.smem <= 227 * 1024
    assert kernels.conv_bwd_workspace_floats(plan, 3) == 264 * 49 * 32
    assert kernels.conv_bwd_plan(64, 64, 64, 3, sms=16).blocks == 32
    assert kernels.conv_bwd_plan(1, 2, 2, 3).blocks == 1


@pytest.mark.parametrize("shape", [(64, 64, 64, 3), (37, 64, 64, 3), (5, 25, 25, 1),
                                   (2, 7, 1100, 4), (1, 1, 1, 3)])
def test_conv_bwd_workspace_is_a_function_of_shape_and_plan(shape):
    """Inside a captured step the workspace's address is fixed, so its size
    is a pure function of the shape and the plan: one row of (16 C + 1) x
    32 floats a block, asked twice the same, whatever the card's SMs."""
    b, h, w, c = shape
    for sms in (16, H100):
        plan = kernels.conv_bwd_plan(b, h, w, c, sms)
        again = kernels.conv_bwd_plan.__wrapped__(b, h, w, c, sms)
        assert plan == again
        assert kernels.conv_bwd_workspace_floats(plan, c) == plan.blocks * (16 * c + 1) * 32
        assert plan.blocks <= sms * kernels.CONV_BWD_BLOCKS_PER_SM


def test_conv_dx_signature_takes_the_gradient_strides_as_64_bits():
    """K4's input gradient reads its upstream gradient through four element
    strides, int64 slots after the four input pointers, then dx, the shape,
    the code of its operands' type (f32 or all bf16) and the plan's warps,
    blocks, shared memory and rows as int32."""
    sig = kernels._SIGNATURES["conv_s2"]["conv4x4s2_swish_dx"]
    assert sig[:4] == [kernels._ptr] * 4 and sig[4:8] == [kernels._i64] * 4
    assert sig[8] == kernels._ptr and sig[9:-1] == [kernels._i32] * 9
    assert list(kernels.ConvDxPlan._fields) == ["warps", "blocks", "smem", "rows"]


def _dx_row_floats(c: int) -> int:
    """A staged input row: 70 columns of c floats after a lead that puts
    the image's 16-byte chunks on 16 bytes (column 2 j0 - 3 starts it)."""
    lead = (4 - 3 * c % 4) % 4
    assert (-3 * c - lead) % 4 == 0
    return -(-(lead + 70 * c) // 4) * 4


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_dx_plan_fits_the_shared_memory_it_asks_for(shape):
    """A block stages both products' weight fragments (hi and lo, 2 x 1024
    C floats), the tile's raw input and its hi and lo planes (2 rows + 6
    input rows of 70 columns) and T (rows + 2 rows of 34 S pixels of 16 C
    floats, padded); it asks for just that, below the 227 KB a block may
    opt into, at every C. Tiles of 8 rows and a warp a row of S where they
    fill the SMs, else tiles of 2 rows and 12 warps; one block an SM or
    one a tile."""
    b, h, w, c = shape
    h_out, w_out = -(-h // 2), -(-w // 2)

    def tiles(rows):
        return b * -(-h_out // rows) * -(-w_out // 32)

    for sms in (16, H100):
        plan = kernels.conv_dx_plan(b, h, w, c, sms)
        if tiles(8) >= sms:
            assert plan.rows == kernels.CONV_DX_MAX_ROWS == 8 and plan.warps == 10
        else:
            assert plan.rows == kernels.CONV_DX_FEW_ROWS == 2
            assert plan.warps == (4 if tiles(2) >= sms else kernels.CONV_DX_MAX_WARPS)
        t_pitch = 16 * c + (2 if c % 2 else 4)
        assert plan.smem == 4 * (2048 * c + 3 * (2 * plan.rows + 6) * _dx_row_floats(c)
                                 + (plan.rows + 2) * 34 * t_pitch)
        assert plan.smem <= kernels.CONV_DX_MAX_SMEM == 227 * 1024
        assert plan.blocks == max(1, min(tiles(plan.rows), sms))
    assert kernels.CONV_DX_MAX_WARPS == 12
    assert kernels.conv_dx_plan(64, 64, 64, 3) == kernels.ConvDxPlan(10, H100, 149600, 8)


def _dx_slot_col(c: int, s: int) -> int:
    """Column (1..32) of the S grid that slot s of a row item holds, as the
    kernel's ``dx_slot`` maps it: at odd C an m-tile's rows 0-7 are its even
    pixels and rows 8-15 its odd ones, at even C they are in order."""
    rho = s % 16
    return 1 + (s // 16 * 16 + (2 * rho if rho < 8 else 2 * rho - 15) if c % 2 else s)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_conv_dx_slots_take_every_column_once(c):
    """A row item's 32 slots hold the 32 columns of its S row once each,
    and the ring item's first 2 (rows + 2) slots the ring's two columns of
    every row."""
    assert sorted(_dx_slot_col(c, s) for s in range(32)) == list(range(1, 33))
    rows = 8
    ring = {(s // 2, 33 if s % 2 else 0) for s in range(2 * (rows + 2))}
    assert ring == {(r, cs) for r in range(rows + 2) for cs in (0, 33)}


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (3, 33, 31, 3), (5, 25, 25, 1),
                                   (2, 30, 70, 3), (2, 18, 10, 3), (1, 1, 1, 3)])
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_conv_dx_plan_covers_every_input_pixel_once(shape, rows):
    """Walking the tiles as the kernel's blocks do (block k takes tiles k,
    k + blocks, ... of a grid smaller than the tiles), each tile once, its
    fold writes every input pixel exactly once (odd H and W: a last row or
    column of one pixel); every output pixel a written pixel reads (2i + ky
    - 1 = h, 2j + kx - 1 = w) lies in the tile's S grid (its rows and the
    ring around them); the ring's rows are read only at their tap row (ky =
    3 above, ky = 0 below: the one m-tile of product 2 they compute), and
    the ring's columns only in a tile that has the ring item."""
    b, h, w, c = shape
    plan = kernels.conv_dx_plan(b, h, w, c, sms=3, rows=rows)
    h_out, w_out = -(-h // 2), -(-w // 2)
    row_tiles, col_tiles = -(-h_out // rows), -(-w_out // 32)
    tiles = b * row_tiles * col_tiles
    assert plan.blocks == min(tiles, 3)
    seen = np.zeros(tiles, np.int64)
    written = np.zeros((b, h, w), np.int64)
    mt_top, mt_bottom = c - 1, 0  # product 2's m-tile (16 k) of the ring's tap rows
    for block in range(plan.blocks):
        for t in range(block, tiles, plan.blocks):
            seen[t] += 1
            rest, j0 = t // col_tiles, t % col_tiles * 32
            n, m0 = rest // row_tiles, rest % row_tiles * rows
            ring_item = j0 > 0 or j0 + 32 < w_out
            for a in range(2 * rows):
                for wl in range(64):
                    hh, ww = 2 * m0 + a, 2 * j0 + wl
                    if hh >= h or ww >= w:
                        continue
                    written[n, hh, ww] += 1
                    ph, pw = a % 2, wl % 2
                    for d in range(2):
                        r, ky = a // 2 + 1 + ph - d, 1 - ph + 2 * d
                        for d2 in range(2):
                            cs, kx = wl // 2 + 1 + pw - d2, 1 - pw + 2 * d2
                            i, j = m0 - 1 + r, j0 - 1 + cs
                            assert 2 * i + ky - 1 == hh and 2 * j + kx - 1 == ww
                            assert 0 <= r <= rows + 1 and 0 <= cs <= 33
                            if not (0 <= i < h_out and 0 <= j < w_out):
                                continue
                            k = (ky * 4 + kx) * c  # the first of the c patch elements
                            if r == 0:
                                assert ky == 3 and k // 16 == (k + c - 1) // 16 == mt_top
                            if r == rows + 1:
                                assert ky == 0 and (k + c - 1) // 16 == mt_bottom
                            if cs in (0, 33):
                                assert ring_item
    assert np.all(seen == 1) and np.all(written == 1)


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


# (T, B, M, L) of the fused PoE + KL's backward: POE_SHAPES, the MNIST
# and MultiMNIST train steps' (a cycle re-read, T = 1), L = 100 at 100
# rows, and 40 terms of CelebA's experts (above the block-a-row design's
# 48 KB).
POE_BWD_SHAPES = POE_SHAPES + [(1, 100, 2, 256), (3, 100, 2, 100), (40, 8, 19, 100)]


def _poe_bwd_covered(b: int, l: int, plan) -> np.ndarray:
    """How often each (batch row, latent) is taken, as the kernel decodes
    the grid: block i is batch row i // tiles and the latents
    [(i % tiles) * tile, + tile) cut at L."""
    tiles = -(-l // plan.tile)
    covered = np.zeros((b, l), dtype=np.int64)
    for block in range(plan.blocks):
        row, l0 = block // tiles, (block % tiles) * plan.tile
        covered[row, l0:min(l, l0 + plan.tile)] += 1
    return covered


@pytest.mark.parametrize("shape", POE_BWD_SHAPES)
@pytest.mark.parametrize("tile", [None, 4, 32])
def test_poe_kl_bwd_plan_covers_every_latent_once(shape, tile):
    """Every (b, l) is taken by exactly one block, L = 37 and 100 ragged in
    the last tile; the block's shared memory is the tile's precisions,
    the weights rounded up to a float4 and three (T x tile) term arrays,
    within 48 KB; a float4 tile is a multiple of 4 of a multiple-of-4 L;
    the threads are whole warps, at most 512, and cover a (term or
    expert, column) each."""
    t, b, m, l = shape
    plan = kernels.poe_kl_bwd_plan(t, b, m, l, tile=tile)
    assert np.all(_poe_bwd_covered(b, l, plan) == 1)
    assert plan.smem == 4 * (m * plan.tile + -(-t * m // 4) * 4 + 3 * t * plan.tile)
    assert plan.smem <= 48 * 1024
    assert not plan.vec or (l % 4 == 0 and plan.tile % 4 == 0)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    cols = -(-min(plan.tile, l) // (4 if plan.vec else 1))
    assert plan.threads >= min(512, max(t, m) * cols)


@pytest.mark.parametrize(
    "shape, plan",
    [((20, 64, 19, 100), (28, 1, 256, 256)), ((3, 100, 2, 64), (32, 0, 96, 200)),
     ((3, 100, 2, 256), (32, 0, 96, 800)), ((1, 100, 2, 256), (32, 0, 64, 800)),
     ((20, 200, 19, 100), (100, 1, 512, 200))],
)
def test_poe_kl_bwd_plan_fills_the_card(shape, plan):
    """CelebA's 64 rows take float4s and split L = 100 into 4 tiles (28,
    28, 28, 16): 256 blocks on 132 SMs, where a block a row gave 64;
    MNIST's and MultiMNIST's train steps (6 or 2 terms x experts) take
    scalars in tiles of 32 latents; 200 CelebA rows one tile each."""
    got = kernels.poe_kl_bwd_plan(*shape)
    assert got[:4] == plan and got.blocks >= H100


def test_poe_kl_bwd_plan_refuses_only_what_no_tile_fits():
    """40 terms of CelebA's 19 experts, refused by the block-a-row design,
    fit in tiles of 8; so does a scalar tile of 37 latents. 40 terms of
    300 experts take 53,760 bytes at a tile of 4: refused, with no
    fallback."""
    assert kernels.poe_kl_bwd_plan(40, 8, 19, 100).smem <= 48 * 1024
    assert kernels.poe_kl_bwd_plan(20, 10, 19, 37).smem <= 48 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        kernels.poe_kl_bwd_plan(40, 8, 300, 100)


# (N, S, V) of K3's VJP: SEQ_SHAPES, the MultiMNIST train shapes, a last
# chunk of fewer examples (1000 = 142 x 7 + 6), and V at the staged path's
# limit and past it.
SEQ_BWD_SHAPES = SEQ_SHAPES + [(300, 5, 13), (100, 5, 13), (1000, 7, 13), (512, 9, 128),
                               (512, 9, 129)]


def _seq_bwd_covered(n: int, s: int, plan) -> np.ndarray:
    """How often each (example, token) is taken, as the kernels decode the
    grid: block i walks the chunks i, i + blocks, ...; chunk c holds the
    examples [c * examples, + examples) cut at N; on the staged and
    lane-group paths the block's groups of lanes take its token rows, on the
    warp path its warps."""
    chunks = -(-n // plan.examples)
    groups = plan.warps if plan.path == kernels.SEQ_GRAD_WARP else plan.warps * 32 // plan.lanes
    covered = np.zeros((n, s), dtype=np.int64)
    for block in range(plan.blocks):
        for chunk in range(block, chunks, plan.blocks):
            n0 = chunk * plan.examples
            rows = (min(n, n0 + plan.examples) - n0) * s
            for group in range(groups):
                for r in range(group, rows, groups):
                    covered[n0 + r // s, r % s] += 1
    return covered


@pytest.mark.parametrize("shape", SEQ_BWD_SHAPES)
def test_seq_ce_grad_plan_covers_every_token_once(shape):
    """Every (n, s) is taken by exactly one group of lanes (staged and
    lane-group layouts), one warp or one block, over every path and a ragged last
    chunk; the blocks are at most the chunks (the lane-group layout: a block an
    example); a staged block's shared memory is within 48 KB and a token
    row has a power-of-two group of lanes holding at most 32 logits a lane
    below a whole warp."""
    n, s, v = shape
    auto = kernels.seq_ce_grad_plan(n, s, v)
    plans = [auto]
    if auto.path != kernels.SEQ_GRAD_GROUPS:
        plans.append(auto._replace(blocks=min(auto.blocks, 5)))
    if kernels.seq_ce_grad_smem(1, max(s, 1), v) <= 48 * 1024:
        plans.append(kernels.seq_ce_grad_plan(n, s, v, path=kernels.SEQ_GRAD_STAGED,
                                              examples=3))
    for plan in plans:
        assert np.all(_seq_bwd_covered(n, s, plan) == 1)
        assert 1 <= plan.blocks <= -(-n // plan.examples)
        assert 1 <= plan.warps <= 16
        if plan.path == kernels.SEQ_GRAD_STAGED:
            assert kernels.seq_ce_grad_smem(plan.examples, max(s, 1), v) <= 48 * 1024
            assert plan.lanes in (1, 2, 4, 8, 16, 32)
            assert plan.lanes == 32 or -(-v // plan.lanes) <= (32 if v % 2 else 16)
        if plan.path == kernels.SEQ_GRAD_GROUPS:
            assert plan.examples == 1 and plan.blocks == n


@pytest.mark.parametrize(
    "shape, plan",
    [((4096, 32, 23), (kernels.SEQ_GRAD_STAGED, 1, 1, 1, 4096)),
     ((1000, 7, 13), (kernels.SEQ_GRAD_STAGED, 1, 7, 2, 143)),
     ((2048, 8, 5003), (kernels.SEQ_GRAD_WARP, 32, 1, 8, 2048)),
     ((300, 5, 13), (kernels.SEQ_GRAD_GROUPS, 16, 1, 3, 300)),
     ((100, 5, 13), (kernels.SEQ_GRAD_GROUPS, 16, 1, 3, 100)),
     ((512, 9, 128), (kernels.SEQ_GRAD_STAGED, 8, 1, 3, 512)),
     ((512, 9, 129), (kernels.SEQ_GRAD_WARP, 32, 1, 9, 512)),
     ((3, 40, 1001), (kernels.SEQ_GRAD_WARP, 32, 1, 16, 3)),
     ((8, 600, 23), (kernels.SEQ_GRAD_WARP, 32, 1, 16, 8))],
)
def test_seq_ce_grad_plan_paths(shape, plan):
    """The synthetic CUB shape is staged, an example (736 logits) a block
    of one warp, a lane a token row (V odd); 1,000 examples of 7 x 13 take 7 a
    chunk (the last of 6); the large vocabulary takes a warp a token row, a
    block an example's 8; MultiMNIST's train shapes, under 32 tokens an SM,
    take the lane-group layout with the forward's 16 lanes a token row; V =
    128 is staged and V = 129 takes a warp a token row; few tokens of a
    large vocabulary take a warp a token row; an example of 600 x 23 logits (55 KB) is not
    staged."""
    assert kernels.seq_ce_grad_plan(*shape) == kernels.SeqCeGradPlan(*plan)


def test_seq_ce_grad_plan_refuses_a_staged_chunk_above_48kb():
    """A staged path forced on 600 tokens of 23 is refused, with no
    fallback; the chunk of 2 such examples of 300 tokens fits."""
    with pytest.raises(ValueError, match="shared memory"):
        kernels.seq_ce_grad_plan(8, 600, 23, path=kernels.SEQ_GRAD_STAGED)
    assert kernels.seq_ce_grad_plan(8, 300, 23, path=kernels.SEQ_GRAD_STAGED).examples == 1


# (N, D, n_x) of K2's VJP: every shape ``chip_smoke.py`` times and checks
# (the MNIST and MultiMNIST train rows, CelebA's image rows in each fold and
# its attribute rows, D off a multiple of 4, more target rows than a grid
# axis holds, the mixture objectives' decode-all rows), 70,000 rows of an
# image, one row.
BCE_GRAD_SHAPES = [(200, 784, 100), (300, 2500, 100), (128, 12288, 64), (200, 784, 200),
                   (21888, 1, 1152), (36, 1002, 18), (70000, 3, 70000), (70000, 784, 70000),
                   (70000, 784, 35000), (128, 12288, 128), (1, 5, 1),
                   (300, 784, 100), (1280, 12288, 64), (23040, 1, 1152)]


def _bce_grad_plans(n: int, d: int, n_x: int) -> list:
    """The picked plan and, at 32 threads and at 1,024, the rule's lanes, a
    block a chunk of the row and a power of two of lanes."""
    pow2 = 1 << max(0, kernels.bce_grad_units(d) - 1).bit_length()
    plans = [kernels.bce_grad_plan(n, d, n_x)]
    plans += [kernels.bce_grad_plan(n, d, n_x, threads, lanes)
              for threads in (32, 1024) for lanes in (None, threads, min(pow2, threads))]
    return list(dict.fromkeys(plans))


def _axis_count(size: int, grid: int, block: int) -> np.ndarray:
    """How often each index below ``size`` is taken along one axis of
    ``bce_rows_grad_kernel``: block i's thread j takes ``i * block + j``,
    then ``grid * block`` further on while below ``size``."""
    count = np.zeros(size, dtype=np.int64)
    first = np.arange(grid * block)
    for j in range(-(-size // (grid * block))):
        i = first + j * grid * block
        np.add.at(count, i[i < size], 1)
    return count


@pytest.mark.parametrize("shape", BCE_GRAD_SHAPES)
def test_bce_grad_plan_is_a_valid_launch(shape):
    """Threads whole warps, at most 1,024, a whole number of rows of lanes;
    grid y and z within 65,535; the indices the kernel strides to stay
    below 2^31, as the C entry checks."""
    n, d, n_x = shape
    for plan in _bce_grad_plans(n, d, n_x):
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
        assert plan.threads % plan.lanes == 0
        assert plan.grid_x >= 1 and 1 <= plan.grid_y <= 65535 and 1 <= plan.grid_z <= 65535
        rows = plan.threads // plan.lanes
        assert d + plan.grid_x * plan.lanes < 2**31
        assert n_x + plan.grid_y * rows < 2**31 and n // n_x + plan.grid_z < 2**31


@pytest.mark.parametrize(
    "shape, plan",
    [((200, 784, 100), (128, 128, 2, 100, 2)), ((300, 2500, 100), (128, 128, 5, 100, 3)),
     ((128, 12288, 64), (128, 128, 24, 64, 2)), ((21888, 1, 1152), (128, 1, 1, 9, 19)),
     ((36, 1002, 18), (128, 128, 8, 18, 2)), ((70000, 3, 70000), (96, 3, 1, 2188, 1)),
     ((70000, 784, 70000), (128, 128, 2, 65535, 1)), ((800, 52, 800), (416, 13, 1, 25, 1))],
)
def test_bce_grad_plan_picks(shape, plan):
    """MNIST's 196 float4s a row take two chunks of 128 lanes, MultiMNIST's
    625 five, CelebA's image rows 24, the terms on grid z; a D off a
    multiple of 4 counts floats (1,002: 8 chunks); CelebA's attribute rows
    take a lane each, 128 rows a block; rows of 3 floats take 3 lanes, 32
    rows in a block of 96; 70,000 rows of a block each stop at 65,535 on
    grid y (the kernel strides past it); 13 float4s take 13 lanes, 32 rows
    in 416 threads."""
    assert kernels.bce_grad_plan(*shape) == kernels.BceGradPlan(*plan)


@pytest.mark.parametrize(
    "shape, fold",
    [((200, 784, 100), kernels.FOLD_T), ((36, 1002, 18), kernels.FOLD_B),
     ((36, 1002, 18), kernels.FOLD_T), ((21888, 1, 1152), kernels.FOLD_T),
     ((70000, 3, 70000), kernels.FOLD_NONE), ((70000, 784, 70000), kernels.FOLD_NONE),
     ((12, 40, 4), kernels.FOLD_B), ((9, 13, 3), kernels.FOLD_T)],
)
@pytest.mark.parametrize("vec", [True, False])
def test_bce_grad_plan_covers_every_element_once(shape, fold, vec):
    """Every unit of every row is written exactly once, as the kernel
    decodes the grid, in float4s and in floats (an unaligned view takes
    floats at a plan sized for float4s), with each grid axis also cut to a
    few blocks (the kernel strides past the grid): it walks (term t, target
    row b, unit) on three independent axes and writes row t * n_x + b (b *
    k + t b-major), whose target row is the fold's."""
    n, d, n_x = shape
    k = n // n_x
    units = d // 4 if vec and d % 4 == 0 else d
    for plan in _bce_grad_plans(n, d, n_x):
        for cut in (plan, plan._replace(grid_x=1, grid_y=min(plan.grid_y, 3), grid_z=1)):
            assert np.all(_axis_count(units, cut.grid_x, cut.lanes) == 1)
            assert np.all(_axis_count(n_x, cut.grid_y, cut.threads // cut.lanes) == 1)
            assert np.all(_axis_count(k, cut.grid_z, 1) == 1)
    t, b = np.meshgrid(np.arange(k), np.arange(n_x), indexing="ij")
    row = b * k + t if fold == kernels.FOLD_B else t * n_x + b
    assert np.array_equal(np.sort(row.ravel()), np.arange(n))
    assert np.array_equal(row // k if fold == kernels.FOLD_B else row % n_x, b)


# (examples, k, rows an example) of K2's b-major map over examples of
# several rows: CelebA's IWAE attributes, ragged, a row wider than a
# block, one of each.
BCE_INNER_SHAPES = [(64, 64, 18), (5, 7, 3), (3, 2, 300), (2, 600, 1), (1, 1, 1)]


@pytest.mark.parametrize("shape", BCE_INNER_SHAPES)
def test_bce_inner_plan_covers_every_row_once(shape):
    """Every logits row is visited once, as the kernel decodes the grid
    (with each axis also cut to a few blocks: it strides past the grid),
    and reads target row ``b * inner + a`` = ``(r / (k * inner)) * inner +
    r % inner``, the map ``tile_rows`` tiles for the plain version."""
    n_b, k, inner = shape
    plan = kernels.bce_inner_plan(n_b, k, inner)
    assert 1 <= plan.lanes * plan.rows <= 1024 and plan.lanes <= inner
    assert 1 <= plan.grid_y <= kernels.GRID_YZ_MAX and 1 <= plan.grid_z <= kernels.GRID_YZ_MAX
    for cut in (plan, plan._replace(grid_x=1, grid_y=min(plan.grid_y, 2), grid_z=1)):
        assert np.all(_axis_count(inner, cut.grid_x, cut.lanes) == 1)
        assert np.all(_axis_count(k, cut.grid_y, cut.rows) == 1)
        assert np.all(_axis_count(n_b, cut.grid_z, 1) == 1)
    b, t, a = np.meshgrid(np.arange(n_b), np.arange(k), np.arange(inner), indexing="ij")
    row = (b * k + t) * inner + a
    n = n_b * k * inner
    assert np.array_equal(np.sort(row.ravel()), np.arange(n))
    target = b * inner + a
    assert np.array_equal(target, (row // (k * inner)) * inner + row % inner)
    x = torch.arange(n_b * inner)
    tiled = kernels.tile_rows(x, n, kernels.FOLD_B, inner)
    assert np.array_equal(tiled.numpy()[row], target)


def test_bce_inner_plan_at_the_celeba_iwae_shape():
    """64 examples of 18 attributes at k = 64: blocks of 18 x 14 threads,
    a grid of (1, 5, 64)."""
    assert kernels.bce_inner_plan(64, 64, 18) == kernels.BceInnerPlan(18, 14, 1, 5, 64)


def test_tile_rows_refuses_an_inner_map_outside_the_b_fold():
    x = torch.zeros(6, 1)
    with pytest.raises(ValueError, match="inner"):
        kernels.tile_rows(x, 12, kernels.FOLD_T, inner=3)
    with pytest.raises(ValueError, match="inner"):
        kernels.tile_rows(x, 12, kernels.FOLD_B, inner=4)
