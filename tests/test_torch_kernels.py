"""The hand-written CUDA kernels against their plain versions.

Tests marked ``gpu`` build ``mmvae_torch/ops/csrc/row_reduce.cu`` (K1, K2),
``seq_ce.cu`` (K3) and ``conv_s2.cu`` (K4) with ``nvcc`` and run on the
card; without one they skip. This file imports nothing of JAX, so on a machine with a card and no
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerance: rtol 1e-5, atol 1e-5 * D for the row reductions, 1e-5 * S *
log V for K3, 1e-5 * 16 * C for K4 in f32 (16 * C products per output)
-- the kernels sum in another order than PyTorch does; K4 in bf16 atol
2e-2, one bf16 rounding of an output below 4.

The ``ops`` entries refuse the kernel path when autograd would record
them (the kernels have no backward yet); the CPU half of that check runs
without a card.
"""

import math


import pytest
import torch

from mmvae_torch import ops
from mmvae_torch.ops import kernels

FOLDS = [kernels.FOLD_NONE, kernels.FOLD_T, kernels.FOLD_B]


@pytest.fixture
def cuda():
    """The card, with TF32 off for cuDNN and matmuls, so that the plain
    versions compute in f32 as the kernels do (cuDNN convs default to
    TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _close(got: torch.Tensor, want: torch.Tensor, d: int) -> None:
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * d)


def _rand(gen, *shape, device, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to(device)


def _seq_close(got: torch.Tensor, want: torch.Tensor, s: int, v: int) -> None:
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * s * math.log(v))


def _seq_inputs(gen, n, s, v, device, dtype=torch.int32):
    """Logits and tokens whose rows end in PAD runs; rows 0 and 1 all PAD."""
    logits = (torch.randn(n, s, v, generator=gen) * 3).to(device)
    tokens = torch.randint(1, v, (n, s), generator=gen, dtype=dtype)
    lengths = torch.randint(0, s + 1, (n,), generator=gen)
    lengths[:2] = 0
    tokens[torch.arange(s)[None, :] >= lengths[:, None]] = 0
    return logits, tokens.to(device)


def test_wrappers_reject_cpu_tensors():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.kl_std_normal_kernel(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bernoulli_nll_kernel(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.masked_seq_ce_kernel(x[None], torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv4x4s2_swish_kernel(
            torch.zeros((1, 8, 8, 3)), torch.zeros((32, 3, 4, 4)), torch.zeros(32)
        )


def test_conv_plain_pads_like_xla_same():
    """The plain K4 pads (1, 1) at an even size and (1, 2) at 25, and
    gives ceil(d / 2) outputs."""
    assert kernels.same_pad((64, 64)) == [1, 1, 1, 1]
    assert kernels.same_pad((25, 24)) == [1, 1, 1, 2]
    assert kernels.same_pad((1, 1)) == [1, 2, 1, 2]
    y = kernels.conv4x4s2_swish_torch(
        torch.ones((2, 25, 7, 3)), torch.ones((32, 3, 4, 4)), torch.zeros(32)
    )
    assert y.shape == (2, 32, 13, 4) and y.dtype == torch.float32


@pytest.mark.parametrize("fold", FOLDS)
def test_tile_rows_is_the_kernel_row_map(fold):
    """Row r of the tiling holds target row ``r`` (no fold), ``r % n_x``
    (t-major) or ``r // k`` (b-major): the map ``bce_rows`` reads through."""
    n_x = 12 if fold == kernels.FOLD_NONE else 4
    n = 12
    src = torch.arange(n_x)[:, None].expand(n_x, 3)
    got = kernels.tile_rows(src, n, fold)[:, 0]
    r = torch.arange(n)
    want = {
        kernels.FOLD_NONE: r,
        kernels.FOLD_T: r % n_x,
        kernels.FOLD_B: r // (n // n_x),
    }[fold]
    torch.testing.assert_close(got, want)
    with pytest.raises(ValueError):
        kernels.tile_rows(src, n + 1, fold)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 64), (37, 100), (12288, 64), (3, 1)])
def test_kl_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(0)
    mu = _rand(gen, *shape, device=cuda)
    lv = _rand(gen, *shape, device=cuda)
    _close(
        kernels.kl_std_normal_kernel(mu, lv),
        kernels.kl_std_normal_torch(mu, lv), shape[1],
    )


@pytest.mark.gpu
def test_kl_kernel_unaligned_rows(cuda):
    """A contiguous view that starts off a 16-byte boundary takes the
    scalar loads."""
    gen = torch.Generator().manual_seed(1)
    n, d = 50, 64
    mu = _rand(gen, n * d + 1, device=cuda)[1:].view(n, d)
    lv = _rand(gen, n * d + 1, device=cuda)[1:].view(n, d)
    _close(kernels.kl_std_normal_kernel(mu, lv), kernels.kl_std_normal_torch(mu, lv), d)


@pytest.mark.gpu
@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("shape", [(200, 784), (36, 1000), (8192, 784), (6, 3)])
def test_bce_kernel_matches_plain(cuda, fold, shape):
    gen = torch.Generator().manual_seed(2)
    n, d = shape
    n_x = n if fold == kernels.FOLD_NONE else n // 2
    logits = _rand(gen, n, d, device=cuda, scale=3.0)
    x = torch.rand(n_x, d, generator=gen).to(cuda)
    _close(
        kernels.bernoulli_nll_kernel(logits, x, fold),
        kernels.bernoulli_nll_torch(logits, x, fold), d,
    )


@pytest.mark.gpu
def test_wrappers_count_launches_and_reject_bad_inputs(cuda):
    x = torch.zeros((8, 16), device=cuda)
    tok = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    img = torch.zeros((2, 8, 8, 3), device=cuda)
    cw = torch.zeros((32, 3, 4, 4), device=cuda)
    cb = torch.zeros(32, device=cuda)
    before = dict(kernels.LAUNCHES)
    after = {k: v + 1 for k, v in before.items()}
    kernels.kl_std_normal_kernel(x, x)
    kernels.bernoulli_nll_kernel(x, x[:4], kernels.FOLD_T)
    kernels.masked_seq_ce_kernel(x.view(8, 4, 4), tok)
    kernels.conv4x4s2_swish_kernel(img, cw, cb)
    assert kernels.LAUNCHES == after
    with pytest.raises(TypeError):
        kernels.kl_std_normal_kernel(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.kl_std_normal_kernel(x.t(), x.t())
    with pytest.raises(ValueError, match="fold"):
        kernels.bernoulli_nll_kernel(x, x[:3], kernels.FOLD_B)
    with pytest.raises(TypeError):
        kernels.masked_seq_ce_kernel(x.view(8, 4, 4), tok.to(torch.int16))
    with pytest.raises(TypeError):
        kernels.masked_seq_ce_kernel(x.view(8, 4, 4).double(), tok)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.masked_seq_ce_kernel(x.view(8, 4, 4).transpose(0, 1), tok.t())
    with pytest.raises(ValueError):
        kernels.masked_seq_ce_kernel(x.view(8, 4, 4), tok[:, :3])
    with pytest.raises(TypeError):
        kernels.conv4x4s2_swish_kernel(img.double(), cw.double(), cb.double())
    with pytest.raises(TypeError):
        kernels.conv4x4s2_swish_kernel(img, cw.bfloat16(), cb)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.conv4x4s2_swish_kernel(img.permute(0, 2, 1, 3), cw, cb)
    with pytest.raises(ValueError):
        kernels.conv4x4s2_swish_kernel(torch.zeros((2, 8, 8, 5), device=cuda), cw, cb)
    with pytest.raises(ValueError):
        kernels.conv4x4s2_swish_kernel(img, cw[:16], cb[:16])
    assert kernels.LAUNCHES == after


@pytest.mark.gpu
def test_ops_auto_backend_runs_the_kernels_on_the_card(cuda):
    gen = torch.Generator().manual_seed(3)
    logits = _rand(gen, 200, 28, 28, device=cuda)
    x = torch.rand(100, 28, 28, generator=gen).to(cuda)
    before = dict(kernels.LAUNCHES)
    got = ops.bernoulli_nll(logits, x, 2, fold="t")
    assert kernels.LAUNCHES["bce"] == before["bce"] + 1
    ops.set_backend("torch")
    try:
        want = ops.bernoulli_nll(logits, x, 2, fold="t")
    finally:
        ops.set_backend("auto")
    assert kernels.LAUNCHES["bce"] == before["bce"] + 1
    _close(got, want, 784)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(200, 5, 13), (37, 7, 13), (300, 32, 23), (64, 8, 5003), (3, 1, 2)]
)
def test_seq_ce_kernel_matches_plain(cuda, shape):
    """V below a warp (13), the synthetic CUB vocabulary (23), an odd
    large V (5003), V = 2; all-pad rows give exactly 0."""
    gen = torch.Generator().manual_seed(4)
    logits, tokens = _seq_inputs(gen, *shape, device=cuda)
    got = kernels.masked_seq_ce_kernel(logits, tokens, 0)
    _seq_close(got, kernels.masked_seq_ce_torch(logits, tokens, 0), *shape[1:])
    assert torch.all(got[:2] == 0)


@pytest.mark.gpu
def test_seq_ce_kernel_int64_tokens_and_other_pad(cuda):
    gen = torch.Generator().manual_seed(5)
    logits, tokens = _seq_inputs(gen, 50, 6, 23, device=cuda, dtype=torch.int64)
    for pad in (0, 2):
        _seq_close(
            kernels.masked_seq_ce_kernel(logits, tokens, pad),
            kernels.masked_seq_ce_torch(logits, tokens, pad), 6, 23,
        )


@pytest.mark.gpu
def test_seq_ce_kernel_offset_view(cuda):
    """Contiguous views that start one element into their storage: no
    load may assume an aligned row."""
    gen = torch.Generator().manual_seed(6)
    n, s, v = 40, 5, 16
    logits = (torch.randn(n * s * v + 1, generator=gen) * 3).to(cuda)[1:].view(n, s, v)
    tokens = torch.randint(0, v, (n * s + 1,), generator=gen, dtype=torch.int32)
    tokens = tokens.to(cuda)[1:].view(n, s)
    _seq_close(
        kernels.masked_seq_ce_kernel(logits, tokens),
        kernels.masked_seq_ce_torch(logits, tokens), s, v,
    )


@pytest.mark.gpu
def test_ops_masked_seq_ce_runs_the_kernel_on_the_card(cuda):
    gen = torch.Generator().manual_seed(7)
    logits, tokens = _seq_inputs(gen, 200, 5, 13, device=cuda)
    before = kernels.LAUNCHES["seq_ce"]
    got = ops.masked_seq_ce(logits, tokens[:100], fold="t")
    assert kernels.LAUNCHES["seq_ce"] == before + 1
    ops.set_backend("torch")
    try:
        want = ops.masked_seq_ce(logits, tokens[:100], fold="t")
    finally:
        ops.set_backend("auto")
    assert kernels.LAUNCHES["seq_ce"] == before + 1
    _seq_close(got, want, 5, 13)


def _conv_inputs(gen, shape, dtype, device):
    """NHWC image in [0, 1], OIHW weights and a bias, as the probe draws them."""
    x = torch.rand(shape, generator=gen)
    w = torch.randn((32, shape[-1], 4, 4), generator=gen) * 0.1
    b = torch.randn(32, generator=gen) * 0.1
    return tuple(t.to(device=device, dtype=dtype) for t in (x, w, b))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape, dtype",
    [
        ((64, 64, 64, 3), torch.float32),  # the CelebA eval batch
        ((256, 64, 64, 3), torch.bfloat16),  # the probe's shape
        ((37, 64, 64, 3), torch.float32),  # ragged batch
        ((5, 25, 25, 1), torch.float32),  # odd size: pads (1, 2)
        ((3, 9, 300, 2), torch.bfloat16),  # 150 outputs a row: 5 chunks
        ((2, 7, 1100, 4), torch.float32),  # 550 outputs a row: 18 chunks
    ],
)
def test_conv_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator().manual_seed(8)
    x, w, b = _conv_inputs(gen, shape, dtype, cuda)
    _conv_check(kernels.conv4x4s2_swish_kernel(x, w, b),
                kernels.conv4x4s2_swish_torch(x, w, b), shape, dtype)


def _conv_check(got, want, shape, dtype):
    assert got.shape == want.shape == (shape[0], 32, -(-shape[1] // 2), -(-shape[2] // 2))
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * 16 * shape[-1])
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape, plan",
    [
        ((600, 64, 64, 3), None),  # 19,200 units for the grid's 2,112 warps
        ((37, 64, 64, 3), kernels.ConvPlan(2, 3, 4 * (16 * 3 * 32 + 32 + 2 * 4 * 200))),
        ((5, 25, 25, 1), kernels.ConvPlan(1, 1, 4 * (16 * 32 + 32 + 4 * 72))),
    ],
)
def test_conv_kernel_more_units_than_the_grid(cuda, shape, plan):
    """Each warp walks several units with the grid's stride: a large batch
    at the wrapper's plan, and small grids forced through ``plan``."""
    gen = torch.Generator().manual_seed(17)
    x, w, b = _conv_inputs(gen, shape, torch.float32, cuda)
    got = kernels.conv4x4s2_swish_kernel(x, w, b, plan=plan)
    _conv_check(got, kernels.conv4x4s2_swish_torch(x, w, b), shape, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape, dtype",
    [((4, 30, 70, 3), torch.float32), ((3, 20, 90, 3), torch.bfloat16),
     ((2, 10, 66, 3), torch.float32), ((2, 64, 130, 4), torch.bfloat16)],
)
def test_conv_kernel_widths_off_the_pixel_tile(cuda, shape, dtype):
    """35, 45, 33 and 65 output columns: a last chunk of a warp's 32 pixels
    that is partly empty, and scalar stores where a row is not a multiple
    of 4 outputs."""
    gen = torch.Generator().manual_seed(18)
    x, w, b = _conv_inputs(gen, shape, dtype, cuda)
    _conv_check(kernels.conv4x4s2_swish_kernel(x, w, b),
                kernels.conv4x4s2_swish_torch(x, w, b), shape, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 2, 4])
def test_conv_kernel_channels(cuda, c, dtype):
    """Every channel count but CelebA's 3, in both types: each shifts the
    staged rows by another lead (3, 2 or 0 floats)."""
    gen = torch.Generator().manual_seed(19)
    shape = (6, 32, 40, c)
    x, w, b = _conv_inputs(gen, shape, dtype, cuda)
    _conv_check(kernels.conv4x4s2_swish_kernel(x, w, b),
                kernels.conv4x4s2_swish_torch(x, w, b), shape, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape, dtype", [((64, 64, 64, 3), torch.float32), ((256, 64, 64, 3), torch.bfloat16)]
)
def test_conv_kernel_same_bits_twice(cuda, shape, dtype):
    gen = torch.Generator().manual_seed(20)
    x, w, b = _conv_inputs(gen, shape, dtype, cuda)
    assert torch.equal(kernels.conv4x4s2_swish_kernel(x, w, b),
                       kernels.conv4x4s2_swish_kernel(x, w, b))


@pytest.mark.gpu
def test_conv_kernel_refuses_a_plan_it_cannot_run(cuda):
    """A plan with too little shared memory or too many warps for the
    kernel is refused at launch and counts no launch."""
    x, w, b = _conv_inputs(torch.Generator().manual_seed(21), (2, 8, 8, 3), torch.float32, cuda)
    good = kernels.conv_plan(2, 8, 8, 3)
    before = kernels.LAUNCHES["conv"]
    for bad in (good._replace(smem=good.smem - 4), good._replace(smem=228 * 1024),
                good._replace(warps=kernels.CONV_MAX_WARPS + 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.conv4x4s2_swish_kernel(x, w, b, plan=bad)
    assert kernels.LAUNCHES["conv"] == before


def _op_calls(device):
    """Each ops entry with a kernel, as a function of whether its float
    inputs require grad."""
    gen = torch.Generator().manual_seed(22)

    def rand(*shape, grad):
        return torch.randn(*shape, generator=gen).to(device).requires_grad_(grad)

    tok = torch.randint(1, 13, (8, 5), generator=gen, dtype=torch.int32).to(device)
    return {
        "kl_std_normal": lambda g: ops.kl_std_normal(rand(8, 16, grad=g), rand(8, 16, grad=False)),
        "bernoulli_nll": lambda g: ops.bernoulli_nll(
            rand(8, 16, grad=False), torch.rand(8, 16, generator=gen).to(device).requires_grad_(g)),
        "masked_seq_ce": lambda g: ops.masked_seq_ce(rand(8, 5, 13, grad=g), tok),
        "conv4x4s2_swish": lambda g: ops.conv4x4s2_swish(
            torch.rand(2, 8, 8, 3, generator=gen).to(device), rand(32, 3, 4, 4, grad=False),
            rand(32, grad=g)),
    }


OPS = ["kl_std_normal", "bernoulli_nll", "masked_seq_ce", "conv4x4s2_swish"]
OP_COUNTERS = dict(zip(OPS, ["kl", "bce", "seq_ce", "conv"]))


@pytest.mark.gpu
@pytest.mark.parametrize("op", OPS)
def test_ops_kernel_path_refuses_grad(cuda, op):
    """With grad on and an input that requires grad (the second target of
    the BCE, the conv's bias alone), the kernel path raises and launches
    nothing; under ``torch.no_grad`` it launches the kernel."""
    call = _op_calls(cuda)[op]
    before = kernels.LAUNCHES[OP_COUNTERS[op]]
    with pytest.raises(RuntimeError, match=f"ops.{op}: .*backward is not yet ported"):
        call(True)
    assert kernels.LAUNCHES[OP_COUNTERS[op]] == before
    with torch.no_grad():
        call(True)
    call(False)
    assert kernels.LAUNCHES[OP_COUNTERS[op]] == before + 2


@pytest.mark.parametrize("op", OPS)
def test_ops_kernel_backend_refuses_grad_on_the_cpu(op):
    """The grad check comes before the device check: under the "kernel"
    backend a CPU input that requires grad gets the grad error, one that
    does not the CUDA error; the "auto" backend takes the plain path,
    which autograd differentiates."""
    call = _op_calls("cpu")[op]
    ops.set_backend("kernel")
    try:
        with pytest.raises(RuntimeError, match=f"ops.{op}: .*backward is not yet ported"):
            call(True)
        with pytest.raises(ValueError, match="CUDA"):
            call(False)
    finally:
        ops.set_backend("auto")
    assert call(True).requires_grad


@pytest.mark.gpu
def test_ops_conv_runs_the_kernel_on_the_card(cuda):
    gen = torch.Generator().manual_seed(9)
    x, w, b = _conv_inputs(gen, (4, 64, 64, 3), torch.float32, cuda)
    before = kernels.LAUNCHES["conv"]
    got = ops.conv4x4s2_swish(x, w, b)
    assert kernels.LAUNCHES["conv"] == before + 1
    ops.set_backend("torch")
    try:
        want = ops.conv4x4s2_swish(x, w, b)
    finally:
        ops.set_backend("auto")
    assert kernels.LAUNCHES["conv"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * 48)


@pytest.mark.gpu
def test_bce_kernel_attribute_rows(cuda):
    """The CelebA attribute NLL through ops: (19 * 64, 18) logits at
    event_ndims=0 against (64, 18) targets, t-fold: rows of D = 1."""
    gen = torch.Generator().manual_seed(10)
    logits = _rand(gen, 19 * 64, 18, device=cuda, scale=3.0)
    x = torch.randint(0, 2, (64, 18), generator=gen).float().to(cuda)
    before = kernels.LAUNCHES["bce"]
    got = ops.bernoulli_nll(logits, x, 0, fold="t")
    assert kernels.LAUNCHES["bce"] == before + 1
    ops.set_backend("torch")
    try:
        want = ops.bernoulli_nll(logits, x, 0, fold="t")
    finally:
        ops.set_backend("auto")
    assert got.shape == (19 * 64, 18)
    _close(got, want, 1)


def _bce_inputs(gen, n, d, fold, device):
    n_x = n if fold == kernels.FOLD_NONE else n // 2
    logits = _rand(gen, n, d, device=device, scale=3.0)
    return logits, torch.rand(n_x, d, generator=gen).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("fold", FOLDS)
def test_bce_kernel_celeba_image_rows(cuda, fold):
    """CelebA's image rows, (128, 12288) against 64 targets in a fold:
    rows split over clusters; two calls give the same bits."""
    gen = torch.Generator().manual_seed(11)
    logits, x = _bce_inputs(gen, 128, 12288, fold, cuda)
    got = kernels.bernoulli_nll_kernel(logits, x, fold)
    _close(got, kernels.bernoulli_nll_torch(logits, x, fold), 12288)
    assert torch.equal(got, kernels.bernoulli_nll_kernel(logits, x, fold))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 50001), (128, 12290)])
def test_bce_kernel_long_rows_scalar_path(cuda, shape):
    """D not a multiple of 4 takes scalar loads in the split layout; 16
    rows are fewer than the SMs, so each spans a cluster."""
    gen = torch.Generator().manual_seed(12)
    logits, x = _bce_inputs(gen, *shape, kernels.FOLD_NONE, cuda)
    got = kernels.bernoulli_nll_kernel(logits, x)
    _close(got, kernels.bernoulli_nll_torch(logits, x), shape[1])
    assert torch.equal(got, kernels.bernoulli_nll_kernel(logits, x))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 12288), (200, 784), (21888, 1)])
def test_bce_kernel_offset_view(cuda, shape):
    """Contiguous views one element into their storage: every layout
    takes scalar loads off a 16-byte boundary."""
    gen = torch.Generator().manual_seed(13)
    n, d = shape
    logits = _rand(gen, n * d + 1, device=cuda, scale=3.0)[1:].view(n, d)
    x = torch.rand(n // 2 * d + 1, generator=gen).to(cuda)[1:].view(n // 2, d)
    _close(
        kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_T),
        kernels.bernoulli_nll_torch(logits, x, kernels.FOLD_T), d,
    )


@pytest.mark.gpu
@pytest.mark.parametrize(
    "plan",
    [
        kernels.BcePlan(kernels.BCE_WARP, 256, 1, 5),
        kernels.BcePlan(kernels.BCE_SPLIT, 128, 1, 38),
        kernels.BcePlan(kernels.BCE_SPLIT, 256, 2, 76),
        kernels.BcePlan(kernels.BCE_SPLIT, 1024, 8, 304),
        kernels.BcePlan(kernels.BCE_THREAD, 64, 1, 1),
    ],
)
@pytest.mark.parametrize("d", [4100, 4099])
def test_bce_kernel_every_layout(cuda, plan, d):
    """Each layout, forced through ``plan``, at an aligned and an odd D
    against b-major targets (38 rows onto 19); the same bits from call to
    call."""
    gen = torch.Generator().manual_seed(14)
    logits, x = _bce_inputs(gen, 38, d, kernels.FOLD_B, cuda)
    got = kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B, plan=plan)
    _close(got, kernels.bernoulli_nll_torch(logits, x, kernels.FOLD_B), d)
    assert torch.equal(got, kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B, plan=plan))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(2048, 8, 5003), (4096, 32, 23), (37, 7, 13), (3, 40, 1001), (5, 3, 31)]
)
def test_seq_ce_kernel_layouts(cuda, shape):
    """Rows that start off a 16-byte boundary (odd V: a scalar head and
    tail around the float4 body), S above what a block runs at once (32,
    40), V below a warp, all-pad rows; the same bits from a second call.
    Every other group of lanes a token row agrees with the plain version
    too."""
    gen = torch.Generator().manual_seed(15)
    logits, tokens = _seq_inputs(gen, *shape, device=cuda)
    want = kernels.masked_seq_ce_torch(logits, tokens, 0)
    got = kernels.masked_seq_ce_kernel(logits, tokens, 0)
    _seq_close(got, want, *shape[1:])
    assert torch.all(got[:2] == 0)
    assert torch.equal(got, kernels.masked_seq_ce_kernel(logits, tokens, 0))
    n = shape[0]
    for lanes, warps in ((32, 32), (32, 1), (8, 2), (1, 1)):
        plan = kernels.SeqCePlan(lanes, warps, n)
        other = kernels.masked_seq_ce_kernel(logits, tokens, 0, plan=plan)
        _seq_close(other, want, *shape[1:])
        assert torch.all(other[:2] == 0)


@pytest.mark.gpu
def test_seq_ce_kernel_large_vocab_int64_tokens_and_other_pad(cuda):
    gen = torch.Generator().manual_seed(16)
    logits, tokens = _seq_inputs(gen, 64, 9, 5003, device=cuda, dtype=torch.int64)
    for pad in (0, 2):
        got = kernels.masked_seq_ce_kernel(logits, tokens, pad)
        _seq_close(got, kernels.masked_seq_ce_torch(logits, tokens, pad), 9, 5003)
        assert torch.equal(got, kernels.masked_seq_ce_kernel(logits, tokens, pad))
