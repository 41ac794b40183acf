"""The hand-written CUDA kernels against their plain versions.

Tests marked ``gpu`` build ``mmvae_torch/ops/csrc/row_reduce.cu`` (K1, K2
with its b-major map over examples of several rows, and their gradients),
``seq_ce.cu`` (K3), ``conv_s2.cu`` (K4, its backward and its input
gradient) and
``poe_kl.cu`` (the fused PoE + KL and its backward) with ``nvcc`` and run
on the card; without one they skip. This file imports nothing of JAX, so
on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerance: rtol 1e-5, atol 1e-5 * D for the row reductions, 1e-5 * S *
log V for K3, 1e-5 * 16 * C for K4 in f32 (16 * C products per output)
-- the kernels sum in another order than PyTorch does; K4 in bf16 atol
2e-2, one bf16 rounding of an output below 4. The fused PoE + KL: rtol
1e-5 and atol 1e-6 for the posteriors, atol 1e-5 * L for the KL. The
elementwise gradients of K1 and K2: rtol 1e-5, atol 1e-6 (the same
products, rounded where the plain version's separate ops round them).
The fused PoE + KL's backward: rtol 1e-5, atol 1e-5 * T times the
largest gradient (it sums T terms, and the plain version sums the
experts of a term's precision in another order). K3's gradient: rtol
1e-5, atol 1e-6 (softmax less the one-hot times g, with the exp-sum in
another order). K4's backward: rtol 1e-5, atol 1e-6 * N, N = B *
ceil(H/2) * ceil(W/2) the terms each entry of dW and db sums (each term
below 1 in size here: an image in [0, 1] times g * swish'), summed in
another order than the plain version's batched product.

``kl_std_normal``, ``bernoulli_nll``, ``masked_seq_ce``, ``poe_kl`` and
``conv4x4s2_swish`` take their gradients from backward kernels on the
card, the image of ``conv4x4s2_swish`` too (``conv4x4s2_swish_dx``); the
targets of ``bernoulli_nll`` get none there, and the kernel path refuses
them when autograd would record them. The CPU half of those checks runs
without a card.
"""

import math


import pytest
import torch

from mmvae_torch import ops
from mmvae_torch.core import elbo_subset_masks
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
        kernels.masked_seq_ce_grad_kernel(
            x[None], torch.zeros((1, 4), dtype=torch.int32), 0, torch.ones(1))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv4x4s2_swish_kernel(
            torch.zeros((1, 8, 8, 3)), torch.zeros((32, 3, 4, 4)), torch.zeros(32)
        )
    with pytest.raises(ValueError, match="CUDA"):
        kernels.poe_kl_kernel(torch.zeros((4, 2, 8)), torch.zeros((4, 2, 8)), torch.ones((3, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv4x4s2_swish_grad_kernel(
            torch.zeros((1, 8, 8, 3)), torch.zeros((32, 3, 4, 4)), torch.zeros(32),
            torch.zeros((1, 32, 4, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv4x4s2_swish_input_grad_kernel(
            torch.zeros((1, 8, 8, 3)), torch.zeros((32, 3, 4, 4)), torch.zeros(32),
            torch.zeros((1, 32, 4, 4)))


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
    experts, masks = x.view(8, 2, 8), elbo_subset_masks(2, device=cuda)
    before = dict(kernels.LAUNCHES)
    after = {k: v + 1 for k, v in before.items()}
    kernels.kl_std_normal_kernel(x, x)
    kernels.bernoulli_nll_kernel(x, x[:4], kernels.FOLD_T)
    kernels.masked_seq_ce_kernel(x.view(8, 4, 4), tok)
    kernels.conv4x4s2_swish_kernel(img, cw, cb)
    mu_f, lv_f, kl = kernels.poe_kl_kernel(experts, experts, masks)
    g = torch.ones(8, device=cuda)
    kernels.kl_rows_grad_kernel(x, x, g)
    kernels.bce_rows_grad_kernel(x, x[:4], g, kernels.FOLD_T)
    kernels.bce_rows_grad_kernel(x, x[:4], g, kernels.FOLD_B, inner=2)
    kernels.masked_seq_ce_grad_kernel(x.view(8, 4, 4), tok, 0, g)
    kernels.poe_kl_grad_kernel(experts, experts, masks, None, mu_f, lv_f, mu_f, lv_f, kl)
    cg = torch.zeros((2, 32, 4, 4), device=cuda)
    kernels.conv4x4s2_swish_grad_kernel(img, cw, cb, cg)
    kernels.conv4x4s2_swish_input_grad_kernel(img, cw, cb, cg)
    assert kernels.LAUNCHES == after
    with pytest.raises(ValueError, match="g is"):
        kernels.conv4x4s2_swish_input_grad_kernel(img, cw, cb, cg[:, :, :3])
    with pytest.raises(TypeError):
        kernels.conv4x4s2_swish_input_grad_kernel(img.bfloat16(), cw, cb, cg)
    with pytest.raises(ValueError, match="g is"):
        kernels.conv4x4s2_swish_grad_kernel(img, cw, cb, cg[:, :, :3])
    with pytest.raises(TypeError):
        kernels.conv4x4s2_swish_grad_kernel(img, cw.bfloat16(), cb.bfloat16(), cg.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.conv4x4s2_swish_grad_kernel(img.permute(0, 2, 1, 3), cw, cb, cg)
    with pytest.raises(ValueError, match="g must be"):
        kernels.masked_seq_ce_grad_kernel(x.view(8, 4, 4), tok, 0, g[:4])
    with pytest.raises(TypeError):
        kernels.masked_seq_ce_grad_kernel(x.view(8, 4, 4), tok.to(torch.int16), 0, g)
    with pytest.raises(ValueError, match="g must be"):
        kernels.kl_rows_grad_kernel(x, x, g[:4])
    with pytest.raises(ValueError, match="fold"):
        kernels.bce_rows_grad_kernel(x, x[:3], g, kernels.FOLD_B)
    with pytest.raises(ValueError):
        kernels.poe_kl_grad_kernel(experts, experts, masks, None, mu_f, lv_f, mu_f, lv_f, kl[:1])
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
    with pytest.raises(ValueError):  # F = 16 and 8 are K4's too; 24 is not
        kernels.conv4x4s2_swish_kernel(img, cw[:24], cb[:24])
    with pytest.raises(TypeError):
        kernels.poe_kl_kernel(experts.double(), experts.double(), masks)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.poe_kl_kernel(experts, experts.transpose(0, 1).contiguous().transpose(0, 1), masks)
    with pytest.raises(ValueError):
        kernels.poe_kl_kernel(experts, experts, masks, torch.ones((8, 3), device=cuda))
    with pytest.raises(ValueError):
        kernels.poe_kl_kernel(experts, experts, masks[:, :1])
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
    """All bf16: the kernel and its plain version round the conv (each
    summed in f32 from the same bf16 operands), the bias add, the sigmoid
    and the product to bf16, as Flax does, so they agree to one bf16 step
    (2^-7 of the value at most) where their f32 sums straddle a rounding."""
    assert got.shape == want.shape == (shape[0], 32, -(-shape[1] // 2), -(-shape[2] // 2))
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * 16 * shape[-1])
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=0)


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


def _conv_grad_inputs(gen, shape, device, strided: bool = False):
    """K4's inputs and an upstream gradient of its output's shape; with
    ``strided``, the gradient is the interior of a padded one, as the next
    stage's ``F.pad`` hands it back (a view that is not contiguous)."""
    x, w, b = _conv_inputs(gen, shape, torch.float32, device)
    out = (shape[0], 32, -(-shape[1] // 2), -(-shape[2] // 2))
    if not strided:
        return x, w, b, torch.randn(out, generator=gen).to(device)
    padded = torch.randn((*out[:2], out[2] + 2, out[3] + 3), generator=gen).to(device)
    return x, w, b, padded[:, :, 1:-1, 1:-2]


def _conv_grad_close(got, want, shape) -> None:
    n_terms = shape[0] * -(-shape[1] // 2) * -(-shape[2] // 2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * n_terms)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape",
    [
        (64, 64, 64, 3),  # the CelebA train batch
        (37, 64, 64, 3),  # ragged batch
        (5, 25, 25, 1),  # odd size: pads (1, 2)
        (4, 30, 70, 3),  # 35 outputs a row: a last chunk of 3 pixels
        (2, 10, 66, 3),  # 33 outputs a row: a last pair of one pixel
        (6, 32, 40, 1), (6, 32, 40, 2), (6, 32, 40, 4),  # every C
        (2, 7, 1100, 4),  # 550 outputs a row: 18 chunks
        (600, 64, 64, 3),  # 19,200 units for the grid's 1,056 warps
    ],
)
def test_conv_grad_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(40)
    args = _conv_grad_inputs(gen, shape, cuda)
    got = kernels.conv4x4s2_swish_grad_kernel(*args)
    assert got[0].shape == (32, shape[3], 4, 4) and got[1].shape == (32,)
    _conv_grad_close(got, kernels.conv4x4s2_swish_grad_torch(*args), shape)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape, plan",
    [
        ((64, 64, 64, 3), None),
        ((37, 64, 64, 3), kernels.conv_bwd_plan(37, 64, 64, 3, warps=4)._replace(blocks=3)),
        ((5, 25, 25, 1), kernels.conv_bwd_plan(5, 25, 25, 1, rows=2)._replace(blocks=1)),
    ],
)
def test_conv_grad_kernel_strided_g_and_small_grids(cuda, shape, plan):
    """The upstream gradient as a strided view, read in place; small grids
    forced through ``plan`` walk many tiles a block."""
    gen = torch.Generator().manual_seed(41)
    args = _conv_grad_inputs(gen, shape, cuda, strided=True)
    assert not args[3].is_contiguous()
    got = kernels.conv4x4s2_swish_grad_kernel(*args, plan=plan)
    _conv_grad_close(got, kernels.conv4x4s2_swish_grad_torch(*args), shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 64, 64, 3), (37, 64, 64, 3)])
def test_conv_grad_kernel_same_bits_twice(cuda, shape):
    """No atomics: two launches with one plan give the same bits."""
    args = _conv_grad_inputs(torch.Generator().manual_seed(42), shape, cuda)
    one, two = (kernels.conv4x4s2_swish_grad_kernel(*args) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.gpu
def test_conv_grad_kernel_refuses_a_plan_it_cannot_run(cuda):
    """Too little shared memory, more than 227 KB, too many warps, or a
    tile of 3 rows: the launch is refused and counts none."""
    args = _conv_grad_inputs(torch.Generator().manual_seed(43), (2, 8, 8, 3), cuda)
    good = kernels.conv_bwd_plan(2, 8, 8, 3)
    before = kernels.LAUNCHES["conv_bwd"]
    for bad in (good._replace(smem=good.smem - 4), good._replace(smem=228 * 1024),
                good._replace(warps=kernels.CONV_BWD_MAX_WARPS + 1), good._replace(rows=3)):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.conv4x4s2_swish_grad_kernel(*args, plan=bad)
    assert kernels.LAUNCHES["conv_bwd"] == before


def _conv_bf16_close(got, want, atol: float) -> None:
    """A bf16 output of a K4 kernel against its plain version: both sum in
    f32 from the same bf16 operands (in another order, ``atol`` as in f32)
    and round once to bf16, so they may land one bf16 step apart (2^-7 of
    the value at most)."""
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=atol)


def _conv_dx_close(got, want) -> None:
    """dx against its plain version: each entry sums 4 taps x 32 channels
    of g * swish'(pre) * w (each below 1 in size here), so atol 1e-6 a
    term, in another order than the plain version's fold."""
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * 4 * 32)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape",
    [
        (64, 64, 64, 3),  # CUB's train batch
        (3, 33, 31, 3),  # odd H and W: the last band ends at the image's last row
        (5, 25, 25, 1),  # odd size: pads (1, 2)
        (6, 32, 40, 1), (6, 32, 40, 2), (6, 32, 40, 4),  # every C
        (4, 30, 70, 3),  # 35 outputs a row: a second tile of 3 columns
        (2, 7, 1100, 4),  # 550 outputs a row: 18 tiles
        (2, 18, 10, 3),  # 9 output rows: a band of one row past two of 4
        (1, 1, 1, 3),  # one pixel
    ],
)
def test_conv_dx_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(44)
    args = _conv_grad_inputs(gen, shape, cuda)
    got = kernels.conv4x4s2_swish_input_grad_kernel(*args)
    assert got.shape == shape and got.dtype == torch.float32
    _conv_dx_close(got, kernels.conv4x4s2_swish_input_grad_torch(*args))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape, plan",
    [
        ((64, 64, 64, 3), None),
        ((5, 25, 25, 1), kernels.conv_dx_plan(5, 25, 25, 1, rows=1, warps=1)),
        ((3, 33, 31, 3), kernels.conv_dx_plan(
            3, 33, 31, 3, rows=kernels.CONV_DX_MAX_ROWS, warps=kernels.CONV_DX_MAX_WARPS)),
        ((64, 64, 64, 3), kernels.conv_dx_plan(64, 64, 64, 3)._replace(blocks=3)),
        ((2, 7, 1100, 4), kernels.conv_dx_plan(2, 7, 1100, 4, rows=2, warps=3)),
    ],
)
def test_conv_dx_kernel_strided_and_transposed_g_and_other_plans(cuda, shape, plan):
    """The upstream gradient as a padded view and as a transposed one, read
    in place; the smallest tile (1 output row, 1 warp taking its 3 rows of
    S in turn) and the largest (8 rows, 12 warps); more tiles than a grid of
    3 blocks; rows of 18 tiles, each with the ring's columns, at 2 output
    rows and 3 warps for 5 items."""
    gen = torch.Generator().manual_seed(45)
    x, w, b, g = _conv_grad_inputs(gen, shape, cuda, strided=True)
    transposed = g.transpose(2, 3).contiguous().transpose(2, 3)
    for view in (g, transposed):
        assert not view.is_contiguous()
        got = kernels.conv4x4s2_swish_input_grad_kernel(x, w, b, view, plan=plan)
        _conv_dx_close(got, kernels.conv4x4s2_swish_input_grad_torch(x, w, b, view))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape",
    [
        (64, 64, 64, 3),  # the CelebA and CUB train batch
        (3, 33, 31, 3),  # odd H and W
        (6, 32, 40, 1), (6, 32, 40, 2), (6, 32, 40, 3), (6, 32, 40, 4),  # every C
    ],
)
def test_conv_bwd_and_dx_kernels_all_bf16_match_plain(cuda, shape):
    """A bf16 model's stage 0: K4's backward (dW, db) and its input gradient
    from a bf16 image, weight, bias and upstream gradient, each in bf16,
    against the plain versions on the same operands (``_conv_bf16_close``);
    a strided upstream gradient too; two launches of each give the same
    bits."""
    gen = torch.Generator().manual_seed(67)
    x, w, b, g = (t.bfloat16() for t in _conv_grad_inputs(gen, shape, cuda, strided=True))
    n_terms = shape[0] * -(-shape[1] // 2) * -(-shape[2] // 2)
    for view in (g, g.contiguous()):
        got = kernels.conv4x4s2_swish_grad_kernel(x, w, b, view)
        want = kernels.conv4x4s2_swish_grad_torch(x, w, b, view)
        for a, c in zip(got, want):
            _conv_bf16_close(a, c, 1e-6 * n_terms)
        again = kernels.conv4x4s2_swish_grad_kernel(x, w, b, view)
        assert all(torch.equal(p, q) for p, q in zip(got, again))
        dx = kernels.conv4x4s2_swish_input_grad_kernel(x, w, b, view)
        assert dx.shape == shape
        _conv_bf16_close(dx, kernels.conv4x4s2_swish_input_grad_torch(x, w, b, view),
                         1e-6 * 4 * 32)
        assert torch.equal(dx, kernels.conv4x4s2_swish_input_grad_kernel(x, w, b, view))


@pytest.mark.gpu
def test_conv_dx_kernel_empty_batch(cuda):
    """An empty batch gives an empty dx and launches nothing."""
    x, w, b, g = _conv_grad_inputs(torch.Generator().manual_seed(46), (0, 8, 8, 3), cuda)
    before = kernels.LAUNCHES["conv_dx"]
    assert kernels.conv4x4s2_swish_input_grad_kernel(x, w, b, g).shape == (0, 8, 8, 3)
    assert kernels.LAUNCHES["conv_dx"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 64, 64, 3), (3, 33, 31, 3)])
def test_conv_dx_kernel_same_bits_twice(cuda, shape):
    """No atomics: two launches give the same bits."""
    args = _conv_grad_inputs(torch.Generator().manual_seed(47), shape, cuda)
    one, two = (kernels.conv4x4s2_swish_input_grad_kernel(*args) for _ in range(2))
    assert torch.equal(one, two)


@pytest.mark.gpu
def test_conv_dx_kernel_refuses_a_plan_it_cannot_run(cuda):
    """Too little shared memory, more than 227 KB, no warps or more than 12,
    no blocks, or tiles of no rows or past 8: the launch is refused and
    counts none."""
    args = _conv_grad_inputs(torch.Generator().manual_seed(48), (2, 8, 8, 3), cuda)
    good = kernels.conv_dx_plan(2, 8, 8, 3)
    before = kernels.LAUNCHES["conv_dx"]
    for bad in (good._replace(smem=good.smem - 4), good._replace(smem=228 * 1024),
                good._replace(warps=0), good._replace(warps=kernels.CONV_DX_MAX_WARPS + 1),
                good._replace(blocks=0), good._replace(rows=0),
                good._replace(rows=kernels.CONV_DX_MAX_ROWS + 1,
                              smem=kernels.conv_dx_smem(3, kernels.CONV_DX_MAX_ROWS + 1))):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.conv4x4s2_swish_input_grad_kernel(*args, plan=bad)
    assert kernels.LAUNCHES["conv_dx"] == before


def _op_calls(device):
    """Each ops entry with a kernel, as a function of whether its float
    inputs require grad: K1's mu, K2's logits, K3's logits, K4's bias
    alone, the fused PoE's expert means."""
    gen = torch.Generator().manual_seed(22)

    def rand(*shape, grad):
        return torch.randn(*shape, generator=gen).to(device).requires_grad_(grad)

    tok = torch.randint(1, 13, (8, 5), generator=gen, dtype=torch.int32).to(device)
    return {
        "kl_std_normal": lambda g: ops.kl_std_normal(rand(8, 16, grad=g), rand(8, 16, grad=False)),
        "bernoulli_nll": lambda g: ops.bernoulli_nll(
            rand(8, 16, grad=g), torch.rand(4, 16, generator=gen).to(device), fold="t"),
        "masked_seq_ce": lambda g: ops.masked_seq_ce(rand(8, 5, 13, grad=g), tok),
        "conv4x4s2_swish": lambda g: ops.conv4x4s2_swish(
            torch.rand(2, 8, 8, 3, generator=gen).to(device), rand(32, 3, 4, 4, grad=False),
            rand(32, grad=g)),
        "poe_kl": lambda g: ops.poe_kl(
            rand(8, 2, 16, grad=g), rand(8, 2, 16, grad=False),
            elbo_subset_masks(2, device=device), torch.ones(8, 2, device=device))[2],
    }


OPS = ["kl_std_normal", "bernoulli_nll", "masked_seq_ce", "conv4x4s2_swish", "poe_kl"]
OP_COUNTERS = dict(zip(OPS, ["kl", "bce", "seq_ce", "conv", "poe_kl"]))
# Each op's backward kernel's counter.
GRAD_COUNTERS = {"kl_std_normal": "kl_bwd", "bernoulli_nll": "bce_bwd",
                 "masked_seq_ce": "seq_ce_bwd", "poe_kl": "poe_kl_bwd",
                 "conv4x4s2_swish": "conv_bwd"}


@pytest.mark.gpu
@pytest.mark.parametrize("op", OPS)
def test_ops_kernel_path_refuses_grad(cuda, op):
    """With grad on and an input that requires grad (K4: its bias alone),
    each op records its kernel, and its backward launches the backward
    kernel once. Under ``torch.no_grad`` every op launches its kernel. The
    inputs that get no gradient on the kernel path (the BCE's targets,
    K4's image) are refused by the tests below."""
    call = _op_calls(cuda)[op]
    before = dict(kernels.LAUNCHES)
    out = call(True)
    assert out.requires_grad
    out.sum().backward()
    assert kernels.LAUNCHES[GRAD_COUNTERS[op]] == before[GRAD_COUNTERS[op]] + 1
    assert kernels.LAUNCHES[OP_COUNTERS[op]] == before[OP_COUNTERS[op]] + 1
    with torch.no_grad():
        call(True)
    call(False)
    assert kernels.LAUNCHES[OP_COUNTERS[op]] == before[OP_COUNTERS[op]] + 3


@pytest.mark.parametrize("op", OPS)
def test_ops_kernel_backend_refuses_grad_on_the_cpu(op):
    """Under the "kernel" backend a CPU input gets the CUDA error, whether
    it requires grad or not. The "auto" backend takes the plain path,
    whose gradient flows."""
    call = _op_calls("cpu")[op]
    ops.set_backend("kernel")
    try:
        with pytest.raises(ValueError, match="CUDA"):
            call(True)
        with pytest.raises(ValueError, match="CUDA"):
            call(False)
    finally:
        ops.set_backend("auto")
    assert call(True).requires_grad


def _bce_with_target_grad(device):
    gen = torch.Generator().manual_seed(23)
    logits = torch.randn(8, 16, generator=gen).to(device).requires_grad_(True)
    x = torch.rand(4, 16, generator=gen).to(device).requires_grad_(True)
    return ops.bernoulli_nll(logits, x, fold="t")


@pytest.mark.gpu
def test_ops_bce_kernel_path_refuses_target_grad(cuda):
    """The BCE's backward kernel computes d logits only: targets that
    require grad raise on the kernel path, before anything launches,
    rather than take a gradient of zero."""
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match=r"no gradient in the targets \(dx\)"):
        _bce_with_target_grad(cuda)
    assert kernels.LAUNCHES == before


def test_ops_bce_kernel_backend_refuses_target_grad_on_the_cpu():
    """Under the "kernel" backend the targets' grad is refused before the
    device is checked; the "auto" backend takes the plain path, whose dx
    flows."""
    ops.set_backend("kernel")
    try:
        with pytest.raises(RuntimeError, match=r"no gradient in the targets \(dx\)"):
            _bce_with_target_grad("cpu")
    finally:
        ops.set_backend("auto")
    assert _bce_with_target_grad("cpu").requires_grad


def _conv_with_input_grad(device):
    gen = torch.Generator().manual_seed(24)
    x, w, b = _conv_inputs(gen, (2, 8, 8, 3), torch.float32, device)
    x.requires_grad_(True)
    return ops.conv4x4s2_swish(x, w.requires_grad_(True), b), x


@pytest.mark.gpu
def test_ops_conv_kernel_path_refuses_input_grad(cuda):
    """An image that requires grad takes K4's input-gradient kernel on the
    kernel path: one forward launch, and a backward of one
    ``conv4x4s2_swish_bwd`` and one ``conv4x4s2_swish_dx`` launch, the
    image's gradient equal to the ``torch`` backend's within the dx
    tolerance."""
    before = dict(kernels.LAUNCHES)
    out, x = _conv_with_input_grad(cuda)
    assert kernels.LAUNCHES["conv"] == before["conv"] + 1
    (d_x,) = torch.autograd.grad(out.sum(), x)
    assert kernels.LAUNCHES["conv_dx"] == before["conv_dx"] + 1
    assert kernels.LAUNCHES["conv_bwd"] == before["conv_bwd"] + 1
    ops.set_backend("torch")
    try:
        out_t, x_t = _conv_with_input_grad(cuda)
        (want,) = torch.autograd.grad(out_t.sum(), x_t)
    finally:
        ops.set_backend("auto")
    assert kernels.LAUNCHES["conv_dx"] == before["conv_dx"] + 1
    _conv_dx_close(d_x, want)


def test_ops_conv_kernel_backend_refuses_input_grad_on_the_cpu():
    """Under the "kernel" backend an image on the CPU that requires grad
    gets the CUDA error the other ops give; the "auto" backend takes the
    plain path, whose dx flows into the image."""
    ops.set_backend("kernel")
    try:
        with pytest.raises(ValueError, match="CUDA"):
            _conv_with_input_grad("cpu")
    finally:
        ops.set_backend("auto")
    out, x = _conv_with_input_grad("cpu")
    (d_x,) = torch.autograd.grad(out.sum(), x)
    assert d_x.shape == x.shape and d_x.abs().sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("f", [16, 8])
@pytest.mark.parametrize("dtype", ["float32", "bf16_x", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [
        (64, 64, 64, 3),  # CelebA's batch on a rank of tp = 2 (16) or 4 (8)
        (37, 64, 64, 3),  # ragged batch
        (3, 33, 31, 3),  # odd H and W
        (5, 25, 25, 1),  # odd size: pads (1, 2)
        (6, 32, 40, 2), (6, 32, 40, 4),  # other C
    ],
)
def test_conv_kernels_at_tp_channels_match_plain(cuda, f, dtype, shape):
    """K4, its backward and its input gradient at F = 16 and 8 output
    channels (a rank's block of stage 0 under tensor parallelism), each a
    library of its own: all f32, a bf16 image into f32 weights (no input
    gradient: the image is data), and all bf16, against the plain versions
    under the F = 32 tolerances (the backward's atol a term, the input
    gradient's 4 taps x F channels); the upstream gradient strided; two
    launches of each give the same bits; each launch counted once."""
    gen = torch.Generator().manual_seed(f + shape[0])
    x, w, b = _conv_inputs(gen, shape, torch.float32, cuda)
    w, b = w[:f].contiguous(), b[:f].contiguous()
    out = (shape[0], f, -(-shape[1] // 2), -(-shape[2] // 2))
    padded = torch.randn((*out[:2], out[2] + 2, out[3] + 3), generator=gen).to(cuda)
    g = padded[:, :, 1:-1, 1:-2]
    if dtype == "bf16_x":
        x = x.bfloat16()
    elif dtype == "bfloat16":
        x, w, b, g = (t.bfloat16() for t in (x, w, b, g))
    before = dict(kernels.LAUNCHES)
    y = kernels.conv4x4s2_swish_kernel(x, w, b)
    assert y.shape == out and y.dtype == w.dtype
    want = kernels.conv4x4s2_swish_torch(x, w, b)
    if w.dtype == torch.float32:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5 * 16 * shape[-1])
    else:
        torch.testing.assert_close(y.float(), want.float(), rtol=2**-7, atol=0)
    n_terms = shape[0] * out[2] * out[3]
    got = kernels.conv4x4s2_swish_grad_kernel(x, w, b, g)
    assert got[0].shape == (f, shape[3], 4, 4) and got[1].shape == (f,)
    for a, c in zip(got, kernels.conv4x4s2_swish_grad_torch(x, w, b, g)):
        torch.testing.assert_close(a.float(), c.float(), atol=1e-6 * n_terms,
                                   rtol=1e-5 if w.dtype == torch.float32 else 2**-7)
    assert all(torch.equal(p, q) for p, q in zip(got, kernels.conv4x4s2_swish_grad_kernel(
        x, w, b, g)))
    dx_launches = 0
    if dtype != "bf16_x":
        dx = kernels.conv4x4s2_swish_input_grad_kernel(x, w, b, g)
        assert dx.shape == shape and dx.dtype == x.dtype
        torch.testing.assert_close(
            dx.float(), kernels.conv4x4s2_swish_input_grad_torch(x, w, b, g).float(),
            rtol=1e-5 if dtype == "float32" else 2**-7, atol=1e-6 * 4 * f)
        assert torch.equal(dx, kernels.conv4x4s2_swish_input_grad_kernel(x, w, b, g))
        dx_launches = 2
    assert kernels.LAUNCHES["conv"] == before["conv"] + 1
    assert kernels.LAUNCHES["conv_bwd"] == before["conv_bwd"] + 2
    assert kernels.LAUNCHES["conv_dx"] == before["conv_dx"] + dx_launches


@pytest.mark.gpu
@pytest.mark.parametrize("f", [24, 4, 64, 1])
def test_conv_kernels_refuse_other_channels(cuda, f):
    """An F outside 32, 16 and 8 raises before any launch: K4, its backward
    and its input gradient never route it elsewhere."""
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((2, 8, 8, 3), generator=gen).to(cuda)
    w = torch.randn((f, 3, 4, 4), generator=gen).to(cuda)
    b = torch.randn(f, generator=gen).to(cuda)
    g = torch.randn((2, f, 4, 4), generator=gen).to(cuda)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="F in"):
        kernels.conv4x4s2_swish_kernel(x, w, b)
    for fn in (kernels.conv4x4s2_swish_grad_kernel, kernels.conv4x4s2_swish_input_grad_kernel):
        with pytest.raises(ValueError, match="F in"):
            fn(x, w, b, g)
    assert kernels.LAUNCHES == before


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


# (examples, k, rows an example, D) of K2's b-major map over examples of
# several rows: CelebA's IWAE attributes (73,728 rows of D = 1 over 1,152
# targets), ragged, an example wider than a block, rows of D > 1, one
# example of two rows.
BCE_INNER_SHAPES = [(64, 64, 18, 1), (5, 7, 3, 1), (3, 2, 300, 1), (4, 3, 5, 7), (1, 1, 2, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BCE_INNER_SHAPES)
def test_bce_kernel_inner_map_matches_plain(cuda, shape):
    """``bce_rows_inner`` against the plain version of its map (the
    targets tiled example by example), in its plan and in a grid cut to a
    block an axis (the kernel strides past it); two calls give the same
    bits."""
    n_b, k, inner, d = shape
    gen = torch.Generator().manual_seed(30)
    logits = _rand(gen, n_b * k * inner, d, device=cuda, scale=3.0)
    x = torch.rand(n_b * inner, d, generator=gen).to(cuda)
    want = kernels.bernoulli_nll_torch(logits, x, kernels.FOLD_B, inner)
    got = kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B, inner=inner)
    _close(got, want, d)
    assert torch.equal(got, kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B, inner=inner))
    cut = kernels.bce_inner_plan(n_b, k, inner)._replace(grid_x=1, grid_y=1, grid_z=1)
    _close(kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B, cut, inner), want, d)


@pytest.mark.gpu
def test_bce_kernel_inner_map_refuses_bad_calls(cuda):
    logits = torch.zeros(12, 1, device=cuda)
    x = torch.zeros(6, 1, device=cuda)
    with pytest.raises(ValueError, match="inner"):
        kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_T, inner=3)
    with pytest.raises(TypeError, match="BceInnerPlan"):
        kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B, kernels.bce_plan(12, 1), 3)
    with pytest.raises(RuntimeError, match="bce_rows_inner launch failed"):
        kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B,
                                     kernels.BceInnerPlan(3, 400, 1, 1, 1), 3)


@pytest.mark.gpu
def test_ops_bce_attribute_rows_b_fold(cuda):
    """The CelebA attribute NLL of the IWAE through ops: (64 * 64, 18)
    logits at event_ndims=0 against (64, 18) targets, b-fold: one launch
    of ``bce_rows_inner``, equal to the ``torch`` backend; with the logits
    requiring grad the backward is one launch of ``bce_rows_grad_inner``,
    equal to the ``torch`` backend's gradient."""
    gen = torch.Generator().manual_seed(31)
    logits = _rand(gen, 64 * 64, 18, device=cuda, scale=3.0)
    x = torch.randint(0, 2, (64, 18), generator=gen).float().to(cuda)
    g = _rand(gen, 64 * 64, 18, device=cuda)
    before = dict(kernels.LAUNCHES)
    got = ops.bernoulli_nll(logits, x, 0, fold="b")
    assert kernels.LAUNCHES["bce"] == before["bce"] + 1
    ops.set_backend("torch")
    try:
        want = ops.bernoulli_nll(logits, x, 0, fold="b")
        lt = logits.clone().requires_grad_(True)
        (want_d,) = torch.autograd.grad(ops.bernoulli_nll(lt, x, 0, fold="b"), lt, g)
    finally:
        ops.set_backend("auto")
    assert got.shape == (64 * 64, 18)
    _close(got, want, 1)
    lk = logits.clone().requires_grad_(True)
    (got_d,) = torch.autograd.grad(ops.bernoulli_nll(lk, x, 0, fold="b"), lk, g)
    assert kernels.LAUNCHES["bce"] == before["bce"] + 2
    assert kernels.LAUNCHES["bce_bwd_inner"] == before["bce_bwd_inner"] + 1
    assert kernels.LAUNCHES["bce_bwd"] == before["bce_bwd"]
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-6)


def test_ops_bce_b_fold_inner_map_refuses_grad_on_the_cpu():
    """The gradient at the b-major map over examples of several rows:
    under the "kernel" backend a CPU tensor is refused for its device
    (the map itself is ported); the "auto" backend takes the plain path,
    whose gradient is ``bce_rows_grad_torch`` at the inner map and
    ``sigmoid(l) - x`` of the tiled targets."""
    gen = torch.Generator().manual_seed(32)
    logits = torch.randn(12, 3, generator=gen).requires_grad_(True)
    x = torch.rand(4, 3, generator=gen)
    g = torch.randn(12, 3, generator=gen)
    ops.set_backend("kernel")
    try:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.bernoulli_nll(logits, x, 0, fold="b")
    finally:
        ops.set_backend("auto")
    (d_l,) = torch.autograd.grad(ops.bernoulli_nll(logits, x, 0, fold="b"), logits, g)
    want = g * (torch.sigmoid(logits) - x.repeat_interleave(3, dim=0))
    torch.testing.assert_close(d_l, want.detach())
    plain = kernels.bce_rows_grad_torch(
        logits.detach().reshape(-1, 1), x.reshape(-1, 1), g.reshape(-1), kernels.FOLD_B, 3)
    torch.testing.assert_close(plain.reshape(12, 3), d_l, rtol=0, atol=0)


# (examples, k, rows an example, D) of K2's VJP at the b-major map over
# examples of several rows: CelebA's train step under the "b" fold (64
# examples, 23 attribute terms) and its mopoe step (20 terms), one rank's
# rows at world 2, a ragged example of 5 rows, D > 1 off the float4 width,
# an example wider than a block, one example of two rows.
BCE_GRAD_INNER_SHAPES = [(64, 23, 18, 1), (64, 20, 18, 1), (32, 23, 18, 1), (5, 7, 5, 1),
                         (4, 3, 5, 7), (3, 2, 300, 1), (1, 1, 2, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BCE_GRAD_INNER_SHAPES)
def test_bce_rows_grad_kernel_inner_map_matches_plain(cuda, shape, dtype):
    """``bce_rows_grad_inner`` against ``bce_rows_grad_torch`` at the same
    map, f32 and bf16 targets, in its plan and in a grid cut to a block an
    axis; two launches give the same bits, each counted as
    ``bce_bwd_inner``."""
    n_b, k, inner, d = shape
    gen = torch.Generator().manual_seed(33)
    logits = _rand(gen, n_b * k * inner, d, device=cuda, scale=3.0)
    x = torch.rand(n_b * inner, d, generator=gen).to(cuda, dtype)
    g = _rand(gen, n_b * k * inner, device=cuda)
    want = kernels.bce_rows_grad_torch(logits, x, g, kernels.FOLD_B, inner)
    before = kernels.LAUNCHES["bce_bwd_inner"]
    got = kernels.bce_rows_grad_kernel(logits, x, g, kernels.FOLD_B, inner=inner)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, kernels.bce_rows_grad_kernel(logits, x, g, kernels.FOLD_B,
                                                         inner=inner))
    assert kernels.LAUNCHES["bce_bwd_inner"] == before + 2
    cut = kernels.bce_grad_inner_plan(n_b, k, inner)._replace(grid_x=1, grid_y=1, grid_z=1)
    assert torch.equal(kernels.bce_rows_grad_kernel(logits, x, g, kernels.FOLD_B, cut, inner),
                       got)


@pytest.mark.gpu
def test_bce_rows_grad_kernel_inner_map_refuses_bad_calls(cuda):
    logits = torch.zeros(12, 1, device=cuda)
    x = torch.zeros(6, 1, device=cuda)
    g = torch.zeros(12, device=cuda)
    with pytest.raises(ValueError, match="inner"):
        kernels.bce_rows_grad_kernel(logits, x, g, kernels.FOLD_T, inner=3)
    with pytest.raises(TypeError, match="BceInnerPlan"):
        kernels.bce_rows_grad_kernel(logits, x, g, kernels.FOLD_B, kernels.bce_grad_plan(12, 1),
                                     3)
    with pytest.raises(RuntimeError, match="bce_rows_grad_inner launch failed"):
        kernels.bce_rows_grad_kernel(logits, x, g, kernels.FOLD_B,
                                     kernels.BceInnerPlan(3, 400, 1, 1, 1), 3)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6400, 784, 100), (6400, 2500, 100), (4096, 12288, 64)])
def test_bce_kernel_iwae_image_rows(cuda, shape):
    """The IWAE's image rows, k = 64 samples of each example b-major:
    MNIST's, MultiMNIST's and CelebA's and CUB's."""
    n, d, n_x = shape
    gen = torch.Generator().manual_seed(32)
    logits = _rand(gen, n, d, device=cuda, scale=3.0)
    x = torch.rand(n_x, d, generator=gen).to(cuda)
    got = kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B)
    _close(got, kernels.bernoulli_nll_torch(logits, x, kernels.FOLD_B), d)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6400, 5, 13, 100), (4096, 32, 23, 64)])
def test_ops_masked_seq_ce_b_fold(cuda, shape):
    """K3 on b-major tiled tokens, the IWAE's: MultiMNIST's digit strings
    and CUB's captions, k = 64, through ops against the ``torch``
    backend."""
    n, s, v, n_x = shape
    gen = torch.Generator().manual_seed(33)
    logits, tokens = _seq_inputs(gen, n_x, s, v, cuda)
    logits = _rand(gen, n, s, v, device=cuda, scale=3.0)
    before = kernels.LAUNCHES["seq_ce"]
    got = ops.masked_seq_ce(logits, tokens, fold="b")
    assert kernels.LAUNCHES["seq_ce"] == before + 1
    ops.set_backend("torch")
    try:
        want = ops.masked_seq_ce(logits, tokens, fold="b")
    finally:
        ops.set_backend("auto")
    _seq_close(got, want, s, v)
    tiled = tokens.repeat_interleave(n // n_x, dim=0)
    _seq_close(got, kernels.masked_seq_ce_torch(logits, tiled, 0), s, v)


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


def _poe_inputs(gen, shape, case, device):
    """Experts, subset masks and presence of the fused PoE + KL at (T, B,
    M, L). ``eval``: every modality present; ``ragged``: the rows past the
    first quarter all absent, as the eval's padded last batch; ``none``: no
    presence; ``wide``: log-variances past the +-11 clamp; ``unaligned``:
    expert views one element into their storage (scalar loads)."""
    t, b, m, l = shape
    n = b * m * l
    mu = torch.randn(n + 1, generator=gen)
    lv = torch.randn(n + 1, generator=gen) * (20.0 if case == "wide" else 1.0)
    lo = 1 if case == "unaligned" else 0
    mu, lv = (a.to(device)[lo:lo + n].view(b, m, l) for a in (mu, lv))
    masks = elbo_subset_masks(m, device=device)
    assert masks.shape == (t, m)
    presence = (torch.rand(b, m, generator=gen) < 0.7).float().to(device)
    if case == "eval":
        presence = torch.ones(b, m, device=device)
    elif case == "ragged":
        presence[b // 4:] = 0.0
    return mu, lv, masks, None if case == "none" else presence


def _poe_close(got, want, l: int) -> None:
    for g, w, atol in zip(got, want, (1e-6, 1e-6, 1e-5 * l)):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=atol)


# (T, B, M, L) of the CelebA, MultiMNIST and MNIST eval batches, and an odd
# L with CelebA's experts.
POE_EVAL_SHAPES = [(20, 64, 19, 100), (3, 100, 2, 256), (3, 100, 2, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["eval", "ragged", "none", "wide", "unaligned"])
@pytest.mark.parametrize("shape", POE_EVAL_SHAPES + [(20, 10, 19, 37)])
def test_poe_kl_kernel_matches_plain(cuda, shape, case):
    """Each eval shape and an odd L, in every case; the absent rows of a
    ragged batch give the prior and exactly 0 KL; two calls give the same
    bits."""
    gen = torch.Generator().manual_seed(23)
    args = _poe_inputs(gen, shape, case, cuda)
    got = kernels.poe_kl_kernel(*args)
    _poe_close(got, kernels.poe_kl_torch(*args), shape[3])
    if case == "ragged":
        b = shape[1]
        assert torch.all(got[2][:, b // 4:] == 0)
        assert torch.all(got[0][:, b // 4:] == 0) and torch.all(got[1][:, b // 4:] == 0)
    again = kernels.poe_kl_kernel(*args)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 2, 3, 7, 20])
def test_poe_kl_kernel_every_term_grouping(cuda, groups):
    """CelebA's shape with the terms of a row split over 1 to 20 blocks,
    forced through ``plan``: the same numbers as the plain version."""
    gen = torch.Generator().manual_seed(24)
    shape = (20, 64, 19, 100)
    args = _poe_inputs(gen, shape, "ragged", cuda)
    plan = kernels.poe_kl_plan(*shape, groups=groups)
    _poe_close(kernels.poe_kl_kernel(*args, plan=plan), kernels.poe_kl_torch(*args), 100)


@pytest.mark.gpu
def test_poe_kl_kernel_refuses_a_plan_it_cannot_run(cuda):
    """Too little shared memory, too many warps or a grid that does not
    match the terms is refused at launch and counts no launch."""
    args = _poe_inputs(torch.Generator().manual_seed(25), (3, 8, 2, 64), "eval", cuda)
    good = kernels.poe_kl_plan(3, 8, 2, 64)
    before = kernels.LAUNCHES["poe_kl"]
    for bad in (good._replace(smem=good.smem - 4), good._replace(warps=33),
                good._replace(blocks=good.blocks + 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.poe_kl_kernel(*args, plan=bad)
    assert kernels.LAUNCHES["poe_kl"] == before


@pytest.mark.gpu
def test_ops_poe_kl_runs_the_kernel_on_the_card(cuda):
    gen = torch.Generator().manual_seed(26)
    mu, lv, masks, presence = _poe_inputs(gen, (20, 64, 19, 100), "ragged", cuda)
    before = kernels.LAUNCHES["poe_kl"]
    got = ops.poe_kl(mu, lv, masks, presence)
    assert kernels.LAUNCHES["poe_kl"] == before + 1
    ops.set_backend("torch")
    try:
        want = ops.poe_kl(mu, lv, masks, presence)
    finally:
        ops.set_backend("auto")
    assert kernels.LAUNCHES["poe_kl"] == before + 1
    _poe_close(got, want, 100)


def _grad_close(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 64), (1280, 100), (37, 100), (5, 3), (3, 1)])
def test_kl_rows_grad_kernel_matches_plain(cuda, shape):
    """K1's VJP at the MNIST and CelebA posterior rows, ragged and odd D."""
    gen = torch.Generator().manual_seed(30)
    mu, lv = _rand(gen, *shape, device=cuda), _rand(gen, *shape, device=cuda)
    g = _rand(gen, shape[0], device=cuda)
    got = kernels.kl_rows_grad_kernel(mu, lv, g)
    for a, b in zip(got, kernels.kl_rows_grad_torch(mu, lv, g)):
        _grad_close(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got, kernels.kl_rows_grad_kernel(mu, lv, g)))


@pytest.mark.gpu
def test_kl_rows_grad_kernel_unaligned_rows(cuda):
    gen = torch.Generator().manual_seed(31)
    n, d = 50, 64
    mu = _rand(gen, n * d + 1, device=cuda)[1:].view(n, d)
    lv = _rand(gen, n * d + 1, device=cuda)[1:].view(n, d)
    g = _rand(gen, n, device=cuda)
    for a, b in zip(kernels.kl_rows_grad_kernel(mu, lv, g), kernels.kl_rows_grad_torch(mu, lv, g)):
        _grad_close(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize(
    "shape", [(200, 784), (128, 12288), (36, 1002), (21888, 1), (8192, 784), (6, 3)]
)
def test_bce_rows_grad_kernel_matches_plain(cuda, fold, shape):
    """K2's VJP in the logits in every fold: MNIST's train rows (200, 784)
    against 100 targets, CelebA's image and attribute rows, D not a
    multiple of 4; two calls give the same bits."""
    gen = torch.Generator().manual_seed(32)
    n, d = shape
    n_x = n if fold == kernels.FOLD_NONE else n // 2
    logits = _rand(gen, n, d, device=cuda, scale=3.0)
    x = torch.rand(n_x, d, generator=gen).to(cuda)
    g = _rand(gen, n, device=cuda)
    got = kernels.bce_rows_grad_kernel(logits, x, g, fold)
    _grad_close(got, kernels.bce_rows_grad_torch(logits, x, g, fold))
    assert torch.equal(got, kernels.bce_rows_grad_kernel(logits, x, g, fold))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 12288), (200, 784), (21888, 1)])
def test_bce_rows_grad_kernel_offset_view(cuda, shape):
    """Logits and targets one element into their storage: scalar loads."""
    gen = torch.Generator().manual_seed(33)
    n, d = shape
    logits = _rand(gen, n * d + 1, device=cuda, scale=3.0)[1:].view(n, d)
    x = torch.rand(n * d // 2 + 1, generator=gen).to(cuda)[1:].view(n // 2, d)
    g = _rand(gen, n, device=cuda)
    _grad_close(
        kernels.bce_rows_grad_kernel(logits, x, g, kernels.FOLD_T),
        kernels.bce_rows_grad_torch(logits, x, g, kernels.FOLD_T),
    )


def _bce_grad_family(n: int, d: int, n_x: int) -> list:
    """Every plan of ``bce_rows_grad``'s family at (n, d) against n_x
    targets: the picked one; at 32 threads and at 1,024 the rule's lanes, a
    block a chunk of the row and a power of two of lanes; and each with its
    grid cut to a block along x and z and to 3 along y, which the kernel
    strides past."""
    pow2 = 1 << max(0, kernels.bce_grad_units(d) - 1).bit_length()
    plans = [kernels.bce_grad_plan(n, d, n_x)]
    plans += [kernels.bce_grad_plan(n, d, n_x, threads, lanes)
              for threads in (32, 1024) for lanes in (None, threads, min(pow2, threads))]
    plans += [p._replace(grid_x=1, grid_y=min(p.grid_y, 3), grid_z=1) for p in plans]
    return list(dict.fromkeys(plans))


# (N, D, terms) of K2's VJP: MNIST's and MultiMNIST's train rows, CelebA's
# image and attribute rows, (36, 1002) as chip_smoke.py checks it, D off a
# multiple of 4 and more rows than a grid axis holds (65,535).
BCE_GRAD_CASES = [(200, 784, 2), (300, 2500, 3), (128, 12288, 2), (36, 1002, 2),
                  (21888, 1, 19), (38, 1001, 2), (70000, 3, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("case", BCE_GRAD_CASES)
def test_bce_rows_grad_kernel_every_plan(cuda, case, fold, offset):
    """Every plan of the family against the plain version in every fold,
    aligned and as views one element into their storage (scalar units at a
    plan sized for float4s); two calls give the same bits, and so does
    every plan: each element is computed alone, in one expression."""
    gen = torch.Generator().manual_seed(34)
    n, d, terms = case
    n_x = n if fold == kernels.FOLD_NONE else n // terms
    logits = _rand(gen, n * d + offset, device=cuda, scale=3.0)[offset:].view(n, d)
    x = torch.rand(n_x * d + offset, generator=gen).to(cuda)[offset:].view(n_x, d)
    g = _rand(gen, n, device=cuda)
    want = kernels.bce_rows_grad_torch(logits, x, g, fold)
    first = None
    for plan in _bce_grad_family(n, d, n_x):
        got = kernels.bce_rows_grad_kernel(logits, x, g, fold, plan=plan)
        _grad_close(got, want)
        assert torch.equal(got, kernels.bce_rows_grad_kernel(logits, x, g, fold, plan=plan))
        first = got if first is None else first
        assert torch.equal(got, first), plan


@pytest.mark.gpu
def test_bce_rows_grad_kernel_refuses_a_plan_it_cannot_run(cuda):
    """Threads off a warp or above 1,024, lanes that do not divide the
    block, and a grid axis empty or past 65,535 are refused at launch and
    count no launch."""
    gen = torch.Generator().manual_seed(35)
    logits, x = _bce_inputs(gen, 64, 784, kernels.FOLD_T, cuda)
    g = _rand(gen, 64, device=cuda)
    good = kernels.bce_grad_plan(64, 784, 32)
    before = kernels.LAUNCHES["bce_bwd"]
    for bad in (good._replace(threads=48, lanes=48), good._replace(threads=2048, lanes=2048),
                good._replace(threads=256, lanes=96), good._replace(lanes=0),
                good._replace(grid_x=0), good._replace(grid_y=65536), good._replace(grid_z=0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.bce_rows_grad_kernel(logits, x, g, kernels.FOLD_T, plan=bad)
    assert kernels.LAUNCHES["bce_bwd"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 5, 13), (100, 5, 13), (4096, 32, 23), (2048, 8, 5003),
                                   (3, 40, 1001), (5, 3, 31), (3, 1, 2), (1000, 7, 13),
                                   (512, 9, 128), (512, 9, 129)])
def test_seq_ce_grad_kernel_matches_plain(cuda, shape):
    """K3's VJP at MultiMNIST's train shapes (the decode-all pass and a
    cycle re-read), the synthetic CUB shape, a large odd vocabulary, S above
    the tokens a block runs at once, V just below a warp, V = 2, a last
    chunk of fewer examples (7 a chunk), V at the staged path's limit and
    just past it, each in the plan ``seq_ce_grad_plan`` picks; pad
    rows (rows 0 and 1 all pad) give exactly 0; a token row with a NaN
    logit in the middle, and where the batch has the rows, one with a +inf
    and one with a NaN at the end (a scalar tail of the warp-a-row layout),
    give NaN on the whole row, as softmax does, and NaN from the forward
    too; two calls give the same bits."""
    gen = torch.Generator().manual_seed(39)
    n, _, v = shape
    logits, tokens = _seq_inputs(gen, *shape, device=cuda)
    for row, col, value in ((2, v // 2, "nan"), (3, v - 1, "inf"), (4, v - 1, "nan")):
        if row < n:
            tokens[row, 0] = 1
            logits[row, 0, col] = float(value)
    g = _rand(gen, n, device=cuda)
    got = kernels.masked_seq_ce_grad_kernel(logits, tokens, 0, g)
    torch.testing.assert_close(got, kernels.masked_seq_ce_grad_torch(logits, tokens, 0, g),
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    bad = slice(2, min(n, 5))
    assert torch.isnan(got[bad, 0]).all()
    assert torch.isnan(kernels.masked_seq_ce_kernel(logits, tokens, 0)[bad]).all()
    assert torch.all(got[tokens == 0] == 0)
    torch.testing.assert_close(got, kernels.masked_seq_ce_grad_kernel(logits, tokens, 0, g),
                               rtol=0, atol=0, equal_nan=True)


def _seq_grad_plans(n: int, s: int, v: int) -> list:
    """Every path of ``seq_ce_rows_grad`` the shape takes: the staged path
    at 1 and 3 examples a chunk with each group of lanes from 1 to 32 (when
    an example's slab fits), fewer blocks than chunks; a warp a token row at
    1 and 3 examples a block, fewer blocks than chunks; the lane-group
    layout at every group of lanes from 1 to 32."""
    plans = []
    if kernels.seq_ce_grad_smem(3, s, v) <= kernels.SEQ_GRAD_MAX_SMEM:
        for examples in (1, 3):
            for lanes in (1, 2, 4, 8, 16, 32):
                warps = max(1, min(16, -(-examples * s * lanes // 32)))
                plans.append(kernels.SeqCeGradPlan(kernels.SEQ_GRAD_STAGED, lanes, examples,
                                                   warps, -(-n // examples)))
        plans.append(plans[-1]._replace(blocks=2))
    for examples, warps in ((1, 4), (3, 8)):
        plans.append(kernels.SeqCeGradPlan(kernels.SEQ_GRAD_WARP, 32, examples, warps,
                                           -(-n // examples)))
    plans.append(plans[-1]._replace(blocks=2))
    for lanes in (1, 2, 4, 8, 16, 32):
        plans.append(kernels.SeqCeGradPlan(kernels.SEQ_GRAD_GROUPS, lanes, 1, 2, n))
    return plans


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(40, 6, 23), (37, 5, 64), (9, 3, 385)])
@pytest.mark.parametrize("offset", [0, 1])
def test_seq_ce_grad_kernel_int64_other_pad_offset_view_and_every_layout(cuda, shape, offset):
    """int64 tokens with pad 2, logits and tokens one element into their
    storage or not (a slab or row at another 16-byte phase than its
    gradient: scalar head and tail, scalar shared-memory reads), at an odd
    V, a V that is a multiple of 4 and one past the staged limit, in every
    plan of every path; two calls give the same bits."""
    gen = torch.Generator().manual_seed(40)
    n, s, v = shape
    lo = offset
    logits = (torch.randn(n * s * v + lo, generator=gen) * 3).to(cuda)[lo:].view(n, s, v)
    tokens = torch.randint(0, v, (n * s + lo,), generator=gen, dtype=torch.int64)
    tokens = tokens.to(cuda)[lo:].view(n, s)
    tokens[0] = 2
    g = _rand(gen, n, device=cuda)
    want = kernels.masked_seq_ce_grad_torch(logits, tokens, 2, g)
    for plan in _seq_grad_plans(n, s, v):
        got = kernels.masked_seq_ce_grad_kernel(logits, tokens, 2, g, plan=plan)
        _grad_close(got, want)
        assert torch.all(got[tokens == 2] == 0)
        assert torch.equal(got, kernels.masked_seq_ce_grad_kernel(logits, tokens, 2, g, plan=plan))


@pytest.mark.gpu
def test_seq_ce_grad_kernel_refuses_a_plan_it_cannot_run(cuda):
    """More blocks than chunks, a staged chunk above 48 KB, lanes that are
    not a power of two, an unknown path, or the lane-group layout at other
    than a block an example is refused at launch and counts no launch."""
    gen = torch.Generator().manual_seed(41)
    logits, tokens = _seq_inputs(gen, 8, 600, 23, device=cuda)
    g = _rand(gen, 8, device=cuda)
    good = kernels.seq_ce_grad_plan(8, 600, 23)
    before = kernels.LAUNCHES["seq_ce_bwd"]
    groups = kernels.SeqCeGradPlan(kernels.SEQ_GRAD_GROUPS, 16, 1, 2, 8)
    for bad in (good._replace(blocks=9), good._replace(path=kernels.SEQ_GRAD_STAGED),
                good._replace(lanes=3), good._replace(path=3), groups._replace(blocks=4),
                groups._replace(examples=2, blocks=4)):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.masked_seq_ce_grad_kernel(logits, tokens, 0, g, plan=bad)
    assert kernels.LAUNCHES["seq_ce_bwd"] == before


def _poe_grads(gen, shape, device):
    """The forward's outputs and output gradients of the fused PoE + KL."""
    t, b, _, l = shape
    return (_rand(gen, t, b, l, device=device), _rand(gen, t, b, l, device=device),
            _rand(gen, t, b, device=device))


def _poe_grad_close(got, want, n_terms: int) -> None:
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(
            g, w, rtol=1e-5, atol=1e-5 * n_terms * w.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [None, 4, 32])
@pytest.mark.parametrize("case", ["eval", "ragged", "none", "wide", "unaligned", "ties",
                                  "cycle"])
@pytest.mark.parametrize("shape", POE_EVAL_SHAPES + [(20, 10, 19, 37), (3, 100, 2, 100)])
def test_poe_kl_grad_kernel_matches_plain(cuda, shape, case, tile):
    """The backward at the three eval shapes (MNIST's is also its train
    step's, (3, 100, 2, 64)), an odd L and L = 100 at 100 rows, in every
    case, with log-variances at exactly +-11 (``ties``: half the gradient)
    and past them, and as a cycle re-read (``cycle``: the first term alone,
    zero log-variance and KL gradients), in the tile ``poe_kl_bwd_plan``
    picks and in tiles of 4 and 32 latents (ragged at L = 37 and 100; with
    the block's threads fewer than its items in the unaligned case); rows
    with no expert present get 0; two calls give the same bits."""
    gen = torch.Generator().manual_seed(34)
    args = _poe_inputs(gen, shape, {"ties": "wide", "cycle": "none"}.get(case, case), cuda)
    if case == "ties":
        lv = args[1]
        lv[:, :, ::3] = 11.0
        lv[:, :, 1::3] = -11.0
    if case == "cycle":
        args = (*args[:2], args[2][:1], None)
    mu_f, lv_f, _ = kernels.poe_kl_kernel(*args)
    g = _poe_grads(gen, (len(args[2]), *shape[1:]), cuda)
    if case == "cycle":
        g = (g[0], torch.zeros_like(g[1]), torch.zeros_like(g[2]))
    t, b, m, l = len(args[2]), *shape[1:]
    plan = None if tile is None else kernels.poe_kl_bwd_plan(t, b, m, l, tile=tile)
    got = kernels.poe_kl_grad_kernel(*args, mu_f, lv_f, *g, plan=plan)
    _poe_grad_close(got, kernels.poe_kl_grad_torch(*args, mu_f, lv_f, *g), t)
    if case == "ragged":
        assert all(torch.all(d[shape[1] // 4:] == 0) for d in got)
    again = kernels.poe_kl_grad_kernel(*args, mu_f, lv_f, *g, plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_poe_kl_grad_kernel_keeps_nan(cuda):
    """A NaN log-variance gives NaN gradients, as the forward keeps it."""
    gen = torch.Generator().manual_seed(35)
    args = _poe_inputs(gen, (3, 8, 2, 64), "eval", cuda)
    args[1][2, 0, 5] = float("nan")
    mu_f, lv_f, _ = kernels.poe_kl_kernel(*args)
    d_mu, d_lv = kernels.poe_kl_grad_kernel(*args, mu_f, lv_f, *_poe_grads(gen, (3, 8, 2, 64), cuda))
    assert torch.isnan(d_lv[2, 0, 5]) and torch.isnan(d_mu[2, :, 5]).all()
    assert torch.isfinite(d_lv[:2]).all()


@pytest.mark.gpu
def test_poe_kl_grad_kernel_refuses_a_plan_it_cannot_run(cuda):
    """Too little shared memory, a block of other than whole warps or a
    grid that is not a block per batch row is refused at launch and
    counts no launch."""
    gen = torch.Generator().manual_seed(36)
    args = _poe_inputs(gen, (3, 8, 2, 64), "eval", cuda)
    mu_f, lv_f, _ = kernels.poe_kl_kernel(*args)
    g = _poe_grads(gen, (3, 8, 2, 64), cuda)
    good = kernels.poe_kl_bwd_plan(3, 8, 2, 64)
    before = kernels.LAUNCHES["poe_kl_bwd"]
    for bad in (good._replace(smem=good.smem - 4), good._replace(threads=48),
                good._replace(blocks=good.blocks + 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels.poe_kl_grad_kernel(*args, mu_f, lv_f, *g, plan=bad)
    assert kernels.LAUNCHES["poe_kl_bwd"] == before


def _grads_both_backends(fn, inputs):
    """The gradients of ``fn(*inputs)`` weighted by a seeded upstream
    gradient, on the "auto" backend (the kernels) and on "torch"."""
    grads = []
    for backend in ("auto", "torch"):
        ops.set_backend(backend)
        try:
            leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
            outs = fn(*leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            gen = torch.Generator().manual_seed(37)
            loss = sum((o * _rand(gen, *o.shape, device=o.device)).sum() for o in outs)
            grads.append(torch.autograd.grad(loss, leaves))
        finally:
            ops.set_backend("auto")
    return grads


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["kl_std_normal", "bernoulli_nll_t", "bernoulli_nll_b",
                                "bernoulli_nll_none", "masked_seq_ce_t", "masked_seq_ce_b",
                                "poe_kl", "poe_kl_presence", "conv4x4s2_swish"])
def test_ops_gradients_on_the_card_match_the_torch_backend(cuda, op):
    """Each ``autograd.Function`` on the card (forward and backward
    kernels) against the same op under ``set_backend("torch")``: MNIST's
    train shapes, the image at event_ndims=2, MultiMNIST's text rows of the
    decode-all pass in both folds, K4's weight and bias at a CelebA train
    batch of 16; one backward launch each."""
    gen = torch.Generator().manual_seed(38)
    if op == "kl_std_normal":
        fn, counter = ops.kl_std_normal, "kl_bwd"
        inputs = [_rand(gen, 3, 100, 64, device=cuda) for _ in range(2)]
    elif op.startswith("bernoulli_nll"):
        fold = op.rsplit("_", 1)[1]
        n_x = 200 if fold == "none" else 100
        x = torch.rand(n_x, 28, 28, generator=gen).to(cuda)

        def fn(logits):
            return ops.bernoulli_nll(logits, x, 2, fold="t" if fold == "none" else fold)

        inputs, counter = [_rand(gen, 200, 28, 28, device=cuda, scale=3.0)], "bce_bwd"
    elif op.startswith("masked_seq_ce"):
        logits, tokens = _seq_inputs(gen, 300, 5, 13, device=cuda)

        def fn(lg):
            return ops.masked_seq_ce(lg, tokens[:100], fold=op.rsplit("_", 1)[1])

        inputs, counter = [logits], "seq_ce_bwd"
    elif op == "conv4x4s2_swish":
        image, w, b = _conv_inputs(gen, (16, 64, 64, 3), torch.float32, cuda)

        def fn(weight, bias):
            return ops.conv4x4s2_swish(image, weight, bias)

        inputs, counter = [w, b], "conv_bwd"
    else:
        mu, lv, masks, presence = _poe_inputs(
            gen, (3, 100, 2, 64), "ragged" if op == "poe_kl_presence" else "none", cuda)

        def fn(m, v):
            return ops.poe_kl(m, v, masks, presence)

        inputs, counter = [mu, lv], "poe_kl_bwd"
    before = kernels.LAUNCHES[counter]
    on_card, plain = _grads_both_backends(fn, inputs)
    assert kernels.LAUNCHES[counter] == before + 1
    for a, b in zip(on_card, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())


# ------------------------------------------------ bf16 data, V = 2,004 ----
# A data_dtype="bfloat16" train split reaches K2 and its VJP as bf16
# targets and K4 (forward, and the backward in its weight and bias) as a
# bf16 image; the kernels upcast on load, the plain versions upcast, so the
# tolerances are the f32 ones. MNIST's train rows (200 onto 100, D = 784),
# CelebA's image and attribute rows, CUB's decode-all pass, and odd and
# unaligned cases.


def _bf16_targets(gen, n, d, fold, device, offset: int = 0):
    """Logits and bf16 targets (``offset`` elements into their storage, so
    that 4 of them do not start on 8 bytes)."""
    n_x = n if fold == kernels.FOLD_NONE else n // 2
    logits = _rand(gen, n, d, device=device, scale=3.0)
    x = torch.rand(n_x * d + offset, generator=gen).to(device, torch.bfloat16)
    return logits, x[offset:].view(n_x, d)


@pytest.mark.gpu
@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("shape", [(200, 784), (384, 12288), (192, 12288), (36, 1002),
                                   (8192, 784), (6, 3), (26496, 1)])
def test_bce_kernel_bf16_targets_match_plain(cuda, fold, shape):
    """K2 and its VJP on bf16 targets, in the layout ``bce_plan`` picks
    (a warp a row, clusters, a thread a row) and in every fold; D = 1002 and
    3 are not whole float4s."""
    gen = torch.Generator().manual_seed(60)
    n, d = shape
    logits, x = _bf16_targets(gen, n, d, fold, cuda)
    _close(kernels.bernoulli_nll_kernel(logits, x, fold),
           kernels.bernoulli_nll_torch(logits, x, fold), d)
    g = _rand(gen, n, device=cuda)
    torch.testing.assert_close(kernels.bce_rows_grad_kernel(logits, x, g, fold),
                               kernels.bce_rows_grad_torch(logits, x, g, fold),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "plan",
    [
        kernels.BcePlan(kernels.BCE_WARP, 256, 1, 5),
        kernels.BcePlan(kernels.BCE_SPLIT, 256, 2, 76),
        kernels.BcePlan(kernels.BCE_SPLIT, 1024, 8, 304),
        kernels.BcePlan(kernels.BCE_THREAD, 64, 1, 1),
    ],
)
@pytest.mark.parametrize("d, offset", [(4100, 0), (4099, 0), (4100, 2)])
def test_bce_kernel_bf16_every_layout(cuda, plan, d, offset):
    """Each layout of ``bce_rows`` on bf16 targets: aligned, odd D, and
    targets 2 elements into their storage (scalar loads); the VJP at the
    same targets; the same bits from call to call."""
    gen = torch.Generator().manual_seed(61)
    logits, x = _bf16_targets(gen, 38, d, kernels.FOLD_B, cuda, offset)
    got = kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B, plan=plan)
    _close(got, kernels.bernoulli_nll_torch(logits, x, kernels.FOLD_B), d)
    assert torch.equal(got, kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B, plan=plan))
    g = _rand(gen, 38, device=cuda)
    torch.testing.assert_close(kernels.bce_rows_grad_kernel(logits, x, g, kernels.FOLD_B),
                               kernels.bce_rows_grad_torch(logits, x, g, kernels.FOLD_B),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BCE_INNER_SHAPES)
def test_bce_kernel_inner_map_bf16_targets(cuda, shape):
    """``bce_rows_inner`` on bf16 targets against its plain version."""
    n_b, k, inner, d = shape
    gen = torch.Generator().manual_seed(62)
    logits = _rand(gen, n_b * k * inner, d, device=cuda, scale=3.0)
    x = torch.rand(n_b * inner, d, generator=gen).to(cuda, torch.bfloat16)
    _close(kernels.bernoulli_nll_kernel(logits, x, kernels.FOLD_B, inner=inner),
           kernels.bernoulli_nll_torch(logits, x, kernels.FOLD_B, inner), d)


@pytest.mark.gpu
def test_bce_kernels_refuse_bf16_logits_and_other_targets(cuda):
    """bf16 logits, and targets of another type, raise ``TypeError`` and
    launch nothing."""
    logits = torch.zeros(8, 16, device=cuda)
    x = torch.zeros(4, 16, device=cuda)
    g = torch.ones(8, device=cuda)
    before = dict(kernels.LAUNCHES)
    for bad_logits, bad_x in ((logits.bfloat16(), x), (logits.bfloat16(), x.bfloat16()),
                              (logits, x.half()), (logits, x.to(torch.uint8))):
        with pytest.raises(TypeError):
            kernels.bernoulli_nll_kernel(bad_logits, bad_x, kernels.FOLD_T)
        with pytest.raises(TypeError):
            kernels.bce_rows_grad_kernel(bad_logits, bad_x, g, kernels.FOLD_T)
    assert kernels.LAUNCHES == before


@pytest.mark.gpu
def test_ops_bernoulli_nll_bf16_targets_on_the_card(cuda):
    """``ops.bernoulli_nll`` hands bf16 targets to the kernels as they are
    (MNIST's image at event_ndims=2, CelebA's attributes at 0), forward and
    backward, against the ``torch`` backend."""
    gen = torch.Generator().manual_seed(63)
    for shape, n_x, event in (((200, 28, 28), 100, 2), ((23 * 64, 18), 64, 0)):
        x = torch.rand(n_x, *shape[1:], generator=gen).to(cuda, torch.bfloat16)

        def fn(logits, x=x, event=event):
            return ops.bernoulli_nll(logits, x, event, fold="t")

        before = dict(kernels.LAUNCHES)
        on_card, plain = _grads_both_backends(fn, [_rand(gen, *shape, device=cuda, scale=3.0)])
        assert kernels.LAUNCHES["bce"] == before["bce"] + 1
        assert kernels.LAUNCHES["bce_bwd"] == before["bce_bwd"] + 1
        torch.testing.assert_close(on_card[0], plain[0], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(64, 64, 64, 3), (37, 64, 64, 3), (5, 25, 25, 1), (4, 30, 70, 3), (6, 32, 40, 2),
              (6, 32, 40, 4), (2, 7, 1100, 4), (3, 33, 31, 3)])
def test_conv_kernels_bf16_image_match_plain(cuda, shape):
    """K4 from a bf16 image into f32 weights (f32 outputs) and its backward
    in the weight and bias from the same image, against the plain versions
    (f32 tolerances: a bf16 value is exact in f32 and in TF32); odd sizes
    and widths off the tile take scalar staging. Two backward launches
    give the same bits."""
    gen = torch.Generator().manual_seed(64)
    x, w, b, g = _conv_grad_inputs(gen, shape, cuda)
    x = x.bfloat16()
    y = kernels.conv4x4s2_swish_kernel(x, w, b)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, kernels.conv4x4s2_swish_torch(x, w, b), rtol=1e-5,
                               atol=1e-5 * 16 * shape[3])
    got = kernels.conv4x4s2_swish_grad_kernel(x, w, b, g)
    _conv_grad_close(got, kernels.conv4x4s2_swish_grad_torch(x, w, b, g), shape)
    _conv_grad_close(got, kernels.conv4x4s2_swish_grad_kernel(x.float(), w, b, g), shape)
    assert all(torch.equal(p, q) for p, q in zip(got, kernels.conv4x4s2_swish_grad_kernel(
        x, w, b, g)))


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [dict(warps=4), dict(rows=2), dict(rows=2, warps=4)])
def test_conv_grad_kernel_bf16_other_plans(cuda, plan):
    """K4's backward from a bf16 image in the other tile and block shapes,
    with a strided upstream gradient."""
    shape = (37, 64, 64, 3)
    x, w, b, g = _conv_grad_inputs(torch.Generator().manual_seed(65), shape, cuda, strided=True)
    x = x.bfloat16()
    got = kernels.conv4x4s2_swish_grad_kernel(x, w, b, g,
                                              plan=kernels.conv_bwd_plan(*shape, **plan))
    _conv_grad_close(got, kernels.conv4x4s2_swish_grad_torch(x, w, b, g), shape)


@pytest.mark.gpu
def test_conv_kernels_refuse_other_bf16_mixes(cuda):
    """K4's input gradient takes no bf16 image with f32 weights; K4 takes no
    f32 image with bf16 weights; K4's backward takes no upstream gradient or
    bias in another type than the weight's."""
    x, w, b, g = _conv_grad_inputs(torch.Generator().manual_seed(66), (2, 8, 8, 3), cuda)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(TypeError):
        kernels.conv4x4s2_swish_input_grad_kernel(x.bfloat16(), w, b, g)
    with pytest.raises(TypeError):
        kernels.conv4x4s2_swish_kernel(x, w.bfloat16(), b.bfloat16())
    with pytest.raises(TypeError):
        kernels.conv4x4s2_swish_kernel(x.bfloat16(), w, b.bfloat16())
    with pytest.raises(TypeError):
        kernels.conv4x4s2_swish_grad_kernel(x.bfloat16(), w, b, g.bfloat16())
    with pytest.raises(TypeError):
        kernels.conv4x4s2_swish_grad_kernel(x.bfloat16(), w.bfloat16(), b, g)
    assert kernels.LAUNCHES == before


@pytest.mark.gpu
def test_ops_conv_bf16_image_on_the_card(cuda):
    """``ops.conv4x4s2_swish`` on a bf16 batch with f32 weights: K4 and its
    backward in the weight and bias, one launch each, against the ``torch``
    backend."""
    image, w, b = _conv_inputs(torch.Generator().manual_seed(67), (16, 64, 64, 3),
                               torch.float32, cuda)
    image = image.bfloat16()

    def fn(weight, bias):
        return ops.conv4x4s2_swish(image, weight, bias)

    before = dict(kernels.LAUNCHES)
    on_card, plain = _grads_both_backends(fn, [w, b])
    assert kernels.LAUNCHES["conv"] == before["conv"] + 1
    assert kernels.LAUNCHES["conv_bwd"] == before["conv_bwd"] + 1
    for a, c in zip(on_card, plain):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5 * c.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(192, 32, 2004), (64, 32, 2004), (128, 32, 2004)])
def test_seq_ce_kernels_at_a_corpus_vocabulary(cuda, shape):
    """K3 and its VJP at a mounted CUB corpus's V = 2,004 (3 reserved, the
    2,000 words, ``<unk>``): a train step's decode-all pass (192 rows), the
    cycle's re-read (64) and an eval batch's member terms (128); the VJP
    takes its warp-a-row path above V = 128."""
    gen = torch.Generator().manual_seed(68)
    logits, tokens = _seq_inputs(gen, *shape, device=cuda)
    got = kernels.masked_seq_ce_kernel(logits, tokens, 0)
    _seq_close(got, kernels.masked_seq_ce_torch(logits, tokens, 0), *shape[1:])
    assert torch.all(got[:2] == 0)
    g = _rand(gen, shape[0], device=cuda)
    assert kernels.seq_ce_grad_plan(*shape).path == kernels.SEQ_GRAD_WARP
    grad = kernels.masked_seq_ce_grad_kernel(logits, tokens, 0, g)
    torch.testing.assert_close(grad, kernels.masked_seq_ce_grad_torch(logits, tokens, 0, g),
                               rtol=1e-5, atol=1e-6)
    assert torch.all(grad[tokens == 0] == 0)
