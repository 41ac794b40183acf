"""The hand-written CUDA kernels against their plain versions.

Tests marked ``gpu`` build ``mmvae_torch/ops/csrc/row_reduce.cu`` (K1, K2),
``seq_ce.cu`` (K3) and ``conv_s2.cu`` (K4) with ``nvcc`` and run on the
card; without one they skip. This file imports nothing of JAX, so on a machine with a card and no
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerance: rtol 1e-5, atol 1e-5 * D for the row reductions, 1e-5 * S *
log V for K3, 1e-5 * 48 for K4 in f32 (48 products per output) -- the
kernels sum in another order than PyTorch does; K4 in bf16 atol 2e-2, one
bf16 rounding of an output below 4.
"""

import math


import pytest
import torch

from mmvae_torch import ops
from mmvae_torch.ops import kernels

FOLDS = [kernels.FOLD_NONE, kernels.FOLD_T, kernels.FOLD_B]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


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
        ((3, 9, 300, 2), torch.bfloat16),  # a band of one row
        ((2, 7, 1100, 4), torch.float32),  # shared memory past 48 KB
    ],
)
def test_conv_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator().manual_seed(8)
    x, w, b = _conv_inputs(gen, shape, dtype, cuda)
    got = kernels.conv4x4s2_swish_kernel(x, w, b)
    want = kernels.conv4x4s2_swish_torch(x, w, b)
    assert got.shape == want.shape == (shape[0], 32, -(-shape[1] // 2), -(-shape[2] // 2))
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * 16 * shape[-1])
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-2)


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
