"""The hand-written CUDA row-reduce kernels against their plain versions.

Tests marked ``gpu`` build ``mmvae_torch/ops/csrc/row_reduce.cu`` with
``nvcc`` and run on the card; without one they skip. This file imports
nothing of JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerance: rtol 1e-5, atol 1e-5 * D -- the kernel sums a row in another
order than PyTorch does.
"""

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


def test_wrappers_reject_cpu_tensors():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.kl_std_normal_kernel(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bernoulli_nll_kernel(x, x)


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
    before = dict(kernels.LAUNCHES)
    kernels.kl_std_normal_kernel(x, x)
    kernels.bernoulli_nll_kernel(x, x[:4], kernels.FOLD_T)
    assert kernels.LAUNCHES == {"kl": before["kl"] + 1, "bce": before["bce"] + 1}
    with pytest.raises(TypeError):
        kernels.kl_std_normal_kernel(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.kl_std_normal_kernel(x.t(), x.t())
    with pytest.raises(ValueError, match="fold"):
        kernels.bernoulli_nll_kernel(x, x[:3], kernels.FOLD_B)
    assert kernels.LAUNCHES == {"kl": before["kl"] + 1, "bce": before["bce"] + 1}


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
