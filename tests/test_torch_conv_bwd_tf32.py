"""K4's backward in 3xTF32, emulated on the CPU.

On the card, ``conv4x4s2_swish_bwd`` forms ``pre = patches . W^T`` and
``dW = S^T . patches`` on the tensor cores, each operand split as ``hi =
tf32(a)``, ``lo = tf32(a - hi)`` (``cvt.rna.tf32.f32``: round to nearest,
ties away from zero) and each product as ``lo . hi' + hi . lo' + hi .
hi'`` accumulated in f32. Here the rounding is emulated by bit masking on
int32 views of f32 and the products by f32 matmuls of the parts. At
CelebA's train shape, with seeded inputs, dW and db so formed lie within
the card tests' tolerance (rtol 1e-5, atol 1e-6 x the terms each entry
sums) of a float64 reference, and their error is of the size of the plain
f32 version's. Imports no JAX.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmvae_torch.ops import kernels

CELEBA_TRAIN = (64, 64, 64, 3)


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """``a`` (f32) rounded to TF32's 10 fraction bits, to nearest with ties
    away from zero: half of the 13 dropped bits added to the magnitude,
    then the 13 bits cleared."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 from the split parts, the small cross terms first."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _inputs(shape, seed: int):
    """The image in [0, 1], weights and bias N(0, 0.01) (as the smoke run
    draws them) and a standard normal upstream gradient, from numpy."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    x = rng.random((b, h, w, c), dtype=np.float32)
    weight = (0.1 * rng.standard_normal((32, c, 4, 4))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    g = rng.standard_normal((b, 32, -(-h // 2), -(-w // 2))).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, weight, bias, g))


def _patches(x: torch.Tensor) -> torch.Tensor:
    """The SAME-padded 4 x 4 / 2 patches as ``(16 C, B * L)``."""
    h = x.permute(0, 3, 1, 2)
    cols = F.unfold(F.pad(h, kernels.same_pad(h.shape[-2:])), 4, stride=2)
    return cols.permute(1, 0, 2).reshape(cols.shape[1], -1)


def _grads(x, weight, bias, g, matmul):
    """(dW, db) with both products through ``matmul``, in ``x``'s dtype."""
    cols = _patches(x)
    w_flat = weight.reshape(32, -1)
    pre = matmul(w_flat, cols) + bias[:, None]
    sig = torch.sigmoid(pre)
    s = g.permute(1, 0, 2, 3).reshape(32, -1) * sig * (1.0 + pre * (1.0 - sig))
    return matmul(s, cols.T).reshape(weight.shape), s.sum(1)


def _errors(got, want) -> float:
    return max((a.double() - b).abs().max().item() for a, b in zip(got, want))


def test_tf32_rounding_keeps_ten_fraction_bits_to_nearest():
    """hi has its 13 low bits clear, lies within half a TF32 step of v
    (ties away from zero), and hi + lo is v to about 2^-22 of it."""
    v = torch.tensor([1.0, 1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-12, 0.1, -3.7e-5])
    hi, lo = split_tf32(v)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert hi[1].item() == 1.0 + 2.0**-10 and hi[2].item() == -(1.0 + 2.0**-10)
    assert hi[3].item() == 1.0 + 2.0**-10 and hi[0].item() == 1.0 and lo[0].item() == 0.0
    step = 2.0 ** (torch.floor(torch.log2(v.abs())) - 10)
    assert torch.all((hi - v).abs() <= step / 2)
    assert torch.all((hi.double() + lo.double() - v.double()).abs() <= 2.0**-21 * v.abs().double())


@pytest.mark.parametrize("shape", [CELEBA_TRAIN, (37, 64, 64, 3), (6, 32, 40, 4)])
def test_3xtf32_grads_within_the_kernel_tolerance_of_float64(shape):
    """dW and db through 3xTF32 products against float64, at the card
    tests' tolerance; the error is at most twice the plain f32 version's
    (both round the same f32 sums; the split drops about 2^-22 of each
    operand)."""
    args = _inputs(shape, seed=14)
    want = _grads(*(a.double() for a in args), torch.matmul)
    got = _grads(*args, matmul_3xtf32)
    n_terms = shape[0] * -(-shape[1] // 2) * -(-shape[2] // 2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-6 * n_terms)
    plain = kernels.conv4x4s2_swish_grad_torch(*args)
    for a, b in zip(plain, want):
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-6 * n_terms)
    assert _errors(got, want) <= 2 * _errors(plain, want)


def test_plain_tf32_would_miss_the_tolerance():
    """One TF32 product (hi . hi' alone) keeps about three digits: at
    CelebA's train shape it lands outside the tolerance, which is why the
    kernel splits its operands."""
    args = _inputs(CELEBA_TRAIN, seed=14)
    want = _grads(*(a.double() for a in args), torch.matmul)
    got = _grads(*args, lambda a, b: tf32_rna(a) @ tf32_rna(b))
    n_terms = 64 * 32 * 32
    with pytest.raises(AssertionError):
        for a, b in zip(got, want):
            torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-6 * n_terms)
