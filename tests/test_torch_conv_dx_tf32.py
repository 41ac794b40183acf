"""K4's input gradient in 3xTF32, emulated on the CPU.

On the card, ``conv4x4s2_swish_dx`` forms ``pre = patches . W^T`` and ``T
= S . W`` (S = g swish'(pre + b), per output pixel the 16 C entries
``(ky, kx, c)`` it gives the input) on the tensor cores, each operand split
as ``hi = tf32(a)``, ``lo = tf32(a - hi)`` (``cvt.rna.tf32.f32``: round to
nearest, ties away from zero) and each product as ``lo . hi' + hi . lo' +
hi . hi'`` accumulated in f32; then each input pixel (2 m + ph, 2 q + pw)
sums the four entries of T that cover it, ``((t00 + t01) + t10) + t11``
with ``t[d][d']`` from output pixel (m + ph - d, q + pw - d') at tap
(1 - ph + 2 d, 1 - pw + 2 d'), 0 outside the output. Here the rounding is
emulated by bit masking on int32 views of f32, the products by f32 matmuls
of the parts and the fold in the kernel's order. At CUB's train shape and
at an odd size, with seeded inputs, dx so formed lies within the card
tests' tolerance (``_conv_dx_close``: rtol 1e-5, atol 1e-6 x the 4 taps x
32 channels each entry sums) of a float64 reference. Imports no JAX.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmvae_torch.ops import kernels
from torch_threads import _one_torch_thread  # noqa: F401

CUB_TRAIN = (64, 64, 64, 3)


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """``a`` (f32) rounded to TF32's 10 fraction bits, to nearest with ties
    away from zero: half of the 13 dropped bits added to the magnitude,
    then the 13 bits cleared."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 from the split parts, the small cross terms first."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
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
    """The SAME-padded 4 x 4 / 2 patches of NHWC ``x`` as ``(B, L, 16 C)``,
    element ``(ky * 4 + kx) * C + c`` as the kernel orders them."""
    b, h, w, c = x.shape
    nchw = F.pad(x.permute(0, 3, 1, 2), kernels.same_pad((h, w)))
    cols = F.unfold(nchw, 4, stride=2)  # (B, C * 16, L), element c * 16 + ky * 4 + kx
    return cols.view(b, c, 16, -1).permute(0, 3, 2, 1).reshape(b, cols.shape[-1], 16 * c)


def _dx(x, weight, bias, g, matmul):
    """dx with both products through ``matmul`` and the kernel's fold, in
    ``x``'s dtype."""
    b, h, w, c = x.shape
    h_out, w_out = g.shape[2:]
    w_k = weight.permute(0, 2, 3, 1).reshape(32, 16 * c)  # W[o][(ky * 4 + kx) * C + c]
    pre = matmul(_patches(x), w_k.T) + bias
    sig = torch.sigmoid(pre)
    s = g.permute(0, 2, 3, 1).reshape(b, -1, 32) * sig * (1.0 + pre * (1.0 - sig))
    t = matmul(s, w_k).view(b, h_out, w_out, 4, 4, c)
    t = F.pad(t, (0, 0, 0, 0, 0, 0, 1, 1, 1, 1))  # 0 outside the output
    dx = torch.zeros((b, 2 * h_out, 2 * w_out, c), dtype=x.dtype)
    for ph in range(2):
        for pw in range(2):
            terms = [t[:, 1 + ph - d: 1 + ph - d + h_out, 1 + pw - d2: 1 + pw - d2 + w_out,
                       1 - ph + 2 * d, 1 - pw + 2 * d2]
                     for d in range(2) for d2 in range(2)]
            dx[:, ph::2, pw::2] = ((terms[0] + terms[1]) + terms[2]) + terms[3]
    return dx[:, :h, :w]


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    """``_conv_dx_close`` of ``tests/test_torch_kernels.py``, in float64."""
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6 * 4 * 32)


def test_fold_in_float64_is_autograd_of_the_conv():
    """The emulation's patch order, fold and pad hold the function: in
    float64 with exact products it is autograd's gradient of
    ``swish(conv(pad(x), w) + b)`` in ``x`` to rounding."""
    x, weight, bias, g = (a.double() for a in _inputs((3, 33, 31, 3), seed=17))
    nchw = x.permute(0, 3, 1, 2).requires_grad_(True)
    y = F.silu(F.conv2d(F.pad(nchw, kernels.same_pad(x.shape[1:3])), weight, bias, stride=2))
    (want,) = torch.autograd.grad(y, nchw, g)
    got = _dx(x, weight, bias, g, torch.matmul)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [CUB_TRAIN, (3, 33, 31, 3)])
def test_3xtf32_dx_within_the_kernel_tolerance_of_float64(shape):
    """dx through 3xTF32 products and the kernel's fold against float64, at
    the card tests' tolerance; the error is at most twice the plain f32
    version's (both round f32 sums; the split drops about 2^-22 of each
    operand)."""
    args = _inputs(shape, seed=17)
    want = _dx(*(a.double() for a in args), torch.matmul)
    got = _dx(*args, matmul_3xtf32)
    _close(got, want)
    plain = kernels.conv4x4s2_swish_input_grad_torch(*args)
    _close(plain, want)
    assert (got.double() - want).abs().max() <= 2 * (plain.double() - want).abs().max()


def test_plain_tf32_would_miss_the_tolerance():
    """One TF32 product a step (hi . hi' alone) keeps about three digits:
    at CUB's train shape its dx lands outside the tolerance, which is why
    the kernel splits its operands."""
    args = _inputs(CUB_TRAIN, seed=17)
    want = _dx(*(a.double() for a in args), torch.matmul)
    got = _dx(*args, lambda a, b: tf32_rna(a) @ tf32_rna(b))
    with pytest.raises(AssertionError):
        _close(got, want)
