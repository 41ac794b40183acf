"""The port's ops layer and core math against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both sides. The JAX Pallas
kernels run in interpret mode, as ``tests/test_pallas.py`` runs them;
the conv probe's kernel (``tools/pallas_conv_probe.py::pallas_conv0``),
which takes no ``interpret`` argument, runs under
``pltpu.force_tpu_interpret_mode()``. The tolerance is rtol 2e-4 because
XLA-CPU transcendentals are approximate (docs/DESIGN.md section 7); the
atol covers sums that cancel to near 0.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mmvae_tpu import core as jcore
from mmvae_tpu import ops as jops
from mmvae_tpu.ops import kernels as jkernels
from mmvae_tpu.train.step import _tile_terms, _tile_terms_tmajor
from mmvae_torch import core, ops
from mmvae_torch.ops import kernels
from tools.pallas_conv_probe import pallas_conv0, xla_conv0

RTOL = 2e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, atol: float = 1e-4) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=atol)


@pytest.mark.parametrize("shape", [(4, 64), (37, 100), (300, 64), (5, 3)])
def test_kl_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(0)
    mu, lv = rng.normal(size=(2,) + shape).astype(np.float32)
    want = jkernels._kl_fwd_impl(jnp.asarray(mu), jnp.asarray(lv), interpret=True)
    _close(kernels.kl_std_normal_torch(_t(mu), _t(lv)), want)


@pytest.mark.parametrize("shape", [(4, 784), (37, 1000), (200, 784), (5, 130)])
def test_bce_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=shape).astype(np.float32) * 3
    x = rng.uniform(size=shape).astype(np.float32)
    want = jkernels._bce_fwd_impl(
        jnp.asarray(logits), jnp.asarray(x), 1, interpret=True
    )
    _close(kernels.bernoulli_nll_torch(_t(logits), _t(x)), want, atol=1e-3)


@pytest.mark.parametrize(
    "fold", [kernels.FOLD_NONE, kernels.FOLD_T, kernels.FOLD_B]
)
def test_bce_fold_modes_match_jax_tiling(fold):
    """Each row map of the BCE kernel's plain version is the JAX tiling
    it replaces: t-major ``_tile_terms_tmajor``, b-major ``_tile_rows``."""
    rng = np.random.default_rng(2)
    k, b, d = 3, 10, 130
    logits = rng.normal(size=(k * b, d)).astype(np.float32) * 3
    n_x = k * b if fold == kernels.FOLD_NONE else b
    x = rng.uniform(size=(n_x, d)).astype(np.float32)
    tiled = {
        kernels.FOLD_NONE: lambda a: a,
        kernels.FOLD_T: lambda a: _tile_terms_tmajor(a, k),
        kernels.FOLD_B: lambda a: jops._tile_rows(a, k),
    }[fold](jnp.asarray(x))
    want = jkernels._bce_fwd_impl(jnp.asarray(logits), tiled, 1, interpret=True)
    _close(kernels.bernoulli_nll_torch(_t(logits), _t(x), fold), want, atol=1e-3)


@pytest.mark.parametrize("fold", ["t", "b"])
def test_ops_nll_term_tiled_targets(fold):
    """ops-level NLLs score term-tiled logits against untiled targets in
    the named order; the JAX reference gets the targets tiled explicitly."""
    rng = np.random.default_rng(3)
    k, b = 3, 10
    tile = (lambda a: _tile_terms_tmajor(a, k)) if fold == "t" else (
        lambda a: jops._tile_rows(a, k)
    )
    logits = rng.normal(size=(k * b, 28, 28)).astype(np.float32)
    x = rng.uniform(size=(b, 28, 28)).astype(np.float32)
    want = jcore.bernoulli_nll(jnp.asarray(logits), tile(jnp.asarray(x)), 2)
    _close(ops.bernoulli_nll(_t(logits), _t(x), 2, fold=fold), want, atol=1e-3)
    cl = rng.normal(size=(k * b, 10)).astype(np.float32)
    lab = rng.integers(0, 10, size=(b,)).astype(np.int32)
    want = jcore.categorical_nll(jnp.asarray(cl), tile(jnp.asarray(lab)))
    _close(ops.categorical_nll(_t(cl), _t(lab), fold=fold), want)


def test_ops_bernoulli_nll_event_ndims_0_t_fold():
    """The CelebA attribute NLL: ``(k * B, A)`` logits at event_ndims=0
    against untiled ``(B, A)`` targets, under the t-fold (the evals') and
    the b-fold (the IWAE's, against JAX's ``_tile_terms``). The kernel path
    flattens both to rows of D = 1 and reads target row ``r % (B * A)``,
    or ``(r / (k * A)) * A + r % A`` (``bce_rows_inner``); the plain
    versions of those row maps give the same. The plain path's gradient
    goes through the same tiling, and so does ``bce_rows_grad_torch`` at the
    b-major map (the plain version of the kernel path's
    ``bce_rows_grad_inner``); the kernel backend refuses a CPU tensor for
    its device."""
    rng = np.random.default_rng(13)
    k, b, a = 19, 6, 18
    logits = (rng.normal(size=(k * b, a)) * 3).astype(np.float32)
    x = rng.integers(0, 2, size=(b, a)).astype(np.float32)
    want = jcore.bernoulli_nll(jnp.asarray(logits), _tile_terms_tmajor(jnp.asarray(x), k), 0)
    got = ops.bernoulli_nll(_t(logits), _t(x), 0, fold="t")
    assert got.shape == (k * b, a)
    _close(got, want)
    rows = kernels.bernoulli_nll_torch(
        _t(logits).reshape(-1, 1), _t(x).reshape(-1, 1), kernels.FOLD_T
    )
    _close(rows.reshape(k * b, a), want)

    def jax_b(lg):
        return jcore.bernoulli_nll(lg, _tile_terms(jnp.asarray(x), k), 0)

    want_b = jax_b(jnp.asarray(logits))
    lt = _t(logits).requires_grad_(True)
    got_b = ops.bernoulli_nll(lt, _t(x), 0, fold="b")
    assert got_b.shape == (k * b, a)
    _close(got_b.detach(), want_b)
    assert not np.allclose(np.asarray(want_b), np.asarray(want))  # the folds differ
    rows_b = kernels.bernoulli_nll_torch(
        _t(logits).reshape(-1, 1), _t(x).reshape(-1, 1), kernels.FOLD_B, inner=a
    )
    _close(rows_b.reshape(k * b, a), want_b)
    g = rng.normal(size=(k * b, a)).astype(np.float32)
    got_b.backward(_t(g))
    _, vjp = jax.vjp(jax_b, jnp.asarray(logits))
    want_g = vjp(jnp.asarray(g))[0]
    _close(lt.grad, want_g)
    grad_rows = kernels.bce_rows_grad_torch(
        _t(logits).reshape(-1, 1), _t(x).reshape(-1, 1), _t(g).reshape(-1), kernels.FOLD_B, a)
    _close(grad_rows.reshape(k * b, a), want_g)
    ops.set_backend("kernel")
    try:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.bernoulli_nll(_t(logits).requires_grad_(True), _t(x), 0, fold="b")
    finally:
        ops.set_backend("auto")


def _conv_inputs(shape, seed: int = 14):
    """NHWC image in [0, 1], HWIO weights and a bias, as the probe draws them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    w = (rng.normal(size=(4, 4, shape[-1], 32)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(32,)) * 0.1).astype(np.float32)
    return x, w, b


def _conv_plain(x, w_hwio, b, dtype=torch.float32) -> np.ndarray:
    """K4's plain version on the probe's layouts: NHWC f32 out."""
    y = kernels.conv4x4s2_swish_torch(
        _t(x).to(dtype), _t(w_hwio.transpose(3, 2, 0, 1)).to(dtype), _t(b).to(dtype)
    )
    assert y.dtype == dtype
    return y.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_conv_plain_matches_pallas_conv0_interpret(dtype, atol):
    """K4's plain version against the TPU kernel itself at (8, 64, 64, 3).
    f32: the two sum the 48 products of each output in other orders
    (1.8e-7 apart as measured). bf16: both accumulate in f32 and round
    each output once, so they may part by one bf16 rounding, 2^-7 of an
    output near 2."""
    x, w, b = _conv_inputs((8, 64, 64, 3))
    with pltpu.force_tpu_interpret_mode():
        want = pallas_conv0(*(jnp.asarray(a, dtype) for a in (x, w, b)))
    want = np.asarray(want.astype(jnp.float32))
    got = _conv_plain(x, w, b, getattr(torch, dtype))
    assert got.shape == want.shape == (8, 32, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [(5, 25, 25, 1), (3, 25, 22, 3), (2, 1, 7, 4)])
def test_conv_plain_matches_flax_same_conv(shape):
    """Odd sizes, where XLA's SAME pads (1, 2): K4's plain version and
    ``ops.conv4x4s2_swish`` on the CPU against Flax ``nn.Conv`` SAME at
    stride 2 plus swish."""
    x, w, b = _conv_inputs(shape)
    conv = flax_nn.Conv(32, (4, 4), strides=(2, 2), padding="SAME")
    y = conv.apply({"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(x))
    want = y * jax.nn.sigmoid(y)
    _close(torch.from_numpy(_conv_plain(x, w, b)), want, atol=1e-5)
    got = ops.conv4x4s2_swish(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b))
    _close(got.permute(0, 2, 3, 1), want, atol=1e-5)


@pytest.fixture(scope="module")
def conv0_full():
    """``pallas_conv0`` in interpret mode at (8, 64, 64, 3), f32 and bf16:
    all 32 channels, which a rank's block of 16 or 8 is held to."""
    x, w, b = _conv_inputs((8, 64, 64, 3))
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for dtype in ("float32", "bfloat16"):
            y = pallas_conv0(*(jnp.asarray(a, dtype) for a in (x, w, b)))
            out[dtype] = np.asarray(y.astype(jnp.float32))
    return (x, w, b), out


@pytest.mark.parametrize("f", [16, 8])
@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_conv_plain_on_a_channel_block_matches_pallas_conv0(conv0_full, f, dtype, atol):
    """K4 at F = 16 and 8 (a rank's stage 0 under tensor parallelism): the
    plain version on each block of F output channels of the weight equals
    that block of the TPU kernel's 32 (interpret mode) and of ``xla_conv0``
    on the block, at f32 and all bf16 (one bf16 rounding apart, as at 32)."""
    (x, w, b), full = conv0_full
    for r in range(32 // f):
        blk = slice(r * f, (r + 1) * f)
        got = _conv_plain(x, w[..., blk], b[blk], getattr(torch, dtype))
        assert got.shape == (8, 32, 32, f)
        np.testing.assert_allclose(got, full[dtype][..., blk], rtol=0, atol=atol)
        want = xla_conv0(*(jnp.asarray(a, dtype) for a in (x, w[..., blk], b[blk])))
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("f", [16, 8])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_conv_grads_on_a_channel_block_match_jax_vjp(f, x_dtype):
    """The autograd gradients of ``ops.conv4x4s2_swish`` at F = 16 and 8 on
    the CPU (K4's backward and input gradient, plain) against ``jax.vjp`` of
    ``xla_conv0`` on the same block: the weight's, the bias's and, for an
    f32 image, the image's; a bf16 image (a bf16 train split) into f32
    weights, the weight's and the bias's; odd 19x17 images that pad (1, 2)."""
    x, w, b = _conv_inputs((3, 19, 17, 3), seed=f)
    w, b = w[..., :f], b[:f]
    x = np.asarray(jnp.asarray(x, x_dtype).astype(jnp.float32))  # the bf16 values
    out, vjp = jax.vjp(xla_conv0, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    g = np.random.default_rng(f).standard_normal(out.shape).astype(np.float32)
    j_dx, j_dw, j_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx = _t(x).to(getattr(torch, x_dtype)).requires_grad_(x_dtype == "float32")
    tw = _t(w.transpose(3, 2, 0, 1)).requires_grad_(True)
    tb = _t(b).requires_grad_(True)
    y = ops.conv4x4s2_swish(tx, tw, tb)
    _close(y.detach().permute(0, 2, 3, 1), out, atol=1e-5)
    y.backward(_t(g).permute(0, 3, 1, 2))
    grads = [(tw.grad, j_dw.transpose(3, 2, 0, 1)), (tb.grad, j_db)]
    if x_dtype == "float32":
        grads.append((tx.grad, j_dx))
    for got, want in grads:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=2e-4 * np.abs(want).max())


def _seq_inputs(rng, n, s, v):
    """Logits and tokens whose rows end in PAD runs; some rows all PAD."""
    logits = (rng.normal(size=(n, s, v)) * 3).astype(np.float32)
    tokens = rng.integers(1, v, size=(n, s)).astype(np.int32)
    lengths = rng.integers(0, s + 1, size=n)
    lengths[0] = 0
    tokens[np.arange(s)[None, :] >= lengths[:, None]] = 0
    return logits, tokens


@pytest.mark.parametrize("shape", [(37, 5, 13), (8, 7, 600), (200, 5, 13)])
def test_seq_ce_plain_matches_pallas_interpret_and_jnp(shape):
    """K3's plain version against the Pallas kernel in interpret mode and
    the jnp path of ``mmvae_tpu.ops.masked_seq_ce``; pad positions give 0."""
    logits, tokens = _seq_inputs(np.random.default_rng(11), *shape)
    assert (tokens == 0).any() and (tokens == 0).all(axis=1).any()
    got = kernels.masked_seq_ce_torch(_t(logits), _t(tokens), 0)
    want = jkernels._seq_ce_fwd_impl(
        jnp.asarray(logits), jnp.asarray(tokens), 0, interpret=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    jops.set_backend("jnp")
    try:
        want = jops.masked_seq_ce(jnp.asarray(logits), jnp.asarray(tokens))
    finally:
        jops.set_backend("auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    assert torch.all(got[torch.from_numpy((tokens == 0).all(axis=1))] == 0)


@pytest.mark.parametrize("fold", ["t", "b"])
@pytest.mark.parametrize("v", [13, 600])
def test_ops_masked_seq_ce_term_tiled_tokens(fold, v):
    """Term-tiled logits rows against untiled tokens in the named order;
    the JAX reference gets the tokens tiled explicitly. A pad token other
    than 0 is honoured."""
    rng = np.random.default_rng(12)
    k, b, s = 3, 10, 5
    logits, tokens = _seq_inputs(rng, k * b, s, v)
    tokens = tokens[:b]
    tile = (lambda a: _tile_terms_tmajor(a, k)) if fold == "t" else (
        lambda a: jops._tile_rows(a, k)
    )
    for pad in (0, 2):
        want = jkernels._seq_ce_fwd_impl(
            jnp.asarray(logits), tile(jnp.asarray(tokens)), pad, interpret=True
        )
        got = ops.masked_seq_ce(_t(logits), _t(tokens), pad, fold=fold)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    batched = ops.masked_seq_ce(_t(logits).view(k, b, s, v), _t(tokens)[None].expand(k, b, s))
    torch.testing.assert_close(batched, ops.masked_seq_ce(_t(logits), _t(tokens), fold="t").view(k, b))


def test_ops_match_jax_ops_with_batch_dims():
    rng = np.random.default_rng(4)
    mu, lv = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    _close(
        ops.kl_std_normal(_t(mu), _t(lv)),
        jops.kl_std_normal(jnp.asarray(mu), jnp.asarray(lv)),
    )
    logits = rng.normal(size=(4, 6, 28, 28)).astype(np.float32)
    x = rng.uniform(size=(4, 6, 28, 28)).astype(np.float32)
    _close(
        ops.bernoulli_nll(_t(logits), _t(x), 2),
        jops.bernoulli_nll(jnp.asarray(logits), jnp.asarray(x), 2),
        atol=1e-3,
    )


def test_backend_dispatch():
    assert ops.get_backend() == "auto"
    mu = torch.zeros((2, 4))
    try:
        with pytest.raises(ValueError):
            ops.set_backend("pallas")
        ops.set_backend("torch")
        np.testing.assert_allclose(ops.kl_std_normal(mu, mu).numpy(), 0.0)
        ops.set_backend("kernel")
        with pytest.raises(ValueError, match="CUDA"):
            ops.kl_std_normal(mu, mu)
        with pytest.raises(ValueError, match="CUDA"):
            ops.bernoulli_nll(mu, mu)
        with pytest.raises(ValueError, match="CUDA"):
            ops.masked_seq_ce(torch.zeros((2, 3, 5)), torch.zeros((2, 3), dtype=torch.int32))
        with pytest.raises(ValueError, match="CUDA"):
            ops.conv4x4s2_swish(torch.zeros((1, 4, 4, 3)), torch.zeros((32, 3, 4, 4)), torch.zeros(32))
    finally:
        ops.set_backend("auto")


def test_product_of_experts_matches_jax():
    """Includes log-variances past the +-11 clamp and absent experts."""
    rng = np.random.default_rng(5)
    mu = rng.normal(size=(3, 6, 4, 8)).astype(np.float32)
    lv = (rng.normal(size=(3, 6, 4, 8)) * 8).astype(np.float32)
    mask = (rng.uniform(size=(3, 6, 4)) < 0.5).astype(np.float32)
    for kw in ({}, {"include_prior": False}):
        for m in (None, mask):
            args = (jnp.asarray(mu), jnp.asarray(lv), None if m is None else jnp.asarray(m))
            w_mu, w_lv = jcore.product_of_experts(*args, **kw)
            if m is None or kw.get("include_prior", True):
                g_mu, g_lv = core.product_of_experts(
                    _t(mu), _t(lv), None if m is None else _t(m), **kw
                )
                _close(g_mu, w_mu)
                _close(g_lv, w_lv)


def test_reparameterize_takes_noise_from_outside():
    rng = np.random.default_rng(6)
    mu, lv, eps = (_t(a) for a in rng.normal(size=(3, 5, 8)).astype(np.float32))
    assert core.reparameterize(mu, lv, sample=False) is mu
    got = core.reparameterize(mu, lv, sample=True, eps=eps)
    torch.testing.assert_close(got, mu + eps * torch.exp(0.5 * lv))
    gen_a = torch.Generator().manual_seed(7)
    gen_b = torch.Generator().manual_seed(7)
    torch.testing.assert_close(
        core.reparameterize(mu, lv, sample=True, generator=gen_a),
        core.reparameterize(mu, lv, sample=True, generator=gen_b),
    )


def test_likelihoods_match_jax():
    rng = np.random.default_rng(8)
    mean, x = rng.normal(size=(2, 6, 5, 7)).astype(np.float32)
    lv = rng.normal(size=(6, 5, 7)).astype(np.float32)
    for logvar, ev in ((0.0, 1), (lv, 2)):
        j_lv = logvar if isinstance(logvar, float) else jnp.asarray(logvar)
        t_lv = logvar if isinstance(logvar, float) else _t(logvar)
        _close(
            core.gaussian_nll(_t(mean), _t(x), t_lv, ev),
            jcore.gaussian_nll(jnp.asarray(mean), jnp.asarray(x), j_lv, ev),
        )
    logits = rng.normal(size=(6, 5, 11)).astype(np.float32)
    tokens = rng.integers(0, 11, size=(6, 5)).astype(np.int32)
    _close(
        core.categorical_nll(_t(logits), _t(tokens), 1),
        jcore.categorical_nll(jnp.asarray(logits), jnp.asarray(tokens), 1),
    )
    probs = rng.uniform(size=(6, 5, 7)).astype(np.float32)
    _close(
        core.bernoulli_nll(_t(mean), _t(probs), 2),
        jcore.bernoulli_nll(jnp.asarray(mean), jnp.asarray(probs), 2),
    )


def test_elbo_math_matches_jax():
    rng = np.random.default_rng(9)
    m1, l1, m2, l2 = rng.normal(size=(4, 3, 9, 16)).astype(np.float32)
    _close(
        core.kl_gauss_gauss(_t(m1), _t(l1), _t(m2), _t(l2)),
        jcore.kl_gauss_gauss(*(jnp.asarray(a) for a in (m1, l1, m2, l2))),
    )
    nll = rng.uniform(0, 50, size=(3, 2, 9)).astype(np.float32)
    kl = rng.uniform(0, 5, size=(3, 9)).astype(np.float32)
    masks = np.asarray(jcore.elbo_subset_masks(2))
    lam = np.asarray([1.0, 10.0], np.float32)
    tw = rng.uniform(size=(3, 9)).astype(np.float32)
    for w in (None, tw):
        loss, met = core.elbo_terms(
            _t(nll), _t(kl), _t(masks), _t(lam), 0.7, None if w is None else _t(w)
        )
        j_loss, j_met = jcore.elbo_terms(
            jnp.asarray(nll), jnp.asarray(kl), jnp.asarray(masks),
            jnp.asarray(lam), 0.7, None if w is None else jnp.asarray(w),
        )
        _close(loss, j_loss)
        for k in j_met:
            _close(met[k], j_met[k])


def test_subset_masks():
    np.testing.assert_array_equal(
        core.elbo_subset_masks(3).numpy(), np.asarray(jcore.elbo_subset_masks(3))
    )
    draw = core.random_subset_masks(torch.Generator().manual_seed(0), 64, 3)
    again = core.random_subset_masks(torch.Generator().manual_seed(0), 64, 3)
    assert draw.shape == (64, 3) and draw.dtype == torch.float32
    assert set(draw.unique().tolist()) == {0.0, 1.0}
    torch.testing.assert_close(draw, again)


def test_fuse_observed_z_matches_jax_and_guards_mixtures():
    rng = np.random.default_rng(10)
    mu, lv = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
    presence = np.asarray([[1, 1], [1, 0], [0, 1], [0, 0], [1, 1]], np.float32)
    want = jcore.fuse_observed_z(
        None, jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(presence),
        objective="mvae", sample=False,
    )
    _close(core.fuse_observed_z(_t(mu), _t(lv), _t(presence), sample=False), want)
    for objective in ("mmvae", "mopoe"):  # the mixture's mean, a row with nothing at 0
        want = jcore.fuse_observed_z(
            None, jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(presence),
            objective=objective, sample=False,
        )
        _close(core.fuse_observed_z(_t(mu), _t(lv), _t(presence), objective, sample=False),
               want)
    with pytest.raises(ValueError):
        core.fuse_observed_z(_t(mu), _t(lv), None, "vae", sample=False)


_FOLD_TILES = {
    "none": lambda a, k: a,
    "t": lambda a, k: _tile_terms_tmajor(a, k),
    "b": lambda a, k: jops._tile_rows(a, k),
}


def _bce_grads(logits, x, g, fold):
    """d logits and d x of sum(g * ops.bernoulli_nll(logits, x)) on the CPU."""
    lt, xt = _t(logits).requires_grad_(True), _t(x).requires_grad_(True)
    out = ops.bernoulli_nll(lt, xt, 1, fold="t" if fold == "none" else fold)
    return [a.numpy() for a in torch.autograd.grad((out * _t(g)).sum(), (lt, xt))]


@pytest.mark.parametrize("fold", ["none", "t", "b"])
def test_bce_grad_at_zero_logits_is_the_pallas_vjp(fold):
    """At logits exactly 0 the plain path's gradient is ``_bce_bwd``'s, the
    VJP of the TPU kernel K2 ports: g * (sigmoid(0) - x) = g * (0.5 - x)
    (autograd of the plain formula gave g * (1 - x) there), and d x =
    -g * l summed over the rows that read each target row."""
    k, b, d = 3, 4, 5
    rng = np.random.default_rng(15)
    logits = rng.normal(size=(k * b, d)).astype(np.float32)
    logits[:, ::2] = 0.0
    x = rng.uniform(size=(k * b if fold == "none" else b, d)).astype(np.float32)
    x[0, :3] = (0.0, 1.0, 0.3)
    g = rng.normal(size=(k * b,)).astype(np.float32)
    tiled = _FOLD_TILES[fold](jnp.asarray(x), k)
    d_logits, d_x_tiled = jkernels._bce_bwd(1, (jnp.asarray(logits), tiled), jnp.asarray(g))
    want_dx = jax.grad(lambda a: jnp.sum(_FOLD_TILES[fold](a, k) * d_x_tiled))(jnp.asarray(x))
    got = _bce_grads(logits, x, g, fold)
    np.testing.assert_allclose(got[0], np.asarray(d_logits), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[1], np.asarray(want_dx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0][:, 0], g * (0.5 - _FOLD_TILES[fold](x, k)[:, 0]),
                               rtol=1e-6)


@pytest.mark.parametrize("fold", ["none", "t", "b"])
def test_bce_grad_matches_jax_grad_away_from_zero(fold):
    """Away from 0, both gradients of the plain path against ``jax.grad``
    of the JAX package's jnp BCE on the tiled targets (rtol 1e-5)."""
    k, b, d = 3, 6, 130
    rng = np.random.default_rng(16)
    logits = (rng.normal(size=(k * b, d)) * 3).astype(np.float32)
    x = rng.uniform(size=(k * b if fold == "none" else b, d)).astype(np.float32)
    g = rng.normal(size=(k * b,)).astype(np.float32)

    def loss(lg, xs):
        return jnp.sum(jnp.asarray(g) * jcore.bernoulli_nll(lg, _FOLD_TILES[fold](xs, k), 1))

    want = jax.grad(loss, (0, 1))(jnp.asarray(logits), jnp.asarray(x))
    for got, w in zip(_bce_grads(logits, x, g, fold), want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5, atol=1e-5)


def test_kl_grad_matches_the_pallas_vjp_and_jax_grad():
    """K1's gradient on the plain path: ``_kl_bwd`` and ``jax.grad`` of the
    jnp KL, with batch dims."""
    rng = np.random.default_rng(17)
    mu, lv = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    g = rng.normal(size=(3, 7)).astype(np.float32)
    mu_t, lv_t = _t(mu).requires_grad_(True), _t(lv).requires_grad_(True)
    got = torch.autograd.grad((ops.kl_std_normal(mu_t, lv_t) * _t(g)).sum(), (mu_t, lv_t))
    vjp = jkernels._kl_bwd((jnp.asarray(mu), jnp.asarray(lv)), jnp.asarray(g))
    want = jax.grad(lambda a, v: jnp.sum(jnp.asarray(g) * jcore.kl_std_normal(a, v)), (0, 1))(
        jnp.asarray(mu), jnp.asarray(lv))
    for a, v, w in zip(got, vjp, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(v), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("fold", ["t", "b"])
@pytest.mark.parametrize("v", [13, 23])
def test_seq_ce_grad_matches_the_pallas_vjp_and_jax_grad(fold, v):
    """K3's gradient on the plain path, for term-tiled logits rows against
    untiled tokens with pad runs (all-pad rows among them): ``_seq_ce_bwd``,
    the VJP of the TPU kernel, on the same arrays with the tokens tiled, and
    ``jax.grad`` of the jnp path of ``mmvae_tpu.ops.masked_seq_ce`` (rtol
    2e-4). A pad position's gradient is exactly 0; the tokens get none."""
    k, b, s = 3, 10, 5
    logits, tokens = _seq_inputs(np.random.default_rng(18), k * b, s, v)
    tokens = tokens[:b]
    g = np.random.default_rng(19).normal(size=(k * b,)).astype(np.float32)
    tiled = _FOLD_TILES[fold](jnp.asarray(tokens), k)
    lt = _t(logits).requires_grad_(True)
    out = ops.masked_seq_ce(lt, _t(tokens), 0, fold=fold)
    got = torch.autograd.grad((out * _t(g)).sum(), lt)[0].numpy()
    vjp, d_tokens = jkernels._seq_ce_bwd(0, (jnp.asarray(logits), tiled), jnp.asarray(g))
    assert d_tokens is None
    jops.set_backend("jnp")
    try:
        want = jax.grad(lambda a: jnp.sum(jnp.asarray(g) * jops.masked_seq_ce(a, tiled)))(
            jnp.asarray(logits))
    finally:
        jops.set_backend("auto")
    np.testing.assert_allclose(got, np.asarray(vjp), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-6)
    pad = np.asarray(tiled) == 0
    assert pad.any() and np.all(got[pad] == 0)


def test_seq_ce_grad_plain_version_is_the_vjp_with_batch_dims():
    """``masked_seq_ce_grad_torch`` with batch dims and another pad token,
    and a token outside the vocabulary (no one-hot, as ``jax.nn.one_hot``),
    against ``_seq_ce_bwd``."""
    rng = np.random.default_rng(20)
    logits = (rng.normal(size=(2, 4, 6, 13)) * 3).astype(np.float32)
    tokens = rng.integers(0, 13, size=(2, 4, 6)).astype(np.int32)
    tokens[0, 0, 0] = 13
    g = rng.normal(size=(2, 4)).astype(np.float32)
    got = kernels.masked_seq_ce_grad_torch(_t(logits), _t(tokens), 2, _t(g))
    want = jkernels._seq_ce_bwd(2, (jnp.asarray(logits), jnp.asarray(tokens)), jnp.asarray(g))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
