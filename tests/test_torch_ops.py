"""The port's ops layer and core math against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both sides. The JAX Pallas
kernels run in interpret mode, as ``tests/test_pallas.py`` runs them. The
tolerance is rtol 2e-4 because XLA-CPU transcendentals are approximate
(docs/DESIGN.md section 7); the atol covers sums that cancel to near 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import core as jcore
from mmvae_tpu import ops as jops
from mmvae_tpu.ops import kernels as jkernels
from mmvae_tpu.train.step import _tile_terms_tmajor
from mmvae_torch import core, ops
from mmvae_torch.ops import kernels

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
    for objective in ("mmvae", "mopoe"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            core.fuse_observed_z(_t(mu), _t(lv), None, objective, sample=False)
    with pytest.raises(ValueError):
        core.fuse_observed_z(_t(mu), _t(lv), None, "vae", sample=False)
