"""The fused PoE + KL of the port (``ops.poe_kl``) against the JAX package,
on the CPU.

The JAX side runs the masked PoE (``mmvae_tpu.core.product_of_experts``)
and then K1's Pallas kernel in interpret mode, as ``tests/test_pallas.py``
runs it; the gradients are ``jax.grad`` of the PoE followed by
``mmvae_tpu.core.elbo.kl_std_normal``, as the JAX train step takes them.
Inputs come from numpy seeds. The tolerance is rtol 2e-4, because XLA-CPU
transcendentals are approximate (docs/DESIGN.md section 7); the atol
covers KLs and gradients that cancel to near 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import core as jcore
from mmvae_tpu.ops import kernels as jkernels
from mmvae_torch import core, ops
from mmvae_torch.ops import kernels

RTOL = 2e-4
# (T, B, M, L): the MNIST slice at a narrow width, CelebA's 19 experts and
# 100 latents, an odd L.
SHAPES = [(3, 10, 2, 64), (20, 6, 19, 100), (3, 5, 2, 37)]
# presence given (rows 0 and 2 with every modality absent, as the eval's
# padding rows); presence absent; log-variances past the +-11 clamp; every
# modality present, as in a full eval batch.
CASES = ["zero_rows", "no_presence", "wide_logvar", "all_present"]


def _inputs(shape, case, seed=0):
    t, b, m, l = shape
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(b, m, l)).astype(np.float32)
    lv = (rng.normal(size=(b, m, l)) * (20.0 if case == "wide_logvar" else 1.0)).astype(
        np.float32)
    masks = np.asarray(jcore.elbo_subset_masks(m))
    assert masks.shape == (t, m)
    presence = (rng.uniform(size=(b, m)) < 0.7).astype(np.float32)
    presence[[0, 2]] = 0.0
    if case == "no_presence":
        presence = None
    elif case == "all_present":
        presence = np.ones((b, m), np.float32)
    return mu, lv, masks, presence


def _jax_poe_kl(mu, lv, masks, presence):
    eff = masks[:, None, :] if presence is None else masks[:, None, :] * presence[None]
    eff = np.broadcast_to(eff, (masks.shape[0], mu.shape[0], masks.shape[1]))
    mu_f, lv_f = jcore.product_of_experts(
        jnp.asarray(mu)[None], jnp.asarray(lv)[None], mask=jnp.asarray(eff)
    )
    kl = jkernels._kl_fwd_impl(mu_f, lv_f, interpret=True)
    return [np.asarray(a) for a in (mu_f, lv_f, kl)]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_poe_kl_plain_matches_jax_poe_and_pallas_kl(shape, case):
    mu, lv, masks, presence = _inputs(shape, case)
    got = kernels.poe_kl_torch(_t(mu), _t(lv), _t(masks), _t(presence))
    want = _jax_poe_kl(mu, lv, masks, presence)
    t, b, _, l = shape
    for g, w, out_shape, atol in zip(got, want, [(t, b, l), (t, b, l), (t, b)],
                                     [1e-6, 1e-6, 1e-5 * l]):
        assert g.shape == out_shape
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=atol)
    if case == "zero_rows":
        assert torch.all(got[2][:, [0, 2]] == 0)
        assert torch.all(got[0][:, [0, 2]] == 0) and torch.all(got[1][:, [0, 2]] == 0)


@pytest.mark.parametrize("case", ["zero_rows", "no_presence"])
def test_ops_poe_kl_on_the_cpu_is_the_sequence_it_replaces(case):
    """On the CPU ``ops.poe_kl`` gives the same bits as the eval's earlier
    sequence: the mask product, ``core.product_of_experts``, then
    ``ops.kl_std_normal``."""
    mu, lv, masks, presence = _inputs((20, 6, 19, 100), case, seed=1)
    mu, lv, masks, presence = _t(mu), _t(lv), _t(masks), _t(presence)
    eff = masks[:, None, :]
    if presence is not None:
        eff = eff * presence[None]
    else:
        eff = eff.expand(masks.shape[0], mu.shape[0], masks.shape[1])
    fused_mu, fused_lv = core.product_of_experts(mu[None], lv[None], mask=eff)
    kl = ops.kl_std_normal(fused_mu, fused_lv)
    got = ops.poe_kl(mu, lv, masks, presence)
    for g, w in zip(got, (fused_mu, fused_lv, kl)):
        assert torch.equal(g, w)


def test_ops_poe_kl_kernel_backend_raises_on_the_cpu():
    """Under the "kernel" backend CPU tensors raise, and a presence that
    requires grad raises first (only the expert stack is differentiated);
    under "torch" the plain version runs."""
    mu, lv, masks, presence = (_t(a) for a in _inputs((3, 10, 2, 64), "zero_rows"))
    try:
        ops.set_backend("kernel")
        with pytest.raises(ValueError, match="CUDA"):
            ops.poe_kl(mu, lv, masks, presence)
        with pytest.raises(ValueError, match="CUDA"):
            ops.poe_kl(mu.requires_grad_(True), lv, masks, presence)
        with pytest.raises(RuntimeError, match="ops.poe_kl: .*backward .*is not yet ported"):
            ops.poe_kl(mu, lv, masks, presence.requires_grad_(True))
        ops.set_backend("torch")
        assert ops.poe_kl(mu, lv, masks)[2].shape == (3, 10)
    finally:
        ops.set_backend("auto")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.poe_kl_kernel(mu, lv, masks)


def _jax_poe_kl_grads(mu, lv, masks, presence, g_mu, g_lv, g_kl):
    """``jax.grad`` in the expert stack of sum(g_mu * mu_f + g_lv * lv_f +
    g_kl * kl): the masked PoE then the KL, as the JAX step computes them."""
    eff = masks[:, None, :] if presence is None else masks[:, None, :] * presence[None]
    eff = jnp.asarray(np.broadcast_to(eff, (masks.shape[0], mu.shape[0], masks.shape[1])))

    def loss(m, v):
        mu_f, lv_f = jcore.product_of_experts(m[None], v[None], mask=eff)
        kl = jcore.kl_std_normal(mu_f, lv_f)
        return jnp.sum(g_mu * mu_f) + jnp.sum(g_lv * lv_f) + jnp.sum(g_kl * kl)

    return [np.asarray(a) for a in jax.grad(loss, (0, 1))(jnp.asarray(mu), jnp.asarray(lv))]


def _torch_poe_kl_grads(mu, lv, masks, presence, g_mu, g_lv, g_kl):
    """The same gradients through ``ops.poe_kl`` on the CPU (its plain
    backward, ``kernels.poe_kl_grad_torch``)."""
    mu_t, lv_t = _t(mu).requires_grad_(True), _t(lv).requires_grad_(True)
    mu_f, lv_f, kl = ops.poe_kl(mu_t, lv_t, _t(masks), _t(presence))
    loss = (mu_f * _t(g_mu)).sum() + (lv_f * _t(g_lv)).sum() + (kl * _t(g_kl)).sum()
    return [a.numpy() for a in torch.autograd.grad(loss, (mu_t, lv_t))]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_poe_kl_plain_grad_matches_jax_grad(shape, case):
    """d mu_e and d lv_e of ``ops.poe_kl``'s plain backward against
    ``jax.grad`` of the JAX PoE and KL, with random output gradients."""
    t, b, _, l = shape
    mu, lv, masks, presence = _inputs(shape, case, seed=2)
    rng = np.random.default_rng(3)
    grads = (rng.normal(size=(t, b, l)).astype(np.float32),
             rng.normal(size=(t, b, l)).astype(np.float32),
             rng.normal(size=(t, b)).astype(np.float32))
    want = _jax_poe_kl_grads(mu, lv, masks, presence, *grads)
    got = _torch_poe_kl_grads(mu, lv, masks, presence, *grads)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-5 * np.abs(w).max())
    if case == "zero_rows":
        assert np.all(got[0][[0, 2]] == 0) and np.all(got[1][[0, 2]] == 0)


def test_poe_clamp_ties_take_half_the_gradient_as_jnp_clip():
    """B = 1, M = 2, the three mvae terms, loss sum(kl) + sum(mu_f) +
    sum(lv_f). Expert log-variances (11, -11, 3, 15; 0.5, 11, -2, -14):
    at exactly +-11 ``jnp.clip`` passes half the gradient (``torch.clamp``
    passed all of it, twice JAX's d lv_e), inside the range all of it,
    beyond none. Both the fused op and ``core.product_of_experts``."""
    mu = np.asarray([[[0.3, -0.2, 0.7, 0.1], [-0.4, 0.6, 0.2, -0.5]]], np.float32)
    lv = np.asarray([[[11.0, -11.0, 3.0, 15.0], [0.5, 11.0, -2.0, -14.0]]], np.float32)
    masks = np.asarray(jcore.elbo_subset_masks(2))
    ones = (np.ones((3, 1, 4), np.float32),) * 2 + (np.ones((3, 1), np.float32),)
    want = _jax_poe_kl_grads(mu, lv, masks, None, *ones)
    got = _torch_poe_kl_grads(mu, lv, masks, None, *ones)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-8)
    assert want[1][0, 1, 3] == 0 and got[1][0, 1, 3] == 0  # beyond the clamp
    lv_t = _t(lv).requires_grad_(True)
    eff = _t(masks)[:, None, :]
    mu_f, lv_f = core.product_of_experts(_t(mu)[None], lv_t[None], mask=eff)
    (core.kl_std_normal(mu_f, lv_f).sum() + mu_f.sum() + lv_f.sum()).backward()
    np.testing.assert_allclose(lv_t.grad.numpy(), want[1], rtol=RTOL, atol=1e-8)


def test_plain_backward_clamp_grad_is_the_forward_clamps():
    """The plain backward's clamp gradient, written out as the kernel's,
    equals autograd's through ``core.poe.clamp_logvar`` at, inside and beyond
    the bound, so the forward's clamp and the backward cannot split."""
    bound = core.poe.LOGVAR_BOUND
    lv = torch.tensor([-bound - 1, -bound, -bound + 1e-3, 0.0, 2.5, bound, bound + 3])
    x = lv.clone().requires_grad_(True)
    core.poe.clamp_logvar(x).sum().backward()
    torch.testing.assert_close(kernels._clamp_grad(lv), x.grad, rtol=0, atol=0)


def test_poe_grad_keeps_a_nan_log_variance():
    """A NaN log-variance stays NaN through the clamp, forward and back."""
    mu, lv, masks, _ = _inputs((3, 4, 2, 8), "all_present")
    lv[1, 0, 3] = np.nan
    mu_t, lv_t = _t(mu).requires_grad_(True), _t(lv).requires_grad_(True)
    mu_f, lv_f, kl = ops.poe_kl(mu_t, lv_t, _t(masks))
    assert torch.isnan(lv_f[:2, 1, 3]).all() and torch.isfinite(lv_f[:, 0]).all()
    kl.sum().backward()
    assert torch.isnan(lv_t.grad[1, 0, 3]) and torch.isfinite(lv_t.grad[0]).all()
