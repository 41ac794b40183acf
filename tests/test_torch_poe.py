"""The fused PoE + KL of the port (``ops.poe_kl``) against the JAX package,
on the CPU.

The JAX side runs the masked PoE (``mmvae_tpu.core.product_of_experts``)
and then K1's Pallas kernel in interpret mode, as ``tests/test_pallas.py``
runs it. Inputs come from numpy seeds. The tolerance is rtol 2e-4, because
XLA-CPU transcendentals are approximate (docs/DESIGN.md section 7); the
atol covers KLs that cancel to near 0.
"""

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
    """Under the "kernel" backend CPU tensors raise, and an input that
    requires grad raises first; under "torch" the plain version runs."""
    mu, lv, masks, presence = (_t(a) for a in _inputs((3, 10, 2, 64), "zero_rows"))
    try:
        ops.set_backend("kernel")
        with pytest.raises(ValueError, match="CUDA"):
            ops.poe_kl(mu, lv, masks, presence)
        with pytest.raises(RuntimeError, match="ops.poe_kl: .*backward is not yet ported"):
            ops.poe_kl(mu, lv, masks, presence.requires_grad_(True))
        ops.set_backend("torch")
        assert ops.poe_kl(mu, lv, masks)[2].shape == (3, 10)
    finally:
        ops.set_backend("auto")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.poe_kl_kernel(mu, lv, masks)
