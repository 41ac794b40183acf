"""The port's b-major term fold against the JAX package's, on the CPU.

``multi_term_loss(term_fold="b")`` of the port against the JAX loss under
the same fold without a mesh (``mmvae_tpu/train/step.py:579-631``): the
JAX models are initialised from a seed at small widths, their parameters
move across with ``convert.from_flax_params``, both sides see the same
numpy batch, and the JAX loss's own draws are handed to the port: the
noise ``normal(split(rng)[1], (B, T, L))`` (the fold's ``(B, T, L)``
layout), the random subset masks of ``split(rng)[0]`` and, under mvtcae,
the cycle noise of ``fold_in(rng_z, 1 + s)``. The loss and every metric
at rtol 2e-4 (XLA-CPU transcendentals are approximate, docs/DESIGN.md
section 7), each gradient tensor at rtol 2e-4 with an atol of 2e-4 of its
largest element, as ``tests/test_torch_train.py`` holds the t fold.

Beside it: the port's ``"b"`` and ``"t"`` folds against each other on the
same noise (rel 1e-5), the plain K2 VJP at the b-major map over examples
of several rows against ``jax.vjp`` of the JAX ``bernoulli_nll`` on
b-tiled attribute rows, and ``_tile_terms`` / ``_tile_terms_tmajor``
against the port's ``tile_rows``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import ops as j_ops
from mmvae_tpu.core import random_subset_masks as j_random_subset_masks
from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
from mmvae_tpu.models import CubMVAE as JCubMVAE
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.models import MultiMnistMVAE as JMultiMnistMVAE
from mmvae_tpu.train import step as j_step_module
from mmvae_tpu.train.step import _tile_terms, _tile_terms_tmajor
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import make_celeba, make_cub, make_mnist, make_multimnist
from mmvae_torch.models import CelebAMVAE, CubMVAE, MnistMVAE, MultiMnistMVAE
from mmvae_torch.ops import kernels
from mmvae_torch.train import multi_term_loss
from torch_threads import _one_torch_thread  # noqa: F401

RTOL = 2e-4
B = 4

# name -> (JAX class, port class, model kwargs, batch maker)
MODELS = {
    "mnist": (JMnistMVAE, MnistMVAE, dict(n_latents=8), lambda: make_mnist(B, seed=5)),
    "multimnist": (JMultiMnistMVAE, MultiMnistMVAE,
                   dict(n_latents=8, conv_features=(4, 8), text_embed=8, text_hidden=16,
                        text_latent_dims=4, lambda_text=30.0),
                   lambda: make_multimnist(B, seed=5)),
    "celeba": (JCelebAMVAE, CelebAMVAE, dict(n_latents=8, image_hw=(32, 32),
                                             conv_features=(32, 16)),
               lambda: make_celeba(B, seed=5, hw=32)),
    "cub": (JCubMVAE, CubMVAE, dict(n_latents=8, vocab_size=23, image_hw=(16, 16),
                                    conv_features=(8, 16)),
            lambda: make_cub(B, seed=5, hw=16)),
}

# case -> (model, loss knobs); every mvae case but the decode-all one is
# member-pruned. Each case is a JAX compile of its own, so one case holds
# knobs that compose: CelebA's random subsets with the first one empty,
# MNIST's cross-reconstruction with the unimodal alignment.
CASES = {
    "mnist_pruned": ("mnist", {}),
    "mnist_decode_all": ("mnist", dict(member_prune=False)),
    "multimnist_cycle": ("multimnist", dict(cross_recon=True, cycle_weight=1.0)),
    "celeba_subsets_one_empty": ("celeba", dict(n_random_subsets=4)),
    "cub_cycle": ("cub", dict(cross_recon=True, cycle_weight=0.1, cycle_render_grad=True)),
    "mnist_mmvae": ("mnist", dict(objective="mmvae")),
    "mnist_mopoe": ("mnist", dict(objective="mopoe")),
    "mnist_mvtcae": ("mnist", dict(objective="mvtcae", mvtcae_alpha=0.8)),
    "mnist_cross_recon_align": ("mnist", dict(cross_recon=True, cross_recon_weight=2.5,
                                              unimodal_align_weight=0.1)),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    """Each model's JAX module, its init parameters (``init`` jitted: one
    compile a model, against a compile for each op of an eager init) and
    its batch."""
    out = {}
    for name, (jcls, _, kw, make) in MODELS.items():
        jm = jcls(**kw)
        batch = make()
        params = jax.jit(lambda b, jm=jm: jm.init(jax.random.key(0), b, rng=jax.random.key(1)))(
            {k: jnp.asarray(v) for k, v in batch.items()})["params"]
        out[name] = (jm, params, batch)
    return out


def _port_model(name: str, params):
    _, cls, kw, _ = MODELS[name]
    model = cls(**kw)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    return model


def _n_terms(jm, knobs: dict) -> int:
    objective = knobs.get("objective", "mvae")
    if objective == "mvtcae":
        return 1
    if objective == "mmvae":
        return jm.n_modalities
    if objective == "mopoe":
        return 2**jm.n_modalities - 1
    return 1 + jm.n_modalities + knobs.get("n_random_subsets", 0)


@pytest.mark.parametrize("case", list(CASES))
def test_b_fold_matches_jax(models, case, monkeypatch):
    """The loss, every metric and every gradient of the port's ``"b"``
    fold against ``jax.value_and_grad`` of the JAX loss under ``"b"``
    (beta 0.3), with JAX's draws passed in. ``celeba_subsets_one_empty``
    makes the first of the 4 random subsets empty on both sides (JAX's mask
    draw patched): it fuses to the prior and reconstructs nothing."""
    name, knobs = CASES[case]
    jm, params, batch = models[name]
    rng = jax.random.key(3)
    rng_subset, rng_z = jax.random.split(rng)
    k = knobs.get("n_random_subsets", 0)
    masks = None
    if k:
        masks = np.array(j_random_subset_masks(rng_subset, k, jm.n_modalities))
        if case == "celeba_subsets_one_empty":
            masks[0] = 0.0
            monkeypatch.setattr(j_step_module, "random_subset_masks",
                                lambda *_: jnp.asarray(masks))
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda q: j_multi_term_loss(jm, q, {k_: jnp.asarray(v) for k_, v in batch.items()},
                                    rng, 0.3, sample=True, term_fold="b", **knobs),
        has_aux=True))(params)
    n_lat = MODELS[name][2]["n_latents"]
    eps = _t(jax.random.normal(rng_z, (B, _n_terms(jm, knobs), n_lat)))
    cycle_eps = None
    if knobs.get("objective") == "mvtcae" and knobs.get("cycle_weight"):
        cycle_eps = _t(jax.random.normal(jax.random.fold_in(rng_z, 2), (B, n_lat)))[None]
    model = _port_model(name, params)
    loss, metrics = multi_term_loss(
        model, {k_: _t(v) for k_, v in batch.items()}, 0.3, term_fold="b", eps=eps,
        subset_masks=None if masks is None else _t(masks), cycle_eps=cycle_eps, **knobs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    assert set(metrics) == set(j_metrics)
    for key, want in j_metrics.items():
        np.testing.assert_allclose(metrics[key].detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-3, err_msg=key)
    want = from_flax_params(_np_tree(j_grads))
    got = {key: p.grad for key, p in model.named_parameters()}
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=RTOL,
                                   atol=2e-4 * w.abs().max().item(), err_msg=key)


@pytest.mark.parametrize("case", ["mnist_pruned", "celeba_subsets_one_empty",
                                  "multimnist_cycle"])
def test_b_and_t_folds_agree(models, case):
    """The port's ``"b"`` and ``"t"`` folds on the same noise (``(B, T,
    L)`` and its transpose) and masks: the loss and every gradient at rel
    1e-5."""
    name, knobs = CASES[case]
    jm, params, batch = models[name]
    gen = torch.Generator().manual_seed(0)
    eps = torch.randn((B, _n_terms(jm, knobs), MODELS[name][2]["n_latents"]), generator=gen)
    k = knobs.get("n_random_subsets", 0)
    masks = (torch.rand((k, jm.n_modalities), generator=gen) < 0.5).float() if k else None
    if case == "celeba_subsets_one_empty":
        masks[0] = 0.0
    out = {}
    for fold, e in (("b", eps), ("t", eps.transpose(0, 1).contiguous())):
        model = _port_model(name, params)
        loss, _ = multi_term_loss(model, {k_: _t(v) for k_, v in batch.items()}, 0.3,
                                  term_fold=fold, eps=e, subset_masks=masks, **knobs)
        loss.backward()
        out[fold] = (loss.item(), {key: p.grad.clone() for key, p in model.named_parameters()})
    np.testing.assert_allclose(out["b"][0], out["t"][0], rtol=1e-5)
    for key, w in out["t"][1].items():
        torch.testing.assert_close(out["b"][1][key], w, rtol=1e-5,
                                   atol=1e-5 * w.abs().max().item())


@pytest.mark.parametrize("shape", [(4, 23, 18), (3, 5, 5), (2, 1, 2)])
def test_plain_bce_grad_at_the_inner_map_matches_jax(shape):
    """``bce_rows_grad_torch`` at the b-major map over examples of several
    rows (CelebA's attributes under the ``"b"`` fold: logits row ``(b * k +
    t) * A + a`` reads target row ``b * A + a``) against ``jax.vjp`` of the
    JAX ``ops.bernoulli_nll`` on the ``(B * k, A)`` logits and the ``(B,
    A)`` attributes at ``event_ndims=0``, which the JAX ops layer tiles
    b-major (``mmvae_tpu/ops/__init__.py:95-111``)."""
    n_b, k, inner = shape
    rs = np.random.default_rng(0)
    logits = (3.0 * rs.standard_normal((n_b * k, inner))).astype(np.float32)
    x = (rs.random((n_b, inner)) < 0.5).astype(np.float32)
    g = rs.standard_normal((n_b * k, inner)).astype(np.float32)
    _, vjp = jax.vjp(lambda lg: j_ops.bernoulli_nll(lg, jnp.asarray(x), 0), jnp.asarray(logits))
    (want,) = vjp(jnp.asarray(g))
    got = kernels.bce_rows_grad_torch(
        torch.from_numpy(logits).reshape(-1, 1), torch.from_numpy(x).reshape(-1, 1),
        torch.from_numpy(g).reshape(-1), kernels.FOLD_B, inner)
    np.testing.assert_allclose(got.reshape(n_b * k, inner).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_tile_terms_match_jax(k):
    """``_tile_terms`` (b-major) and ``_tile_terms_tmajor`` of the JAX step
    against the port's ``tile_rows`` in ``FOLD_B`` and ``FOLD_T``, on
    integer token rows and on float rows."""
    rs = np.random.default_rng(1)
    tree = {"text": rs.integers(0, 13, (5, 7)).astype(np.int32),
            "image": rs.random((5, 3, 2)).astype(np.float32)}
    for j_tile, fold in ((_tile_terms, kernels.FOLD_B), (_tile_terms_tmajor, kernels.FOLD_T)):
        want = j_tile({key: jnp.asarray(v) for key, v in tree.items()}, k)
        for key, v in tree.items():
            got = kernels.tile_rows(torch.from_numpy(v), 5 * k, fold)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[key]))
