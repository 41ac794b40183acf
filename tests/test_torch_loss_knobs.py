"""The three loss knobs no named config sets, against the JAX package, on the CPU.

``cross_recon_stopgrad`` (the cross entries from a second decode-all pass on
detached decoders), ``unimodal_align_weight`` (the non-joint posteriors
pulled toward the detached joint one, ramped by beta) and
``cycle_contrast_weight`` (the soft render's pixel mean and population std
matched to the true image's) on the JAX ``MultiMnistMVAE`` at the small
widths of ``tests/test_torch_multimnist_train.py`` (n_latents 8, conv
features (4, 8), text embed 8, hidden 16, a text expert on the first 4
latent dims, lambda_text 30), weights moved across with
``convert.from_flax_params``, batch 8. The posterior noise and the random
subset masks are the JAX loss's own draws (the normal of ``split(rng)[1]``,
``random_subset_masks(split(rng)[0], k, M)``), passed in. Where the cycle
term thresholds its render (``"both"``), JAX's own 0/1 mask is fed into the
port's straight-through binarize, as in
``tests/test_torch_multimnist_train.py``, and the port's own threshold is
checked to flip no pixel.

Tolerances as in ``tests/test_torch_train.py``: rtol 2e-4 (XLA-CPU
transcendentals are approximate, docs/DESIGN.md section 7), each gradient
tensor with an atol of 2e-4 of its largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import elbo_subset_masks as j_elbo_subset_masks
from mmvae_tpu.core import product_of_experts as j_product_of_experts
from mmvae_tpu.core import random_subset_masks as j_random_subset_masks
from mmvae_tpu.core import reparameterize as j_reparameterize
from mmvae_tpu.models import MultiMnistMVAE as JMultiMnistMVAE
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import make_multimnist
from mmvae_torch.models import MultiMnistMVAE
from mmvae_torch.train import make_train_step, multi_term_loss
from mmvae_torch.train import step as step_module
from torch_threads import _one_torch_thread  # noqa: F401

N_LATENTS, B, M = 8, 8, 2
SMALL = dict(conv_features=(4, 8), text_embed=8, text_hidden=16, text_latent_dims=4,
             lambda_text=30.0)
RTOL = 2e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tbatch(batch) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads_close(got: dict[str, torch.Tensor], want: dict[str, torch.Tensor]) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 2e-4 * w.abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL, atol=atol, err_msg=k)


def _batch(with_presence: bool, seed: int = 5):
    """A batch of 8; with a presence mask dropping row 1's text, row 2's
    image and all of row 3."""
    batch = make_multimnist(B, seed=seed)
    if with_presence:
        presence = np.ones((B, M), np.float32)
        presence[1, 1] = presence[2, 0] = 0.0
        presence[3] = 0.0
        batch = dict(batch, presence=presence)
    return batch


@pytest.fixture(scope="module")
def jmodel():
    return JMultiMnistMVAE(n_latents=N_LATENTS, **SMALL)


@pytest.fixture(scope="module")
def init_params(jmodel):
    return jmodel.init(jax.random.key(0), _jbatch(_batch(False)), rng=jax.random.key(1))["params"]


def _tmodel(params) -> MultiMnistMVAE:
    model = MultiMnistMVAE(n_latents=N_LATENTS, **SMALL)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    return model


def _draws(rng, k: int):
    """The random subset masks and the noise JAX's loss draws from ``rng``."""
    rng_subset, rng_z = jax.random.split(rng)
    out = {"eps": torch.from_numpy(np.asarray(
        jax.random.normal(rng_z, (1 + M + k, B, N_LATENTS))))}
    if k:
        out["subset_masks"] = torch.from_numpy(np.asarray(
            j_random_subset_masks(rng_subset, k, M)))
    return out


def _match_jax(jmodel, params, batch, rng, beta, knobs, monkeypatch=None):
    """The port's loss, metrics and gradients against JAX's for ``knobs``;
    returns the port's metrics."""

    @jax.jit
    def loss_and_grad(q):
        return jax.value_and_grad(
            lambda p: j_multi_term_loss(jmodel, p, _jbatch(batch), rng, beta, sample=True,
                                        term_fold="t", **knobs), has_aux=True)(q)

    (j_loss, j_metrics), j_grads = loss_and_grad(params)
    model = _tmodel(params)
    loss, metrics = multi_term_loss(model, _tbatch(batch), beta, **knobs,
                                    **_draws(rng, knobs.get("n_random_subsets", 0)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    assert set(metrics) == set(j_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(j_metrics[k]), rtol=RTOL,
                                   atol=1e-3 if v.ndim else 0, err_msg=k)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))
    return metrics, model


@pytest.mark.parametrize("with_presence", [False, True])
def test_cross_recon_stopgrad_matches_jax(jmodel, init_params, with_presence):
    """Cross-recon at weight 2 with the cross entries from detached
    decoders: the loss, the metrics and every gradient against JAX; the
    forward is that of plain cross-recon, and the decoders' gradients are
    not."""
    batch = _batch(with_presence)
    knobs = dict(cross_recon=True, cross_recon_weight=2.0, cross_recon_stopgrad=True)
    metrics, model = _match_jax(jmodel, init_params, batch, jax.random.key(3), 0.4, knobs)
    plain = _tmodel(init_params)
    loss, _ = multi_term_loss(plain, _tbatch(batch), 0.4, cross_recon=True,
                              cross_recon_weight=2.0, **_draws(jax.random.key(3), 0))
    loss.backward()
    assert loss.item() == metrics["loss"].item()
    grads = dict(model.named_parameters())
    for name, p in plain.named_parameters():
        if name.split(".", 1)[0].endswith("_enc"):
            continue
        assert not torch.allclose(p.grad, grads[name].grad), name


@pytest.mark.parametrize("with_presence", [False, True])
def test_unimodal_align_matches_jax(jmodel, init_params, with_presence):
    """``unimodal_align_weight`` 0.5 at beta 0.3 over the joint, the two
    unimodal and two random subset terms (JAX's masks passed in), with and
    without presence (an empty effective term aligns nothing): the loss,
    ``align_kl`` and every gradient against JAX."""
    knobs = dict(unimodal_align_weight=0.5, n_random_subsets=2)
    rng = jax.random.key(8)
    metrics, _ = _match_jax(jmodel, init_params, _batch(with_presence), rng, 0.3, knobs)
    assert metrics["align_kl"].item() > 0


@pytest.mark.parametrize("with_presence", [False, True])
def test_cycle_contrast_matches_jax(jmodel, init_params, with_presence):
    """The cycle term on the soft render with its decoder live and the
    contrast penalty at weight 3 (presence times the text's row): the loss,
    ``cycle_ce``, ``cycle_contrast`` and every gradient against JAX."""
    knobs = dict(cycle_weight=1.0, cycle_render_grad=True, cycle_contrast_weight=3.0)
    metrics, _ = _match_jax(jmodel, init_params, _batch(with_presence, seed=6),
                            jax.random.key(4), 0.5, knobs)
    assert metrics["cycle_contrast"].item() > 0


def _j_render(jmodel, params, batch, rng):
    """JAX's soft render of the text's unimodal z (``step.py:871-885``)."""
    mu_e, lv_e = jmodel.apply({"params": params}, batch, method="encode")
    eff = jnp.broadcast_to(j_elbo_subset_masks(M)[:, None, :], (1 + M, B, M))
    mu_f, lv_f = j_product_of_experts(mu_e[None], lv_e[None], mask=eff)
    z = j_reparameterize(jax.random.split(rng)[1], mu_f, lv_f)
    return jax.nn.sigmoid(jmodel.apply({"params": params}, z[2], method="decode")["image"])


def test_the_three_knobs_together_match_jax(jmodel, init_params, monkeypatch):
    """The ``multimnist`` config's loss (cross-recon, the cycle term on both
    render forms with a live render) with all three knobs as the card's
    ``multimnist_knobs_train`` path sets them (stop-gradient cross entries,
    align 0.1, contrast 1.0), JAX's hard render mask fed in: the loss, every
    metric and every gradient against JAX."""
    batch = _batch(False)
    rng = jax.random.key(3)
    hard = torch.from_numpy(
        np.asarray(jax.jit(_j_render, static_argnums=0)(jmodel, init_params, _jbatch(batch), rng))
        > 0.5).to(torch.float32)
    flips = []

    def fed(p):
        flips.append(int(((p.detach() > 0.5).float() != hard).sum()))
        return p + (hard - p).detach()

    monkeypatch.setattr(step_module, "_straight_through", fed)
    knobs = dict(cross_recon=True, cross_recon_stopgrad=True, unimodal_align_weight=0.1,
                 cycle_weight=1.0, cycle_render_grad=True, cycle_render_binarize="both",
                 cycle_contrast_weight=1.0)
    metrics, _ = _match_jax(jmodel, init_params, batch, rng, 0.3, knobs)
    assert flips == [0]
    assert {"align_kl", "cycle_ce", "cycle_contrast"} <= set(metrics)


@pytest.mark.parametrize("shape", [(4, 50, 50), (3, 7), (2, 5, 6, 3)])
def test_moment_gap_uses_the_population_std(shape):
    """The penalty against ``jnp.mean``/``jnp.std`` (the population std) on
    the same arrays; ``torch.std``'s default (``correction=1``) would give
    another number."""
    rng = np.random.default_rng(0)
    r, x = rng.random(shape, dtype=np.float32), rng.random(shape, dtype=np.float32)
    ax = tuple(range(1, len(shape)))
    want = ((jnp.mean(r, axis=ax) - jnp.mean(x, axis=ax)) ** 2
            + (jnp.std(r, axis=ax) - jnp.std(x, axis=ax)) ** 2)
    got = step_module._moment_gap(torch.from_numpy(r), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    dims = tuple(range(1, len(shape)))
    tr, tx = torch.from_numpy(r), torch.from_numpy(x)
    sample_std = ((tr.mean(dims) - tx.mean(dims)) ** 2 + (tr.std(dims) - tx.std(dims)) ** 2)
    assert not torch.allclose(sample_std, got, rtol=1e-4, atol=0)


@pytest.mark.parametrize(
    "knobs,match",
    [(dict(cross_recon_stopgrad=True), "requires cross_recon=True"),
     (dict(cycle_contrast_weight=1.0), "requires cycle_weight > 0")])
def test_knobs_without_their_partner_raise_as_in_jax(jmodel, init_params, knobs, match):
    """``cross_recon_stopgrad`` without ``cross_recon`` and
    ``cycle_contrast_weight`` without ``cycle_weight`` raise JAX's
    ``ValueError`` from the loss and from the step's builder, as the JAX
    loss does."""
    model = _tmodel(init_params)
    with pytest.raises(ValueError, match=match):
        multi_term_loss(model, _tbatch(_batch(False)), **knobs)
    with pytest.raises(ValueError, match=match):
        make_train_step(model, **knobs)
    with pytest.raises(ValueError, match=match):
        j_multi_term_loss(jmodel, init_params, _jbatch(_batch(False)), jax.random.key(0), 1.0,
                          term_fold="t", **knobs)


def test_api_train_with_the_three_knobs():
    """``api.train`` of the ``multimnist`` config at a small width with the
    three knobs: one epoch of 3 batches, ``cycle_ce``, ``cycle_contrast``
    and ``align_kl`` in the history, all finite; ``step_options`` hands the
    knobs to the step."""
    cfg = configs.get_config("multimnist").replace(
        n_latents=N_LATENTS, epochs=1, train_size=24, test_size=16, batch_size=B,
        model_kwargs=SMALL, cross_recon_stopgrad=True, unimodal_align_weight=0.1,
        cycle_contrast_weight=1.0)
    options = api.step_options(cfg)
    assert (options["cross_recon_stopgrad"], options["unimodal_align_weight"],
            options["cycle_contrast_weight"]) == (True, 0.1, 1.0)
    result = api.train(cfg, device="cpu", verbose=False)
    record = result.history[0]
    assert set(record) == {"epoch", "train_loss", "cycle_ce", "cycle_contrast", "align_kl",
                           "test_elbo"}
    assert all(np.isfinite(v) for v in record.values())
