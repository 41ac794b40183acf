"""The port's CelebA training slice against the JAX package, on the CPU.

The JAX ``CelebAMVAE`` is initialised from a seed at the small widths of
``tests/test_torch_celeba.py`` (n_latents 8, 32x32 RGB images, conv
features (32, 16), the 18 attribute experts at full width), its parameters
move across with ``convert.from_flax_params``, and both sides see the same
numpy batch. The loss is the ``celeba`` config's: the joint, 19 unimodal
and 4 random subset terms (T = 24), t-fold, member-pruned. The random
subset masks and the posterior noise of each step are the JAX step's own
draws (``random_subset_masks(split(rng)[0], 4, 19)`` and the normal of
``split(rng)[1]``, ``mmvae_tpu/train/step.py:471-496``), handed to the port
as ``subset_masks`` and ``eps``, as ``tests/test_torch_train.py`` hands it
the noise.

Tolerances as in ``tests/test_torch_train.py``: one loss evaluation at
rtol 2e-4 (XLA-CPU transcendentals are approximate, docs/DESIGN.md
section 7), each gradient tensor with an atol of 2e-4 of its largest
element; Adam steps by the relative 2-norm of the two updates' difference
(below 1e-4) and elementwise within 1e-4. The stage-0 conv's plain
gradient against ``jax.vjp`` of the probe's XLA form at rtol 2e-4, atol
2e-4 of each gradient's largest element.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import configs as jconfigs
from mmvae_tpu.core import random_subset_masks as j_random_subset_masks
from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
from mmvae_tpu.train import step as j_step_module
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_tpu.train.step import make_train_step as j_make_train_step
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.core import random_subset_masks
from mmvae_torch.data import make_celeba
from mmvae_torch.models import CelebAMVAE
from mmvae_torch.ops import kernels
from mmvae_torch.train import create_train_state, make_train_step, multi_term_loss
from tools.pallas_conv_probe import xla_conv0

N_LATENTS, B, M, K = 8, 4, 19, 4
T = 1 + M + K
HW = 32
SMALL = dict(image_hw=(HW, HW), conv_features=(32, 16))
RTOL = 2e-4
STEP_ATOL = 1e-4
STEP_REL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tmodel(params) -> CelebAMVAE:
    model = CelebAMVAE(n_latents=N_LATENTS, **SMALL)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    return model


def _tbatch(batch) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _draws(rng) -> tuple[torch.Tensor, torch.Tensor]:
    """The random subset masks and the noise JAX's ``multi_term_loss``
    draws from ``rng``."""
    rng_subset, rng_z = jax.random.split(rng)
    masks = j_random_subset_masks(rng_subset, K, M)
    eps = jax.random.normal(rng_z, (T, B, N_LATENTS))
    return torch.from_numpy(np.array(masks)), torch.from_numpy(np.array(eps))


def _batches(n: int, seed: int = 5):
    data = make_celeba(n * B, seed=seed, hw=HW)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(n)]


@pytest.fixture(scope="module")
def jmodel():
    return JCelebAMVAE(n_latents=N_LATENTS, **SMALL)


@pytest.fixture(scope="module")
def init_params(jmodel):
    return jmodel.init(jax.random.key(0), _jbatch(_batches(1)[0]), rng=jax.random.key(1))["params"]


def _grads_close(got: dict[str, torch.Tensor], want: dict[str, torch.Tensor]) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 2e-4 * w.abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL, atol=atol, err_msg=k)


def _loss_matches_jax(jmodel, init_params, rng, masks: torch.Tensor, eps: torch.Tensor):
    """JAX's loss, metrics and gradients at ``rng`` (beta 0.3) against the
    port's given ``masks`` and ``eps``; returns the port's metrics."""
    batch = _batches(1)[0]

    def loss_fn(params):
        return j_multi_term_loss(jmodel, params, _jbatch(batch), rng, 0.3, n_random_subsets=K,
                                 sample=True, term_fold="t")

    (j_loss, j_metrics), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(init_params)
    model = _tmodel(init_params)
    loss, metrics = multi_term_loss(model, _tbatch(batch), 0.3, n_random_subsets=K,
                                    subset_masks=masks, eps=eps)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    assert metrics["elbo_per_term"].shape == (T,)
    for k in ("recon_per_term", "kl_per_term", "elbo_per_term"):
        np.testing.assert_allclose(
            metrics[k].detach().numpy(), np.asarray(j_metrics[k]), rtol=RTOL, atol=1e-3)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))
    return metrics


def test_loss_metrics_and_every_gradient_match_jax_at_24_terms(jmodel, init_params):
    """One loss evaluation of the train step with 4 random subsets (T =
    24): the loss, the per-term metrics and every parameter's gradient
    against ``jax.value_and_grad`` of the JAX loss, JAX's masks passed in."""
    rng = jax.random.key(3)
    masks, eps = _draws(rng)
    assert masks.shape == (K, M) and 0 < masks.sum() < K * M
    _loss_matches_jax(jmodel, init_params, rng, masks, eps)


def test_an_empty_random_subset_matches_jax(jmodel, init_params, monkeypatch):
    """Random rows JAX would draw only once in 2^19 steps, set in JAX's step
    (its ``random_subset_masks`` patched in the test) and handed to the
    port: an all-zero row (the prior, KL exactly 0, nothing reconstructed)
    beside a full one and single modalities."""
    masks = np.zeros((K, M), np.float32)
    masks[1] = 1.0
    masks[2, 0] = 1.0
    masks[3, [3, 7, 11]] = 1.0
    monkeypatch.setattr(j_step_module, "random_subset_masks",
                        lambda rng, k, m, dtype=jnp.float32: jnp.asarray(masks, dtype))
    rng = jax.random.key(4)
    _, eps = _draws(rng)
    metrics = _loss_matches_jax(jmodel, init_params, rng, torch.from_numpy(masks), eps)
    empty = 1 + M  # the first random row
    assert metrics["kl_per_term"][empty].item() == 0.0
    assert metrics["recon_per_term"][empty].item() == 0.0


def test_masks_are_drawn_from_the_generator_before_the_noise(init_params):
    """Without ``subset_masks`` and ``eps`` the loss draws the masks, then
    the noise, from its generator: the same loss as those draws passed in."""
    batch = _tbatch(_batches(1)[0])
    gen = torch.Generator().manual_seed(9)
    masks = random_subset_masks(gen, K, M)
    eps = torch.randn((T, B, N_LATENTS), generator=gen)
    model = _tmodel(init_params)
    drawn, _ = multi_term_loss(model, batch, 0.5, n_random_subsets=K,
                               generator=torch.Generator().manual_seed(9))
    fed, _ = multi_term_loss(model, batch, 0.5, n_random_subsets=K, subset_masks=masks, eps=eps)
    assert drawn.item() == fed.item()


def test_five_clipped_train_steps_match_jax(jmodel):
    """Five steps of the ``celeba`` step (4 random subsets, clipping at
    500, beta ramping over 4 steps) from the JAX init, each step's masks
    and noise JAX's own: loss, beta and the raw gradient norm each step,
    the parameters after."""
    batches = _batches(5)
    state = j_create_train_state(jmodel, _jbatch(batches[0]), jax.random.key(7), 1e-3,
                                 grad_clip=500.0)
    init = _np_tree(state.params)
    j_step = j_make_train_step(jmodel, n_random_subsets=K, annealing_steps=4, term_fold="t")
    model = _tmodel(init)
    t_state = create_train_state(model, 1e-3, grad_clip=500.0)
    step = make_train_step(model, n_random_subsets=K, annealing_steps=4)
    clipped = 0
    for batch in batches:
        masks, eps = _draws(jax.random.split(state.rng, 3)[0])
        state, j_metrics = j_step(state, _jbatch(batch))
        t_state, metrics = step(t_state, _tbatch(batch), eps=eps, subset_masks=masks)
        assert metrics["beta"].item() == float(j_metrics["beta"])
        np.testing.assert_allclose(metrics["loss"].item(), float(j_metrics["loss"]), rtol=RTOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(j_metrics["grad_norm"]),
                                   rtol=1e-4)
        clipped += metrics["grad_norm"].item() > 500.0
    assert clipped > 0  # the clip fires
    assert t_state.step == int(state.step) == 5
    want = from_flax_params(_np_tree(state.params))
    start = from_flax_params(init)
    got = t_state.params
    diff = sum(((got[k].detach() - w) ** 2).sum() for k, w in want.items())
    update = sum(((w - start[k]) ** 2).sum() for k, w in want.items())
    assert update > 0 and (diff / update).sqrt() < STEP_REL
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=0, atol=STEP_ATOL,
                                   err_msg=k)


def test_api_train_celeba_on_the_cpu():
    """``api.train`` of the ``celeba`` config (4 random subsets, clipping
    at 500) at a small width over its 64x64 images: one epoch of 2 batches,
    a finite train loss and test ELBO, and the same history again from the
    same seed."""
    cfg = configs.get_config("celeba").replace(
        n_latents=N_LATENTS, epochs=1, train_size=32, test_size=16, batch_size=16,
        model_kwargs=dict(conv_features=(32, 8)))
    assert (cfg.n_random_subsets, cfg.grad_clip) == (K, 500.0)
    result = api.train(cfg, device="cpu", verbose=False)
    assert result.state.step == 2 and len(result.history) == 1
    assert all(map(math.isfinite, result.history[0].values()))
    assert api.train(cfg, device="cpu", verbose=False).history == result.history


def test_step_options_are_the_jax_runner_options():
    """``api.step_options`` of ``celeba`` names only keywords of
    ``make_train_step`` and carries the JAX config's values, the random
    subsets with them."""
    options = api.step_options(configs.get_config("celeba"))
    assert set(options) <= set(inspect.signature(make_train_step).parameters)
    jcfg = jconfigs.get_config("celeba")
    assert options == {k: getattr(jcfg, k) for k in options}
    assert options["n_random_subsets"] == K


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (3, 25, 25, 1), (2, 16, 20, 2),
                                   (2, 12, 10, 4), (64, 64, 64, 3)])
def test_conv_plain_grad_matches_jax_vjp(shape):
    """``conv4x4s2_swish_grad_torch`` (dW, db) and the plain input
    gradient against ``jax.vjp`` of ``xla_conv0`` (XLA's SAME 4x4/2 conv +
    swish, NHWC, HWIO): CelebA's 64x64 RGB, a 25x25 grayscale image that
    pads (1, 2), C = 2 and 4, and CUB's train batch of 64 (the cycle
    term's re-encode takes the input gradient there)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape, dtype=np.float32)
    w = (0.1 * rng.standard_normal((32, shape[3], 4, 4))).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32)
    out, vjp = jax.vjp(xla_conv0, jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
                       jnp.asarray(b))
    g = rng.standard_normal(out.shape).astype(np.float32)  # NHWC, as XLA gives it
    j_dx, j_dw, j_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    tg = torch.from_numpy(g).permute(0, 3, 1, 2)  # the port's NCHW output
    d_w, d_b = kernels.conv4x4s2_swish_grad_torch(tx, tw, tb, tg)
    d_x = kernels.conv4x4s2_swish_input_grad_torch(tx, tw, tb, tg)
    for got, want in ((d_w, j_dw.transpose(3, 2, 0, 1)), (d_b, j_db), (d_x, j_dx)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=2e-4 * np.abs(want).max())
