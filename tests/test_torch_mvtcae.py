"""The port's mvtcae objective against the JAX package, on the CPU.

The loss and every gradient of ``multi_term_loss(objective="mvtcae")``
against ``jax.value_and_grad`` of the JAX loss (``term_fold="t"``) on the
JAX ``MnistMVAE`` (n_latents 16), with and without a presence mask and at
several ``mvtcae_alpha``; alpha 0 against the joint ELBO written out; the
cycle term under mvtcae on a narrow ``MultiMnistMVAE``, whose s-only latent
is drawn from the unimodal posterior with JAX's noise
``normal(fold_in(rng_z, 1 + s))`` passed in as ``cycle_eps``; and five Adam
steps of ``make_train_step`` against the JAX step (the gradient components
both sides compute at rounding level fed from JAX, see the test). The weights move across
with ``convert.from_flax_params``; the posterior noise is JAX's, the normal
of ``split(rng)[1]``.

Tolerances as in ``tests/test_torch_train.py``: one loss evaluation at
rtol 2e-4 (XLA-CPU transcendentals are approximate, docs/DESIGN.md section
7), each gradient tensor with an atol of 2e-4 of its largest element; Adam
steps by the relative 2-norm of the two updates' difference (below 1e-4)
and elementwise within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from optax import global_norm as optax_global_norm

from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.models import MultiMnistMVAE as JMultiMnistMVAE
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.core import kl_std_normal, product_of_experts
from mmvae_torch.data import make_mnist, make_multimnist
from mmvae_torch.models import MnistMVAE, MultiMnistMVAE
from mmvae_torch.train import create_train_state, make_train_step, multi_term_loss

RTOL = 2e-4
STEP_ATOL = 1e-4
STEP_REL = 1e-4
N_LATENTS, B, M = 16, 8, 2
MM_SMALL = dict(n_latents=8, conv_features=(4, 8), text_embed=8, text_hidden=16,
                text_latent_dims=4, lambda_text=30.0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tbatch(batch) -> dict[str, torch.Tensor]:
    return {k: _t(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads_close(got: dict[str, torch.Tensor], want: dict[str, torch.Tensor]) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 2e-4 * w.abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL, atol=atol, err_msg=k)


def _batches(n: int, seed: int = 5):
    data = make_mnist(n * B, seed=seed)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(n)]


def _eps(rng, b: int = B, l: int = N_LATENTS) -> torch.Tensor:
    """The noise JAX's ``multi_term_loss`` draws from ``rng`` for its one term."""
    return _t(jax.random.normal(jax.random.split(rng)[1], (1, b, l)))


@pytest.fixture(scope="module")
def jmodel():
    return JMnistMVAE(n_latents=N_LATENTS)


@pytest.fixture(scope="module")
def init_params(jmodel):
    return jmodel.init(jax.random.key(0), _jbatch(_batches(1)[0]), rng=jax.random.key(1))["params"]


def _tmodel(params) -> MnistMVAE:
    model = MnistMVAE(n_latents=N_LATENTS)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    return model


def _presence() -> np.ndarray:
    """Row 1 without its image, row 2 without its label, row 3 with nothing."""
    presence = np.ones((B, M), np.float32)
    presence[1, 0] = presence[2, 1] = 0.0
    presence[3] = 0.0
    return presence


@pytest.mark.parametrize("alpha,with_presence", [(0.9, False), (0.9, True), (0.3, True)])
def test_loss_metrics_and_every_gradient_match_jax(jmodel, init_params, alpha, with_presence):
    """One loss evaluation of the train step (sample=True, beta 0.3): the
    joint term decoding every observed modality, its KL mixed with the
    cross-KLs to the observed unimodal posteriors (both sides get
    gradient), the loss, every metric (``cross_kl`` with them) and every
    parameter's gradient against ``jax.value_and_grad`` of the JAX loss."""
    batch = _batches(1)[0]
    if with_presence:
        batch = dict(batch, presence=_presence())
    rng = jax.random.key(3)

    @jax.jit
    def loss_and_grad(params):
        return jax.value_and_grad(
            lambda q: j_multi_term_loss(jmodel, q, _jbatch(batch), rng, 0.3, sample=True,
                                        term_fold="t", objective="mvtcae", mvtcae_alpha=alpha),
            has_aux=True)(params)

    (j_loss, j_metrics), j_grads = loss_and_grad(init_params)
    model = _tmodel(init_params)
    loss, metrics = multi_term_loss(model, _tbatch(batch), 0.3, objective="mvtcae",
                                    mvtcae_alpha=alpha, eps=_eps(rng))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    assert set(metrics) == set(j_metrics)
    np.testing.assert_allclose(metrics["cross_kl"].item(), float(j_metrics["cross_kl"]),
                               rtol=RTOL)
    for k in ("recon_per_term", "kl_per_term", "elbo_per_term"):
        np.testing.assert_allclose(metrics[k].detach().numpy(), np.asarray(j_metrics[k]),
                                   rtol=RTOL, atol=1e-3)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))


def test_alpha_zero_is_the_joint_elbo(init_params):
    """alpha 0: the mean over the batch of every modality's weighted NLL
    from the joint posterior's mean plus the joint's KL to the prior,
    written out with the port's plain parts."""
    model = _tmodel(init_params)
    batch = _tbatch(_batches(1)[0])
    with torch.no_grad():
        got, _ = multi_term_loss(model, batch, 1.0, sample=False, objective="mvtcae",
                                 mvtcae_alpha=0.0)
        mu_e, lv_e = model.encode(batch)
        mu, lv = product_of_experts(mu_e, lv_e)
        nll = model.nll_all(model.decode(mu), batch)  # (M, B)
        want = torch.mean(model.lambdas() @ nll + kl_std_normal(mu, lv))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_mvtcae_cycle_term_matches_jax():
    """The cycle term under mvtcae on a narrow MultiMNIST (soft render,
    its image decoder live, presence dropping one row's text): the s-only
    latent is a draw from the text's unimodal posterior with JAX's noise
    ``normal(fold_in(rng_z, 1 + s), (B, L))`` passed in as ``cycle_eps``;
    the loss, every metric and every gradient against JAX."""
    jm = JMultiMnistMVAE(**MM_SMALL)
    data = make_multimnist(B, seed=5)
    params = jm.init(jax.random.key(0), _jbatch(data), rng=jax.random.key(1))["params"]
    presence = np.ones((B, M), np.float32)
    presence[2, 1] = 0.0
    batch = dict(data, presence=presence)
    knobs = dict(objective="mvtcae", cycle_weight=1.0, cycle_render_grad=True)
    rng = jax.random.key(4)
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda q: j_multi_term_loss(jm, q, _jbatch(batch), rng, 0.5, sample=True,
                                    term_fold="t", **knobs), has_aux=True))(params)
    rng_z = jax.random.split(rng)[1]
    cycle_eps = _t(jax.random.normal(jax.random.fold_in(rng_z, 1 + 1), (B, 8)))[None]
    model = MultiMnistMVAE(**MM_SMALL)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    loss, metrics = multi_term_loss(model, _tbatch(batch), 0.5, eps=_eps(rng, l=8),
                                    cycle_eps=cycle_eps, **knobs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    assert set(metrics) == set(j_metrics) >= {"cycle_ce", "cross_kl"}
    for k in ("cycle_ce", "cross_kl"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]), rtol=RTOL)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))


# Adam's eps; a gradient component below 9 eps has not saturated Adam's
# normalisation g / (|g| + eps), so its update follows its rounding bits.
TAIL_BELOW = 9e-8


def test_five_train_steps_match_jax(jmodel):
    """Five mvtcae steps of ``make_train_step`` (alpha 0.8, clipping at 500,
    beta ramping over 4 steps) from the JAX init against JAX's step, spelled
    out as ``_train_step_impl`` runs it (``step.py:1044-1091``: the loss key
    of ``split(state.rng, 3)``, ``value_and_grad`` of the loss,
    ``state.apply_gradients``) so that its gradient is at hand: loss,
    ``cross_kl``, beta and the raw gradient norm each step, the parameters
    after. A gradient component that both sides compute below TAIL_BELOW
    is at the rounding level of its tensor (the image decoder's head holds
    one at 1e-8 of a largest 0.2 at the first step: two XLA programs of the
    same loss give it -1.0e-8 and +2e-9, and Adam turns that into 0.65 lr);
    the port's Adam takes JAX's value there, and each step the components
    so fed that differ must be under 0.01% of the parameters."""
    from mmvae_tpu.core.annealing import annealing_factor as j_annealing_factor

    batches = _batches(5)
    state = j_create_train_state(jmodel, _jbatch(batches[0]), jax.random.key(7), 1e-3,
                                 grad_clip=500.0)
    init = _np_tree(state.params)
    knobs = dict(objective="mvtcae", mvtcae_alpha=0.8)

    @jax.jit
    def j_grads(params, batch, rng, beta):
        return jax.value_and_grad(
            lambda q: j_multi_term_loss(jmodel, q, batch, rng, beta, sample=True,
                                        term_fold="t", **knobs), has_aux=True)(params)

    model = _tmodel(init)
    t_state = create_train_state(model, 1e-3, grad_clip=500.0)
    step = make_train_step(model, annealing_steps=4, **knobs)
    apply, fed = t_state.apply_gradients, []

    def apply_gradients(commit=None):
        n_fed = 0
        for name, p in model.named_parameters():
            want = j_grad[name]
            tail = (p.grad.abs() < TAIL_BELOW) & (want.abs() < TAIL_BELOW)
            n_fed += int((tail & (p.grad != want)).sum())
            p.grad[tail] = want[tail]
        fed.append(n_fed)
        apply(commit)

    t_state.apply_gradients = apply_gradients
    n_params = sum(p.numel() for p in model.parameters())
    for batch in batches:
        rng, _, new_rng = jax.random.split(state.rng, 3)
        beta = j_annealing_factor(state.step, 4)
        (_, j_metrics), grads = j_grads(state.params, _jbatch(batch), rng, beta)
        j_grad = from_flax_params(_np_tree(grads))
        state = state.apply_gradients(grads, new_rng)
        t_state, metrics = step(t_state, _tbatch(batch), eps=_eps(rng))
        assert metrics["beta"].item() == float(beta)
        for k in ("loss", "cross_kl"):
            np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]), rtol=RTOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(),
                                   float(optax_global_norm(grads)), rtol=1e-4)
    del t_state.apply_gradients
    assert t_state.step == int(state.step) == 5
    assert max(fed) < 1e-4 * n_params, fed
    want = from_flax_params(_np_tree(state.params))
    start = from_flax_params(init)
    got = t_state.params
    diff = sum(((got[k].detach() - w) ** 2).sum() for k, w in want.items())
    update = sum(((w - start[k]) ** 2).sum() for k, w in want.items())
    assert update > 0 and (diff / update).sqrt() < STEP_REL
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=0, atol=STEP_ATOL,
                                   err_msg=k)


def test_api_train_and_generate_under_mvtcae():
    """``api.train`` of ``mnist`` under mvtcae at a small width records
    ``cross_kl``; ``generate`` from the label is the PoE's mean, as under
    mvae."""
    cfg = configs.get_config("mnist").replace(
        objective="mvtcae", n_latents=8, epochs=1, train_size=24, test_size=16, batch_size=8)
    result = api.train(cfg, device="cpu", verbose=False)
    record = result.history[0]
    assert set(record) == {"epoch", "train_loss", "cross_kl", "test_elbo"}
    assert all(np.isfinite(v) for v in record.values()) and record["cross_kl"] > 0
    label = {"label": np.asarray([1, 2, 3], np.int32)}
    got = api.generate(cfg, label, model=result.model, device="cpu")
    want = api.generate(cfg.replace(objective="mvae"), label, model=result.model, device="cpu")
    torch.testing.assert_close(got["image"], want["image"], rtol=0, atol=0)
