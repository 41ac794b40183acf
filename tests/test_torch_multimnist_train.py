"""The port's MultiMNIST training slice against the JAX package, on the CPU.

The JAX ``MultiMnistMVAE`` is initialised from a seed at small widths
(n_latents 8, conv features (4, 8), text embed 8, hidden 16, a text expert
limited to the first 4 latent dims, lambda_text 30), its parameters move
across with ``convert.from_flax_params``, and both sides see the same
numpy batch of 8. The loss is the ``multimnist`` config's: cross-recon
(the decode-all pass) and the cycle term. The posterior noise is the JAX
step's own draw, handed to the port as ``eps`` (as in
``tests/test_torch_train.py``).

The cycle term thresholds the soft render at 0.5 (straight-through). A
pixel whose render lies closer to 0.5 than the two implementations'
difference (a few float steps at a random init, whose image logits sit
near 0) could land on different sides. So each loss and step test feeds
JAX's own hard render mask into the port's binarize, as the noise is fed
in, records the smallest |soft - 0.5| JAX met, and asserts that the
port's own threshold would have flipped no pixel. The binarize alone is
held against JAX's form on one array, values at 0.5 and next to it.

Tolerances as in ``tests/test_torch_train.py``: one loss evaluation at
rtol 2e-4 (XLA-CPU transcendentals are approximate, docs/DESIGN.md
section 7), each gradient tensor with an atol of 2e-4 of its largest
element; Adam steps by the relative 2-norm of the two updates' difference
(below 1e-4) and elementwise within 1e-4.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import configs as jconfigs
from mmvae_tpu.core import elbo_subset_masks as j_elbo_subset_masks
from mmvae_tpu.core import product_of_experts as j_product_of_experts
from mmvae_tpu.core import reparameterize as j_reparameterize
from mmvae_tpu.models import MultiMnistMVAE as JMultiMnistMVAE
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_tpu.train.step import make_train_step as j_make_train_step
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import make_multimnist
from mmvae_torch.models import MultiMnistMVAE
from mmvae_torch.train import create_train_state, make_train_step, multi_term_loss
from mmvae_torch.train import step as step_module
from mmvae_torch.train.step import _straight_through

N_LATENTS, B, M, T = 8, 8, 2, 3
SMALL = dict(conv_features=(4, 8), text_embed=8, text_hidden=16, text_latent_dims=4,
             lambda_text=30.0)
CYCLE = dict(cross_recon=True, cycle_weight=1.0)
RTOL = 2e-4
STEP_ATOL = 1e-4
STEP_REL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tmodel(params) -> MultiMnistMVAE:
    model = MultiMnistMVAE(n_latents=N_LATENTS, **SMALL)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    return model


def _tbatch(batch) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _eps(rng) -> torch.Tensor:
    """The noise JAX's ``multi_term_loss`` draws from ``rng``."""
    return torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.split(rng)[1], (T, B, N_LATENTS))))


def _batches(n: int, seed: int = 5):
    data = make_multimnist(n * B, seed=seed)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(n)]


@pytest.fixture(scope="module")
def jmodel():
    return JMultiMnistMVAE(n_latents=N_LATENTS, **SMALL)


@pytest.fixture(scope="module")
def init_params(jmodel):
    return jmodel.init(jax.random.key(0), _jbatch(_batches(1)[0]), rng=jax.random.key(1))["params"]


def _grads_close(got: dict[str, torch.Tensor], want: dict[str, torch.Tensor]) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 2e-4 * w.abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def j_render(jmodel):
    """JAX's own soft render of the cycle term (``step.py:871-885``): the
    text's unimodal term of z, drawn as ``multi_term_loss`` draws it from
    ``rng``, through the image decoder and a sigmoid."""

    @jax.jit
    def render(params, batch, rng):
        mu_e, lv_e = jmodel.apply({"params": params}, batch, method="encode")
        masks = j_elbo_subset_masks(M)
        eff = jnp.broadcast_to(masks[:, None, :], (T, B, M))
        mu_f, lv_f = j_product_of_experts(mu_e[None], lv_e[None], mask=eff)
        z = j_reparameterize(jax.random.split(rng)[1], mu_f, lv_f)
        return jax.nn.sigmoid(jmodel.apply({"params": params}, z[2], method="decode")["image"])

    return render


def _feed_hard_form(monkeypatch, j_soft) -> dict[str, float]:
    """Feed JAX's hard render mask into the port's straight-through
    binarize (the port keeps its own soft render and the identity
    backward), and record how far the port's own threshold would have
    differed: the smallest |soft - 0.5| JAX met and the pixels the port
    would have put on the other side."""
    hard = torch.from_numpy(np.asarray(j_soft) > 0.5).to(torch.float32)
    seen = {}

    def fed(p):
        seen["flips"] = int(((p.detach() > 0.5).float() != hard).sum())
        return p + (hard - p).detach()

    monkeypatch.setattr(step_module, "_straight_through", fed)
    seen["margin"] = float(np.abs(np.asarray(j_soft) - 0.5).min())
    return seen


@pytest.mark.parametrize("render_grad", [True, False])
@pytest.mark.parametrize("binarize", [False, True, "both"])
def test_loss_metrics_and_every_gradient_match_jax(
    jmodel, init_params, j_render, monkeypatch, binarize, render_grad
):
    """One loss evaluation with cross-recon and the cycle term (sample=True,
    beta 0.3): the loss, every metric (``cycle_ce`` with them) and the
    gradient of every parameter against ``jax.value_and_grad`` of the JAX
    ``multi_term_loss`` (t-fold). The decoders' stop-gradient shows here: a
    decoder weight gets the cycle's gradient only through the render, and
    only with ``cycle_render_grad``. JAX's hard render mask is fed in (see
    the module docstring): the smallest |soft - 0.5| JAX meets is 1.8e-7,
    3 float steps, and the port's own threshold puts no pixel on the other
    side."""
    batch = _batches(1)[0]
    rng = jax.random.key(3)
    knobs = dict(CYCLE, cycle_render_grad=render_grad, cycle_render_binarize=binarize)

    @jax.jit
    def loss_and_grad(params):
        return jax.value_and_grad(
            lambda q: j_multi_term_loss(jmodel, q, _jbatch(batch), rng, 0.3, sample=True,
                                        term_fold="t", **knobs), has_aux=True)(params)

    (j_loss, j_metrics), j_grads = loss_and_grad(init_params)
    seen = _feed_hard_form(monkeypatch, j_render(init_params, _jbatch(batch), rng))
    model = _tmodel(init_params)
    loss, metrics = multi_term_loss(model, _tbatch(batch), 0.3, eps=_eps(rng), **knobs)
    loss.backward()
    assert seen.get("flips", 0) == 0, seen
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    assert set(metrics) == set(j_metrics)
    np.testing.assert_allclose(metrics["cycle_ce"].item(), float(j_metrics["cycle_ce"]),
                               rtol=RTOL)
    for k in ("recon_per_term", "kl_per_term", "elbo_per_term"):
        np.testing.assert_allclose(
            metrics[k].detach().numpy(), np.asarray(j_metrics[k]), rtol=RTOL, atol=1e-3)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))


def test_cross_recon_weight_and_presence_match_jax(jmodel, init_params):
    """Cross entries weighed 2.5, a presence mask (a row without its text,
    one without its image, one with nothing) and no cycle term: the loss,
    the metrics and every gradient against JAX."""
    batch = _batches(1, seed=6)[0]
    presence = np.ones((B, M), np.float32)
    presence[1, 1] = presence[2, 0] = 0.0
    presence[3] = 0.0
    batch = dict(batch, presence=presence)
    rng = jax.random.key(4)

    def loss_fn(params):
        return j_multi_term_loss(jmodel, params, _jbatch(batch), rng, 1.0, sample=True,
                                 term_fold="t", cross_recon=True, cross_recon_weight=2.5)

    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        init_params)
    model = _tmodel(init_params)
    loss, metrics = multi_term_loss(model, _tbatch(batch), 1.0, eps=_eps(rng),
                                    cross_recon=True, cross_recon_weight=2.5)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    np.testing.assert_allclose(metrics["recon_per_term"].detach().numpy(),
                               np.asarray(j_metrics["recon_per_term"]), rtol=RTOL, atol=1e-3)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))


def test_decode_all_pass_equals_member_pruning(init_params):
    """Without cross-recon, the decode-all pass (``member_prune=False``)
    gives the member-pruned loss and gradients: the entries it adds have
    recon mask 0."""
    batch = _tbatch(_batches(1)[0])
    eps = torch.randn(T, B, N_LATENTS, generator=torch.Generator().manual_seed(0))
    results = []
    for prune in (True, False):
        model = _tmodel(init_params)
        loss, _ = multi_term_loss(model, batch, 0.5, eps=eps, member_prune=prune)
        loss.backward()
        results.append((loss.item(), {k: p.grad for k, p in model.named_parameters()}))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-6)
    for k, g in results[0][1].items():
        torch.testing.assert_close(results[1][1][k], g, rtol=1e-5, atol=1e-6)


def test_straight_through_binarize_matches_jax_form():
    """The hard form alone on one numpy soft array, with values at 0.5
    exactly and a float step either side of it: the same forward bits as
    the JAX expression (``soft + stop_gradient((soft > 0.5) - soft)``), and
    the identity as its gradient."""
    half = np.float32(0.5)
    soft = np.array([0.0, 0.2, np.nextafter(half, np.float32(0)), half,
                     np.nextafter(half, np.float32(1)), 0.5000001, 0.8, 1.0], np.float32)
    g = np.arange(1, soft.size + 1, dtype=np.float32)

    def j_hard(s):
        return s + jax.lax.stop_gradient((s > 0.5).astype(s.dtype) - s)

    j_out, j_vjp = jax.vjp(j_hard, jnp.asarray(soft))
    t_soft = torch.from_numpy(soft).requires_grad_(True)
    out = _straight_through(t_soft)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(out.detach().numpy(), (soft > 0.5).astype(np.float32))
    np.testing.assert_array_equal(t_soft.grad.numpy(), np.asarray(j_vjp(jnp.asarray(g))[0]))
    np.testing.assert_array_equal(t_soft.grad.numpy(), g)


def test_five_clipped_train_steps_match_jax(jmodel, j_render, monkeypatch):
    """Five steps of the ``multimnist`` step (cross-recon, the cycle term
    with a live render and both forms, clipping at 500) from the JAX init,
    beta ramping over 4 steps, each step's hard render mask JAX's own (fed
    in; the smallest |soft - 0.5| JAX meets over the steps is 1.8e-7 to
    9.5e-7, and the port's threshold would flip no pixel): loss,
    ``cycle_ce``, beta and the raw gradient norm each step, the parameters
    after."""
    batches = _batches(5)
    knobs = dict(CYCLE, cycle_render_grad=True, cycle_render_binarize="both")
    state = j_create_train_state(jmodel, _jbatch(batches[0]), jax.random.key(7), 1e-3,
                                 grad_clip=500.0)
    init = _np_tree(state.params)
    j_step = j_make_train_step(jmodel, annealing_steps=4, term_fold="t", **knobs)
    model = _tmodel(init)
    t_state = create_train_state(model, 1e-3, grad_clip=500.0)
    step = make_train_step(model, annealing_steps=4, **knobs)
    for batch in batches:
        rng = jax.random.split(state.rng, 3)[0]
        seen = _feed_hard_form(monkeypatch, j_render(state.params, _jbatch(batch), rng))
        state, j_metrics = j_step(state, _jbatch(batch))
        t_state, metrics = step(t_state, _tbatch(batch), eps=_eps(rng))
        assert seen["flips"] == 0, seen
        assert metrics["beta"].item() == float(j_metrics["beta"])
        for k in ("loss", "cycle_ce"):
            np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]), rtol=RTOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(j_metrics["grad_norm"]),
                                   rtol=1e-4)
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


def _small_config(**kw):
    return configs.get_config("multimnist").replace(
        n_latents=N_LATENTS, epochs=1, train_size=24, test_size=16, batch_size=B,
        model_kwargs=SMALL, **kw)


def test_api_train_multimnist_on_the_cpu():
    """``api.train`` of the ``multimnist`` config at a small width: one
    epoch of 3 batches, a finite train loss, ``cycle_ce`` and test ELBO in
    the history, the state trained 3 steps, and the same history again from
    the same seed."""
    cfg = _small_config()
    assert (cfg.cross_recon, cfg.cycle_weight, cfg.cycle_render_grad,
            cfg.cycle_render_binarize, cfg.grad_clip) == (True, 1.0, True, "both", 500.0)
    result = api.train(cfg, device="cpu", verbose=False)
    assert result.state.step == 3 and len(result.history) == 1
    record = result.history[0]
    assert set(record) == {"epoch", "train_loss", "cycle_ce", "test_elbo"}
    assert all(map(math.isfinite, record.values())) and record["cycle_ce"] > 0
    assert api.train(cfg, device="cpu", verbose=False).history == result.history


@pytest.mark.parametrize("name", ["mnist", "multimnist"])
def test_step_options_are_the_jax_runner_options(name):
    """``api.step_options`` (what ``api.train`` and the smoke run hand the
    step) names only keywords of ``make_train_step`` and carries the values
    the JAX ``api.train`` hands its runner from the same config
    (``mmvae_tpu/api.py:591-613``)."""
    options = api.step_options(configs.get_config(name))
    assert set(options) <= set(inspect.signature(make_train_step).parameters)
    jcfg = jconfigs.get_config(name)
    assert options == {k: getattr(jcfg, k) for k in options}


@pytest.mark.parametrize("knob,value", [("objective", "mopoe"), ("term_fold", "b")])
def test_unported_loss_knobs_raise(init_params, knob, value):
    """The b fold is ported: the step builds and the loss under it equals
    the t fold's on the same noise (rel 1e-5). A mixture objective is
    ported and refuses the config's cross-recon with the JAX loss's
    ``ValueError``, from the loss and from the step's builder."""
    model = _tmodel(init_params)
    if knob == "term_fold":
        make_train_step(model, **CYCLE, **{knob: value})
        batch = _tbatch(_batches(1)[0])
        eps = torch.randn((T, B, N_LATENTS), generator=torch.Generator().manual_seed(0))
        got, _ = multi_term_loss(model, batch, **CYCLE, **{knob: value},
                                 eps=eps.transpose(0, 1).contiguous())
        want, _ = multi_term_loss(model, batch, **CYCLE, eps=eps)
        assert got.item() == pytest.approx(want.item(), rel=1e-5)
        return
    error, match = ValueError, "mvae term-structure knobs"
    with pytest.raises(error, match=match):
        make_train_step(model, **CYCLE, **{knob: value})
    with pytest.raises(error, match=match):
        multi_term_loss(model, _tbatch(_batches(1)[0]), **CYCLE, **{knob: value})


def test_cycle_knobs_are_checked_as_in_jax(init_params):
    """A binarize mode other than False, True or "both" and a cycle term on
    a model without a sequence modality raise JAX's ``ValueError``s."""
    model = _tmodel(init_params)
    with pytest.raises(ValueError, match="cycle_render_binarize"):
        multi_term_loss(model, _tbatch(_batches(1)[0]), cycle_weight=1.0,
                        cycle_render_binarize="hard")
    mnist = configs.get_config("mnist").replace(
        n_latents=8, epochs=1, train_size=16, test_size=8, batch_size=8, cycle_weight=1.0)
    with pytest.raises(ValueError, match="needs a seq and a bernoulli modality"):
        api.train(mnist, device="cpu", verbose=False)


def test_api_train_multimnist_with_random_subsets():
    """The ``multimnist`` loss (cross-recon, the cycle term) with 2 random
    subset terms (T = 5) trains through ``api.train`` on the CPU: finite
    losses, ``cycle_ce`` and test ELBO, 3 steps, and the same history again
    from the same seed."""
    cfg = _small_config(n_random_subsets=2)
    result = api.train(cfg, device="cpu", verbose=False)
    assert result.state.step == 3
    record = result.history[0]
    assert all(map(math.isfinite, record.values())) and record["cycle_ce"] > 0
    assert api.train(cfg, device="cpu", verbose=False).history == result.history
