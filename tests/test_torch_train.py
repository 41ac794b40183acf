"""The port's MNIST training slice against the JAX package, on the CPU.

The JAX ``MnistMVAE`` (n_latents 16, the 512-wide experts) is initialised
from a seed, its parameters move across with ``convert.from_flax_params``,
and both sides see the same numpy batch of 8. The posterior noise of each
step is the JAX step's own draw, ``jax.random.normal`` of the key that
``multi_term_loss`` splits off for it (``step.py:471``), handed to the port
as ``eps``; a presence-dropout mask is the JAX step's own Bernoulli draw
(``step.py:1049-1053``), handed to the port as ``keep``.

Tolerances: one loss evaluation, rtol 2e-4 (XLA-CPU transcendentals are
approximate, docs/DESIGN.md section 7) with an atol of 2e-4 of each
gradient tensor's largest element for the entries that cancel to near
0. Adam steps: beta exactly, the loss at rtol 2e-4 and the raw gradient
norm at rtol 1e-4 each step (measured over five steps: 1.8e-6 and
8.6e-6); the parameters and the EMA parameters after, by the relative
2-norm of the difference of the two updates, below 1e-4 (measured
1.1e-5 to 1.5e-5 with and without clipping), and elementwise within
1e-4 (measured at most 2.7e-5 on 35 of 1.65M elements above 1e-6: where
a gradient sits at its rounding level, Adam's m / sqrt(v) can step the
two sides differently, each step by up to the learning rate, 1e-3).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import random_subset_masks as j_random_subset_masks
from mmvae_tpu.core.annealing import annealing_factor as j_annealing_factor
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_tpu.train.step import make_train_step as j_make_train_step
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.core import annealing_factor
from mmvae_torch.data import make_mnist
from mmvae_torch.models import MnistMVAE
from mmvae_torch.train import (
    create_train_state,
    make_epoch_runner,
    make_train_step,
    multi_term_loss,
    presence_from_keep,
)

N_LATENTS, B, M, T = 16, 8, 2, 3
RTOL = 2e-4
STEP_ATOL = 1e-4
STEP_REL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tmodel(params) -> MnistMVAE:
    model = MnistMVAE(n_latents=N_LATENTS)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    return model


def _tbatch(batch) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _eps(rng) -> torch.Tensor:
    """The noise JAX's ``multi_term_loss`` draws from ``rng``."""
    return torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.split(rng)[1], (T, B, N_LATENTS))))


def _step_keys(state_rng):
    """The loss key and the dropout key of a JAX train step (``:1045``)."""
    rng, drop_rng, _ = jax.random.split(state_rng, 3)
    return rng, drop_rng


def _batches(n: int, seed: int = 5):
    data = make_mnist(n * B, seed=seed)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(n)]


@pytest.fixture(scope="module")
def jmodel():
    return JMnistMVAE(n_latents=N_LATENTS)


@pytest.fixture(scope="module")
def init_params(jmodel):
    batch = {k: jnp.asarray(v) for k, v in _batches(1)[0].items()}
    return jmodel.init(jax.random.key(0), batch, rng=jax.random.key(1))["params"]


def _params_close(got: dict[str, torch.Tensor], want, init) -> None:
    """The parameters ``got`` against JAX's tree ``want``, both trained
    from the tree ``init`` (see the module docstring)."""
    want, init = from_flax_params(_np_tree(want)), from_flax_params(_np_tree(init))
    assert set(got) == set(want)
    diff = sum(((got[k].detach() - w) ** 2).sum() for k, w in want.items())
    update = sum(((w - init[k]) ** 2).sum() for k, w in want.items())
    assert update > 0 and (diff / update).sqrt() < STEP_REL
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k].detach().numpy(), w.numpy(), rtol=0, atol=STEP_ATOL, err_msg=k)


def _grads_close(got: dict[str, torch.Tensor], want: dict[str, torch.Tensor]) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 2e-4 * w.abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL, atol=atol, err_msg=k)


@pytest.mark.parametrize("with_presence", [False, True])
def test_loss_metrics_and_every_gradient_match_jax(jmodel, init_params, with_presence):
    """One loss evaluation of the train step (sample=True, beta 0.3): the
    loss, the per-term metrics and the gradient of every parameter against
    ``jax.value_and_grad`` of the JAX ``multi_term_loss`` (t-fold)."""
    batch = _batches(1)[0]
    if with_presence:
        presence = np.ones((B, M), np.float32)
        presence[1, 0] = presence[2, 1] = 0.0
        presence[3] = 0.0
        batch = dict(batch, presence=presence)
    rng = jax.random.key(3)

    def loss_fn(params):
        return j_multi_term_loss(
            jmodel, params, {k: jnp.asarray(v) for k, v in batch.items()}, rng, 0.3,
            sample=True, term_fold="t",
        )

    (j_loss, j_metrics), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(init_params)
    model = _tmodel(init_params)
    loss, metrics = multi_term_loss(model, _tbatch(batch), 0.3, sample=True, eps=_eps(rng))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    for k in ("recon_per_term", "kl_per_term", "elbo_per_term"):
        np.testing.assert_allclose(
            metrics[k].detach().numpy(), np.asarray(j_metrics[k]), rtol=RTOL, atol=1e-3)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))


def _run_jax(jmodel, batches, grad_clip, ema_decay, annealing_steps, p_modality_drop=0.0):
    """JAX's state and its per-step metrics, eps and dropout keys."""
    state = j_create_train_state(
        jmodel, {k: jnp.asarray(v) for k, v in batches[0].items()}, jax.random.key(7),
        1e-3, grad_clip=grad_clip, ema_decay=ema_decay,
    )
    init = _np_tree(state.params)
    step = j_make_train_step(
        jmodel, annealing_steps=annealing_steps, p_modality_drop=p_modality_drop,
        term_fold="t",
    )
    per_step = []
    for batch in batches:
        rng, drop_rng = _step_keys(state.rng)
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        per_step.append((_np_tree(metrics), _eps(rng), drop_rng))
    return init, state, per_step


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_five_train_steps_match_jax(jmodel, grad_clip):
    """Five steps of ``make_train_step`` from the JAX init, with EMA 0.9 and
    beta ramping over 4 steps: loss, beta and the raw gradient norm each
    step, the parameters and the EMA parameters after. grad_clip 1 fires
    on every step (the norms are in the hundreds)."""
    batches = _batches(5)
    init, j_state, per_step = _run_jax(jmodel, batches, grad_clip, 0.9, 4)
    model = _tmodel(init)
    state = create_train_state(model, 1e-3, grad_clip=grad_clip, ema_decay=0.9)
    step = make_train_step(model, annealing_steps=4)
    for batch, (j_metrics, eps, _) in zip(batches, per_step):
        state, metrics = step(state, _tbatch(batch), eps=eps)
        assert metrics["beta"].item() == float(j_metrics["beta"])
        np.testing.assert_allclose(metrics["loss"].item(), j_metrics["loss"], rtol=RTOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(), j_metrics["grad_norm"], rtol=1e-4)
        if grad_clip:
            assert metrics["grad_norm"].item() > grad_clip
    assert state.step == int(j_state.step) == 5
    _params_close(state.params, j_state.params, init)
    _params_close(state.ema_params, j_state.ema_params, init)


def test_presence_dropout_matches_jax(jmodel):
    """JAX's step with p_modality_drop 0.5 draws a keep mask with a row
    that drops both modalities (that row keeps both); the port's step given
    that mask lands on JAX's parameters."""
    batches = _batches(1)
    for seed in range(100):
        state = j_create_train_state(
            jmodel, {k: jnp.asarray(v) for k, v in batches[0].items()},
            jax.random.key(seed), 1e-3,
        )
        _, drop_rng = _step_keys(state.rng)
        keep = np.asarray(jax.random.bernoulli(drop_rng, 0.5, shape=(B, M)))
        if (~keep.any(-1)).any():
            break
    presence = presence_from_keep(torch.from_numpy(keep))
    rows = torch.from_numpy(~keep.any(-1))
    assert torch.all(presence[rows] == 1) and torch.equal(presence[~rows],
                                                          torch.from_numpy(keep[~rows]).float())
    init = _np_tree(state.params)
    rng, _ = _step_keys(state.rng)
    j_step = j_make_train_step(jmodel, p_modality_drop=0.5, term_fold="t")
    j_state, _ = j_step(state, {k: jnp.asarray(v) for k, v in batches[0].items()})
    model = _tmodel(init)
    t_state = create_train_state(model, 1e-3)
    make_train_step(model, p_modality_drop=0.5)(
        t_state, _tbatch(batches[0]), eps=_eps(rng), keep=torch.from_numpy(keep))
    _params_close(t_state.params, j_state.params, init)


def test_presence_dropout_leaves_a_given_presence_alone(init_params):
    """A batch that carries ``presence`` is trained on it as it is, whatever
    keep mask is passed."""
    batch = dict(_batches(1)[0], presence=np.ones((B, M), np.float32))
    batch["presence"][0, 1] = 0.0
    eps = torch.randn(T, B, N_LATENTS, generator=torch.Generator().manual_seed(0))
    params = []
    for p_drop in (0.0, 0.5):
        model = _tmodel(init_params)
        state = create_train_state(model, 1e-3)
        make_train_step(model, p_modality_drop=p_drop)(
            state, _tbatch(batch), eps=eps, keep=torch.zeros(B, M, dtype=torch.bool))
        params.append(state.params)
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k])


@pytest.mark.parametrize("step, annealing_steps", [(0, 40), (17, 40), (40, 40), (95, 40),
                                                   (3, 0), (3, -5)])
def test_annealing_factor_matches_jax(step, annealing_steps):
    got = annealing_factor(step, annealing_steps)
    want = float(j_annealing_factor(step, annealing_steps))
    assert np.float32(got) == want


def test_epoch_runner_stacks_the_steps(init_params):
    """The runner over pre-stacked (steps, B, ...) batches gives the steps'
    metrics stacked, and the same state as the steps taken one by one."""
    batches = _batches(3)
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
    gen = torch.Generator().manual_seed(11)
    model = _tmodel(init_params)
    state, metrics = make_epoch_runner(model, annealing_steps=2, generator=gen)(
        create_train_state(model, 1e-3), stacked)
    assert state.step == 3 and metrics["loss"].shape == (3,)
    torch.testing.assert_close(metrics["beta"], torch.tensor([0.0, 0.5, 1.0]))
    gen = torch.Generator().manual_seed(11)
    model_b = _tmodel(init_params)
    state_b = create_train_state(model_b, 1e-3)
    step = make_train_step(model_b, annealing_steps=2, generator=gen)
    for b in batches:
        step(state_b, _tbatch(b))
    for k, v in state.params.items():
        assert torch.equal(v, state_b.params[k])


def test_unported_step_options_raise(init_params):
    """Every fold of the JAX step is ported: ``"st"`` without a mesh and an
    unknown fold raise JAX's ``ValueError``, and ``"b"`` builds."""
    model = _tmodel(init_params)
    with pytest.raises(ValueError, match="term_fold='st' requires a mesh"):
        make_train_step(model, term_fold="st")
    with pytest.raises(ValueError, match="unknown term_fold"):
        make_train_step(model, term_fold="x")
    assert callable(make_train_step(model, term_fold="b"))


def test_api_train_one_epoch_on_the_cpu():
    """``api.train`` at a tiny train split: one epoch of 3 batches, a
    finite test ELBO in the history, and the state trained 3 steps."""
    cfg = configs.get_config("mnist").replace(
        n_latents=8, epochs=1, train_size=60, test_size=30, batch_size=20)
    result = api.train(cfg, device="cpu", verbose=False)
    assert isinstance(result, api.TrainResult)
    assert result.config is cfg and result.state.step == 3
    assert result.model is result.state.model
    assert len(result.history) == 1 and result.history[0]["epoch"] == 1
    assert math.isfinite(result.history[0]["test_elbo"])
    assert result.best_test_elbo == result.history[0]["test_elbo"]
    again = api.train(cfg, device="cpu", verbose=False)
    assert again.history == result.history


def test_api_train_tracks_ema_for_eval():
    cfg = configs.get_config("mnist").replace(
        n_latents=8, epochs=1, train_size=40, test_size=20, batch_size=20, ema_decay=0.5)
    result = api.train(cfg, device="cpu", verbose=False)
    assert result.state.eval_model is result.state.ema_model
    want = api.eval_elbo(cfg, model=result.state.ema_model, device="cpu")
    assert result.history[0]["test_elbo"] == pytest.approx(want, rel=1e-6)


def test_random_subsets_train_mnist_as_jax_does(jmodel):
    """``mnist`` with 2 random subset terms (T = 5): ``api.train`` takes the
    knob and trains on the CPU, and one step from the JAX init, given the
    masks and the noise JAX's step draws (``step.py:471-496``), gives JAX's
    loss and raw gradient norm, and every gradient of the JAX loss at that
    step's key. (Adam's first step is the sign of each gradient component
    times the learning rate, so the parameters after one step would hold a
    component at its rounding level to its sign; five steps are held to
    JAX's parameters above.)"""
    cfg = configs.get_config("mnist").replace(
        n_latents=8, epochs=1, train_size=40, test_size=20, batch_size=20, n_random_subsets=2)
    result = api.train(cfg, device="cpu", verbose=False)
    assert result.state.step == 2 and math.isfinite(result.history[0]["test_elbo"])

    batch = _batches(1)[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = j_create_train_state(jmodel, jbatch, jax.random.key(7), 1e-3)
    init = _np_tree(state.params)  # before the step, which donates the state
    rng = jax.random.split(state.rng, 3)[0]
    rng_subset, rng_z = jax.random.split(rng)
    masks = torch.from_numpy(np.array(j_random_subset_masks(rng_subset, 2, M)))
    assert masks.shape == (2, M)
    eps = torch.from_numpy(np.array(jax.random.normal(rng_z, (T + 2, B, N_LATENTS))))
    _, j_metrics = j_make_train_step(jmodel, n_random_subsets=2, term_fold="t")(state, jbatch)
    (_, _), j_grads = jax.value_and_grad(
        lambda q: j_multi_term_loss(jmodel, q, jbatch, rng, float(j_metrics["beta"]),
                                    n_random_subsets=2, sample=True, term_fold="t"),
        has_aux=True)(jax.tree.map(jnp.asarray, init))
    model = _tmodel(init)
    _, metrics = make_train_step(model, n_random_subsets=2)(
        create_train_state(model, 1e-3), _tbatch(batch), eps=eps, subset_masks=masks)
    assert metrics["elbo_per_term"].shape == (T + 2,)
    np.testing.assert_allclose(metrics["loss"].item(), float(j_metrics["loss"]), rtol=RTOL)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))


@pytest.mark.parametrize("kw", [{"objective": "mmvae"}, {"mounted": "mnist"},
                                {"config": "deep_mnist"}, {"config": "deep_cub"}])
def test_api_train_raises_on_unported_entry_options(kw, tmp_path, monkeypatch):
    """The ``deep_*`` pipeline configs are ported now: ``api.train`` trains
    them at a small width to a finite history (their parity with JAX is in
    ``tests/test_torch_deep.py``). A mixture objective is ported; with an mvae term knob (cross-recon) it
    raises the JAX loss's ``ValueError``. Mounted data is ported: a mounted
    ``mnist/`` without data files in it leaves the generators' split (as
    the JAX loader does), so the run equals the unmounted one."""
    kw = {"config": "mnist", **kw}
    config = kw.pop("config")
    error, match = NotImplementedError, "not yet ported"
    if "objective" in kw:
        config = configs.get_config(config).replace(
            objective=kw.pop("objective"), cross_recon=True, train_size=100, test_size=100)
        error, match = ValueError, "mvae term-structure knobs"
    if "mounted" in kw:
        small = configs.get_config(config).replace(n_latents=8, epochs=1, train_size=32,
                                                   test_size=16, batch_size=16)
        want = api.train(small, device="cpu", verbose=False).history
        (tmp_path / kw.pop("mounted")).mkdir()
        monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
        assert api.train(small, device="cpu", verbose=False).history == want
        return
    if isinstance(config, str) and config.startswith("deep_"):
        small = configs.get_config(config).replace(
            n_latents=8, epochs=1, train_size=16, test_size=8, batch_size=8,
            model_kwargs=dict(trunk_stages=2, **(
                dict(conv_features=(8, 8)) if config == "deep_cub" else dict(trunk_width=32))))
        history = api.train(small, device="cpu", verbose=False).history
        assert np.isfinite([history[0]["train_loss"], history[0]["test_elbo"]]).all()
        return
    with pytest.raises(error, match=match):
        api.train(config, device="cpu", **kw)
