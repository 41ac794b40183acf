"""The port's CUB training slice against the JAX package, on the CPU.

The JAX ``CubMVAE`` is initialised from a seed at the small widths of
``tests/test_torch_cub.py`` (n_latents 16, 16x16 RGB images, conv
features (8, 16); the caption experts at the embed 128 and hidden 256 the
JAX model fixes, over the 23-id synthetic vocabulary, 32 tokens), its
parameters move across with ``convert.from_flax_params``, and both sides
see the same numpy batch. The loss is the ``cub`` config's: cross-recon
(the decode-all pass) and the cycle term at weight 0.1 on the soft render
(``cycle_render_binarize=False``, so no threshold can land on different
sides), its image decoder live on the render (``cycle_render_grad``).
The cycle term re-encodes the render through the image encoder, so the
encoder's stage 0 (``ops.conv4x4s2_swish``, K4 on the card) takes a
gradient in its input here. The posterior noise is the JAX step's own
draw, handed to the port as ``eps`` (as in ``tests/test_torch_train.py``).

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
from mmvae_tpu.models import CubMVAE as JCubMVAE
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_tpu.train.step import make_train_step as j_make_train_step
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import make_cub
from mmvae_torch.models import CubMVAE
from mmvae_torch.train import create_train_state, make_train_step, multi_term_loss
from torch_threads import _one_torch_thread  # noqa: F401

N_LATENTS, B, M, T = 16, 4, 2, 3
HW = 16
SMALL = dict(vocab_size=23, image_hw=(HW, HW), conv_features=(8, 16))
# The ``cub`` config's loss knobs (``mmvae_tpu/configs.py:249-253``).
CUB = dict(cross_recon=True, cycle_weight=0.1, cycle_render_grad=True,
           cycle_render_binarize=False)
RTOL = 2e-4
STEP_ATOL = 1e-4
STEP_REL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tmodel(params) -> CubMVAE:
    model = CubMVAE(n_latents=N_LATENTS, **SMALL)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    return model


def _tbatch(batch) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _eps(rng) -> torch.Tensor:
    """The noise JAX's ``multi_term_loss`` draws from ``rng``."""
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.split(rng)[1], (T, B, N_LATENTS))))


def _batches(n: int, seed: int = 5):
    data = make_cub(n * B, seed=seed, hw=HW)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(n)]


@pytest.fixture(scope="module")
def jmodel():
    return JCubMVAE(n_latents=N_LATENTS, **SMALL)


@pytest.fixture(scope="module")
def init_params(jmodel):
    return jmodel.init(jax.random.key(0), _jbatch(_batches(1)[0]), rng=jax.random.key(1))["params"]


def _grads_close(got: dict[str, torch.Tensor], want: dict[str, torch.Tensor]) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 2e-4 * w.abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL, atol=atol, err_msg=k)


def test_the_config_is_the_jax_cub_config():
    """The port's ``cub`` config carries the JAX config's loss knobs, no
    clipping, batch 64 and T = 3 (the joint and the two unimodal terms)."""
    cfg, jcfg = configs.get_config("cub"), jconfigs.get_config("cub")
    assert {k: getattr(cfg, k) for k in CUB} == CUB == {k: getattr(jcfg, k) for k in CUB}
    assert (cfg.grad_clip, cfg.batch_size, cfg.n_random_subsets) == (0.0, 64, 0)
    assert (jcfg.grad_clip, jcfg.batch_size, jcfg.n_random_subsets) == (0.0, 64, 0)


@pytest.mark.parametrize("render_grad", [True, False])
def test_loss_metrics_and_every_gradient_match_jax(jmodel, init_params, render_grad):
    """One loss evaluation under the ``cub`` flags (sample=True, beta 0.3):
    the loss, every metric (``cycle_ce`` with them) and the gradient of
    every parameter against ``jax.value_and_grad`` of the JAX
    ``multi_term_loss`` (t-fold). The cycle term's stop-gradient shows
    here: the decoders' weights get the cycle's gradient only through the
    render, and only with ``cycle_render_grad``; the encoders stay live on
    the re-encode, whose stage 0 takes its input's gradient (the render's)."""
    batch = _batches(1)[0]
    rng = jax.random.key(3)
    knobs = dict(CUB, cycle_render_grad=render_grad)

    @jax.jit
    def loss_and_grad(params):
        return jax.value_and_grad(
            lambda q: j_multi_term_loss(jmodel, q, _jbatch(batch), rng, 0.3, sample=True,
                                        term_fold="t", **knobs), has_aux=True)(params)

    (j_loss, j_metrics), j_grads = loss_and_grad(init_params)
    model = _tmodel(init_params)
    loss, metrics = multi_term_loss(model, _tbatch(batch), 0.3, eps=_eps(rng), **knobs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    assert set(metrics) == set(j_metrics)
    np.testing.assert_allclose(metrics["cycle_ce"].item(), float(j_metrics["cycle_ce"]),
                               rtol=RTOL)
    for k in ("recon_per_term", "kl_per_term", "elbo_per_term"):
        np.testing.assert_allclose(
            metrics[k].detach().numpy(), np.asarray(j_metrics[k]), rtol=RTOL, atol=1e-3)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))


def test_the_re_encode_takes_the_render_s_gradient(init_params):
    """Without the cycle term the image encoder's stage 0 sees only the
    data; with it, the re-encode's input is the render, which requires
    grad: the cycle's share of stage 0's gradient is not zero."""
    batch = _tbatch(_batches(1)[0])
    eps = torch.randn(T, B, N_LATENTS, generator=torch.Generator().manual_seed(0))
    grads = []
    for cycle_weight in (0.0, 0.1):
        model = _tmodel(init_params)
        loss, _ = multi_term_loss(model, batch, 0.3, eps=eps, **dict(CUB, cycle_weight=cycle_weight))
        loss.backward()
        grads.append(model.image_enc.convs[0].weight.grad.clone())
    assert (grads[1] - grads[0]).abs().max() > 0


def test_five_train_steps_match_jax(jmodel):
    """Five steps of the ``cub`` step (cross-recon, the cycle term on the
    soft render with a live image decoder, no clipping) from the JAX init,
    beta ramping over 4 steps, each step's noise JAX's own: loss,
    ``cycle_ce``, beta and the raw gradient norm each step, the parameters
    after."""
    batches = _batches(5)
    state = j_create_train_state(jmodel, _jbatch(batches[0]), jax.random.key(7), 1e-3)
    init = _np_tree(state.params)
    j_step = j_make_train_step(jmodel, annealing_steps=4, term_fold="t", **CUB)
    model = _tmodel(init)
    t_state = create_train_state(model, 1e-3)
    step = make_train_step(model, annealing_steps=4, **CUB)
    for batch in batches:
        rng = jax.random.split(state.rng, 3)[0]
        state, j_metrics = j_step(state, _jbatch(batch))
        t_state, metrics = step(t_state, _tbatch(batch), eps=_eps(rng))
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


def test_api_train_cub_on_the_cpu():
    """``api.train`` of the ``cub`` config at a small width over its 64x64
    images and 32-token captions: one epoch of 2 batches, a finite train
    loss, ``cycle_ce`` and test ELBO in the history, and the same history
    again from the same seed."""
    cfg = configs.get_config("cub").replace(
        n_latents=8, epochs=1, train_size=16, test_size=8, batch_size=8,
        model_kwargs=dict(conv_features=(8, 8)))
    result = api.train(cfg, device="cpu", verbose=False)
    assert result.state.step == 2 and len(result.history) == 1
    record = result.history[0]
    assert set(record) == {"epoch", "train_loss", "cycle_ce", "test_elbo"}
    assert all(map(math.isfinite, record.values())) and record["cycle_ce"] > 0
    assert api.train(cfg, device="cpu", verbose=False).history == result.history


def test_step_options_are_the_jax_runner_options():
    """``api.step_options`` of ``cub`` names only keywords of
    ``make_train_step`` and carries the JAX config's values."""
    options = api.step_options(configs.get_config("cub"))
    assert set(options) <= set(inspect.signature(make_train_step).parameters)
    jcfg = jconfigs.get_config("cub")
    assert options == {k: getattr(jcfg, k) for k in options}
