"""The port's FashionMNIST slice against the JAX package, on the CPU.

The JAX ``FashionMnistMVAE`` is initialised from a seed at n_latents 16
with the conv widths the JAX model fixes (an image encoder of features
(32, 64) over the 28x28 grayscale garment, 28 -> 14 -> 7, a transposed-conv
decoder of (64, 32), 7 -> 14 -> 28, and the label expert), every bias is
moved off 0 so that the bias mapping is exercised, its parameters move
across with ``convert.from_flax_params``, and both sides see the same
numpy data. Inference (the model's methods, the eval step, ``eval_elbo``
on a padded split, ``generate``, ``log_likelihood`` with JAX's noise
passed in), the data, and training (one loss and every gradient against
``jax.value_and_grad``, five Adam steps against the JAX step, with the
noise JAX's steps draw passed in as ``eps``).

Tolerances as in ``tests/test_torch_mnist.py`` and
``tests/test_torch_train.py``: rtol 2e-4 (XLA-CPU transcendentals are
approximate, docs/DESIGN.md section 7), each gradient tensor with an atol
of 2e-4 of its largest element; Adam steps by the relative 2-norm of the
two updates' difference (below 1e-4) and elementwise within 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import api as japi
from mmvae_tpu import configs as jconfigs
from mmvae_tpu.data import load_dataset as j_load_dataset
from mmvae_tpu.data.pipelines import Dataset as JDataset
from mmvae_tpu.data.synthetic import _garment_masks as j_garment_masks
from mmvae_tpu.data.synthetic import make_fashionmnist as j_make_fashionmnist
from mmvae_tpu.models import FashionMnistMVAE as JFashionMnistMVAE
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_tpu.train.step import make_eval_step as j_make_eval_step
from mmvae_tpu.train.step import make_train_step as j_make_train_step
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import Dataset, load_dataset, make_fashionmnist
from mmvae_torch.data.synthetic import _garment_masks
from mmvae_torch.models import FashionMnistMVAE
from mmvae_torch.train import create_train_state, make_train_step, multi_term_loss

N_LATENTS, B, M, T = 16, 8, 2, 3
RTOL = 2e-4
STEP_ATOL = 1e-4
STEP_REL = 1e-4
BIASES = ("bias",)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, atol: float = 1e-4) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=atol)


def _tbatch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _tmodel(params) -> FashionMnistMVAE:
    model = FashionMnistMVAE(n_latents=N_LATENTS)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    return model


def _shift_biases(tree, rng):
    for key, value in tree.items():
        if isinstance(value, dict):
            _shift_biases(value, rng)
        elif key in BIASES:
            tree[key] = (value + 0.1 * rng.normal(size=value.shape)).astype(np.float32)


def _batches(n: int, seed: int = 5):
    data = make_fashionmnist(n * B, seed=seed)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(n)]


@pytest.fixture(scope="module")
def jmodel():
    return JFashionMnistMVAE(n_latents=N_LATENTS)


@pytest.fixture(scope="module")
def init_params(jmodel):
    """The JAX init, as training starts from it."""
    return jmodel.init(jax.random.key(0), _jbatch(_batches(1)[0]), rng=jax.random.key(1))["params"]


@pytest.fixture(scope="module")
def matched(init_params):
    """(JAX params with shifted biases, port model on the CPU, numpy data
    of 12 examples)."""
    params = jax.tree.map(np.array, init_params)
    _shift_biases(params, np.random.default_rng(0))
    return params, _tmodel(params), make_fashionmnist(12, seed=5)


def test_full_width_config():
    """The ``fashionmnist`` config and model at full width, as the JAX
    package sets them (``mmvae_tpu/configs.py:199-201``)."""
    cfg, jcfg = configs.get_config("fashionmnist"), jconfigs.get_config("fashionmnist")
    for k in ("n_latents", "batch_size", "epochs", "annealing_epochs", "learning_rate",
              "train_size", "test_size", "objective", "cross_recon", "cycle_weight"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    assert (cfg.n_latents, cfg.batch_size, cfg.train_size, cfg.test_size) == (64, 100, 10000, 2000)
    model = configs.build_model("fashionmnist", device="cpu")
    assert model.lambdas().tolist() == [1.0, 10.0]
    assert [c.out_channels for c in model.image_enc.convs] == [32, 64]
    assert model.image_enc.convs[0].in_channels == 1 and model.image_enc.channels == 1
    assert model.image_enc.layers[0].in_features == 7 * 7 * 64
    assert model.image_dec.base_hw == (7, 7)
    assert [d.out_channels for d in model.image_dec.deconvs] == [32, 1]


def test_convert_maps_every_parameter(matched):
    params, tmodel, _ = matched
    state = from_flax_params(params)
    assert set(state) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert state[k].shape == v.shape, k
    assert set(params["image_enc"]) == {"Conv_0", "Conv_1", "Dense_0", "Dense_1"}
    assert set(params["image_dec"]) == {"Dense_0", "Dense_1", "ConvTranspose_0",
                                        "ConvTranspose_1"}


@pytest.mark.parametrize("method", ["encode", "decode", "nll_all", "infer"])
def test_model_matches_jax(jmodel, matched, method):
    params, tmodel, data = matched
    vs = {"params": params}
    jb, tb = _jbatch(data), _tbatch(data)
    if method in ("encode", "infer"):
        want = jmodel.apply(vs, jb, method=method)
        got = getattr(tmodel, method)(tb)
        for g, w in zip(got, want):
            _close(g, w)
        return
    z = np.random.default_rng(0).normal(size=(12, N_LATENTS)).astype(np.float32)
    want = jmodel.apply(vs, jnp.asarray(z), method="decode")
    got = tmodel.decode(torch.from_numpy(z))
    if method == "decode":
        assert got["image"].shape == (12, 28, 28)
        for k in want:
            _close(got[k], want[k])
        return
    j_nll = jmodel.apply(vs, want, jb, method="nll_all")
    _close(tmodel.nll_all(got, tb), j_nll, atol=1e-3)


def test_eval_step_metrics_match_jax(jmodel, matched):
    """t-fold, member-pruned, with a presence mask that drops modalities
    and a whole example."""
    params, tmodel, data = matched
    presence = np.ones((12, 2), np.float32)
    presence[1, 0] = presence[2, 1] = 0.0
    presence[3] = 0.0
    want = j_make_eval_step(jmodel)(params, _jbatch(dict(data, presence=presence)))
    with torch.no_grad():
        _, got = multi_term_loss(tmodel, _tbatch(dict(data, presence=presence)), 1.0,
                                 sample=False)
    for k in ("loss", "recon_per_term", "kl_per_term", "elbo_per_term"):
        _close(got[k], want[k], atol=1e-3)


def test_eval_elbo_matches_jax_on_padded_split(jmodel, matched):
    """70 examples at batch 32: the last batch is 26 rows padded by 6."""
    params, tmodel, _ = matched
    want = japi.eval_elbo(
        "fashionmnist", model=jmodel, params=params, batch_size=32,
        dataset=j_load_dataset("fashionmnist", "test", n=70),
    )
    got = api.eval_elbo(
        "fashionmnist", model=tmodel, dataset=load_dataset("fashionmnist", "test", n=70),
        batch_size=32, device="cpu",
    )
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("observed", [("label",), ("image",)])
def test_generate_matches_jax(jmodel, matched, observed):
    params, tmodel, data = matched
    condition = {"label": np.asarray([3, 5, 7], np.int32), "image": data["image"][:3]}
    condition = {k: condition[k] for k in observed}
    want = japi.generate(
        "fashionmnist", condition, model=jmodel, params=params, sample_z=False)
    got = api.generate("fashionmnist", condition, model=tmodel, device="cpu")
    _close(got["image"], want["image"])
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))


def test_sample_shapes_and_range(matched):
    _, tmodel, _ = matched
    out = api.sample("fashionmnist", n=16, model=tmodel, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert out["image"].shape == (16, 28, 28) and out["label"].shape == (16,)
    assert torch.isfinite(out["image"]).all()
    assert 0.0 <= out["image"].min() and out["image"].max() <= 1.0
    assert 0 <= out["label"].min() and out["label"].max() < 10


@pytest.mark.parametrize("seed", [0, 1_000_003])
def test_make_fashionmnist_byte_identical_to_jax(seed):
    assert _garment_masks().tobytes() == j_garment_masks().tobytes()
    got, want = make_fashionmnist(50, seed=seed), j_make_fashionmnist(50, seed=seed)
    for k in ("image", "label"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes()
    split = load_dataset("fashionmnist", "train" if seed == 0 else "test", n=50)
    for k in ("image", "label"):
        assert split.arrays[k].tobytes() == want[k].tobytes()


def test_log_likelihood_matches_jax(jmodel, matched):
    """10 examples at batch 4 (the last batch holds 2 and 2 pad rows), k =
    3, the noise JAX draws for batch i from ``fold_in(key(seed), i)``."""
    params, tmodel, _ = matched
    n, bs, k, seed = 10, 4, 3, 3
    data = make_fashionmnist(n, seed=1_000_003)
    want = japi.log_likelihood(
        "fashionmnist", model=jmodel, params=params, k=k, batch_size=bs, seed=seed,
        dataset=JDataset(arrays=_jbatch(data), size=n),
    )
    key = jax.random.key(seed)
    eps = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (bs, k, N_LATENTS)))
        for i in range(-(-n // bs))
    ])
    got = api.log_likelihood(
        "fashionmnist", model=tmodel, dataset=Dataset(arrays=data, size=n), k=k,
        batch_size=bs, device="cpu", eps=torch.from_numpy(eps),
    )
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _eps(rng) -> torch.Tensor:
    """The noise JAX's ``multi_term_loss`` draws from ``rng``."""
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.split(rng)[1], (T, B, N_LATENTS))))


def _grads_close(got: dict[str, torch.Tensor], want: dict[str, torch.Tensor]) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 2e-4 * w.abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL, atol=atol, err_msg=k)


def test_loss_metrics_and_every_gradient_match_jax(jmodel, init_params):
    """One loss evaluation of the train step (sample=True, beta 0.3,
    member-pruned, t-fold): the loss, the per-term metrics and every
    parameter's gradient against ``jax.value_and_grad`` of the JAX loss."""
    batch = _batches(1)[0]
    rng = jax.random.key(3)

    def loss_fn(params):
        return j_multi_term_loss(jmodel, params, _jbatch(batch), rng, 0.3, sample=True,
                                 term_fold="t")

    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        init_params)
    model = _tmodel(init_params)
    loss, metrics = multi_term_loss(model, _tbatch(batch), 0.3, eps=_eps(rng))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    for k in ("recon_per_term", "kl_per_term", "elbo_per_term"):
        np.testing.assert_allclose(
            metrics[k].detach().numpy(), np.asarray(j_metrics[k]), rtol=RTOL, atol=1e-3)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))


def test_five_train_steps_match_jax(jmodel):
    """Five steps of the ``fashionmnist`` step from the JAX init, beta
    ramping over 4 steps, each step's noise JAX's own: loss, beta and the
    raw gradient norm each step, the parameters after."""
    batches = _batches(5)
    state = j_create_train_state(jmodel, _jbatch(batches[0]), jax.random.key(7), 1e-3)
    init = _np_tree(state.params)
    j_step = j_make_train_step(jmodel, annealing_steps=4, term_fold="t")
    model = _tmodel(init)
    t_state = create_train_state(model, 1e-3)
    step = make_train_step(model, annealing_steps=4)
    for batch in batches:
        rng = jax.random.split(state.rng, 3)[0]
        state, j_metrics = j_step(state, _jbatch(batch))
        t_state, metrics = step(t_state, _tbatch(batch), eps=_eps(rng))
        assert metrics["beta"].item() == float(j_metrics["beta"])
        np.testing.assert_allclose(metrics["loss"].item(), float(j_metrics["loss"]), rtol=RTOL)
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


def test_api_train_fashionmnist_on_the_cpu():
    """``api.train`` of the ``fashionmnist`` config at n_latents 16: one
    epoch of 2 batches of 16, a finite train loss and test ELBO, and the
    same history again from the same seed."""
    cfg = configs.get_config("fashionmnist").replace(
        n_latents=N_LATENTS, epochs=1, train_size=32, test_size=16, batch_size=16)
    result = api.train(cfg, device="cpu", verbose=False)
    assert result.state.step == 2 and len(result.history) == 1
    assert set(result.history[0]) == {"epoch", "train_loss", "test_elbo"}
    assert all(map(math.isfinite, result.history[0].values()))
    assert api.train(cfg, device="cpu", verbose=False).history == result.history
