"""The port's IWAE log-likelihood against the JAX package, on the CPU.

``core.iwae_bound`` and ``api.log_likelihood`` of ``mnist``, ``multimnist``,
``celeba`` and ``cub`` at small widths (n_latents 8-16; conv features (8,
16) over 16x16 images; MultiMNIST's text hidden 16; MNIST's MLPs and CUB's
caption experts at the widths the JAX models fix) on weights converted from
the Flax tree, with the JAX noise passed in: ``jax.random.normal(rng, (B,
k, L))`` as ``iwae_bound`` draws it, and for ``log_likelihood`` batch
``i``'s from ``fold_in(key(seed), i)``. The k samples fold b-major (row
``b * k + t``); no two examples of the data are equal, so a t-major
decode or NLL would pair samples with other examples' targets, which
``test_bmajor_pairing`` checks against a sample-by-sample reference.
Tolerance rtol 2e-4: XLA-CPU transcendentals are approximate
(docs/DESIGN.md section 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import api as japi
from mmvae_tpu import models as jmodels
from mmvae_tpu.core.iwae import iwae_bound as j_iwae_bound
from mmvae_tpu.data.pipelines import Dataset as JDataset
from mmvae_torch import api, models
from mmvae_torch.convert import from_flax_params
from mmvae_torch.core import iwae_bound
from mmvae_torch.data import Dataset, make_celeba, make_cub, make_mnist, make_multimnist
from mmvae_torch.train import make_iwae_runner

RTOL = 2e-4
HW = 16
CONFIGS = ("mnist", "multimnist", "celeba", "cub")
# (model class name, constructor keywords, data of n examples at seed s).
SMALL = {
    "mnist": ("MnistMVAE", dict(n_latents=16), lambda n, s: make_mnist(n, seed=s)),
    "multimnist": (
        "MultiMnistMVAE",
        dict(n_latents=16, conv_features=(4, 8), text_hidden=16, text_embed=8,
             text_latent_dims=8, lambda_text=30.0),
        lambda n, s: make_multimnist(n, seed=s),
    ),
    "celeba": (
        "CelebAMVAE", dict(n_latents=8, image_hw=(HW, HW), conv_features=(8, 16)),
        lambda n, s: make_celeba(n, seed=s, hw=HW),
    ),
    "cub": (
        "CubMVAE", dict(n_latents=16, vocab_size=23, image_hw=(HW, HW), conv_features=(8, 16)),
        lambda n, s: make_cub(n, seed=s, hw=HW),
    ),
}


def _tbatch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


@pytest.fixture(scope="module", params=CONFIGS)
def matched(request):
    """(config, JAX model, JAX params, port model on the CPU, data maker)."""
    name = request.param
    cls, kwargs, make = SMALL[name]
    jmodel = getattr(jmodels, cls)(**kwargs)
    params = jmodel.init(jax.random.key(0), _jbatch(make(2, 5)), rng=jax.random.key(1))
    params = jax.tree.map(np.array, params["params"])
    tmodel = getattr(models, cls)(**kwargs)
    tmodel.load_state_dict(from_flax_params(params))
    return name, jmodel, params, tmodel, make


@pytest.mark.parametrize("k", [1, 4])
def test_iwae_bound_matches_jax(matched, k):
    _, jmodel, params, tmodel, make = matched
    data = make(6, 11)
    rng = jax.random.key(7)
    want = j_iwae_bound(jmodel, params, _jbatch(data), rng, k=k)
    eps = jax.random.normal(rng, (6, k, tmodel.n_latents))
    with torch.no_grad():
        got = iwae_bound(tmodel, _tbatch(data), k, eps=torch.from_numpy(np.array(eps)))
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-3)


def test_log_likelihood_matches_jax(matched):
    """10 examples at batch 4: the last batch holds 2 and 2 pad rows."""
    name, jmodel, params, tmodel, make = matched
    n, bs, k, seed = 10, 4, 3, 3
    data = make(n, 1_000_003)
    want = japi.log_likelihood(
        name, model=jmodel, params=params, k=k, batch_size=bs, seed=seed,
        dataset=JDataset(arrays=_jbatch(data), size=n),
    )
    key = jax.random.key(seed)
    eps = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (bs, k, tmodel.n_latents)))
        for i in range(-(-n // bs))
    ])
    got = api.log_likelihood(
        name, model=tmodel, dataset=Dataset(arrays=data, size=n), k=k, batch_size=bs,
        device="cpu", eps=torch.from_numpy(eps),
    )
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _distinct(data) -> bool:
    """Whether every example differs from every other (in some modality)."""
    n = len(next(iter(data.values())))
    rows = np.concatenate([v.reshape(n, -1).astype(np.float64) for v in data.values()], 1)
    return len(np.unique(rows, axis=0)) == n


def test_bmajor_pairing(matched):
    """Each sample z[b, t] scored against its own example's targets: one
    decode and NLL per sample (no fold at all), from ``model.infer``'s
    plain product of experts, equals the b-major folded bound."""
    _, _, _, tmodel, make = matched
    data, b, k = _tbatch(make(5, 21)), 5, 3
    assert _distinct({key: v.numpy() for key, v in data.items()})
    eps = torch.randn((b, k, tmodel.n_latents), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = iwae_bound(tmodel, data, k, eps=eps)
        mu, logvar = tmodel.infer(data)
        log_w = torch.empty(b, k)
        seq = [s.name for s in tmodel.specs() if s.kind == "seq"]
        for i in range(b):
            one = {key: v[i : i + 1] for key, v in data.items()}
            for t in range(k):
                z = mu[i] + torch.exp(0.5 * logvar[i]) * eps[i, t]
                recons = tmodel.decode(z[None], one if seq else None)
                log_p = -tmodel.nll_all(recons, one).sum()
                log_q = torch.distributions.Normal(mu[i], torch.exp(0.5 * logvar[i])).log_prob(z)
                log_prior = torch.distributions.Normal(0.0, 1.0).log_prob(z)
                log_w[i, t] = log_p + log_prior.sum() - log_q.sum()
    want = torch.logsumexp(log_w, dim=1) - np.log(k)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


def test_runner_zeroes_pad_rows_and_reads_the_generator(matched):
    """The eager runner (the CPU's): pad rows give exactly 0; with no
    ``eps`` the noise is drawn from the generator, batch after batch, as
    ``iwae_bound`` draws it alone."""
    _, _, _, tmodel, make = matched
    data = _tbatch(make(4, 31))
    stacked = {key: v.reshape((2, 2) + v.shape[1:]) for key, v in data.items()}
    stacked["valid"] = torch.tensor([[1.0, 1.0], [1.0, 0.0]])
    runner = make_iwae_runner(tmodel, 2, generator=torch.Generator().manual_seed(4))
    got = runner(stacked)["log_likelihood"]
    assert got.shape == (2, 2) and got[1, 1] == 0.0 and torch.isfinite(got).all()
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        want = [iwae_bound(tmodel, {key: v[i] for key, v in stacked.items() if key != "valid"},
                           2, generator=gen) for i in range(2)]
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1, 0], want[1][0], rtol=0, atol=0)


def test_log_likelihood_checks_eps_shape(matched):
    name, _, _, tmodel, make = matched
    data = make(5, 41)
    with pytest.raises(ValueError, match="eps must be"):
        api.log_likelihood(name, model=tmodel, dataset=Dataset(arrays=data, size=5), k=2,
                           batch_size=4, device="cpu", eps=torch.zeros(1, 4, 2, tmodel.n_latents))
