"""Segmented eval against the JAX package.

``eval_elbo`` and ``log_likelihood`` with ``segment_steps`` keep the padded
split on the host and copy it to the device a segment at a time; the
result equals the whole split's to the bit (the per-batch values are
summed in float64 in one order either way) and matches JAX's segmented
eval at rtol 2e-4 (MNIST, and a narrow CelebA; 11 examples at batch
4 in segments of 2 batches, so the last batch and the last segment are
padded; JAX's IWAE noise passed in). Weights converted from the Flax
tree, on the CPU. (A CUB model on a mounted corpus is
``tests/test_torch_data_formats.py``'s.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import api as japi
from mmvae_tpu.data.pipelines import Dataset as JDataset
from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_torch import api
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import Dataset, make_celeba, make_mnist
from mmvae_torch.models import CelebAMVAE, MnistMVAE
from torch_threads import _one_torch_thread  # noqa: F401

RTOL = 2e-4
HW = 16
MODELS = {
    "mnist": (MnistMVAE, JMnistMVAE, dict(n_latents=16), lambda n, s: make_mnist(n, seed=s)),
    "celeba": (CelebAMVAE, JCelebAMVAE, dict(n_latents=8, image_hw=(HW, HW),
                                              conv_features=(32, 8)),
               lambda n, s: make_celeba(n, seed=s, hw=HW)),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", list(MODELS))
def test_segmented_eval_equals_the_whole_split_and_jax(name):
    """``eval_elbo`` and ``log_likelihood`` (the noise passed in, and drawn
    from a seed) at ``segment_steps`` 0 and 2: equal to the bit, and within
    rtol 2e-4 of JAX's segmented ones (the IWAE on MNIST)."""
    tcls, jcls, kwargs, make = MODELS[name]
    n, bs, k, seed = 11, 4, 3, 3
    data = make(n, 1_000_003)
    jmodel = jcls(**kwargs)
    jdata = {kk: jnp.asarray(v) for kk, v in data.items()}
    init = jax.jit(lambda b: jmodel.init(jax.random.key(0), b, rng=jax.random.key(1)))
    params = _np_tree(init(jdata)["params"])
    tmodel = tcls(**kwargs)
    tmodel.load_state_dict(from_flax_params(params))
    ds, jds = Dataset(data, n), JDataset(jdata, n)
    elbo = {s: api.eval_elbo(name, model=tmodel, dataset=ds, batch_size=bs, device="cpu",
                             segment_steps=s) for s in (0, 2)}
    assert elbo[0] == elbo[2]
    want = japi.eval_elbo(name, model=jmodel, params=params, dataset=jds, batch_size=bs,
                          segment_steps=2)
    np.testing.assert_allclose(elbo[0], want, rtol=RTOL)
    key = jax.random.key(seed)
    eps = torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (bs, k, tmodel.n_latents)))
        for i in range(-(-n // bs))]))
    ll = {s: api.log_likelihood(name, model=tmodel, dataset=ds, k=k, batch_size=bs,
                                device="cpu", eps=eps, segment_steps=s) for s in (0, 2)}
    assert ll[0] == ll[2]
    drawn = {s: api.log_likelihood(name, model=tmodel, dataset=ds, k=k, batch_size=bs,
                                   device="cpu", seed=5, segment_steps=s) for s in (0, 2)}
    assert drawn[0] == drawn[2]
    if name == "mnist":  # every config's IWAE meets JAX's in tests/test_torch_iwae.py
        want = japi.log_likelihood(name, model=jmodel, params=params, k=k, batch_size=bs,
                                   seed=seed, dataset=jds, segment_steps=2)
        np.testing.assert_allclose(ll[0], want, rtol=RTOL)


@pytest.mark.parametrize("caller", [False, True])
def test_evals_run_on_deterministic_algorithms_and_restore_the_callers(monkeypatch, caller):
    """``eval_elbo`` and ``log_likelihood`` build and run their runners with
    cuDNN's deterministic algorithms on, the fastest a shape kept for the
    process (``cudnn.benchmark``; what makes the segmented eval equal the
    whole one on the card at the default's speed), and leave the caller's
    settings as they were."""
    seen = []

    def flags():
        return torch.backends.cudnn.deterministic and torch.backends.cudnn.benchmark

    def spy(make):
        def made(*a, **k):
            seen.append(flags())
            runner = make(*a, **k)
            return lambda *ra: (seen.append(flags()), runner(*ra))[1]
        return made

    monkeypatch.setattr(api, "make_eval_runner", spy(api.make_eval_runner))
    monkeypatch.setattr(api, "make_iwae_runner", spy(api.make_iwae_runner))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", caller)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", caller)
    tmodel = MnistMVAE(n_latents=8)
    ds = Dataset(make_mnist(6, seed=3), 6)
    api.eval_elbo("mnist", model=tmodel, dataset=ds, batch_size=4, device="cpu",
                  segment_steps=1)
    api.log_likelihood("mnist", model=tmodel, dataset=ds, k=2, batch_size=4, device="cpu")
    assert seen and all(seen)
    assert torch.backends.cudnn.deterministic is caller
    assert torch.backends.cudnn.benchmark is caller
