"""The port's mixture objectives (mmvae, mopoe) against the JAX package, on the CPU.

``core.component_masks``, ``posterior_components``, ``mixture_z`` and
``fuse_observed_z`` against ``mmvae_tpu/core/mixture.py``; the loss and
every gradient of ``multi_term_loss`` under ``"mmvae"`` and ``"mopoe"``
against ``jax.value_and_grad`` of the JAX loss (``term_fold="t"``) on the
JAX ``MnistMVAE`` (n_latents 16) and, for mopoe's fallback family past 8
modalities, on a narrow ``CelebAMVAE`` (16x16 images, conv features (8,
16), 19 modalities, T = 20); ``api.eval_elbo``, ``api.generate`` and
``api.log_likelihood`` under mixture configs against the JAX entry points.
The weights move across with ``convert.from_flax_params``.

JAX's randomness is passed in: the posterior noise as the normal of
``split(rng)[1]`` (``multi_term_loss``), and a mixture draw's component
index and noise as ``categorical`` of the first half of its key and the
normal of the second (``mixture_z``).

Tolerances as in ``tests/test_torch_train.py``: rtol 2e-4 (XLA-CPU
transcendentals are approximate, docs/DESIGN.md section 7), each gradient
tensor with an atol of 2e-4 of its largest element. Masks, validity
weights and component indices are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import api as japi
from mmvae_tpu import configs as jconfigs
from mmvae_tpu.core import mixture as jmixture
from mmvae_tpu.data import load_dataset as j_load_dataset
from mmvae_tpu.data.pipelines import Dataset as JDataset
from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs, core
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import Dataset, load_dataset, make_celeba, make_mnist
from mmvae_torch.models import CelebAMVAE, MnistMVAE
from mmvae_torch.train import make_train_step, multi_term_loss

RTOL = 2e-4
N_LATENTS, B, M = 16, 8, 2
MIXTURES = ("mmvae", "mopoe")
# Terms of each objective on MNIST's two modalities.
TERMS = {"mmvae": 2, "mopoe": 3}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tbatch(batch) -> dict[str, torch.Tensor]:
    return {k: _t(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got: torch.Tensor, want, atol: float = 1e-5) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=atol)


def _grads_close(got: dict[str, torch.Tensor], want: dict[str, torch.Tensor]) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 2e-4 * w.abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL, atol=atol, err_msg=k)


def _experts(b: int, m: int, l: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(b, m, l)).astype(np.float32)
    lv = rng.normal(size=(b, m, l)).astype(np.float32)
    return mu, lv


def _presence(b: int, m: int) -> np.ndarray:
    """All observed but row 1 (its first modality absent), row 2 (its last
    absent) and row 3 (nothing observed)."""
    presence = np.ones((b, m), np.float32)
    presence[1, 0] = presence[2, -1] = 0.0
    presence[3] = 0.0
    return presence


def _jax_mixture_draws(rng, weights, l: int):
    """The component index and the noise JAX's ``mixture_z`` draws from
    ``rng`` for ``weights`` ``(B, K)``."""
    comp_rng, z_rng = jax.random.split(rng)
    logits = jnp.where(jnp.asarray(weights) > 0, 0.0, -jnp.inf)
    idx = jax.random.categorical(comp_rng, logits, axis=-1)
    eps = jax.random.normal(z_rng, (weights.shape[0], l))
    return _t(idx), _t(eps)


@pytest.mark.parametrize(
    "objective,m", [("mmvae", 2), ("mmvae", 5), ("mopoe", 2), ("mopoe", 3), ("mopoe", 8),
                    ("mopoe", 9), ("mopoe", 19)])
def test_component_masks_match_jax(objective, m):
    """The identity; the powerset in bit order up to 8 modalities, then
    the joint and the unimodal rows; the same bits as JAX's."""
    got = core.component_masks(objective, m)
    want = np.asarray(jmixture.component_masks(objective, m))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("objective", ["mvae", "mvtcae", "vae"])
def test_component_masks_refuse_objectives_without_a_mixture(objective):
    with pytest.raises(ValueError, match="no mixture components"):
        core.component_masks(objective, 3)


@pytest.mark.parametrize("with_presence", [False, True])
@pytest.mark.parametrize("objective", MIXTURES)
def test_posterior_components_match_jax(objective, with_presence):
    """The (B, K, L) component posteriors through ``ops.poe_kl`` and the
    validity weights against JAX's PoE of each component: a row with
    nothing observed gives the prior and weights 0."""
    mu, lv = _experts(6, 3, 8)
    presence = _presence(6, 3) if with_presence else None
    comp = core.component_masks(objective, 3)
    got = core.posterior_components(
        _t(mu), _t(lv), None if presence is None else _t(presence), comp)
    want = jmixture.posterior_components(
        jnp.asarray(mu), jnp.asarray(lv), None if presence is None else jnp.asarray(presence),
        jmixture.component_masks(objective, 3))
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if with_presence:
        assert not got[2][3].any()
        torch.testing.assert_close(got[0][3], torch.zeros_like(got[0][3]))


@pytest.mark.parametrize("objective", MIXTURES)
def test_mixture_z_mean_matches_jax(objective):
    mu, lv = _experts(6, 3, 8, seed=1)
    presence = _presence(6, 3)
    comp = core.component_masks(objective, 3)
    mu_c, lv_c, w = core.posterior_components(_t(mu), _t(lv), _t(presence), comp)
    j_mu_c, j_lv_c, j_w = jmixture.posterior_components(
        jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(presence),
        jmixture.component_masks(objective, 3))
    want = jmixture.mixture_z(None, j_mu_c, j_lv_c, j_w, sample=False)
    got = core.mixture_z(mu_c, lv_c, w, sample=False)
    _close(got, want)
    torch.testing.assert_close(got[3], torch.zeros_like(got[3]))  # nothing observed


@pytest.mark.parametrize("objective", MIXTURES)
def test_mixture_z_draw_matches_jax_with_its_component_and_noise(objective):
    """``sample=True`` with JAX's own component index and noise passed in
    gives JAX's draw; the all-invalid row takes component 0 in JAX, and the
    port's own draw takes it there too and a valid component elsewhere."""
    mu, lv = _experts(6, 3, 8, seed=2)
    presence = _presence(6, 3)
    comp = core.component_masks(objective, 3)
    mu_c, lv_c, w = core.posterior_components(_t(mu), _t(lv), _t(presence), comp)
    j_mu_c, j_lv_c, j_w = jmixture.posterior_components(
        jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(presence),
        jmixture.component_masks(objective, 3))
    rng = jax.random.key(7)
    want = jmixture.mixture_z(rng, j_mu_c, j_lv_c, j_w, sample=True)
    idx, eps = _jax_mixture_draws(rng, np.asarray(j_w), 8)
    assert idx[3] == 0
    _close(core.mixture_z(mu_c, lv_c, w, component=idx, eps=eps), want)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        z = core.mixture_z(mu_c, lv_c, w, generator=gen, eps=torch.zeros(6, 8))
        # Which component each row took: the one whose mean is z (eps 0).
        drawn = (mu_c - z[:, None]).abs().amax(-1).argmin(-1)
        assert drawn[3] == 0
        assert bool((w[torch.arange(6), drawn] > 0)[torch.arange(6) != 3].all())


def test_mixture_z_own_draw_is_uniform_over_the_valid_components():
    """20,000 draws over rows of valid sets {0, 2, 3}, {1} and {0..4}: each
    valid component within 0.015 of its uniform share, never an invalid
    one."""
    w = torch.tensor([[1.0, 0, 1, 1, 0], [0, 1, 0, 0, 0], [1, 1, 1, 1, 1]])
    n = 20_000
    mu_c = torch.arange(5.0)[None, :, None].expand(3, 5, 1).contiguous()
    gen = torch.Generator().manual_seed(1)
    counts = torch.zeros(3, 5)
    for _ in range(n // 1000):
        z = core.mixture_z(mu_c.repeat(1000, 1, 1), torch.zeros(3000, 5, 1), w.repeat(1000, 1),
                           generator=gen, eps=torch.zeros(3000, 1))
        idx = z[:, 0].round().long().view(1000, 3)
        for r in range(3):
            counts[r] += torch.bincount(idx[:, r], minlength=5).float()
    share = counts / n
    want = w / w.sum(-1, keepdim=True)
    assert bool((share[w == 0] == 0).all())
    assert (share - want).abs().max() < 0.015, share


@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("objective", ["mvae", "mmvae", "mopoe", "mvtcae"])
def test_fuse_observed_z_matches_jax(objective, sample):
    """Every objective, the mean and a draw with JAX's index and noise
    passed in (the PoE objectives draw only the noise, from the whole key)."""
    mu, lv = _experts(6, 3, 8, seed=3)
    presence = _presence(6, 3)
    rng = jax.random.key(11)
    want = jmixture.fuse_observed_z(rng, jnp.asarray(mu), jnp.asarray(lv),
                                    jnp.asarray(presence), objective, sample=sample)
    component = eps = None
    if sample and objective in MIXTURES:
        _, _, j_w = jmixture.posterior_components(
            jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(presence),
            jmixture.component_masks(objective, 3))
        component, eps = _jax_mixture_draws(rng, np.asarray(j_w), 8)
    elif sample:
        eps = _t(jax.random.normal(rng, (6, 8)))
    got = core.fuse_observed_z(_t(mu), _t(lv), _t(presence), objective, sample=sample,
                               component=component, eps=eps)
    _close(got, want)


# -------------------------------------------------------------- the loss --


def _batches(n: int, seed: int = 5):
    data = make_mnist(n * B, seed=seed)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(n)]


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


def _eps(rng, t: int, b: int, l: int) -> torch.Tensor:
    """The noise JAX's ``multi_term_loss`` draws from ``rng``."""
    return _t(jax.random.normal(jax.random.split(rng)[1], (t, b, l)))


@pytest.mark.parametrize("with_presence", [False, True])
@pytest.mark.parametrize("objective", MIXTURES)
def test_loss_metrics_and_every_gradient_match_jax(jmodel, init_params, objective,
                                                   with_presence):
    """One loss evaluation of the train step (sample=True, beta 0.3) under
    a mixture objective: the decode-all pass of every component, the
    per-example term weights over the valid components (presence: rows
    missing a modality, and a row with nothing, whose terms weigh 0), the
    loss, every metric and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX loss."""
    batch = _batches(1)[0]
    if with_presence:
        batch = dict(batch, presence=_presence(B, M))
    rng = jax.random.key(3)

    @jax.jit
    def loss_and_grad(params):
        return jax.value_and_grad(
            lambda q: j_multi_term_loss(jmodel, q, _jbatch(batch), rng, 0.3, sample=True,
                                        term_fold="t", objective=objective),
            has_aux=True)(params)

    (j_loss, j_metrics), j_grads = loss_and_grad(init_params)
    model = _tmodel(init_params)
    loss, metrics = multi_term_loss(model, _tbatch(batch), 0.3, objective=objective,
                                    eps=_eps(rng, TERMS[objective], B, N_LATENTS))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    assert set(metrics) == set(j_metrics)
    for k in ("recon_per_term", "kl_per_term", "elbo_per_term"):
        _close(metrics[k], j_metrics[k], atol=1e-3)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))


CELEBA_SMALL = dict(n_latents=8, image_hw=(16, 16), conv_features=(8, 16))


def test_mopoe_on_celeba_takes_the_fallback_family(monkeypatch):
    """CelebA's 19 modalities under mopoe: the 20 terms of the joint and
    the unimodal rows, every key decoded on all of them, with a presence
    mask (one row without its image, one without three attributes): the
    loss, the metrics and every gradient against JAX."""
    jm = JCelebAMVAE(**CELEBA_SMALL)
    data = make_celeba(4, seed=5, hw=16)
    params = jm.init(jax.random.key(0), _jbatch(data), rng=jax.random.key(1))["params"]
    presence = np.ones((4, 19), np.float32)
    presence[1, 0] = 0.0
    presence[2, 3:6] = 0.0
    batch = dict(data, presence=presence)
    rng = jax.random.key(5)
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda q: j_multi_term_loss(jm, q, _jbatch(batch), rng, 0.5, sample=True,
                                    term_fold="t", objective="mopoe"), has_aux=True))(params)
    model = CelebAMVAE(**CELEBA_SMALL)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    loss, metrics = multi_term_loss(model, _tbatch(batch), 0.5, objective="mopoe",
                                    eps=_eps(rng, 20, 4, 8))
    loss.backward()
    assert metrics["elbo_per_term"].shape == (20,)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    for k in ("recon_per_term", "kl_per_term", "elbo_per_term"):
        _close(metrics[k], j_metrics[k], atol=1e-3)
    _grads_close(
        {k: p.grad for k, p in model.named_parameters()}, from_flax_params(_np_tree(j_grads)))


@pytest.mark.parametrize(
    "knob", [dict(n_random_subsets=1), dict(cross_recon=True),
             dict(cross_recon=True, cross_recon_stopgrad=True), dict(cross_recon_stopgrad=True),
             dict(unimodal_align_weight=0.1)])
@pytest.mark.parametrize("objective", ["mmvae", "mopoe", "mvtcae"])
def test_mixture_objectives_refuse_the_mvae_term_knobs(init_params, objective, knob):
    """As the JAX loss does (``step.py:494-505``), from the loss and from
    the step's builder; the JAX loss raises the same."""
    model = _tmodel(init_params)
    with pytest.raises(ValueError, match="mvae term-structure knobs"):
        multi_term_loss(model, _tbatch(_batches(1)[0]), objective=objective, **knob)
    with pytest.raises(ValueError, match="mvae term-structure knobs"):
        make_train_step(model, objective=objective, **knob)


def test_the_jax_loss_refuses_the_same_knobs(jmodel, init_params):
    with pytest.raises(ValueError, match="mvae term-structure knobs"):
        j_multi_term_loss(jmodel, init_params, _jbatch(_batches(1)[0]), jax.random.key(0), 1.0,
                          term_fold="t", objective="mopoe", unimodal_align_weight=0.1)


# ------------------------------------------------------- the entry points --


@pytest.mark.parametrize("objective", ["mmvae", "mopoe", "mvtcae"])
def test_eval_elbo_matches_jax_on_padded_split(jmodel, init_params, objective):
    """70 examples at batch 32: the last batch is 26 rows padded by 6,
    whose terms all weigh 0 under every objective."""
    params = _np_tree(init_params)
    want = japi.eval_elbo(
        jconfigs.get_config("mnist").replace(n_latents=N_LATENTS, objective=objective),
        model=jmodel, params=params, batch_size=32,
        dataset=j_load_dataset("mnist", "test", n=70))
    got = api.eval_elbo(
        configs.get_config("mnist").replace(n_latents=N_LATENTS, objective=objective),
        model=_tmodel(params), dataset=load_dataset("mnist", "test", n=70), batch_size=32,
        device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("sample_z", [False, True])
@pytest.mark.parametrize("observed", [("label",), ("image",), ()])
@pytest.mark.parametrize("objective", MIXTURES)
def test_generate_matches_jax(jmodel, init_params, objective, observed, sample_z):
    """``generate`` from the label, the image or nothing (every row then
    falls back to the prior, component 0), the mixture's mean or a draw
    with JAX's component index and noise passed in (``api.py:1567-1579``:
    the mixture's key is the second half of ``key(seed)``)."""
    params = _np_tree(init_params)
    data = _batches(1)[0]
    condition = {"label": np.asarray([3, 5, 7], np.int32), "image": data["image"][:3]}
    condition = {k: condition[k] for k in observed}
    jcfg = jconfigs.get_config("mnist").replace(n_latents=N_LATENTS, objective=objective)
    want = japi.generate(jcfg, condition, n=3, model=jmodel, params=params, seed=4,
                         sample_z=sample_z)
    component = eps = None
    if sample_z:
        presence = np.zeros((3, M), np.float32)
        presence[:, [("image", "label").index(k) for k in observed]] = 1.0
        weights = (presence @ np.asarray(jmixture.component_masks(objective, M)).T > 0)
        z_rng = jax.random.split(jax.random.key(4))[1]
        component, eps = _jax_mixture_draws(z_rng, weights.astype(np.float32), N_LATENTS)
        if not observed:
            assert not component.any()
    got = api.generate(
        configs.get_config("mnist").replace(n_latents=N_LATENTS, objective=objective),
        condition, n=3, model=_tmodel(params), device="cpu", sample_z=sample_z,
        component=component, eps=eps)
    _close(got["image"], want["image"], atol=1e-4)
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))


@pytest.mark.parametrize("objective", MIXTURES)
def test_generate_draws_its_own_mixture_component(init_params, objective):
    """Without passed-in draws, ``generate`` from the label with
    ``sample_z`` draws from ``generator``: the same seed gives the same
    images, another seed others, and nothing raises on rows that observe
    nothing (``sample``)."""
    model = _tmodel(init_params)
    cfg = configs.get_config("mnist").replace(n_latents=N_LATENTS, objective=objective)

    def gen(seed, condition):
        return api.generate(cfg, condition, n=4, model=model, device="cpu", sample_z=True,
                            generator=torch.Generator().manual_seed(seed))["image"]

    label = {"label": np.asarray([1, 2, 3, 4], np.int32)}
    torch.testing.assert_close(gen(0, label), gen(0, label))
    assert not torch.equal(gen(0, label), gen(1, label))
    out = api.sample(cfg, n=4, model=model, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out["image"]).all() and out["image"].shape == (4, 28, 28)


@pytest.mark.parametrize("objective", MIXTURES)
def test_log_likelihood_keeps_the_joint_proposal(jmodel, init_params, objective):
    """``log_likelihood`` of a mixture config equals JAX's (the joint PoE
    proposal under every objective, ``mmvae_tpu/api.py:1234-1238``), and
    the port's own value under the mvae config, to the bit."""
    params = _np_tree(init_params)
    n, bs, k, seed = 10, 4, 3, 3
    data = make_mnist(n, seed=1_000_003)
    want = japi.log_likelihood(
        jconfigs.get_config("mnist").replace(n_latents=N_LATENTS, objective=objective),
        model=jmodel, params=params, k=k, batch_size=bs, seed=seed,
        dataset=JDataset(arrays=_jbatch(data), size=n))
    key = jax.random.key(seed)
    eps = torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (bs, k, N_LATENTS)))
        for i in range(-(-n // bs))]))
    model = _tmodel(params)

    def port(obj):
        return api.log_likelihood(
            configs.get_config("mnist").replace(n_latents=N_LATENTS, objective=obj),
            model=model, dataset=Dataset(arrays=data, size=n), k=k, batch_size=bs,
            device="cpu", eps=eps)

    got = port(objective)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got == port("mvae")


@pytest.mark.parametrize("objective", MIXTURES)
def test_api_train_under_a_mixture_objective(objective):
    """``api.train`` of ``mnist`` under the objective at a small width: one
    epoch of 3 batches, a finite train loss and test ELBO, and the same
    history again from the same seed."""
    cfg = configs.get_config("mnist").replace(
        objective=objective, n_latents=8, epochs=1, train_size=24, test_size=16, batch_size=8)
    result = api.train(cfg, device="cpu", verbose=False)
    assert result.state.step == 3 and set(result.history[0]) == {"epoch", "train_loss",
                                                                 "test_elbo"}
    assert all(np.isfinite(v) for v in result.history[0].values())
    assert api.train(cfg, device="cpu", verbose=False).history == result.history
