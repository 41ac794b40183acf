"""The port's bf16 compute dtype against the JAX package at ``dtype=jnp.bfloat16``, on the CPU.

Each of the seven configs at a small width (the widths of the configs'
own CPU test files) is built twice on each side: the port's model at
``dtype=torch.bfloat16`` with the weights of a random Flax tree
(``convert.from_flax_params``: kernels N(0, 1/fan-in), every bias and
vector N(0, 0.1^2), so that the bias order shows), against the same Flax
model at ``dtype=jnp.bfloat16`` (the reference) and at float32 (the
control). Both sides see the same numpy data; JAX's noise is passed in
where the port draws its own.

What is held, and how:

* each expert against its Flax module: a model's ``encode`` (every
  encoder's ``(mu, logvar)``: the MLP, label, conv, attribute-bank and GRU
  encoders; batches of 16) and ``decode`` (every decoder's logits: MLP, label, deconv,
  attribute bank, the teacher-forced ``SeqDecoder``), the trunks alone,
  CelebA with ``space_to_depth=2`` and ``upsample_mode="shuffle"``;
* ``eval_elbo``, ``log_likelihood`` (JAX's noise) and ``generate`` of
  all seven configs; tokens generated at temperature 0 equal wherever
  JAX's top two logits at that step (the teacher-forced JAX decoder on
  JAX's own tokens) differ by more than ``MARGIN``; the rows where they do
  not are counted and reported;
* one loss and every gradient against ``jax.value_and_grad`` of the bf16
  JAX loss (``mnist``; ``celeba`` at T = 24 with JAX's subset masks;
  ``cub`` with cross-recon and the cycle term on a live soft render);
* ``api.train(dtype=bf16)`` against ``mmvae_tpu.api.train(dtype=bf16)``;
* ``_dequant_data`` at a bf16 model against JAX's for every uint8 value,
  to the bit;
* the plain K4, its weight gradient and its dx on bf16 operands against
  ``jax.vjp`` of ``tools/pallas_conv_probe.py::xla_conv0``;
* the ops layer on bf16 logits against the Pallas kernels in interpret
  mode, and the dtypes of the gradients.

Tolerances. A bf16 value carries 8 significant bits, so one rounding
moves it by at most 2^-9 of itself, and two bf16 results of one function
may land one step (2^-7 of the value at most) apart. Each side rounds
every op's output, but sums a product in its own order (and XLA may keep
f32 inside a fusion, its "excess precision"), so an output may differ by
a step or two at its largest
entries: each output tensor is held to an atol of ``BF16_TOL`` = 2^-5 of
its largest magnitude (4 steps at the top; measured 1 to 1.3 steps on
these models). The gradients, the products of many such factors, to an
atol of 2^-4 of each tensor's largest entry. Scalars that sum many
rounded terms (the losses, the ELBO, the IWAE estimate) to rtol 2e-3.
The check that makes these tolerances mean something: every tensor is
also compared with the f32 control, and each output tensor of the port
must be NEARER the bf16 reference than the f32 one (the mean absolute
difference over the tensor; ``NOT_NEARER`` names the one exception, with
its readings) -- the port rounds where JAX rounds, and is not computing
in f32. The JAX side runs op by op, as Flax's modules round; under
``jax.jit`` XLA:CPU keeps f32 inside its fusions and MultiMNIST's means
land nearer the f32 control. The
gradients cannot show it on the CPU: XLA:CPU's bf16 backward rounds and
sums more coarsely than the port's (CelebA's decoder's conv biases,
sums over the batch and pixels: printed by the loss test, their mean
distance from the f32 control is 17% and 62% of its largest at bf16 on
XLA:CPU, the port's 0.09% and 0.07%; the port sums in f32 and rounds
once), so a
gradient is held within ``GRAD_TOL`` of the bf16 reference widened entry
by entry by the reference's own distance from f32, and the port's bf16
gradients must stand apart from its f32 ones. A
scalar that sums many rounded terms cannot show that: its bf16 and f32
references may lie closer together than the noise of any one rounding
order (CUB's IWAE estimate: 1e-4 apart, the port 2e-3 from both), so a
scalar is held to the bf16 reference alone, and to differ from the
port's own f32 result; the tensors it is made of are held above. The f32
parity of every config stays at rtol 2e-4 in its own test files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmvae_tpu.models as JM
from mmvae_tpu import api as japi
from mmvae_tpu.configs import get_config as j_get_config
from mmvae_tpu.core import fuse_observed_z as j_fuse_observed_z
from mmvae_tpu.core import random_subset_masks as j_random_subset_masks
from mmvae_tpu.data.pipelines import Dataset as JDataset
from mmvae_tpu.models.pipeline import PipelineTrunk as JPipelineTrunk
from mmvae_tpu.ops.kernels import (
    _bce_bwd,
    _bce_fwd_impl,
    _kl_bwd,
    _kl_fwd_impl,
    _seq_ce_bwd,
    _seq_ce_fwd_impl,
)
from mmvae_tpu.train.step import _dequant_data as j_dequant_data
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs, ops
from mmvae_torch import models as TM
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import (
    Dataset,
    make_celeba,
    make_cub,
    make_fashionmnist,
    make_mnist,
    make_multimnist,
)
from mmvae_torch.models import PipelineTrunk
from mmvae_torch.models.text import PAD, STOP
from mmvae_torch.ops import kernels
from mmvae_torch.train import multi_term_loss
from mmvae_torch.train.step import _dequant_data
from tools.pallas_conv_probe import xla_conv0
from torch_threads import _one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
BF16_TOL = 2.0**-5
GRAD_TOL = 2.0**-4
SCALAR_RTOL = 2e-3
# Logits whose top two are closer than this may take either token.
MARGIN = 2.0**-4
L, B = 8, 4
EXPERT_B = 16  # the experts' batch: more entries for the mean distances
CUB = dict(n_latents=L, vocab_size=23, image_hw=(16, 16), conv_features=(8, 16))
CELEBA = dict(n_latents=L, image_hw=(32, 32), conv_features=(32, 16))
# name -> (model class name, model kwargs, data maker)
CASES = {
    "mnist": ("MnistMVAE", dict(n_latents=L), lambda n, s: make_mnist(n, seed=s)),
    "fashionmnist": ("FashionMnistMVAE", dict(n_latents=L),
                     lambda n, s: make_fashionmnist(n, seed=s)),
    "multimnist": ("MultiMnistMVAE",
                   dict(n_latents=L, conv_features=(4, 8), text_embed=8, text_hidden=16,
                        text_latent_dims=4),
                   lambda n, s: make_multimnist(n, seed=s)),
    "celeba": ("CelebAMVAE", CELEBA, lambda n, s: make_celeba(n, seed=s, hw=32)),
    "cub": ("CubMVAE", CUB, lambda n, s: make_cub(n, seed=s, hw=16)),
    "deep_mnist": ("DeepMnistMVAE", dict(n_latents=L, trunk_stages=2, trunk_width=32),
                   lambda n, s: make_mnist(n, seed=s)),
    "deep_cub": ("DeepCubMVAE", dict(CUB, trunk_stages=2),
                 lambda n, s: make_cub(n, seed=s, hw=16)),
}
VARIANTS = {"s2d": dict(CELEBA, space_to_depth=2), "shuffle": dict(CELEBA, upsample_mode="shuffle")}
# The one output held to ``BF16_TOL`` without the "nearer" check:
# ``deep_cub``'s log-variances, whose image half comes through the 512-wide
# trunk (mean distance 1.55e-3 of the largest from the bf16 reference,
# 1.42e-3 from the f32 control; its ``mu`` is nearer the bf16 reference).
NOT_NEARER = {"deep_cub": ("logvar",)}


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _tbatch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def _random_params(jmodel, data, seed=0):
    """Random weights in the Flax tree's shapes: each kernel N(0, 1/fan-in),
    each vector N(0, 0.1^2) (the trunks' gates too: live), a caption
    decoder's STOP bias raised so that captions end."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda d: jmodel.init(jax.random.key(0), d, rng=jax.random.key(1)), _jbatch(data))

    def draw(s):
        std = (s.shape[-1] / np.prod(s.shape)) ** 0.5 if len(s.shape) > 1 else 0.1
        return (std * rng.normal(size=s.shape)).astype(np.float32)

    params = jax.tree.map(draw, shapes["params"])
    for expert in ("text_dec",):
        if expert in params:
            params[expert]["out_proj"]["bias"][STOP] += 1.5
    return params


class Matched:
    """A config's JAX models at bf16 and f32 on one random tree, and the
    port's model at bf16 with its weights."""

    def __init__(self, name: str, cls: str, kwargs: dict, make):
        self.name, self.make = name, make
        self.j16 = getattr(JM, cls)(**kwargs, dtype=jnp.bfloat16)
        self.j32 = getattr(JM, cls)(**kwargs)
        self.params = _random_params(self.j32, make(B, 5))
        self.model = getattr(TM, cls)(**kwargs, dtype=BF16)
        self.model.load_state_dict(from_flax_params(self.params))


@pytest.fixture(scope="module", params=sorted(CASES))
def matched(request):
    return Matched(request.param, *CASES[request.param])


def _nearer(got, ref16, ref32, tol=BF16_TOL, what="", each=True):
    """``got`` within ``tol`` of the bf16 reference's largest magnitude,
    and (``each``) nearer it than the f32 control (mean absolute
    difference, relative to the reference's largest magnitude). Returns
    both relative distances."""
    got, ref16, ref32 = (np.asarray(a, np.float64) for a in (got, ref16, ref32))
    scale = max(np.abs(ref16).max(), 1e-30)
    np.testing.assert_allclose(got, ref16, rtol=0, atol=tol * scale, err_msg=what)
    d16, d32 = np.abs(got - ref16).mean() / scale, np.abs(got - ref32).mean() / scale
    assert d16 < d32 or not each, f"{what}: {d16} from the bf16 reference, {d32} from f32"
    return d16, d32


def _grad_close(got, ref16, ref32, what=""):
    """A gradient on the bf16 path within ``GRAD_TOL`` times the f32
    control's largest magnitude of the bf16 reference, the bound widened
    entry by entry by the bf16 reference's own distance from the f32
    control (see the module docstring: XLA:CPU's bf16 backward). Returns
    the mean distances to the bf16 reference and to the f32 control."""
    got, ref16, ref32 = (np.asarray(a, np.float64) for a in (got, ref16, ref32))
    bound = GRAD_TOL * np.abs(ref32).max() + np.abs(ref16 - ref32)
    excess = np.abs(got - ref16) - bound
    assert excess.max() <= 0, f"{what}: {int((excess > 0).sum())} entries past the bound"
    return np.abs(got - ref16).mean(), np.abs(got - ref32).mean()


def _scalar_close(got, ref16, got32, what=""):
    """A bf16 scalar within ``SCALAR_RTOL`` of the bf16 reference, and not
    the port's f32 result (``got32``)."""
    np.testing.assert_allclose(got, ref16, rtol=SCALAR_RTOL, err_msg=what)
    assert got != got32, (what, got)


# --- the experts ------------------------------------------------------------


def _jax_encode_decode(jmodel, params, data, z):
    """Flax's ``encode`` and ``decode`` of ``data`` (``z`` to decode), op by
    op: each op's output rounded to bf16 as the port rounds it (under
    ``jax.jit`` XLA keeps f32 inside its fusions, and the reference would
    round less often than Flax's modules say)."""
    vs, jb = {"params": params}, _jbatch(data)
    return (jmodel.apply(vs, jb, method="encode"),
            jmodel.apply(vs, jnp.asarray(z), jb, method="decode"))


def _encode_decode_match(jmodels, params, model, data, z, exempt=()):
    """``encode`` and ``decode`` of the port's bf16 model against both JAX
    models: every expert's output in f32, within ``BF16_TOL`` of the bf16
    reference and nearer it than the f32 control, each output but those
    named in ``exempt`` (held to the tolerance alone). Returns the
    distances."""
    j16, j32 = jmodels
    with torch.no_grad():
        got = model.encode(_tbatch(data))
        recon = model.decode(torch.from_numpy(z), _tbatch(data))
    (e16, w16), (e32, w32) = (_jax_encode_decode(j, params, data, z) for j in (j16, j32))
    dist = {}
    for i, part in enumerate(("mu", "logvar")):
        assert got[i].dtype == torch.float32
        dist[part] = _nearer(got[i].numpy(), e16[i], e32[i], what=part, each=part not in exempt)
    assert set(recon) == set(w16)
    for k in w16:
        assert recon[k].dtype == torch.float32
        dist[k] = _nearer(recon[k].numpy(), w16[k], w32[k], what=k, each=k not in exempt)
    print({k: tuple(f"{d:.2e}" for d in v) for k, v in dist.items()})
    return dist


def test_every_expert_matches_flax_at_bf16(matched):
    """Every encoder and decoder of the config: the outputs f32, each
    within ``BF16_TOL`` of Flax at bf16 and nearer it than Flax at f32
    (but ``NOT_NEARER``)."""
    z = np.random.default_rng(2).normal(size=(EXPERT_B, L)).astype(np.float32)
    _encode_decode_match((matched.j16, matched.j32), matched.params, matched.model,
                         matched.make(EXPERT_B, 5), z, NOT_NEARER.get(matched.name, ()))
    assert all(p.dtype == torch.float32 for p in matched.model.parameters())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_conv_variants_match_flax_at_bf16(variant):
    """CelebA with the 2x2 ``space_to_depth`` stages (K4 not on the path)
    and with the pixel-shuffle decoder, at bf16."""
    kwargs = VARIANTS[variant]
    m = Matched("celeba", "CelebAMVAE", kwargs, CASES["celeba"][2])
    z = np.random.default_rng(3).normal(size=(EXPERT_B, L)).astype(np.float32)
    _encode_decode_match((m.j16, m.j32), m.params, m.model, m.make(EXPERT_B, 6), z)


@pytest.mark.parametrize("rezero", [True, False])
def test_trunk_matches_flax_at_bf16(rezero):
    """3 stages of 2 layers at width 16, the kernels, biases and gates cast
    once: the output bf16 as Flax's is, within ``BF16_TOL`` and nearer
    Flax at bf16."""
    x = np.random.default_rng(1).normal(size=(5, 16)).astype(np.float32)
    j16 = JPipelineTrunk(3, 16, 2, rezero=rezero, dtype=jnp.bfloat16)
    j32 = JPipelineTrunk(3, 16, 2, rezero=rezero)
    shapes = jax.eval_shape(lambda: j32.init(jax.random.key(0), jnp.asarray(x)))["params"]
    rng = np.random.default_rng(2)
    params = {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in shapes.items()}
    trunk = PipelineTrunk(3, 16, 2, rezero=rezero, dtype=BF16)
    trunk.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    want = j16.apply({"params": params}, jnp.asarray(x))
    got = trunk(torch.from_numpy(x)).detach()
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _nearer(got.float().numpy(), np.asarray(want, np.float32),
            j32.apply({"params": params}, jnp.asarray(x)))


# --- the entry points -------------------------------------------------------


def test_eval_elbo_matches_jax_at_bf16(matched):
    """10 examples at batch 4, a padded last batch."""
    data = matched.make(10, 1_000_003)
    want = japi.eval_elbo(matched.name, model=matched.j16, params=matched.params, batch_size=4,
                          dataset=JDataset(arrays=_jbatch(data), size=10))
    got = {dt: api.eval_elbo(matched.name, model=matched.model, batch_size=4, device="cpu",
                             dataset=Dataset(arrays=data, size=10), dtype=dt)
           for dt in (torch.float32, BF16)}
    _scalar_close(got[BF16], want, got[torch.float32])


def test_log_likelihood_matches_jax_at_bf16(matched):
    """10 examples at batch 4, k = 3, each batch's noise JAX's own
    (``fold_in(key(seed), i)``)."""
    n, bs, k, seed = 10, 4, 3, 3
    data = matched.make(n, 1_000_003)
    want = japi.log_likelihood(matched.name, model=matched.j16, params=matched.params, k=k,
                               batch_size=bs, seed=seed,
                               dataset=JDataset(arrays=_jbatch(data), size=n))
    key = jax.random.key(seed)
    eps = torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (bs, k, L)))
        for i in range(-(-n // bs))]))
    got = {dt: api.log_likelihood(matched.name, model=matched.model, k=k, batch_size=bs,
                                  dataset=Dataset(arrays=data, size=n), device="cpu", eps=eps,
                                  dtype=dt)
           for dt in (torch.float32, BF16)}
    _scalar_close(got[BF16], want, got[torch.float32])


def _token_rows_agree(got, want, jmodel, params, z, name) -> int:
    """Generated tokens equal row by row up to their first difference,
    where JAX's own top two logits (its decoder teacher-forced on its
    tokens at JAX's z) must lie within ``MARGIN``; returns the rows that
    differ."""
    logits = np.asarray(jmodel.apply({"params": params}, z, {"text": jnp.asarray(want)},
                                     method="decode")["text"], np.float32)
    differ = 0
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size == 0:
            continue
        differ += 1
        top2 = np.sort(logits[r, diff[0]])[-2:]
        assert top2[1] - top2[0] <= MARGIN, (name, r, int(diff[0]), top2)
    return differ


def test_generate_matches_jax_at_bf16(matched):
    """From the images at temperature 0, z the posterior mean: the
    probabilities within ``BF16_TOL`` and nearer JAX at bf16; labels equal;
    tokens under ``_token_rows_agree``."""
    n = EXPERT_B  # the experts' batch: the same shapes, JAX's ops compiled once
    data = matched.make(n, 7)
    condition = {"image": data["image"]}
    want = {m: japi.generate(matched.name, condition, n=n, model=j, params=matched.params,
                             sample_z=False, temperature=0.0)
            for m, j in (("16", matched.j16), ("32", matched.j32))}
    got = api.generate(matched.name, condition, n=n, model=matched.model, device="cpu",
                       temperature=0.0, dtype=BF16)
    assert set(got) == set(want["16"])
    for k, v in want["16"].items():
        if got[k].dtype.is_floating_point:
            _nearer(got[k].numpy(), v, want["32"][k], what=k)
        elif k == "text":
            jb = _jbatch(matched.model.dummy_batch(n) | {"image": torch.from_numpy(data["image"])})
            mu_e, lv_e = matched.j16.apply({"params": matched.params}, jb, method="encode")
            presence = np.zeros((n, matched.model.n_modalities), np.float32)
            presence[:, 0] = 1.0
            z = j_fuse_observed_z(jax.random.key(0), mu_e, lv_e, jnp.asarray(presence),
                                  sample=False)
            differ = _token_rows_agree(got[k].numpy(), np.asarray(v), matched.j16,
                                       matched.params, z, matched.name)
            print(f"{matched.name}: {differ} of {n} token rows differ within the margin")
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


# --- training ---------------------------------------------------------------

K = 4  # CelebA's random subset terms
LOSS_CASES = {
    "mnist": dict(n_terms=3, knobs={}),
    "celeba": dict(n_terms=1 + 19 + K, knobs=dict(n_random_subsets=K)),
    "cub": dict(n_terms=3, knobs=dict(cross_recon=True, cycle_weight=0.1,
                                      cycle_render_grad=True, cycle_render_binarize=False)),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_and_every_gradient_match_jax_at_bf16(name):
    """One loss evaluation (sample=True, beta 0.3; CelebA at T = 24 with
    JAX's subset masks, CUB with cross-recon and the cycle term on a live
    soft render): the f32 loss, and each f32 parameter's gradient, against
    ``jax.value_and_grad`` of the JAX loss at bf16 and nearer it than at
    f32."""
    m = Matched(name, *CASES[name])
    case = LOSS_CASES[name]
    knobs = dict(case["knobs"])
    batch = m.make(B, 11)
    rng = jax.random.key(3)

    def j_loss(jmodel):
        return jax.jit(lambda q: jax.value_and_grad(
            lambda p: j_multi_term_loss(jmodel, p, _jbatch(batch), rng, 0.3, sample=True,
                                        term_fold="t", **knobs), has_aux=True)(q))(m.params)

    (l16, _), g16 = j_loss(m.j16)
    _, g32 = j_loss(m.j32)
    rng_subset, rng_z = jax.random.split(rng)
    if "n_random_subsets" in knobs:
        knobs["subset_masks"] = torch.from_numpy(
            np.array(j_random_subset_masks(rng_subset, K, m.model.n_modalities)))
    eps = torch.from_numpy(np.array(jax.random.normal(rng_z, (case["n_terms"], B, L))))
    grads = {}
    for dt in (torch.float32, BF16):
        m.model.zero_grad()
        with m.model.at_dtype(dt):
            loss, _ = multi_term_loss(m.model, _tbatch(batch), 0.3, eps=eps, **knobs)
        loss.backward()
        grads[dt] = {k: p.grad.clone() for k, p in m.model.named_parameters()}
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(l16), rtol=SCALAR_RTOL)
    w16 = from_flax_params(jax.tree.map(np.asarray, g16))
    w32 = from_flax_params(jax.tree.map(np.asarray, g32))
    got = grads[BF16]
    assert set(got) == set(w16)
    dist = {}
    for k, w in w16.items():
        assert got[k].dtype == torch.float32, k
        _grad_close(got[k].numpy(), w.numpy(), w32[k].numpy(), what=k)
        scale = w32[k].abs().max().item()
        dist[k] = tuple(f"{(a - b).abs().mean().item() / scale:.2e}"
                        for a, b in ((got[k], w), (got[k], w32[k]), (w, w32[k])))
    print(name, "mean distances over the f32 control's largest (port to the bf16 reference, "
          "port to f32, the bf16 reference to f32):", dist)
    # Not f32: the bf16 gradients stand apart from the port's f32 ones.
    apart = sum((got[k] - g).abs().sum() / g.abs().max() for k, g in grads[torch.float32].items())
    assert apart / sum(g.numel() for g in got.values()) > 2.0**-12


def test_api_train_at_bf16_matches_jax():
    """One small epoch of ``mnist`` at bf16 (2 steps of 32): the best test
    ELBO within rtol 0.02 of JAX's at bf16 (the bound
    ``tests/test_api_fast.py`` holds two JAX runs to; the inits differ),
    the parameters f32, and the port's bf16 run apart from its f32 run."""
    cfg = configs.get_config("mnist").replace(
        n_latents=8, epochs=1, batch_size=32, train_size=64, test_size=32, annealing_epochs=1)
    j_cfg = j_get_config("mnist").replace(
        n_latents=8, epochs=1, batch_size=32, train_size=64, test_size=32, annealing_epochs=1)
    want = japi.train(j_cfg, None, use_mesh=False, verbose=False, dtype=jnp.bfloat16)
    got = api.train(cfg, device="cpu", verbose=False, dtype=BF16)
    f32 = api.train(cfg, device="cpu", verbose=False)
    np.testing.assert_allclose(got.best_test_elbo, want.best_test_elbo, rtol=0.02)
    assert got.model.dtype == BF16 and f32.model.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in got.model.parameters())
    assert got.best_test_elbo != f32.best_test_elbo


def test_a_workdir_trained_at_f32_evaluates_at_bf16(tmp_path):
    """``dtype`` is an argument of the entry point, not a config field:
    ``eval_elbo`` of an f32 workdir at bf16 is the bf16 model's on the
    same weights; ``dtype`` with a ``model`` holds for the call alone: the
    model keeps its own, and a later call without ``dtype`` runs at it."""
    cfg = configs.get_config("mnist").replace(
        n_latents=8, epochs=1, batch_size=16, train_size=32, test_size=16)
    api.train(cfg, str(tmp_path), device="cpu", verbose=False)
    at16 = api.eval_elbo(cfg, workdir=str(tmp_path), device="cpu", dtype=BF16)
    at32 = api.eval_elbo(cfg, workdir=str(tmp_path), device="cpu")
    model = configs.build_model(cfg, device="cpu")
    model.load_state_dict(api._resolve(cfg, None, None, "cpu", str(tmp_path))[1].state_dict())
    assert api.eval_elbo(cfg, model=model, device="cpu", dtype=BF16) == at16
    assert model.dtype == torch.float32 and model.image_enc.dtype == torch.float32
    assert api.eval_elbo(cfg, model=model, device="cpu") == at32
    assert at16 != at32 and abs(at16 - at32) < SCALAR_RTOL * abs(at32)


def test_dequant_data_at_bf16_matches_jax_to_the_bit():
    """All 256 uint8 values divided by 255 in bf16, as JAX's
    ``_dequant_data(data, jnp.bfloat16)`` divides them; 255 gives 1."""
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = _dequant_data({"x": torch.from_numpy(u8), "t": torch.zeros(3, dtype=torch.int64)},
                        BF16)
    want = j_dequant_data({"x": jnp.asarray(u8), "t": jnp.zeros(3, jnp.int32)}, jnp.bfloat16)
    assert got["x"].dtype == BF16 and want["x"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(got["x"].view(torch.int16).numpy(),
                                  np.asarray(want["x"]).view(np.int16))
    assert got["x"][-1, -1].item() == 1.0 and got["t"].dtype == torch.int64


# --- the kernels' plain versions -------------------------------------------


@pytest.mark.parametrize("shape", [(4, 16, 16, 3), (3, 13, 9, 2)])
def test_plain_conv_and_its_gradients_at_bf16_match_jax_vjp(shape):
    """K4's plain version, its weight and bias gradient and its dx on
    all-bf16 operands against ``jax.vjp`` of ``xla_conv0`` on the same bf16
    operands: bf16 outputs, each within the tolerances and nearer the bf16
    XLA form than the f32 one (on the unrounded f32 operands)."""
    rng = np.random.default_rng(8)
    b, h, w, c = shape
    x = rng.random(shape).astype(np.float32)
    wt = (rng.normal(size=(32, c, 4, 4)) / (4 * c) ** 0.5).astype(np.float32)
    bias = (0.1 * rng.normal(size=32)).astype(np.float32)
    g = rng.normal(size=(b, 32, -(-h // 2), -(-w // 2))).astype(np.float32)
    t = [torch.from_numpy(a).to(BF16) for a in (x, wt, bias, g)]

    def jax_side(dtype):
        args = [jnp.asarray(a, dtype) for a in (x, wt.transpose(2, 3, 1, 0), bias)]
        out, vjp = jax.vjp(xla_conv0, *args)
        dx, dw, db = vjp(jnp.asarray(g.transpose(0, 2, 3, 1), dtype))
        return (np.asarray(out, np.float32).transpose(0, 3, 1, 2),
                np.asarray(dw, np.float32).transpose(3, 2, 0, 1), np.asarray(db, np.float32),
                np.asarray(dx, np.float32), out.dtype)

    y16, dw16, db16, dx16, out_dtype = jax_side(jnp.bfloat16)
    y32, dw32, db32, dx32, _ = jax_side(jnp.float32)
    assert out_dtype == jnp.bfloat16
    y = kernels.conv4x4s2_swish_torch(*t[:3])
    dw, db = kernels.conv4x4s2_swish_grad_torch(*t)
    dx = kernels.conv4x4s2_swish_input_grad_torch(*t)
    assert y.dtype == dw.dtype == db.dtype == dx.dtype == BF16
    _nearer(y.float().numpy(), y16, y32, what="y")
    for what, got, w16, w32 in (("dW", dw, dw16, dw32), ("db", db, db16, db32),
                                ("dx", dx, dx16, dx32)):
        _grad_close(got.float().numpy(), w16, w32, what=what)


def test_ops_on_bf16_logits_match_the_pallas_kernels_in_interpret_mode():
    """``kl_std_normal``, ``bernoulli_nll`` and ``masked_seq_ce`` on bf16
    inputs (the plain path) against ``_kl_fwd_impl``, ``_bce_fwd_impl`` and
    ``_seq_ce_fwd_impl`` with ``interpret=True``, which cast to f32 outside
    the kernel as the port's ops layer does: the values f32 and equal
    within f32 rounding. The gradients: torch's autograd hands back each
    input's gradient in the input's dtype, bf16; JAX's custom VJPs hand
    back f32 for K1's mu and logvar and K2's logits (``_kl_bwd``,
    ``_bce_bwd`` compute in the promoted type and do not cast back) and
    bf16 for K3's (``_seq_ce_bwd`` casts): so the port's gradients are
    held to JAX's rounded to bf16, to one bf16 step."""
    rng = np.random.default_rng(9)
    mu, lv, logits, x = (rng.normal(size=(6, 10)).astype(np.float32) for _ in range(4))
    x = (x > 0).astype(np.float32)
    seq = rng.normal(size=(4, 5, 13)).astype(np.float32)
    tokens = rng.integers(0, 13, size=(4, 5))
    tokens[:, 3:] = PAD
    b16 = {k: torch.from_numpy(v).to(BF16).requires_grad_() for k, v in
           (("mu", mu), ("lv", lv), ("logits", logits), ("seq", seq))}
    j16 = {k: jnp.asarray(v.detach().float().numpy(), jnp.bfloat16) for k, v in b16.items()}
    tok_t, tok_j = torch.from_numpy(tokens), jnp.asarray(tokens, jnp.int32)
    g = rng.normal(size=6).astype(np.float32)
    gs = rng.normal(size=4).astype(np.float32)

    kl = ops.kl_std_normal(b16["mu"], b16["lv"])
    bce = ops.bernoulli_nll(b16["logits"], torch.from_numpy(x), event_ndims=1)
    ce = ops.masked_seq_ce(b16["seq"], tok_t)
    for got, want in ((kl, _kl_fwd_impl(j16["mu"], j16["lv"], interpret=True)),
                      (bce, _bce_fwd_impl(j16["logits"], jnp.asarray(x), 1, interpret=True)),
                      (ce, _seq_ce_fwd_impl(j16["seq"], tok_j, PAD, interpret=True))):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    torch.autograd.backward([kl, bce, ce], [torch.from_numpy(g), torch.from_numpy(g),
                                            torch.from_numpy(gs)])
    d_mu, d_lv = _kl_bwd((j16["mu"], j16["lv"]), jnp.asarray(g))
    d_logits, _ = _bce_bwd(1, (j16["logits"], jnp.asarray(x)), jnp.asarray(g))
    d_seq, _ = _seq_ce_bwd(PAD, (j16["seq"], tok_j), jnp.asarray(gs))
    assert (d_mu.dtype, d_lv.dtype, d_logits.dtype, d_seq.dtype) == (
        jnp.float32, jnp.float32, jnp.float32, jnp.bfloat16)
    for name, want in (("mu", d_mu), ("lv", d_lv), ("logits", d_logits), ("seq", d_seq)):
        got = b16[name].grad
        assert got.dtype == BF16, name
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7,
                                   atol=2.0**-9 * np.abs(want).max(), err_msg=name)
