"""The port's deep-trunk configs against the JAX package, on the CPU.

``PipelineTrunk`` alone (ReZero gates on and off), then ``deep_mnist``
(trunks of 2 stages at width 32) and a narrow ``deep_cub`` (2 stages at
the fc width 512 over conv features (8, 16), 16x16 images, the 23-id
synthetic vocabulary). The JAX trees are random in the init's shapes
with every gate and bias nonzero: a fresh ReZero trunk is the identity,
so a parity test at the init would not see the trunk at all. Both sides
see the same numpy data; JAX's noise is passed in where the port draws
its own. Tolerances as in ``tests/test_torch_cub.py`` and
``tests/test_torch_train.py``: rtol 2e-4 (XLA-CPU transcendentals are
approximate, docs/DESIGN.md section 7), each gradient tensor with an atol
of 2e-4 of its largest element, Adam steps elementwise within 1e-4 and by
the relative 2-norm of the two updates' difference below 1e-4; labels and
tokens equal.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import api as japi
from mmvae_tpu.data.pipelines import Dataset as JDataset
from mmvae_tpu.models import DeepCubMVAE as JDeepCubMVAE
from mmvae_tpu.models import DeepMnistMVAE as JDeepMnistMVAE
from mmvae_tpu.models.pipeline import PipelineTrunk as JPipelineTrunk
from mmvae_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_tpu.train.step import make_train_step as j_make_train_step
from mmvae_tpu.train.step import multi_term_loss as j_multi_term_loss
from mmvae_torch import api, configs
from mmvae_torch.cli import main
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import Dataset, make_cub, make_mnist
from mmvae_torch.models import DeepCubMVAE, DeepMnistMVAE, PipelineTrunk
from mmvae_torch.models.text import STOP
from mmvae_torch.train import create_train_state, make_train_step, multi_term_loss
from mmvae_torch.train.checkpoint import load_checkpoint, save_checkpoint
from torch_threads import _one_torch_thread  # noqa: F401

RTOL = 2e-4
L, B = 8, 4
CUB_HW = 16
# name -> (JAX class, port class, model kwargs, data maker, the config's loss knobs)
CASES = {
    "deep_mnist": (JDeepMnistMVAE, DeepMnistMVAE,
                   dict(n_latents=L, trunk_stages=2, trunk_width=32),
                   lambda n, seed: make_mnist(n, seed=seed), {}),
    "deep_cub": (JDeepCubMVAE, DeepCubMVAE,
                 dict(n_latents=L, vocab_size=23, image_hw=(CUB_HW, CUB_HW),
                      conv_features=(8, 16), trunk_stages=2),
                 lambda n, seed: make_cub(n, seed=seed, hw=CUB_HW),
                 dict(cross_recon=True, cycle_weight=0.1, cycle_render_grad=True,
                      cycle_render_binarize=False)),
}
# Both configs carry a trunk in each image expert.
TRUNKED = ("image_enc", "image_dec")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _tbatch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def _live_gates(params, rng):
    """``params`` with every trunk's gates in [0.3, 0.8) and biases N(0,
    0.1^2): a trunk that is not the identity."""
    for expert in params.values():
        trunk = expert.get("PipelineTrunk_0") if isinstance(expert, dict) else None
        if trunk is not None:
            trunk["alphas"] = rng.uniform(0.3, 0.8, trunk["alphas"].shape).astype(np.float32)
            trunk["biases"] = (0.1 * rng.normal(size=trunk["biases"].shape)).astype(np.float32)
    return params


def _random_params(jmodel, data, seed=0):
    """Random weights in the JAX tree's shapes: each kernel N(0, 1/fan-in),
    each vector N(0, 0.1^2), the trunks' gates live."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda d: jmodel.init(jax.random.key(0), d, rng=jax.random.key(1)), _jbatch(data))

    def draw(s):
        std = (s.shape[-1] / np.prod(s.shape)) ** 0.5 if len(s.shape) > 1 else 0.1
        return (std * rng.normal(size=s.shape)).astype(np.float32)

    params = jax.tree.map(draw, shapes["params"])
    if "text_dec" in params:
        params["text_dec"]["out_proj"]["bias"][STOP] += 1.5
    return _live_gates(params, rng)


@pytest.fixture(scope="module", params=sorted(CASES))
def matched(request):
    """(name, JAX model, JAX params, port model on the CPU, data maker)."""
    jcls, tcls, kwargs, make, _ = CASES[request.param]
    jmodel = jcls(**kwargs)
    params = _random_params(jmodel, make(B, 5))
    tmodel = tcls(**kwargs)
    tmodel.load_state_dict(from_flax_params(params))
    return request.param, jmodel, params, tmodel, make


@pytest.mark.parametrize("rezero", [True, False])
def test_trunk_matches_jax(rezero):
    """3 stages of 2 layers at width 16: the Flax names and shapes, and the
    output. With the gates the tree has three leaves, without two."""
    jtrunk = JPipelineTrunk(3, 16, 2, rezero=rezero)
    x = np.random.default_rng(1).normal(size=(5, 16)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jtrunk.init(jax.random.key(0), jnp.asarray(x)))["params"]
    rng = np.random.default_rng(2)
    params = {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in shapes.items()}
    assert sorted(params) == (["alphas", "biases", "kernels"] if rezero else
                              ["biases", "kernels"])
    trunk = PipelineTrunk(3, 16, 2, rezero=rezero)
    assert {k: tuple(v.shape) for k, v in trunk.state_dict().items()} == {
        k: v.shape for k, v in params.items()}
    trunk.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    want = np.asarray(jtrunk.apply({"params": params}, jnp.asarray(x)))
    got = trunk(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert np.abs(got - x).max() > 0.1  # the trunk is not the identity here


def test_a_fresh_rezero_trunk_is_the_identity_and_the_pipe_mesh_raises():
    """A fresh trunk is the identity; a pipe mesh and ``pp_n_micro`` reach
    both image experts' trunks, and a trunk of 4 stages on a pipe of 2
    raises ``pipeline_apply``'s stage mismatch (the schedule itself runs in
    ``tests/test_torch_pp.py``)."""
    model = configs.build_model(
        configs.get_config("deep_mnist").replace(n_latents=L), seed=0, device="cpu")
    h = torch.randn(3, 256, generator=torch.Generator().manual_seed(0))
    assert torch.equal(model.image_enc.trunk(h), h)
    mesh = types.SimpleNamespace(pipe_size=2, n_shards=1)
    with pytest.raises(ValueError, match="one stage per pipe device"):
        PipelineTrunk(4, 8, pp_mesh=mesh)(torch.zeros(4, 8))
    piped = DeepMnistMVAE(pp_mesh=mesh, pp_n_micro=2)
    assert piped.pp_n_micro == 2
    for expert in (piped.image_enc, piped.image_dec):
        assert expert.trunk.pp_mesh is mesh and expert.trunk.pp_n_micro == 2


def test_convert_maps_every_parameter(matched):
    """Each image expert's ``PipelineTrunk_0/{kernels, biases, alphas}``
    lands on ``trunk.*`` as it is, between ``Dense_0`` (``layers.0``) and
    ``Dense_1`` (``head``)."""
    name, _, params, tmodel, _ = matched
    state = from_flax_params(params)
    assert set(state) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert state[k].shape == v.shape, k
    for expert in TRUNKED:
        trunk = params[expert]["PipelineTrunk_0"]
        assert sorted(trunk) == ["alphas", "biases", "kernels"]
        for leaf, value in trunk.items():
            torch.testing.assert_close(state[f"{expert}.trunk.{leaf}"], torch.from_numpy(value))
        assert sorted(k for k in params[expert] if k.startswith("Dense_")) == ["Dense_0", "Dense_1"]


@pytest.mark.parametrize("method", ["encode", "decode", "nll_all"])
def test_model_matches_jax(matched, method):
    name, jmodel, params, tmodel, make = matched
    data = make(B, 5)
    vs, jb, tb = {"params": params}, _jbatch(data), _tbatch(data)
    if method == "encode":
        want = jmodel.apply(vs, jb, method="encode")
        with torch.no_grad():
            got = tmodel.encode(tb)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-4)
        return
    z = np.random.default_rng(2).normal(size=(B, L)).astype(np.float32)
    want = jmodel.apply(vs, jnp.asarray(z), jb, method="decode")
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z), tb)
        if method == "decode":
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL,
                                           atol=1e-4, err_msg=k)
            return
        nll = tmodel.nll_all(got, tb)
    np.testing.assert_allclose(nll.numpy(), np.asarray(jmodel.apply(vs, want, jb,
                                                                    method="nll_all")),
                               rtol=RTOL, atol=1e-3)


def test_eval_elbo_matches_jax_on_padded_split(matched):
    """10 examples at batch 4: the last batch is 2 rows padded by 2."""
    name, jmodel, params, tmodel, make = matched
    data = make(10, 1_000_003)
    want = japi.eval_elbo(name, model=jmodel, params=params, batch_size=4,
                          dataset=JDataset(arrays=_jbatch(data), size=10))
    got = api.eval_elbo(name, model=tmodel, dataset=Dataset(arrays=data, size=10),
                        batch_size=4, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_generate_matches_jax(matched):
    """From the images, at temperature 0: the other modality's labels or
    tokens equal, the images' probabilities within rtol."""
    name, jmodel, params, tmodel, make = matched
    data = make(6, 7)
    condition = {"image": data["image"]}
    want = japi.generate(name, condition, n=6, model=jmodel, params=params, sample_z=False,
                         temperature=0.0)
    got = api.generate(name, condition, n=6, model=tmodel, device="cpu", temperature=0.0)
    assert set(got) == set(want)
    for k, v in want.items():
        if got[k].dtype.is_floating_point:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=RTOL, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def test_log_likelihood_matches_jax(matched):
    """10 examples at batch 4, k = 3, each batch's noise JAX's own
    (``fold_in(key(seed), i)``)."""
    name, jmodel, params, tmodel, make = matched
    n, bs, k, seed = 10, 4, 3, 3
    data = make(n, 1_000_003)
    want = japi.log_likelihood(name, model=jmodel, params=params, k=k, batch_size=bs, seed=seed,
                               dataset=JDataset(arrays=_jbatch(data), size=n))
    key = jax.random.key(seed)
    eps = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), (bs, k, L)))
                    for i in range(-(-n // bs))])
    got = api.log_likelihood(name, model=tmodel, dataset=Dataset(arrays=data, size=n), k=k,
                             batch_size=bs, device="cpu", eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _eps(rng, n_terms: int) -> torch.Tensor:
    """The noise JAX's ``multi_term_loss`` draws from ``rng``."""
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.split(rng)[1], (n_terms, B, L))))


def test_loss_and_every_gradient_match_jax(matched):
    """One loss evaluation under the config's knobs (``deep_cub``: cub's
    cross-recon and cycle term on the soft render with a live decoder),
    sample=True, beta 0.3: the loss and the gradient of every parameter,
    the trunks' gates, kernels and biases among them."""
    name, jmodel, params, _, make = matched
    knobs = CASES[name][4]
    batch = make(B, 11)
    rng = jax.random.key(3)
    (j_loss, _), j_grads = jax.jit(lambda q: jax.value_and_grad(
        lambda p: j_multi_term_loss(jmodel, p, _jbatch(batch), rng, 0.3, sample=True,
                                    term_fold="t", **knobs), has_aux=True)(q))(params)
    model = CASES[name][1](**CASES[name][2])
    model.load_state_dict(from_flax_params(params))
    loss, _ = multi_term_loss(model, _tbatch(batch), 0.3, eps=_eps(rng, 3), **knobs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    want = from_flax_params(_np_tree(j_grads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for expert in TRUNKED:
        assert got[f"{expert}.trunk.alphas"].abs().max() > 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL,
                                   atol=2e-4 * w.abs().max().item(), err_msg=k)


def test_five_clipped_adam_steps_match_jax(matched):
    """Five steps of the config's step with clipping at 1 (it fires every
    step) from JAX's init with the gates made live: loss and raw gradient
    norm each step, every parameter after."""
    name, jmodel, _, _, make = matched
    knobs = CASES[name][4]
    batches = [make(B, 20 + i) for i in range(5)]
    state = j_create_train_state(jmodel, _jbatch(batches[0]), jax.random.key(7), 1e-3,
                                 grad_clip=1.0)
    init = _live_gates(jax.tree.map(np.array, state.params), np.random.default_rng(4))
    state = state.replace(params=jax.tree.map(jnp.asarray, init))
    j_step = j_make_train_step(jmodel, annealing_steps=4, term_fold="t", **knobs)
    model = CASES[name][1](**CASES[name][2])
    model.load_state_dict(from_flax_params(init))
    t_state = create_train_state(model, 1e-3, grad_clip=1.0)
    step = make_train_step(model, annealing_steps=4, **knobs)
    for batch in batches:
        rng = jax.random.split(state.rng, 3)[0]
        state, j_metrics = j_step(state, _jbatch(batch))
        t_state, metrics = step(t_state, _tbatch(batch), eps=_eps(rng, 3))
        np.testing.assert_allclose(metrics["loss"].item(), float(j_metrics["loss"]), rtol=RTOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(j_metrics["grad_norm"]),
                                   rtol=1e-4)
        assert metrics["grad_norm"].item() > 1.0
    want, start = from_flax_params(_np_tree(state.params)), from_flax_params(init)
    got = t_state.params
    diff = sum(((got[k].detach() - w) ** 2).sum() for k, w in want.items())
    update = sum(((w - start[k]) ** 2).sum() for k, w in want.items())
    assert update > 0 and (diff / update).sqrt() < 1e-4
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)


def test_checkpoint_layout_and_trunk_leaves_round_trip(tmp_path):
    """``deep_mnist`` saves: after each of three saves the ``ckpt/``
    directory names and ``last_meta.json`` are the JAX package's, and a
    load gives back every trunk leaf and Adam moment bit for bit."""
    jcls, tcls, kwargs, make, _ = CASES["deep_mnist"]
    jmodel = jcls(**kwargs)
    j_state = j_create_train_state(jmodel, _jbatch(make(2, 0)), jax.random.key(0), 1e-3)
    model = tcls(**kwargs)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model, 1e-3)
    step = make_train_step(model, annealing_steps=2)
    for epoch, is_best in zip((1, 2, 3), (True, False, True)):
        state, _ = step(state, _tbatch(make(B, epoch)))
        extra = {"best_test_elbo": 10.0 - epoch}
        j_save_checkpoint(str(tmp_path / "jax"), j_state, epoch, is_best=is_best, extra=extra,
                          keep_epochs=2)
        save_checkpoint(str(tmp_path / "port"), state, epoch, is_best=is_best, extra=extra,
                        keep_epochs=2)
        views = []
        for side in ("jax", "port"):
            ckpt = tmp_path / side / "ckpt"
            views.append((sorted(os.listdir(ckpt)),
                          json.loads((ckpt / "last_meta.json").read_text())))
        assert views[0] == views[1]
    fresh = tcls(**kwargs)
    fresh.reset_parameters(torch.Generator().manual_seed(1))
    loaded, extra = load_checkpoint(str(tmp_path / "port"), create_train_state(fresh, 1e-3),
                                    which="last")
    assert extra["epoch"] == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], v), k
    moments = [s["exp_avg"] for p, s in loaded.optimizer.state.items()
               if p is loaded.model.image_enc.trunk.alphas]
    assert moments and moments[0].abs().max() > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_init_distributions_match_flax(name):
    """The seeded init against Flax's at 4 stages of width 64 (deep_mnist)
    or 512 (deep_cub): each kernel's std within 15%, the trunk kernels' at
    Flax's fan-in S * depth * W (1/16 and 1/sqrt(2048)), gates and biases 0."""
    jcls, tcls, kwargs, make, _ = CASES[name]
    kwargs = dict(kwargs, trunk_stages=4, **({"trunk_width": 64} if name == "deep_mnist" else {}))
    flax = from_flax_params(_np_tree(jcls(**kwargs).init(
        jax.random.key(0), _jbatch(make(2, 0)), rng=jax.random.key(1))["params"]))
    model = tcls(**kwargs)
    model.reset_parameters(torch.Generator().manual_seed(3))
    ours = model.state_dict()
    assert set(ours) == set(flax)
    for key, value in ours.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("bias", "b", "biases", "alphas"):
            assert torch.all(value == 0), key
        elif value.numel() >= 500:
            got, want = value.std().item(), flax[key].std().item()
            assert abs(got / want - 1) < 0.15, (key, got, want)
    width = 64 if name == "deep_mnist" else 512
    for expert in TRUNKED:
        kernels = ours[f"{expert}.trunk.kernels"]
        assert kernels.shape == (4, 1, width, width)
        assert kernels.std().item() == pytest.approx((4 * width) ** -0.5, rel=0.05)


def test_full_width_configs_are_the_jax_ones():
    """``deep_cub``: cub's config and widths with 4 trunk stages at 512 in
    both image experts; ``deep_mnist``: 4 stages at 256."""
    from mmvae_tpu.configs import get_config as j_get_config

    for name in ("deep_mnist", "deep_cub"):
        cfg, jcfg = configs.get_config(name), j_get_config(name)
        shared = set(cfg.__dataclass_fields__) & set(jcfg.__dataclass_fields__)
        assert {"data_backend", "reshuffle_every", "shuffle_mode"} <= shared
        for field in shared:
            assert getattr(cfg, field) == getattr(jcfg, field), (name, field)
    cub = configs.build_model("deep_cub", device="cpu")
    for expert in (cub.image_enc, cub.image_dec):
        assert expert.trunk.kernels.shape == (4, 1, 512, 512) and expert.trunk.rezero
    assert [c.out_channels for c in cub.image_enc.convs] == [32, 64, 128, 256]
    assert cub.n_latents == 256 and cub.text_dec.hidden == 256
    mnist = configs.build_model("deep_mnist", device="cpu")
    assert mnist.image_enc.trunk.kernels.shape == (4, 1, 256, 256)


def test_exported_artifact_matches_jax_generate(tmp_path):
    """``deep_mnist``'s batch-4 per-row artifact exported on the CPU, from
    the labels at temperature 0, against the JAX ``make_generate_fn``
    under ``jax.jit``: the trunks inside the traced program."""
    from mmvae_tpu import serving as jserving
    from mmvae_torch import serving

    jcls, tcls, kwargs, make = CASES["deep_mnist"][:4]
    jmodel, tmodel = jcls(**kwargs), tcls(**kwargs)
    params = _random_params(jmodel, make(B, 5))
    tmodel.load_state_dict(from_flax_params(params))
    cfg = configs.get_config("deep_mnist").replace(n_latents=L, model_kwargs=kwargs)
    path = serving.export_generate(cfg, str(tmp_path / "a.mmvaept"), batch_size=B,
                                   model=tmodel, device="cpu")
    _, call = serving.load_generate(path, device="cpu")
    data = make(B, 7)
    presence = np.zeros((B, 2), np.float32)
    presence[:, 1] = 1.0  # the label
    seeds = np.arange(B, dtype=np.int32)
    got = call(data, presence, seed=seeds, temperature=0.0)
    want = jax.jit(jserving.make_generate_fn(jmodel, params, per_row_seed=True))(
        _jbatch(data), jnp.asarray(presence), jnp.asarray(seeds), jnp.float32(0.0))
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_train_and_eval_on_the_cpu(name, tmp_path, capsys):
    """``train`` then ``eval`` through the CLI at a small size: the eval
    JSON's ELBO equals ``api.eval_elbo`` of the workdir."""
    wd = str(tmp_path / "wd")
    argv = ["--config", name, "--workdir", wd, "--device", "cpu"]
    small = {"model_kwargs": ({"conv_features": [8, 8], "trunk_stages": 2}
                              if name == "deep_cub" else {"trunk_stages": 2, "trunk_width": 32})}
    (tmp_path / "cfg.json").write_text(json.dumps(small))
    assert main(["train", *argv, "--epochs", "1", "--train-size", "16", "--test-size", "8",
                 "--n-latents", "8", "--batch-size", "8",
                 "--config-file", str(tmp_path / "cfg.json")]) == 0
    capsys.readouterr()
    assert main(["eval", *argv]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = api.eval_elbo(name, workdir=wd, device="cpu")
    assert np.isfinite(want)
    assert [v for v in out.values() if isinstance(v, float)][0] == pytest.approx(want,
                                                                                   rel=1e-6)
