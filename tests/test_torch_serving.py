"""The port's serving export against the JAX package's, on the CPU.

``mmvae_torch.serving.export_generate`` artifacts (exported and run on the
CPU, ``sample_z=False``, temperature 0) against the JAX
``mmvae_tpu.serving.make_generate_fn`` under ``jax.jit`` on converted
weights (``convert.from_flax_params``): MNIST under mvae, mopoe and
mvtcae, MultiMNIST with its tokens, and a narrow CelebA conditioned on the
stacked ``attrs`` and on one ``attr_i``. Tolerance rtol 2e-4 (XLA-CPU
transcendentals are approximate, docs/DESIGN.md section 7); labels and
tokens equal; the CelebA artifact with bf16 experts against the JAX program
at bf16. Beside them: the mvae fusion through ``ops.poe_kl`` against
the JAX ``product_of_experts``, and ``torch.library.opcheck`` of the two
``mmvae`` ops on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import serving as jserving
from mmvae_tpu.core.poe import product_of_experts as j_product_of_experts
from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.models import MultiMnistMVAE as JMultiMnistMVAE
from mmvae_torch import configs, ops, serving
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import make_celeba, make_multimnist
from mmvae_torch.models import CelebAMVAE, MnistMVAE, MultiMnistMVAE
from mmvae_torch.models.text import STOP

RTOL = 2e-4
N_LATENTS, B = 8, 4
MULTIMNIST = dict(conv_features=(4, 8), text_hidden=16, text_embed=8, text_latent_dims=4,
                  lambda_text=30.0)
CELEBA_HW = 16
CELEBA = dict(image_hw=(CELEBA_HW, CELEBA_HW), conv_features=(32, 8))


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _matched(jmodel, tmodel, data, seed=0):
    """Random weights in the JAX tree's shapes (``jax.eval_shape`` of the
    init, which is much quicker than the init), loaded into ``tmodel``:
    each kernel N(0, 1/fan-in), each vector N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda d: jmodel.init(jax.random.key(0), d, rng=jax.random.key(1)), _jbatch(data))

    def draw(s):
        std = (s.shape[-1] / np.prod(s.shape)) ** 0.5 if len(s.shape) > 1 else 0.1
        return (std * rng.normal(size=s.shape)).astype(np.float32)

    params = jax.tree.map(draw, shapes["params"])
    tmodel.load_state_dict(from_flax_params(params))
    return params


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, JAX params, port model, numpy batch of B rows)."""
    out = {}
    jm, tm = JMnistMVAE(n_latents=N_LATENTS), MnistMVAE(n_latents=N_LATENTS)
    data = {k: np.array(v) for k, v in jm.dummy_batch(B).items()}
    data["label"] = np.array([0, 3, 5, 9], np.int32)
    data["image"] = np.random.default_rng(0).random(data["image"].shape).astype(np.float32)
    out["mnist"] = (jm, _matched(jm, tm, data), tm, data)
    jm, tm = JMultiMnistMVAE(n_latents=N_LATENTS, **MULTIMNIST), MultiMnistMVAE(
        n_latents=N_LATENTS, **MULTIMNIST)
    data = make_multimnist(B, seed=5)
    params = _matched(jm, tm, data)
    # A higher STOP bias, so that the greedy decode stops early in some rows.
    params["text_dec"]["out_proj"]["bias"][STOP] += 0.6
    tm.load_state_dict(from_flax_params(params))
    out["multimnist"] = (jm, params, tm, data)
    jm, tm = JCelebAMVAE(n_latents=N_LATENTS, **CELEBA), CelebAMVAE(n_latents=N_LATENTS, **CELEBA)
    data = make_celeba(B, seed=5, hw=CELEBA_HW)
    out["celeba"] = (jm, _matched(jm, tm, data), tm, data)
    return out


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """(config, objective) -> (meta, call, path) of a static batch-B
    per-row artifact, exported on the CPU once."""
    cache = {}

    def get(name, objective="mvae"):
        if (name, objective) not in cache:
            cfg = configs.get_config(name).replace(n_latents=N_LATENTS, objective=objective)
            path = str(tmp_path_factory.mktemp("art") / f"{name}_{objective}.mmvaept")
            serving.export_generate(cfg, path, batch_size=B, model=models[name][2], device="cpu")
            cache[name, objective] = (*serving.load_generate(path, device="cpu"), path)
        return cache[name, objective]

    return get


# Which modalities each case observes, by batch key or by modality name.
CASES = {
    "mnist-mvae": ("mnist", "mvae", ["label"]),
    "mnist-mopoe": ("mnist", "mopoe", ["image"]),
    "mnist-mvtcae": ("mnist", "mvtcae", ["image", "label"]),
    "multimnist": ("multimnist", "mvae", ["text"]),
    "celeba-attrs": ("celeba", "mvae", ["attrs"]),
    "celeba-attr_4": ("celeba", "mvae", ["attr_4"]),
}


def _presence(meta, observed) -> np.ndarray:
    names = meta["modalities"]
    presence = np.zeros((B, len(names)), np.float32)
    for key in observed:
        for name in meta["batch_modalities"].get(key, [key]):
            presence[:, names.index(name)] = 1.0
    return presence


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_matches_jax_generate(models, artifacts, case):
    name, objective, observed = CASES[case]
    jm, params, _, data = models[name]
    meta, call, _ = artifacts(name, objective)
    presence = _presence(meta, observed)
    seeds = np.arange(B, dtype=np.int32)
    got = call(data, presence, seed=seeds, temperature=0.0)
    fn = jax.jit(jserving.make_generate_fn(jm, params, per_row_seed=True, objective=objective))
    want = fn(_jbatch(data), jnp.asarray(presence), jnp.asarray(seeds), jnp.float32(0.0))
    assert set(got) == set(want) == set(meta["batch_shapes"])
    for k, w in want.items():
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_bf16_artifact_matches_jax_generate_at_bf16(models, tmp_path):
    """The narrow CelebA with bf16 experts (stage 0 the ``mmvae`` conv op on
    bf16 operands) exported on the CPU, conditioned on the stacked
    ``attrs``, against the JAX program of the same model at
    ``dtype=jnp.bfloat16`` under ``jax.jit``: the probabilities within 2^-5
    of their largest (``tests/test_torch_bf16.py``'s tolerance: a bf16 step
    or two) and, the two outputs together, nearer it than the JAX program
    at f32 (the sum of their mean distances relative to their largest)."""
    jm, params, tm, data = models["celeba"]
    model = CelebAMVAE(n_latents=N_LATENTS, **CELEBA, dtype=torch.bfloat16)
    model.load_state_dict(tm.state_dict())
    cfg = configs.get_config("celeba").replace(n_latents=N_LATENTS)
    path = str(tmp_path / "celeba_bf16.mmvaept")
    serving.export_generate(cfg, path, batch_size=B, model=model, device="cpu",
                            dtype=torch.bfloat16)
    meta, call = serving.load_generate(path, device="cpu")
    convs = [n for n in call.exported.graph.nodes
             if str(n.target) == "mmvae.conv4x4s2_swish.default"]
    assert convs and all(a.meta["val"].dtype == torch.bfloat16 for a in convs[0].args)
    presence = _presence(meta, ["attrs"])
    seeds = np.arange(B, dtype=np.int32)
    got = call(data, presence, seed=seeds, temperature=0.0)
    want = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        jmodel = JCelebAMVAE(n_latents=N_LATENTS, **CELEBA, dtype=dtype)
        fn = jax.jit(jserving.make_generate_fn(jmodel, params, per_row_seed=True))
        want[dtype] = fn(_jbatch(data), jnp.asarray(presence), jnp.asarray(seeds),
                         jnp.float32(0.0))
    d16 = d32 = 0.0
    for k in ("image", "attrs"):
        w16, w32 = (np.asarray(want[d][k], np.float64) for d in (jnp.bfloat16, jnp.float32))
        g, scale = got[k].numpy().astype(np.float64), np.abs(w16).max()
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(g, w16, rtol=0, atol=2.0**-5 * scale, err_msg=k)
        d16 += np.abs(g - w16).mean() / scale
        d32 += np.abs(g - w32).mean() / scale
    assert d16 < d32, (d16, d32)


def test_graph_holds_the_mmvae_ops(artifacts):
    """Exported on the CPU under the "auto" backend, the graph holds the
    ops, not their plain versions: on the card they launch the kernels."""
    for name, want in (("mnist", {"mmvae.poe_kl.default"}),
                       ("celeba", {"mmvae.poe_kl.default", "mmvae.conv4x4s2_swish.default"})):
        targets = {str(n.target) for n in artifacts(name)[1].exported.graph.nodes
                   if n.op == "call_function"}
        assert want <= {t for t in targets if t.startswith("mmvae.")}, targets


def test_torch_backend_exports_the_plain_ops(models, tmp_path):
    path = str(tmp_path / "plain.mmvaept")
    cfg = configs.get_config("mnist").replace(n_latents=N_LATENTS)
    ops.set_backend("torch")
    try:
        serving.export_generate(cfg, path, batch_size=2, model=models["mnist"][2], device="cpu")
    finally:
        ops.set_backend("auto")
    _, call = serving.load_generate(path, device="cpu")
    targets = {str(n.target) for n in call.exported.graph.nodes}
    assert not any(t.startswith("mmvae.") for t in targets)


def test_mvae_fusion_is_poe_kl_against_jax_product_of_experts():
    """``fuse_observed_z``'s mvae branch: ``ops.poe_kl`` under one all-ones
    term against the JAX PoE, a row observing nothing (the prior) and log
    variances at the +-11 clamp and past it."""
    rng = np.random.default_rng(0)
    mu = rng.normal(size=(5, 3, 6)).astype(np.float32)
    lv = rng.normal(size=(5, 3, 6)).astype(np.float32)
    lv[1, 0, :2] = [11.0, -11.0]
    lv[2, 1, :2] = [14.0, -13.0]
    presence = rng.integers(0, 2, size=(5, 3)).astype(np.float32)
    presence[3] = 0.0
    mu_f, lv_f, _ = ops.poe_kl(torch.from_numpy(mu), torch.from_numpy(lv), torch.ones(1, 3),
                               torch.from_numpy(presence))
    want_mu, want_lv = j_product_of_experts(jnp.asarray(mu), jnp.asarray(lv),
                                            mask=jnp.asarray(presence))
    np.testing.assert_allclose(mu_f[0].numpy(), np.asarray(want_mu), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(lv_f[0].numpy(), np.asarray(want_lv), rtol=RTOL, atol=1e-6)
    assert torch.all(mu_f[0, 3] == 0) and torch.all(lv_f[0, 3] == 0)


def test_opcheck_the_mmvae_ops_on_the_cpu():
    """Schema, fake (meta) registration and dispatch of both ops, including
    a call with no presence."""
    rng = np.random.default_rng(1)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    presence = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
    for args in ((t(2, 3, 5), t(2, 3, 5), torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]]),
                  presence),
                 (t(2, 3, 5), t(2, 3, 5), torch.ones(1, 3), None)):
        torch.library.opcheck(torch.ops.mmvae.poe_kl.default, args)
    torch.library.opcheck(torch.ops.mmvae.conv4x4s2_swish.default,
                          (t(2, 9, 7, 3), t(32, 3, 4, 4), t(32)))
