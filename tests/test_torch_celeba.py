"""The port's CelebA inference slice against the JAX package, on the CPU.

The JAX ``CelebAMVAE`` is initialised from a seed at small widths
(n_latents 8, 32x32 RGB images, conv features (32, 16); the 18 attribute
experts at their full embed 32 and hidden 64), every bias is moved off 0
so that the bias mapping is exercised, the parameters are moved across
with ``mmvae_torch.convert``, and both sides see the same numpy data.
Tolerance rtol 2e-4: XLA-CPU transcendentals are approximate
(docs/DESIGN.md section 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmvae_tpu import api as japi
from mmvae_tpu.data import load_dataset as j_load_dataset
from mmvae_tpu.data.pipelines import Dataset as JDataset
from mmvae_tpu.data.synthetic import make_celeba as j_make_celeba
from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
from mmvae_tpu.train.step import make_eval_step as j_make_eval_step
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import CELEBA_ATTRS, Dataset, load_dataset, make_celeba
from mmvae_torch.models import CelebAMVAE
from mmvae_torch.models.experts import swish
from mmvae_torch.ops.kernels import same_pad
from mmvae_torch.train import multi_term_loss
from torch_threads import _one_torch_thread  # noqa: F401

RTOL = 2e-4
N_LATENTS = 8
HW = 32
SMALL = dict(image_hw=(HW, HW), conv_features=(32, 16))
BIASES = ("bias", "b1", "b2")


def _close(got: torch.Tensor, want, atol: float = 1e-4) -> None:
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=atol
    )


def _tbatch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _shift_biases(tree, rng):
    for key, value in tree.items():
        if isinstance(value, dict):
            _shift_biases(value, rng)
        elif key in BIASES:
            tree[key] = (value + 0.1 * rng.normal(size=value.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def matched():
    """(JAX model, JAX params, port model on the CPU, numpy batch)."""
    jmodel = JCelebAMVAE(n_latents=N_LATENTS, **SMALL)
    data = make_celeba(12, seed=5, hw=HW)
    params = jmodel.init(jax.random.key(0), _jbatch(data), rng=jax.random.key(1))
    params = jax.tree.map(np.array, params["params"])
    _shift_biases(params, np.random.default_rng(0))
    tmodel = CelebAMVAE(n_latents=N_LATENTS, **SMALL)
    tmodel.load_state_dict(from_flax_params(params))
    return jmodel, params, tmodel, data


def _z(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, N_LATENTS)).astype(np.float32)


def _sub(name):
    """A Flax ``method`` that calls the submodule ``name``."""
    return lambda module, x: getattr(module, name)(x)


def test_convert_maps_every_parameter(matched):
    _, params, tmodel, _ = matched
    state = from_flax_params(params)
    assert set(state) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert state[k].shape == v.shape, k
    torch.testing.assert_close(state["attr_enc.embed"], torch.from_numpy(params["attr_enc"]["embed"]))
    torch.testing.assert_close(state["attr_dec.w2"], torch.from_numpy(params["attr_dec"]["w2"]))
    kernel = params["image_dec"]["ConvTranspose_1"]["kernel"]
    assert kernel.shape[-1] == 3
    torch.testing.assert_close(
        state["image_dec.deconvs.1.weight"],
        torch.from_numpy(kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy()),
    )
    with pytest.raises(ValueError, match="cannot map"):
        from_flax_params({"attr_enc": {"w3": np.zeros(2)}})


@pytest.mark.parametrize("expert", ["image_enc", "image_dec", "attr_enc", "attr_dec"])
def test_experts_match_jax(matched, expert):
    """The RGB ``ConvEncoder`` (NHWC in) and ``DeconvDecoder`` (NHWC
    logits out) and both attribute banks."""
    jmodel, params, tmodel, data = matched
    x = {
        "image_enc": data["image"],
        "attr_enc": data["attrs"],
    }.get(expert, _z(12, seed=1))
    want = jmodel.apply({"params": params}, jnp.asarray(x), method=_sub(expert))
    with torch.no_grad():
        got = getattr(tmodel, expert)(torch.from_numpy(x))
    if expert.endswith("enc"):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        assert got.shape == ((12, HW, HW, 3) if expert == "image_dec" else (12, 18))
        _close(got, want)


def test_conv_encoder_stage0_through_ops_equals_conv2d(matched):
    """Stage 0 of the RGB encoder goes through ``ops.conv4x4s2_swish``
    (NHWC in, NCHW out); the same encoder run with every stage a plain
    padded ``F.conv2d`` from an NCHW copy of the batch gives the same."""
    _, _, tmodel, data = matched
    enc = tmodel.image_enc
    x = torch.from_numpy(data["image"])
    with torch.no_grad():
        got = enc(x)
        h = x.permute(0, 3, 1, 2)
        for conv in enc.convs:
            h = swish(F.conv2d(F.pad(h, same_pad(h.shape[-2:])), conv.weight, conv.bias, stride=2))
        h = swish(enc.layers[0](h.permute(0, 2, 3, 1).flatten(1)))
        out = enc.head(h)
    torch.testing.assert_close(got[0], out[:, :N_LATENTS], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], out[:, N_LATENTS:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["encode", "infer", "decode", "nll_all"])
def test_model_matches_jax(matched, method):
    jmodel, params, tmodel, data = matched
    vs = {"params": params}
    jb, tb = _jbatch(data), _tbatch(data)
    if method in ("encode", "infer"):
        want = jmodel.apply(vs, jb, method=method)
        with torch.no_grad():
            got = getattr(tmodel, method)(tb)
        assert got[0].shape == ((12, 19, N_LATENTS) if method == "encode" else (12, N_LATENTS))
        for g, w in zip(got, want):
            _close(g, w)
        return
    z = _z(12, seed=2)
    want = jmodel.apply(vs, jnp.asarray(z), method="decode")
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z))
        if method == "decode":
            for k in ("image", "attrs"):
                torch.testing.assert_close(tmodel.decode_one(k, torch.from_numpy(z)), got[k])
                _close(got[k], want[k])
            return
        nll = tmodel.nll_all(got, tb)
    assert nll.shape == (19, 12)
    _close(nll, jmodel.apply(vs, want, jb, method="nll_all"), atol=1e-3)


def test_eval_step_metrics_match_jax(matched):
    """T = 20 terms (joint + 19 unimodal), t-fold, member-pruned: the
    ``attrs`` key decodes rows [0, 2..19] and scores 18 modalities at
    rows of D = 1. The presence mask drops modalities and a whole
    example."""
    jmodel, params, tmodel, data = matched
    presence = np.ones((12, 19), np.float32)
    presence[1, 0] = presence[2, 5] = presence[2, 17] = 0.0
    presence[4, 1:] = 0.0
    presence[3] = 0.0
    want = j_make_eval_step(jmodel)(params, _jbatch(dict(data, presence=presence)))
    with torch.no_grad():
        _, got = multi_term_loss(tmodel, _tbatch(dict(data, presence=presence)), sample=False)
    assert got["elbo_per_term"].shape == (20,)
    for k in ("loss", "recon_per_term", "kl_per_term", "elbo_per_term"):
        _close(got[k], want[k], atol=1e-3)


def test_eval_elbo_matches_jax_on_padded_split(matched):
    """100 examples at batch 64: the last batch is 36 rows padded by 28."""
    jmodel, params, tmodel, _ = matched
    data = make_celeba(100, seed=1_000_003, hw=HW)
    want = japi.eval_elbo(
        "celeba", model=jmodel, params=params, batch_size=64,
        dataset=JDataset(arrays=_jbatch(data), size=100),
    )
    got = api.eval_elbo(
        "celeba", model=tmodel, dataset=Dataset(arrays=data, size=100),
        batch_size=64, device="cpu",
    )
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("observed", ["image", "attrs", "attr_4", "attr_4+attr_8+attrs"])
def test_generate_matches_jax(matched, observed):
    """From an image, from all 18 attributes, from one attribute, and from
    single attributes beside the whole set (the whole set wins)."""
    jmodel, params, tmodel, data = matched
    every = {
        "image": data["image"][:5],
        "attrs": data["attrs"][:5],
        "attr_4": data["attrs"][:5, 4],
        "attr_8": 1.0 - data["attrs"][:5, 8],
    }
    condition = {k: every[k] for k in observed.split("+")}
    want = japi.generate(
        "celeba", condition, model=jmodel, params=params, sample_z=False
    )
    got = api.generate("celeba", condition, model=tmodel, device="cpu")
    assert set(got) == {"image", "attrs"}
    assert got["image"].shape == (5, HW, HW, 3) and got["attrs"].shape == (5, 18)
    for k in ("image", "attrs"):
        _close(got[k], want[k])


def test_generate_rejects_unknown_keys(matched):
    _, _, tmodel, _ = matched
    with pytest.raises(ValueError, match="unknown modality"):
        api.generate("celeba", {"attr_18": [1.0]}, model=tmodel, device="cpu")


def test_sample_shapes_and_range(matched):
    _, _, tmodel, _ = matched
    out = api.sample(
        "celeba", n=6, model=tmodel, device="cpu",
        generator=torch.Generator().manual_seed(0),
    )
    assert out["image"].shape == (6, HW, HW, 3) and out["attrs"].shape == (6, 18)
    for v in out.values():
        assert torch.isfinite(v).all() and 0.0 <= v.min() and v.max() <= 1.0


@pytest.mark.parametrize("seed", [0, 1_000_003])
def test_make_celeba_byte_identical_to_jax(seed):
    got, want = make_celeba(20, seed=seed), j_make_celeba(20, seed=seed)
    for k in ("image", "attrs"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


def test_test_split_matches_jax():
    got = load_dataset("celeba", "test", n=10)
    want = j_load_dataset("celeba", "test", n=10, device_put=False)
    assert got.size == want.size == 10 and len(CELEBA_ATTRS) == 18
    for k in ("image", "attrs"):
        assert got.arrays[k].tobytes() == np.asarray(want.arrays[k]).tobytes()


def test_full_width_config():
    model = configs.build_model("celeba", device="cpu")
    assert model.n_latents == 100 and model.n_modalities == 19
    assert model.lambdas().tolist() == [1.0] + [10.0] * 18
    assert [c.out_channels for c in model.image_enc.convs] == [32, 64, 128, 256]
    assert model.image_enc.convs[0].in_channels == 3
    assert model.image_enc.layers[0].in_features == 4 * 4 * 256
    assert model.image_dec.base_hw == (4, 4) and model.image_dec.deconvs[-1].out_channels == 3
    assert model.attr_enc.w1.shape == (18, 32, 64) and model.attr_dec.w1.shape == (18, 100, 64)
    cfg = configs.get_config("celeba")
    assert (cfg.batch_size, cfg.test_size, cfg.objective) == (64, 2000, "mvae")
