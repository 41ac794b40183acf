"""The port's MultiMNIST inference slice against the JAX package, on the CPU.

The JAX ``MultiMnistMVAE`` is initialised from a seed at small widths
(n_latents 16, conv features (4, 8), text hidden 16, embed 8, a text
expert limited to the first 8 latent dims), its parameters are moved
across with ``mmvae_torch.convert``, and both sides see the same numpy
data. Tolerance rtol 2e-4: XLA-CPU transcendentals are approximate
(docs/DESIGN.md section 7). Tokens generated at temperature 0 must be
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import api as japi
from mmvae_tpu.data import load_dataset as j_load_dataset
from mmvae_tpu.data.synthetic import make_multimnist as j_make_multimnist
from mmvae_tpu.models import MultiMnistMVAE as JMultiMnistMVAE
from mmvae_tpu.train.step import make_eval_step as j_make_eval_step
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import load_dataset, make_multimnist
from mmvae_torch.models import MultiMnistMVAE
from mmvae_torch.models.experts import ConvEncoder, DeconvDecoder
from mmvae_torch.models.text import PAD, STOP
from mmvae_torch.train import multi_term_loss
from torch_threads import _one_torch_thread  # noqa: F401

RTOL = 2e-4
N_LATENTS = 16
SMALL = dict(
    conv_features=(4, 8), text_hidden=16, text_embed=8, text_latent_dims=8,
    lambda_text=30.0,
)


def _close(got: torch.Tensor, want, atol: float = 1e-4) -> None:
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=atol
    )


def _tbatch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def _jbatch(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def matched():
    """(JAX model, JAX params, port model on the CPU, numpy batch).

    The text decoder's STOP bias is raised so that greedy decoding stops
    early in some rows and late in others: the stop masking is exercised.
    """
    jmodel = JMultiMnistMVAE(n_latents=N_LATENTS, **SMALL)
    data = make_multimnist(12, seed=5)
    params = jmodel.init(jax.random.key(0), _jbatch(data), rng=jax.random.key(1))
    params = jax.tree.map(np.array, params["params"])
    params["text_dec"]["out_proj"]["bias"][STOP] += 0.6
    tmodel = MultiMnistMVAE(n_latents=N_LATENTS, **SMALL)
    tmodel.load_state_dict(from_flax_params(params))
    return jmodel, params, tmodel, data


def _z(n: int, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, N_LATENTS)) * scale).astype(np.float32)


def test_convert_maps_every_parameter(matched):
    _, params, tmodel, _ = matched
    state = from_flax_params(params)
    assert set(state) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert state[k].shape == v.shape, k
    torch.testing.assert_close(
        state["image_enc.convs.1.weight"],
        torch.from_numpy(params["image_enc"]["Conv_1"]["kernel"].transpose(3, 2, 0, 1).copy()),
    )
    torch.testing.assert_close(state["text_dec.u_rec"], torch.from_numpy(params["text_dec"]["u_rec"]))
    with pytest.raises(ValueError, match="cannot map"):
        from_flax_params({"text_dec": {"lstm_cell": {}}})


@pytest.mark.parametrize("method", ["encode", "infer"])
def test_encoders_match_jax(matched, method):
    """Includes the content mask: mu 0 and logvar 11 on the text expert's
    style dims."""
    jmodel, params, tmodel, data = matched
    want = jmodel.apply({"params": params}, _jbatch(data), method=method)
    with torch.no_grad():
        got = getattr(tmodel, method)(_tbatch(data))
    for g, w in zip(got, want):
        _close(g, w)
    if method == "encode":
        assert torch.all(got[0][:, 1, 8:] == 0) and torch.all(got[1][:, 1, 8:] == 11)


@pytest.mark.parametrize("key", ["image", "text"])
def test_decode_one_matches_jax(matched, key):
    """The image decoder and the teacher-forced text decoder."""
    jmodel, params, tmodel, data = matched
    z = _z(12)
    vs = {"params": params}
    want = jmodel.apply(vs, key, jnp.asarray(z), _jbatch(data), method="decode_one")
    with torch.no_grad():
        got = tmodel.decode_one(key, torch.from_numpy(z), _tbatch(data))
        assert torch.equal(got, tmodel.decode(torch.from_numpy(z), _tbatch(data))[key])
    assert got.shape == ((12, 50, 50) if key == "image" else (12, 5, 13))
    _close(got, want)


def test_nll_all_matches_jax(matched):
    jmodel, params, tmodel, data = matched
    z = _z(12, seed=1)
    vs = {"params": params}
    recons = jmodel.apply(vs, jnp.asarray(z), _jbatch(data), method="decode")
    want = jmodel.apply(vs, recons, _jbatch(data), method="nll_all")
    with torch.no_grad():
        got = tmodel.nll_all(tmodel.decode(torch.from_numpy(z), _tbatch(data)), _tbatch(data))
    _close(got, want, atol=1e-3)


def test_generate_text_at_temperature_zero_matches_jax(matched):
    jmodel, params, tmodel, _ = matched
    z = _z(64, seed=2, scale=3.0)
    want = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(z), jax.random.key(0), 0.0,
        method="generate_text",
    ))
    with torch.no_grad():
        got = tmodel.generate_text(torch.from_numpy(z), 0.0).numpy()
    np.testing.assert_array_equal(got, want)
    # Stop masking is exercised: rows stop at different steps, before
    # the end, and everything after the first STOP is PAD.
    stops = [np.flatnonzero(row == STOP) for row in got]
    first = [s[0] for s in stops if len(s)]
    assert first and min(first) < got.shape[1] - 1 and max(first) > 0
    for row, s in zip(got, stops):
        if len(s):
            assert np.all(row[s[0] + 1:] == PAD)


def test_generate_text_samples_from_the_generator(matched):
    _, _, tmodel, _ = matched
    z = torch.from_numpy(_z(32, seed=3))
    with torch.no_grad():
        a = tmodel.generate_text(z, 1.0, torch.Generator().manual_seed(4))
        b = tmodel.generate_text(z, 1.0, torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b)
    assert a.shape == (32, 5) and 0 <= a.min() and a.max() < 13


def test_eval_step_metrics_match_jax(matched):
    """t-fold, member-pruned, teacher-forced on t-major tiled tokens, with
    a presence mask that drops modalities and whole examples."""
    jmodel, params, tmodel, data = matched
    presence = np.ones((12, 2), np.float32)
    presence[1, 0] = presence[2, 1] = 0.0
    presence[3] = 0.0
    want = j_make_eval_step(jmodel)(params, _jbatch(dict(data, presence=presence)))
    with torch.no_grad():
        _, got = multi_term_loss(tmodel, _tbatch(dict(data, presence=presence)), sample=False)
    for k in ("loss", "recon_per_term", "kl_per_term", "elbo_per_term"):
        _close(got[k], want[k], atol=1e-3)


def test_eval_elbo_matches_jax_on_padded_split(matched):
    """130 examples at batch 50: the last batch is 30 rows padded by 20."""
    jmodel, params, tmodel, _ = matched
    want = japi.eval_elbo(
        "multimnist", model=jmodel, params=params, batch_size=50,
        dataset=j_load_dataset("multimnist", "test", n=130),
    )
    got = api.eval_elbo(
        "multimnist", model=tmodel, dataset=load_dataset("multimnist", "test", n=130),
        batch_size=50, device="cpu",
    )
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("observed", ["text", "image"])
def test_generate_matches_jax(matched, observed):
    jmodel, params, tmodel, data = matched
    condition = {observed: data[observed][:6]}
    want = japi.generate(
        "multimnist", condition, model=jmodel, params=params, sample_z=False,
        temperature=0.0,
    )
    got = api.generate("multimnist", condition, model=tmodel, device="cpu", temperature=0.0)
    assert set(got) == {"image", "text"}
    _close(got["image"], want["image"])
    np.testing.assert_array_equal(got["text"].numpy(), np.asarray(want["text"]))


def test_sample_shapes_and_range(matched):
    _, _, tmodel, _ = matched
    out = api.sample(
        "multimnist", n=8, model=tmodel, device="cpu",
        generator=torch.Generator().manual_seed(0),
    )
    assert out["image"].shape == (8, 50, 50) and out["text"].shape == (8, 5)
    assert torch.isfinite(out["image"]).all()
    assert 0.0 <= out["image"].min() and out["image"].max() <= 1.0
    assert 0 <= out["text"].min() and out["text"].max() < 13


@pytest.mark.parametrize("seed", [0, 1_000_003])
def test_make_multimnist_byte_identical_to_jax(seed):
    got, want = make_multimnist(40, seed=seed), j_make_multimnist(40, seed=seed)
    for k in ("image", "text"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


def test_full_width_config():
    model = configs.build_model("multimnist", device="cpu")
    assert model.n_latents == 256 and model.text_latent_dims == 128
    assert model.lambdas().tolist() == [1.0, 30.0]
    assert [c.out_channels for c in model.image_enc.convs] == [32, 64, 128, 256]
    assert model.image_enc.layers[0].in_features == 4 * 4 * 256
    assert model.image_dec.base_hw == (4, 4) and model.text_dec.hidden == 256
    cfg = configs.get_config("multimnist")
    assert (cfg.batch_size, cfg.test_size, cfg.objective) == (100, 2000, "mvae")


def test_unported_expert_options_raise():
    """``space_to_depth`` and ``upsample_mode="shuffle"`` are ported now
    (``tests/test_torch_conv_variants.py`` holds them against JAX): they
    build their 2x2 layers; a factor that does not divide the image and an
    unknown mode raise ``ValueError``."""
    enc = ConvEncoder(8, (64, 64), space_to_depth=2)
    assert enc.convs[0].kernel_size == (2, 2) and enc.convs[0].in_channels == 4
    dec = DeconvDecoder(8, (64, 64), upsample_mode="shuffle")
    assert [c.out_channels for c in dec.convs] == [4 * 32, 4 * 1] and not len(dec.deconvs)
    with pytest.raises(ValueError, match="does not divide"):
        ConvEncoder(8, (50, 50), space_to_depth=4)
    with pytest.raises(ValueError, match="unknown upsample_mode"):
        DeconvDecoder(8, (64, 64), upsample_mode="nearest")
