"""The port's CUB inference slice against the JAX package, on the CPU.

The JAX ``CubMVAE`` is initialised from a seed at small widths (n_latents
16, 16x16 RGB images, conv features (8, 16); the caption experts at the
embed 128 and hidden 256 the JAX model fixes, over the 23-id synthetic
vocabulary), every bias is moved off 0 so that the bias mapping is
exercised, the caption decoder's STOP bias is raised so that greedy
decoding stops at different steps, the parameters are moved across with
``mmvae_torch.convert``, and both sides see the same numpy data.
Tolerance rtol 2e-4: XLA-CPU transcendentals are approximate
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
from mmvae_tpu.data.pipelines import Dataset as JDataset
from mmvae_tpu.data.synthetic import cub_vocab as j_cub_vocab
from mmvae_tpu.data.synthetic import make_cub as j_make_cub
from mmvae_tpu.models import CubMVAE as JCubMVAE
from mmvae_tpu.train.step import make_eval_step as j_make_eval_step
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import Dataset, Vocab, cub_vocab, load_dataset, make_cub
from mmvae_torch.models import CubMVAE
from mmvae_torch.models.text import PAD, STOP
from mmvae_torch.train import multi_term_loss

RTOL = 2e-4
N_LATENTS = 16
HW = 16
V = 23
SMALL = dict(vocab_size=V, image_hw=(HW, HW), conv_features=(8, 16))
BIASES = ("bias", "b")


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
    jmodel = JCubMVAE(n_latents=N_LATENTS, **SMALL)
    data = make_cub(8, seed=5, hw=HW)
    params = jmodel.init(jax.random.key(0), _jbatch(data), rng=jax.random.key(1))
    params = jax.tree.map(np.array, params["params"])
    _shift_biases(params, np.random.default_rng(0))
    params["text_dec"]["out_proj"]["bias"][STOP] += 1.5
    tmodel = CubMVAE(n_latents=N_LATENTS, **SMALL)
    tmodel.load_state_dict(from_flax_params(params))
    return jmodel, params, tmodel, data


def _z(n: int, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, N_LATENTS)) * scale).astype(np.float32)


def test_convert_maps_every_parameter(matched):
    """CUB's Flax tree has the leaf names of MultiMNIST's image and text
    experts: ``image_enc/{Conv_{0,1}, Dense_{0,1}}``, ``image_dec/{Dense_{0,1},
    ConvTranspose_{0,1}}``, ``text_enc/{Embed_0, w_in, u_rec, b, Dense_0}``,
    ``text_dec/{embed, init_proj, w_in, u_rec, b, out_proj}``."""
    _, params, tmodel, _ = matched
    state = from_flax_params(params)
    assert set(state) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert state[k].shape == v.shape, k
    assert sorted(params["text_enc"]) == ["Dense_0", "Embed_0", "b", "u_rec", "w_in"]
    assert sorted(params["text_dec"]) == ["b", "embed", "init_proj", "out_proj", "u_rec", "w_in"]
    torch.testing.assert_close(state["text_enc.embed.weight"],
                               torch.from_numpy(params["text_enc"]["Embed_0"]["embedding"]))
    torch.testing.assert_close(state["text_dec.w_in"], torch.from_numpy(params["text_dec"]["w_in"]))
    kernel = params["image_dec"]["ConvTranspose_1"]["kernel"]
    assert kernel.shape[-1] == 3
    torch.testing.assert_close(
        state["image_dec.deconvs.1.weight"],
        torch.from_numpy(kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy()),
    )
    assert state["image_enc.convs.0.weight"].shape == (8, 3, 4, 4)


@pytest.mark.parametrize("method", ["encode", "infer", "decode", "nll_all"])
def test_model_matches_jax(matched, method):
    jmodel, params, tmodel, data = matched
    vs = {"params": params}
    jb, tb = _jbatch(data), _tbatch(data)
    if method in ("encode", "infer"):
        want = jmodel.apply(vs, jb, method=method)
        with torch.no_grad():
            got = getattr(tmodel, method)(tb)
        assert got[0].shape == ((8, 2, N_LATENTS) if method == "encode" else (8, N_LATENTS))
        for g, w in zip(got, want):
            _close(g, w)
        return
    z = _z(8, seed=2)
    want = jmodel.apply(vs, jnp.asarray(z), jb, method="decode")
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z), tb)
        if method == "decode":
            assert got["image"].shape == (8, HW, HW, 3) and got["text"].shape == (8, 32, V)
            for k in ("image", "text"):
                torch.testing.assert_close(tmodel.decode_one(k, torch.from_numpy(z), tb), got[k])
                _close(got[k], want[k])
            return
        nll = tmodel.nll_all(got, tb)
    assert nll.shape == (2, 8)
    _close(nll, jmodel.apply(vs, want, jb, method="nll_all"), atol=1e-3)


def test_eval_step_metrics_match_jax(matched):
    """T = 3 terms, t-fold, member-pruned, teacher-forced on t-major tiled
    captions, a presence mask dropping modalities and a whole example."""
    jmodel, params, tmodel, data = matched
    presence = np.ones((8, 2), np.float32)
    presence[1, 0] = presence[2, 1] = 0.0
    presence[3] = 0.0
    want = j_make_eval_step(jmodel)(params, _jbatch(dict(data, presence=presence)))
    with torch.no_grad():
        _, got = multi_term_loss(tmodel, _tbatch(dict(data, presence=presence)), sample=False)
    for k in ("loss", "recon_per_term", "kl_per_term", "elbo_per_term"):
        _close(got[k], want[k], atol=1e-3)


def test_eval_elbo_matches_jax_on_padded_split(matched):
    """20 examples at batch 8: the last batch is 4 rows padded by 4."""
    jmodel, params, tmodel, _ = matched
    data = make_cub(20, seed=1_000_003, hw=HW)
    want = japi.eval_elbo(
        "cub", model=jmodel, params=params, batch_size=8,
        dataset=JDataset(arrays=_jbatch(data), size=20),
    )
    got = api.eval_elbo(
        "cub", model=tmodel, dataset=Dataset(arrays=data, size=20), batch_size=8, device="cpu",
    )
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_generate_text_at_temperature_zero_matches_jax(matched):
    jmodel, params, tmodel, _ = matched
    z = _z(32, seed=3, scale=3.0)
    want = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(z), jax.random.key(0), 0.0, method="generate_text",
    ))
    with torch.no_grad():
        got = tmodel.generate_text(torch.from_numpy(z), 0.0).numpy()
    np.testing.assert_array_equal(got, want)
    stops = [np.flatnonzero(row == STOP) for row in got]
    first = [s[0] for s in stops if len(s)]
    assert first and min(first) < got.shape[1] - 1 and len(set(first)) > 1
    for row, s in zip(got, stops):
        if len(s):
            assert np.all(row[s[0] + 1:] == PAD)


@pytest.mark.parametrize("observed", ["image", "text", "nothing"])
def test_generate_matches_jax(matched, observed):
    """From images, from captions and from nothing (the prior mean),
    captions generated at temperature 0."""
    jmodel, params, tmodel, data = matched
    condition = {} if observed == "nothing" else {observed: data[observed][:5]}
    want = japi.generate(
        "cub", condition, n=5, model=jmodel, params=params, sample_z=False, temperature=0.0,
    )
    got = api.generate("cub", condition, n=5, model=tmodel, device="cpu", temperature=0.0)
    assert set(got) == {"image", "text"}
    assert got["image"].shape == (5, HW, HW, 3) and got["text"].shape == (5, 32)
    _close(got["image"], want["image"])
    np.testing.assert_array_equal(got["text"].numpy(), np.asarray(want["text"]))


def test_sample_shapes_and_range(matched):
    _, _, tmodel, _ = matched
    out = api.sample("cub", n=6, model=tmodel, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert out["image"].shape == (6, HW, HW, 3) and out["text"].shape == (6, 32)
    assert torch.isfinite(out["image"]).all()
    assert 0.0 <= out["image"].min() and out["image"].max() <= 1.0
    assert 0 <= out["text"].min() and out["text"].max() < V


@pytest.mark.parametrize("seed", [0, 1_000_003])
def test_make_cub_byte_identical_to_jax(seed):
    got, want = make_cub(12, seed=seed), j_make_cub(12, seed=seed)
    for k in ("image", "text"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


def test_vocab_matches_jax():
    got, want = cub_vocab(), j_cub_vocab()
    assert len(got) == len(want) == V and got.itos == want.itos
    sentence = "this bird has a red body with small wings and a long beak"
    np.testing.assert_array_equal(got.encode(sentence, 32), want.encode(sentence, 32))
    ids = got.encode(sentence, 32)
    assert got.decode(ids) == want.decode(ids) == sentence
    assert got.encode(sentence, 6).tolist() == [3, 4, 5, 6, 12, STOP]  # "red" is 12
    with pytest.raises(KeyError):
        got.encode("this bird sings", 8)
    unk = Vocab(["a", "b"], unk=True)
    assert unk.encode("a zebra b", 5).tolist() == [4, 3, 5, STOP, PAD]


def test_test_split_matches_jax():
    got = load_dataset("cub", "test", n=6)
    want = j_load_dataset("cub", "test", n=6, device_put=False)
    assert got.size == want.size == 6
    for k in ("image", "text"):
        assert got.arrays[k].tobytes() == np.asarray(want.arrays[k]).tobytes()


def test_full_width_config():
    model = configs.build_model("cub", device="cpu")
    assert model.n_latents == 256 and model.n_modalities == 2 and model.vocab_size == V
    assert model.lambdas().tolist() == [1.0, 5.0]
    assert [c.out_channels for c in model.image_enc.convs] == [32, 64, 128, 256]
    assert model.image_enc.convs[0].in_channels == 3
    assert model.image_dec.base_hw == (4, 4) and model.image_dec.deconvs[-1].out_channels == 3
    assert model.text_enc.embed.embedding_dim == 128 and model.text_dec.hidden == 256
    assert model.text_dec.max_len == 32
    cfg = configs.get_config("cub")
    assert (cfg.batch_size, cfg.test_size, cfg.objective) == (64, 2000, "mvae")
    assert cfg.cross_recon and cfg.cycle_weight == 0.1 and cfg.cycle_render_grad


def test_train_and_a_mounted_corpus_raise(tmp_path, monkeypatch):
    """A mounted ``cub/`` with no corpus keeps the synthetic vocabulary
    (as the JAX config does); a mounted corpus of 6 image-caption pairs
    sizes the model from its vocabulary, loads (the first caption over it),
    and ``api.train`` trains on it at a small width (the images at the
    reader's 64x64)."""
    from PIL import Image

    (tmp_path / "cub").mkdir()
    monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
    assert configs.cub_vocab_size() == V
    assert load_dataset("cub", "test", n=2).arrays["text"].max() < V
    rng = np.random.default_rng(0)
    for j in range(6):
        (tmp_path / "cub" / "images" / "001.a").mkdir(parents=True, exist_ok=True)
        (tmp_path / "cub" / "text_c10" / "001.a").mkdir(parents=True, exist_ok=True)
        Image.fromarray((rng.random((30, 40, 3)) * 255).astype(np.uint8)).save(
            tmp_path / "cub" / "images" / "001.a" / f"{j}.jpg")
        (tmp_path / "cub" / "text_c10" / "001.a" / f"{j}.txt").write_text(
            f"a bird number {j} with {'red blue green'.split()[j % 3]} wings\n")
    v = configs.cub_vocab_size()
    assert v == 3 + 1 + 14  # a bird number 0-5 with red blue green wings
    data = load_dataset("cub", "train")
    assert data.size == 5 and data.arrays["image"].shape == (5, 64, 64, 3)
    assert 3 < data.arrays["text"].max() < v
    cfg = configs.get_config("cub").replace(
        n_latents=8, epochs=1, batch_size=4, test_size=1,
        model_kwargs=dict(conv_features=(8, 8)))
    result = api.train(cfg, device="cpu", verbose=False)
    assert result.model.vocab_size == v and np.isfinite(result.history[0]["test_elbo"])
