"""The port's MNIST inference slice against the JAX package, on the CPU.

The JAX ``MnistMVAE`` is initialised from a seed, its parameters are moved
across with ``mmvae_torch.convert``, and both sides see the same numpy
data. Tolerance rtol 2e-4: XLA-CPU transcendentals are approximate
(docs/DESIGN.md section 7).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu import api as japi
from mmvae_tpu.data import load_dataset as j_load_dataset
from mmvae_tpu.data.pipelines import stacked_epoch_padded as j_stacked_epoch_padded
from mmvae_tpu.data.synthetic import make_mnist as j_make_mnist
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.train.step import make_eval_step as j_make_eval_step
from mmvae_torch import api, configs, ops
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import load_dataset, make_mnist, stacked_epoch_padded
from mmvae_torch.device import resolve_device
from mmvae_torch.models import MnistMVAE
from mmvae_torch.train import multi_term_loss

RTOL = 2e-4
REPO = Path(__file__).resolve().parent.parent
N_LATENTS = 16


def _close(got: torch.Tensor, want, atol: float = 1e-4) -> None:
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=atol
    )


@pytest.fixture(scope="module")
def matched():
    """(JAX model, JAX params, port model on the CPU, numpy batch)."""
    jmodel = JMnistMVAE(n_latents=N_LATENTS)
    data = make_mnist(12, seed=5)
    batch = {k: jnp.asarray(v) for k, v in data.items()}
    params = jmodel.init(jax.random.key(0), batch, rng=jax.random.key(1))["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = MnistMVAE(n_latents=N_LATENTS)
    tmodel.load_state_dict(from_flax_params(params))
    return jmodel, params, tmodel, data


def _tbatch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def test_convert_maps_every_parameter(matched):
    _, params, tmodel, _ = matched
    state = from_flax_params(params)
    assert set(state) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert state[k].shape == v.shape, k
    torch.testing.assert_close(
        state["image_enc.head.weight"],
        torch.from_numpy(params["image_enc"]["Dense_2"]["kernel"].T.copy()),
    )
    with pytest.raises(ValueError, match="cannot map"):
        from_flax_params({"image_enc": {"BatchNorm_0": {}}})


@pytest.mark.parametrize("method", ["encode", "decode", "nll_all", "infer"])
def test_model_matches_jax(matched, method):
    jmodel, params, tmodel, data = matched
    vs = {"params": params}
    jb, tb = {k: jnp.asarray(v) for k, v in data.items()}, _tbatch(data)
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
        for k in want:
            _close(got[k], want[k])
        return
    j_nll = jmodel.apply(vs, want, jb, method="nll_all")
    _close(tmodel.nll_all(got, tb), j_nll, atol=1e-3)


def test_eval_step_metrics_match_jax(matched):
    """t-fold, member-pruned, with a presence mask that drops modalities
    and whole examples."""
    jmodel, params, tmodel, data = matched
    presence = np.ones((12, 2), np.float32)
    presence[1, 0] = presence[2, 1] = 0.0
    presence[3] = 0.0
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    jb["presence"] = jnp.asarray(presence)
    want = j_make_eval_step(jmodel)(params, jb)
    tb = _tbatch(dict(data, presence=presence))
    with torch.no_grad():
        _, got = multi_term_loss(tmodel, tb, 1.0, sample=False)
    for k in ("loss", "recon_per_term", "kl_per_term", "elbo_per_term"):
        _close(got[k], want[k], atol=1e-3)


def test_example_without_modalities_contributes_zero(matched):
    _, _, tmodel, data = matched
    tb = _tbatch(data)
    presence = torch.ones((12, 2))
    presence[-1] = 0.0
    with torch.no_grad():
        full, _ = multi_term_loss(tmodel, dict(tb, presence=presence), sample=False)
        head, _ = multi_term_loss(
            tmodel, {k: v[:-1] for k, v in tb.items()}, sample=False
        )
    torch.testing.assert_close(full * 12, head * 11, rtol=1e-5, atol=1e-3)


def test_decode_all_pass_matches_jax(matched):
    """``member_prune=False``: every key decodes all T terms (the decode-all
    pass, ``step.py:565-576``), against the JAX eval step's, with a
    presence mask that drops modalities and a whole example."""
    jmodel, params, tmodel, data = matched
    presence = np.ones((12, 2), np.float32)
    presence[1, 0] = presence[2, 1] = 0.0
    presence[3] = 0.0
    jb = {k: jnp.asarray(v) for k, v in dict(data, presence=presence).items()}
    want = j_make_eval_step(jmodel, member_prune=False)(params, jb)
    with torch.no_grad():
        _, got = multi_term_loss(tmodel, _tbatch(dict(data, presence=presence)), 1.0,
                                 sample=False, member_prune=False)
    for k in ("loss", "recon_per_term", "kl_per_term", "elbo_per_term"):
        _close(got[k], want[k], atol=1e-3)


@pytest.mark.parametrize(
    "kw",
    [{"objective": "mmvae", "cross_recon": True}, {"term_fold": "b"}, {"term_fold": "st"}],
)
def test_unported_loss_paths_raise(matched, kw):
    """The b fold is ported and gives the t fold's eval loss (rel 1e-5); the
    st fold without a mesh raises JAX's ``ValueError``; the mixture
    objectives refuse the mvae term knobs with the JAX loss's
    ``ValueError``."""
    _, _, tmodel, data = matched
    if kw.get("term_fold") == "b":
        got, _ = multi_term_loss(tmodel, _tbatch(data), sample=False, **kw)
        want, _ = multi_term_loss(tmodel, _tbatch(data), sample=False)
        assert got.item() == pytest.approx(want.item(), rel=1e-5)
        return
    if "term_fold" in kw:
        error, match = ValueError, "requires a mesh"
    else:
        error, match = ValueError, "mvae term-structure knobs"
    with pytest.raises(error, match=match):
        multi_term_loss(tmodel, _tbatch(data), sample=False, **kw)


def test_eval_elbo_matches_jax_on_padded_split(matched):
    """70 examples at batch 32: the last batch is 26 rows padded by 6."""
    jmodel, params, tmodel, _ = matched
    want = japi.eval_elbo(
        "mnist", model=jmodel, params=params, batch_size=32,
        dataset=j_load_dataset("mnist", "test", n=70),
    )
    got = api.eval_elbo(
        "mnist", model=tmodel, dataset=load_dataset("mnist", "test", n=70),
        batch_size=32, device="cpu",
    )
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("observed", [("label",), ("image",), ("image", "label")])
def test_generate_matches_jax(matched, observed):
    jmodel, params, tmodel, data = matched
    condition = {"label": np.asarray([3, 5, 7], np.int32), "image": data["image"][:3]}
    condition = {k: condition[k] for k in observed}
    want = japi.generate(
        "mnist", condition, model=jmodel, params=params, sample_z=False
    )
    got = api.generate("mnist", condition, model=tmodel, device="cpu")
    _close(got["image"], want["image"])
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))


def test_sample_shapes_and_range(matched):
    _, _, tmodel, _ = matched
    out = api.sample(
        "mnist", n=16, model=tmodel, device="cpu",
        generator=torch.Generator().manual_seed(0),
    )
    assert out["image"].shape == (16, 28, 28) and out["label"].shape == (16,)
    assert torch.isfinite(out["image"]).all()
    assert 0.0 <= out["image"].min() and out["image"].max() <= 1.0
    assert 0 <= out["label"].min() and out["label"].max() < 10


@pytest.mark.parametrize("seed", [0, 1_000_003])
def test_make_mnist_byte_identical_to_jax(seed):
    got, want = make_mnist(50, seed=seed), j_make_mnist(50, seed=seed)
    for k in ("image", "label"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


def test_split_seeds_and_padding_match_jax():
    got = load_dataset("mnist", "test", n=70)
    want = j_load_dataset("mnist", "test", n=70, device_put=False)
    assert got.size == want.size == 70
    for k in ("image", "label"):
        assert got.arrays[k].tobytes() == want.arrays[k].tobytes()
    batches, valid = stacked_epoch_padded(got, 32)
    j_batches, j_valid = j_stacked_epoch_padded(want, 32, host=True)
    np.testing.assert_array_equal(valid, j_valid)
    for k in ("image", "label"):
        np.testing.assert_array_equal(batches[k], j_batches[k])


def test_port_imports_no_jax():
    """The port and chip_smoke.py load without JAX or the JAX package."""
    code = (
        "import sys\n"
        "import mmvae_torch, mmvae_torch.api, mmvae_torch.convert, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'mmvae_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card(matched):
    _, _, tmodel, data = matched
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda")
    else:
        for call in (
            lambda: resolve_device(None),
            lambda: configs.build_model("mnist"),
            lambda: api.generate("mnist", {"label": [1]}, model=tmodel),
            lambda: api.sample("mnist", n=2, model=tmodel),
            lambda: api.eval_elbo("mnist", model=tmodel),
        ):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    ops.set_backend("kernel")
    try:
        with pytest.raises(ValueError, match="CUDA"):
            api.eval_elbo(
                "mnist", model=tmodel, dataset=load_dataset("mnist", "test", n=8),
                device="cpu",
            )
    finally:
        ops.set_backend("auto")


def test_unported_configs_and_datasets_raise(tmp_path, monkeypatch):
    """The ``deep_mnist`` pipeline config is ported now and is the JAX
    config (its trunks are in ``tests/test_torch_deep.py``); an unknown name
    is a ``ValueError``. A mounted ``fashionmnist/`` with no IDX files in
    it: both loaders find no format there and generate the same split."""
    from mmvae_tpu.configs import get_config as j_get_config

    deep, j_deep = configs.get_config("deep_mnist"), j_get_config("deep_mnist")
    assert (deep.dataset, deep.n_latents, deep.annealing_epochs, deep.batch_size) == (
        j_deep.dataset, j_deep.n_latents, j_deep.annealing_epochs, j_deep.batch_size)
    (tmp_path / "fashionmnist").mkdir()
    monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
    got = load_dataset("fashionmnist", n=6)
    want = j_load_dataset("fashionmnist", n=6, device_put=False)
    for k, v in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[k], np.asarray(v))
    with pytest.raises(ValueError):
        configs.get_config("nope")
