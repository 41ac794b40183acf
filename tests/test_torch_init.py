"""``configs.build_model(seed)`` draws its weights as Flax's ``model.init``
does, on the CPU.

For each ported config at small widths, the Flax tree is mapped onto the
port's names with ``mmvae_torch.convert``, and every parameter tensor of
500 elements or more must have a standard deviation within 15% of the
Flax tensor's (the sampling error of a std over 500 draws is about 3%);
every bias is exactly 0. This pins the two init rules that differ from
PyTorch's: ``nn.Embed`` tables are N(0, 1/features), and the fan-in of a
stacked parameter (the CelebA attribute banks, the deep configs' residual
trunks) is ``shape[-2]`` times the product of its leading dims.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
from mmvae_tpu.models import DeepCubMVAE as JDeepCubMVAE
from mmvae_tpu.models import DeepMnistMVAE as JDeepMnistMVAE
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.models import MultiMnistMVAE as JMultiMnistMVAE
from mmvae_torch import configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import make_celeba, make_cub, make_mnist, make_multimnist

SMALL = {
    "mnist": (JMnistMVAE, 16, {}, lambda: make_mnist(4)),
    "multimnist": (
        JMultiMnistMVAE, 16,
        dict(conv_features=(32, 64), text_hidden=64, text_embed=64, text_latent_dims=8),
        lambda: make_multimnist(4),
    ),
    "celeba": (
        JCelebAMVAE, 8, dict(image_hw=(32, 32), conv_features=(32, 16)),
        lambda: make_celeba(4, hw=32),
    ),
    # The residual trunks' kernels (S, depth, W, W) at Flax's fan-in S * depth * W.
    "deep_mnist": (JDeepMnistMVAE, 16, dict(trunk_width=64), lambda: make_mnist(4)),
    "deep_cub": (
        JDeepCubMVAE, 16, dict(image_hw=(32, 32), conv_features=(8, 16), vocab_size=23),
        lambda: make_cub(4, hw=32),
    ),
}
BIASES = ("bias", "b", "b1", "b2", "biases", "alphas")  # the trunks start at 0 too


def _flax_state(name):
    jcls, n_latents, kwargs, data = SMALL[name]
    batch = {k: jnp.asarray(v) for k, v in data().items()}
    params = jcls(n_latents=n_latents, **kwargs).init(
        jax.random.key(0), batch, rng=jax.random.key(1)
    )["params"]
    return from_flax_params(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_build_model_matches_flax_init_distributions(name):
    _, n_latents, kwargs, _ = SMALL[name]
    cfg = dataclasses.replace(
        configs.get_config(name), n_latents=n_latents,
        model_kwargs={**configs.get_config(name).model_kwargs, **kwargs},
    )
    ours = configs.build_model(cfg, seed=3, device="cpu").state_dict()
    flax = _flax_state(name)
    assert set(ours) == set(flax)
    checked = []
    for key, value in ours.items():
        if key.rsplit(".", 1)[-1] in BIASES:
            assert torch.all(value == 0), key
            continue
        if value.numel() < 500:
            continue
        got, want = value.std().item(), flax[key].std().item()
        assert abs(got / want - 1) < 0.15, (key, got, want)
        checked.append(key)
    embeds = [k for k in checked if "embed" in k]
    assert embeds, "no embedding table was checked"
    if name == "celeba":
        assert {"attr_enc.w1", "attr_dec.w1", "attr_enc.w2", "attr_enc.embed"} <= set(checked)
    if name.startswith("deep_"):
        assert {"image_enc.trunk.kernels", "image_dec.trunk.kernels"} <= set(checked)


def test_stacked_and_embedding_stds():
    """The stds Flax gives the CelebA banks and an ``nn.Embed`` table:
    0.0418 for (18, 32, 64) (fan-in 576), 0.233 for a 2-D (18, 64)
    (fan-in 18), 1/sqrt(512) for a 512-wide label embedding."""
    model = configs.build_model("celeba", seed=0, device="cpu")
    assert model.attr_enc.w1.std().item() == pytest.approx(576**-0.5, rel=0.05)
    assert model.attr_dec.w2.std().item() == pytest.approx(18**-0.5, rel=0.15)
    assert model.attr_enc.embed.std().item() == pytest.approx(0.02, rel=0.1)
    mnist = configs.build_model("mnist", seed=0, device="cpu")
    assert mnist.label_enc.embed.weight.std().item() == pytest.approx(512**-0.5, rel=0.05)
