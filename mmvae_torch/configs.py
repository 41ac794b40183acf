"""Experiment configs (port of ``mmvae_tpu/configs.py``).

Only the fields the inference slices read, and only the ``mnist``,
``multimnist`` and ``celeba`` configs; the other experiments raise until
their slice lands. The training knobs of the JAX configs
(``cross_recon``, the ``cycle_*`` fields, ``grad_clip``,
``n_random_subsets``, epochs) are not read by eval or generation and are
left out: eval pins ``n_random_subsets=0``
(``mmvae_tpu/train/step.py:1568``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mmvae_torch.device import resolve_device
from mmvae_torch.models import CelebAMVAE, MnistMVAE, MultiMnistMVAE

__all__ = ["ExperimentConfig", "CONFIGS", "get_config", "build_model"]


@dataclasses.dataclass
class ExperimentConfig:
    """Hyperparameters of one experiment."""

    name: str
    dataset: str
    n_latents: int
    batch_size: int = 100
    test_size: int = 2000
    objective: str = "mvae"
    # Extra constructor arguments of the config's model.
    model_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)


CONFIGS: dict[str, ExperimentConfig] = {
    # MVAE on MNIST image+label: MLP encoders, PoE, full ELBO.
    "mnist": ExperimentConfig(name="mnist", dataset="mnist", n_latents=64),
    # MultiMNIST image + digit string: conv image expert over the 50x50
    # canvas, GRU text expert, a text expert limited to the first 128
    # latent dims (``mmvae_tpu/configs.py:223-234``).
    "multimnist": ExperimentConfig(
        name="multimnist", dataset="multimnist", n_latents=256,
        model_kwargs={
            "conv_features": (32, 64, 128, 256),
            "lambda_text": 30.0,
            "text_hidden": 256,
            "text_latent_dims": 128,
        },
    ),
    # CelebA image + 18 attributes: conv image expert over 64x64 RGB, one
    # Gaussian expert per attribute, batch 64
    # (``mmvae_tpu/configs.py:236-239``).
    "celeba": ExperimentConfig(
        name="celeba", dataset="celeba", n_latents=100, batch_size=64,
    ),
}

_MODEL_CLASSES = {
    "mnist": MnistMVAE,
    "multimnist": MultiMnistMVAE,
    "celeba": CelebAMVAE,
}
_NOT_PORTED = ("deep_mnist", "fashionmnist", "cub", "deep_cub")


def get_config(name: str) -> ExperimentConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(f"config {name!r} is not yet ported to mmvae_torch")
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r}; have {list(CONFIGS)}")
    return CONFIGS[name]


def build_model(
    config: ExperimentConfig | str,
    *,
    seed: int = 0,
    device: torch.device | str | None = None,
):
    """The config's model with seeded random weights, on ``device``.

    The weights are drawn on the CPU from a ``torch.Generator`` seeded with
    ``seed`` and then moved, so one seed gives the same weights on every
    device.
    """
    if isinstance(config, str):
        config = get_config(config)
    device = resolve_device(device)
    model = _MODEL_CLASSES[config.name](
        n_latents=config.n_latents, **config.model_kwargs
    )
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)
