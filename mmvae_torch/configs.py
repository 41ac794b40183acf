"""Experiment configs (port of ``mmvae_tpu/configs.py``).

Only the fields the inference slice reads, and only the ``mnist`` config;
the other experiments raise until their slice lands.
"""

from __future__ import annotations

import dataclasses

import torch

from mmvae_torch.device import resolve_device
from mmvae_torch.models import MnistMVAE

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


CONFIGS: dict[str, ExperimentConfig] = {
    # MVAE on MNIST image+label: MLP encoders, PoE, full ELBO.
    "mnist": ExperimentConfig(name="mnist", dataset="mnist", n_latents=64),
}

_MODEL_CLASSES = {"mnist": MnistMVAE}
_NOT_PORTED = ("deep_mnist", "fashionmnist", "multimnist", "celeba", "cub", "deep_cub")


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
    model = _MODEL_CLASSES[config.name](n_latents=config.n_latents)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)
