"""Experiment configs (port of ``mmvae_tpu/configs.py``).

Only the ``mnist``, ``multimnist`` and ``celeba`` configs; the other
experiments raise until their slice lands. The fields are those the
inference slices, the MNIST and MultiMNIST training slices and the
checkpoints (``ckpt_every``, ``keep_epoch_ckpts``) read, with the JAX
defaults (``mmvae_tpu/configs.py:30-175``), and the one training
feature the ``celeba`` config sets that is not ported yet
(:data:`UNPORTED_TRAIN_FIELDS`: ``n_random_subsets``); ``api.train``
raises ``NotImplementedError`` when it is set, so training CelebA raises
until its slice lands. The JAX configs' other knobs (gradient
accumulation, LR schedules, shuffle modes, the data backends, mesh
layouts, ``cross_recon_stopgrad``, ``unimodal_align_weight``,
``cycle_contrast_weight``) are left out until a slice reads them. Eval
pins ``n_random_subsets=0`` (``mmvae_tpu/train/step.py:1568``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mmvae_torch.device import resolve_device
from mmvae_torch.models import CelebAMVAE, MnistMVAE, MultiMnistMVAE

__all__ = [
    "ExperimentConfig",
    "CONFIGS",
    "UNPORTED_TRAIN_FIELDS",
    "get_config",
    "build_model",
]


@dataclasses.dataclass
class ExperimentConfig:
    """Hyperparameters of one experiment."""

    name: str
    dataset: str
    n_latents: int
    epochs: int = 20
    batch_size: int = 100
    learning_rate: float = 1e-3
    annealing_epochs: int = 10  # beta ramps 0 -> 1 over these epochs
    n_random_subsets: int = 0  # random modality-subset terms
    objective: str = "mvae"
    member_prune: bool = True  # decode each key on its member terms only
    p_modality_drop: float = 0.0  # presence dropout per example and modality
    grad_clip: float = 0.0  # global-norm gradient clipping (0: off)
    ema_decay: float = 0.0  # EMA shadow of the parameters (0: off)
    train_size: int = 10000
    test_size: int = 2000
    # Checkpoints (with a workdir): every ckpt_every epochs and always at
    # the last; keep_epoch_ckpts > 0 also keeps that many newest
    # per-epoch snapshots (0: last and best only).
    ckpt_every: int = 1
    keep_epoch_ckpts: int = 0
    # Reconstruct every modality from every subset posterior; cross
    # entries (modality m from a subset without m) weigh cross_recon_weight.
    cross_recon: bool = False
    cross_recon_weight: float = 1.0
    # The cycle term: the seq posterior rendered into the bernoulli
    # modalities, re-encoded, and the sequence read back (its CE weighs
    # cycle_weight); cycle_render_grad lets the render's decoders learn
    # from it; cycle_render_binarize: False (soft render), True (0/1
    # straight-through) or "both" (the CE of the two averaged).
    cycle_weight: float = 0.0
    cycle_render_grad: bool = False
    cycle_render_binarize: bool | str = False
    # Extra constructor arguments of the config's model.
    model_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# The training features ``api.train`` does not take yet: each must be
# falsy (off) to train.
UNPORTED_TRAIN_FIELDS = ("n_random_subsets",)


CONFIGS: dict[str, ExperimentConfig] = {
    # MVAE on MNIST image+label: MLP encoders, PoE, full ELBO.
    "mnist": ExperimentConfig(
        name="mnist", dataset="mnist", n_latents=64, annealing_epochs=10,
    ),
    # MultiMNIST image + digit string: conv image expert over the 50x50
    # canvas, GRU text expert, a text expert limited to the first 128
    # latent dims (``mmvae_tpu/configs.py:223-234``).
    "multimnist": ExperimentConfig(
        name="multimnist", dataset="multimnist", n_latents=256,
        cross_recon=True, grad_clip=500.0, epochs=60, train_size=100000,
        cycle_weight=1.0, cycle_render_grad=True, cycle_render_binarize="both",
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
        n_random_subsets=4, grad_clip=500.0,
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
