"""Per-modality encoder/decoder experts (port of ``mmvae_tpu/models/experts.py:40-164``).

Encoders return ``(mu, logvar)``; decoders return logits. Each expert is a
stack of ``nn.Linear`` layers with swish activations (``layers``) and an
output ``head``; ``mmvae_torch.convert`` maps Flax's ``Dense_{i}`` onto
them in order. Encoder heads are ONE ``Linear`` to ``2 * n_latents`` that
is split ``[:L]`` / ``[L:]``, as in the JAX experts.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

__all__ = ["swish", "MLPEncoder", "MLPDecoder", "LabelEncoder", "LabelDecoder"]


def swish(x: torch.Tensor) -> torch.Tensor:
    """Swish/SiLU, ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def _hidden_layers(in_features: int, hidden: Sequence[int]) -> nn.ModuleList:
    widths = (in_features, *hidden)
    return nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
    )


def _run(layers: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        h = swish(layer(h))
    return h


def _split_head(out: torch.Tensor, n_latents: int):
    return out[:, :n_latents], out[:, n_latents:]


class MLPEncoder(nn.Module):
    """Flat-input MLP encoder -> ``(mu, logvar)``; the MNIST image expert."""

    def __init__(
        self, in_features: int, n_latents: int, hidden: Sequence[int] = (512, 512)
    ):
        super().__init__()
        self.n_latents = n_latents
        self.layers = _hidden_layers(in_features, hidden)
        self.head = nn.Linear(hidden[-1], 2 * n_latents)

    def forward(self, x: torch.Tensor):
        h = _run(self.layers, x.reshape(x.shape[0], -1))
        return _split_head(self.head(h), self.n_latents)


class MLPDecoder(nn.Module):
    """Latent -> logits of shape ``out_shape``; the MNIST image expert."""

    def __init__(
        self,
        n_latents: int,
        out_shape: tuple[int, ...],
        hidden: Sequence[int] = (512, 512),
    ):
        super().__init__()
        self.out_shape = tuple(out_shape)
        self.layers = _hidden_layers(n_latents, hidden)
        self.head = nn.Linear(hidden[-1], math.prod(self.out_shape))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        logits = self.head(_run(self.layers, z))
        return logits.reshape((z.shape[0],) + self.out_shape)


class LabelEncoder(nn.Module):
    """Class-label expert: embed -> MLP -> ``(mu, logvar)``."""

    def __init__(
        self,
        n_latents: int,
        n_classes: int,
        embed_dim: int = 512,
        hidden: Sequence[int] = (512,),
    ):
        super().__init__()
        self.n_latents = n_latents
        self.embed = nn.Embedding(n_classes, embed_dim)
        self.layers = _hidden_layers(embed_dim, hidden)
        self.head = nn.Linear(hidden[-1], 2 * n_latents)

    def forward(self, y: torch.Tensor):
        h = _run(self.layers, self.embed(y.long()))
        return _split_head(self.head(h), self.n_latents)


class LabelDecoder(nn.Module):
    """Latent -> class logits."""

    def __init__(
        self, n_latents: int, n_classes: int, hidden: Sequence[int] = (512,)
    ):
        super().__init__()
        self.layers = _hidden_layers(n_latents, hidden)
        self.head = nn.Linear(hidden[-1], n_classes)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.head(_run(self.layers, z))
