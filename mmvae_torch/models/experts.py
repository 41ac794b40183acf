"""Per-modality encoder/decoder experts (port of ``mmvae_tpu/models/experts.py:40-396``).

Encoders return ``(mu, logvar)``; decoders return logits. Each expert's
dense part is a stack of ``nn.Linear`` layers with swish activations
(``layers``) and a last ``head``; ``mmvae_torch.convert`` maps Flax's
``Dense_{i}`` onto them in order, and ``Conv_{i}`` / ``ConvTranspose_{i}``
onto ``convs.{i}`` / ``deconvs.{i}``. Encoder heads are ONE ``Linear`` to
``2 * n_latents`` that is split ``[:L]`` / ``[L:]``, as in the JAX experts.

The conv experts take and give grayscale images in the JAX package's
layout, ``(B, H, W)``; inside, the convolutions run NCHW.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "swish",
    "MLPEncoder",
    "MLPDecoder",
    "LabelEncoder",
    "LabelDecoder",
    "ConvEncoder",
    "DeconvDecoder",
]


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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to mmvae_torch")


def _same_pad(hw: Sequence[int], k: int = 4, s: int = 2) -> list[int]:
    """``F.pad`` widths of XLA's SAME for a k x k stride-s conv. Per dim the
    total is ``max((ceil(d/s) - 1) * s + k - d, 0)``, the low side gets
    ``total // 2``: at odd sizes the pad is asymmetric (25 -> 13 pads
    (1, 2)), which ``Conv2d(padding=)`` cannot express."""
    pads = []
    for d in reversed(tuple(hw)):  # F.pad takes (w_lo, w_hi, h_lo, h_hi)
        total = max((-(-d // s) - 1) * s + k - d, 0)
        pads += [total // 2, total - total // 2]
    return pads


def _conv_out(d: int, n_stages: int) -> int:
    for _ in range(n_stages):
        d = -(-d // 2)
    return d


class ConvEncoder(nn.Module):
    """Strided-conv image encoder -> ``(mu, logvar)``.

    Each stage is a 4x4 stride-2 SAME conv and a swish, halving the
    spatial dims (rounding up); then a ``fc_hidden`` dense layer and the
    head. Only the reference-shaped grayscale stack is ported:
    ``space_to_depth=1`` and no bottleneck trunk.
    """

    def __init__(
        self,
        n_latents: int,
        image_hw: tuple[int, int],
        features: Sequence[int] = (32, 64),
        fc_hidden: int = 512,
        space_to_depth: int = 1,
    ):
        super().__init__()
        if space_to_depth != 1:
            raise _not_ported(f"space_to_depth={space_to_depth}")
        self.n_latents = n_latents
        widths = (1, *features)
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, 4, stride=2) for a, b in zip(widths[:-1], widths[1:])
        )
        out_h, out_w = (_conv_out(d, len(features)) for d in image_hw)
        self.layers = _hidden_layers(out_h * out_w * features[-1], (fc_hidden,))
        self.head = nn.Linear(fc_hidden, 2 * n_latents)

    def forward(self, x: torch.Tensor):
        h = x[:, None]  # NCHW
        for conv in self.convs:
            h = swish(conv(F.pad(h, _same_pad(h.shape[-2:]))))
        h = h.permute(0, 2, 3, 1).flatten(1)  # Flax flattens NHWC
        return _split_head(self.head(_run(self.layers, h)), self.n_latents)


class DeconvDecoder(nn.Module):
    """Transposed-conv image decoder: latent -> per-pixel logits.

    Mirror of :class:`ConvEncoder`: ``layers.0`` (Flax ``Dense_0``, to
    ``fc_hidden``) and ``head`` (``Dense_1``, to the bottleneck grid of
    ``ceil(out_hw / 2**stages)`` by ``features[0]``), each with a swish;
    then 4x4 stride-2 transposed convs, swish between them, and a last one
    to one channel. The grid overshoots a non-power-of-two target (50x50
    from 4x4 -> 64x64) and the TOP-LEFT ``out_hw`` is kept, as in the JAX
    decoder. Only the reference-shaped ``upsample_mode="deconv"`` stack
    is ported. Flax's ``ConvTranspose`` does not flip its kernel, so
    ``convert`` flips it into ``deconvs.{i}.weight``.
    """

    def __init__(
        self,
        n_latents: int,
        out_hw: tuple[int, int],
        features: Sequence[int] = (64, 32),
        fc_hidden: int = 512,
        upsample_mode: str = "deconv",
    ):
        super().__init__()
        if upsample_mode != "deconv":
            raise _not_ported(f"upsample_mode={upsample_mode!r}")
        self.out_hw = tuple(out_hw)
        self.features = tuple(features)
        n_stages = len(self.features)
        self.base_hw = tuple(-(-d // 2**n_stages) for d in self.out_hw)
        self.layers = _hidden_layers(n_latents, (fc_hidden,))
        self.head = nn.Linear(fc_hidden, math.prod(self.base_hw) * self.features[0])
        widths = (*self.features, 1)
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(a, b, 4, stride=2, padding=1)
            for a, b in zip(widths[:-1], widths[1:])
        )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = swish(self.head(_run(self.layers, z)))
        h = h.reshape(z.shape[0], *self.base_hw, self.features[0]).permute(0, 3, 1, 2)
        for i, deconv in enumerate(self.deconvs):
            h = deconv(h)
            if i < len(self.deconvs) - 1:
                h = swish(h)
        return h[:, 0, : self.out_hw[0], : self.out_hw[1]]
