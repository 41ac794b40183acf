"""Per-modality encoder/decoder experts (port of ``mmvae_tpu/models/experts.py:40-484``).

Encoders return ``(mu, logvar)``; decoders return logits. Each expert's
dense part is a stack of ``nn.Linear`` layers with swish activations
(``layers``) and a last ``head``; ``mmvae_torch.convert`` maps Flax's
``Dense_{i}`` onto them in order, and ``Conv_{i}`` / ``ConvTranspose_{i}``
onto ``convs.{i}`` / ``deconvs.{i}``. Encoder heads are ONE ``Linear`` to
``2 * n_latents`` that is split ``[:L]`` / ``[L:]``, as in the JAX experts.

The conv experts take and give images in the JAX package's layout:
grayscale ``(B, H, W)`` or, with ``channels > 1``, NHWC ``(B, H, W, C)``;
inside, the convolutions run NCHW. The attribute banks keep their
parameters stacked along a leading attribute axis in the Flax layout and
contract them with ``einsum``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmvae_torch import ops
from mmvae_torch.ops.kernels import same_pad

__all__ = [
    "swish",
    "MLPEncoder",
    "MLPDecoder",
    "LabelEncoder",
    "LabelDecoder",
    "ConvEncoder",
    "DeconvDecoder",
    "AttributeEncoderBank",
    "AttributeDecoderBank",
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


def _promote(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x`` in the type both ``x`` and ``weight`` promote to, as Flax's
    ``promote_dtype`` meets a bf16 batch with f32 parameters: f32 (a bf16
    value is exact in f32)."""
    return x.to(torch.promote_types(x.dtype, weight.dtype))


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
        h = _run(self.layers, _promote(x.reshape(x.shape[0], -1), self.head.weight))
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


def _conv_out(d: int, n_stages: int) -> int:
    for _ in range(n_stages):
        d = -(-d // 2)
    return d


class ConvEncoder(nn.Module):
    """Strided-conv image encoder -> ``(mu, logvar)``.

    Each stage is a 4x4 stride-2 SAME conv and a swish, halving the
    spatial dims (rounding up); then a ``fc_hidden`` dense layer and the
    head. Only the reference-shaped stack is ported: ``space_to_depth=1``
    and no bottleneck trunk. With ``channels > 1`` the input is NHWC and
    stage 0 runs in ``ops.conv4x4s2_swish`` (K4 on the card), which reads
    the batch as it is (a bf16 batch too, into f32 outputs) and gives
    NCHW; a grayscale stage 0 stays a ``Conv2d``, its input promoted to
    the weights' type.
    """

    def __init__(
        self,
        n_latents: int,
        image_hw: tuple[int, int],
        features: Sequence[int] = (32, 64),
        fc_hidden: int = 512,
        space_to_depth: int = 1,
        channels: int = 1,
    ):
        super().__init__()
        if space_to_depth != 1:
            raise _not_ported(f"space_to_depth={space_to_depth}")
        self.n_latents = n_latents
        self.channels = channels
        widths = (channels, *features)
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, 4, stride=2) for a, b in zip(widths[:-1], widths[1:])
        )
        out_h, out_w = (_conv_out(d, len(features)) for d in image_hw)
        self.layers = _hidden_layers(out_h * out_w * features[-1], (fc_hidden,))
        self.head = nn.Linear(fc_hidden, 2 * n_latents)

    def forward(self, x: torch.Tensor):
        convs = list(self.convs)
        if self.channels == 1:
            h = _promote(x[:, None], convs[0].weight)  # NCHW
        else:
            stage0 = convs.pop(0)
            h = ops.conv4x4s2_swish(x, stage0.weight, stage0.bias)  # NCHW
        for conv in convs:
            h = swish(conv(F.pad(h, same_pad(h.shape[-2:]))))
        h = h.permute(0, 2, 3, 1).flatten(1)  # Flax flattens NHWC
        return _split_head(self.head(_run(self.layers, h)), self.n_latents)


class DeconvDecoder(nn.Module):
    """Transposed-conv image decoder: latent -> per-pixel logits.

    Mirror of :class:`ConvEncoder`: ``layers.0`` (Flax ``Dense_0``, to
    ``fc_hidden``) and ``head`` (``Dense_1``, to the bottleneck grid of
    ``ceil(out_hw / 2**stages)`` by ``features[0]``), each with a swish;
    then 4x4 stride-2 transposed convs, swish between them, and a last one
    to ``channels``. The grid overshoots a non-power-of-two target (50x50
    from 4x4 -> 64x64) and the TOP-LEFT ``out_hw`` is kept, as in the JAX
    decoder. Logits are ``(B, H, W)`` for one channel, else NHWC ``(B, H,
    W, channels)``. Only the reference-shaped ``upsample_mode="deconv"``
    stack is ported. Flax's ``ConvTranspose`` does not flip its kernel, so
    ``convert`` flips it into ``deconvs.{i}.weight``.
    """

    def __init__(
        self,
        n_latents: int,
        out_hw: tuple[int, int],
        features: Sequence[int] = (64, 32),
        fc_hidden: int = 512,
        upsample_mode: str = "deconv",
        channels: int = 1,
    ):
        super().__init__()
        if upsample_mode != "deconv":
            raise _not_ported(f"upsample_mode={upsample_mode!r}")
        self.out_hw = tuple(out_hw)
        self.channels = channels
        self.features = tuple(features)
        n_stages = len(self.features)
        self.base_hw = tuple(-(-d // 2**n_stages) for d in self.out_hw)
        self.layers = _hidden_layers(n_latents, (fc_hidden,))
        self.head = nn.Linear(fc_hidden, math.prod(self.base_hw) * self.features[0])
        widths = (*self.features, channels)
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
        h = h[:, :, : self.out_hw[0], : self.out_hw[1]]
        return h[:, 0] if self.channels == 1 else h.permute(0, 2, 3, 1)


class AttributeEncoderBank(nn.Module):
    """All binary-attribute experts as one stacked bank: attribute ``a``'s
    value selects a row of ``embed[a]``, then a swish hidden layer and a
    head, each one ``einsum`` over the stack.

    ``(B, A)`` attributes in {0, 1} -> ``(mu, logvar)``, each ``(B, A, L)``.
    Parameters as in Flax: ``embed`` ``(A, 2, E)``, ``w1`` ``(A, E, H)``,
    ``b1`` ``(A, H)``, ``w2`` ``(A, H, 2L)``, ``b2`` ``(A, 2L)``.
    """

    def __init__(
        self, n_latents: int, n_attrs: int = 18, embed_dim: int = 32, hidden: int = 64
    ):
        super().__init__()
        self.n_latents = n_latents
        self.embed = nn.Parameter(torch.empty(n_attrs, 2, embed_dim))
        self.w1 = nn.Parameter(torch.empty(n_attrs, embed_dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(n_attrs, hidden))
        self.w2 = nn.Parameter(torch.empty(n_attrs, hidden, 2 * n_latents))
        self.b2 = nn.Parameter(torch.zeros(n_attrs, 2 * n_latents))

    def forward(self, attrs: torch.Tensor):
        a = attrs.to(torch.float32)[..., None]  # (B, A, 1)
        h = self.embed[None, :, 0] * (1.0 - a) + self.embed[None, :, 1] * a
        h = swish(torch.einsum("bae,aeh->bah", h, self.w1) + self.b1)
        out = torch.einsum("bah,aho->bao", h, self.w2) + self.b2
        return out[..., : self.n_latents], out[..., self.n_latents :]


class AttributeDecoderBank(nn.Module):
    """Latent -> ``(B, A)`` per-attribute Bernoulli logits, one stacked
    bank: ``w1`` ``(A, L, H)``, ``b1`` ``(A, H)``, ``w2`` ``(A, H)``,
    ``b2`` ``(A,)``."""

    def __init__(self, n_latents: int, n_attrs: int = 18, hidden: int = 64):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(n_attrs, n_latents, hidden))
        self.b1 = nn.Parameter(torch.zeros(n_attrs, hidden))
        self.w2 = nn.Parameter(torch.empty(n_attrs, hidden))
        self.b2 = nn.Parameter(torch.zeros(n_attrs))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = swish(torch.einsum("bl,alh->bah", z, self.w1) + self.b1)
        return torch.einsum("bah,ah->ba", h, self.w2) + self.b2
