"""MNIST image+label MVAE (port of ``mmvae_tpu/models/mnist.py``).

MLP image expert over flat 784 pixels, label expert over 10 classes, PoE
fusion. Recon weights lambda_image = 1, lambda_label = 10. The NLLs go
through ``mmvae_torch.ops``, so on the card the image BCE runs in the
hand-written row-reduce kernel.
"""

from __future__ import annotations

import math

import torch

from mmvae_torch import ops
from mmvae_torch.models.base import ModalitySpec, MVAEBase
from mmvae_torch.models.experts import (
    LabelDecoder,
    LabelEncoder,
    MLPDecoder,
    MLPEncoder,
)

__all__ = ["MnistMVAE"]


class MnistMVAE(MVAEBase):
    def __init__(
        self,
        n_latents: int = 64,
        n_classes: int = 10,
        image_hw: tuple[int, int] = (28, 28),
        lambda_image: float = 1.0,
        lambda_label: float = 10.0,
    ):
        super().__init__()
        self.n_latents = n_latents
        self.image_hw = tuple(image_hw)
        self.lambda_image = lambda_image
        self.lambda_label = lambda_label
        self.image_enc = MLPEncoder(math.prod(self.image_hw), n_latents)
        self.image_dec = MLPDecoder(n_latents, self.image_hw)
        self.label_enc = LabelEncoder(n_latents, n_classes)
        self.label_dec = LabelDecoder(n_latents, n_classes)
        self._register_lambdas()

    def specs(self):
        return (
            ModalitySpec("image", "bernoulli", self.lambda_image),
            ModalitySpec("label", "categorical", self.lambda_label),
        )

    def encode(self, batch):
        mu_i, lv_i = self.image_enc(batch["image"])
        mu_l, lv_l = self.label_enc(batch["label"])
        mu = torch.stack([mu_i, mu_l], dim=1)  # (B, 2, L)
        logvar = torch.stack([lv_i, lv_l], dim=1)
        return mu, logvar

    def decode(self, z, batch=None):
        return {"image": self.image_dec(z), "label": self.label_dec(z)}

    def nll_all(self, recons, batch):
        return torch.cat(
            [self.nll_one(k, recons[k], batch) for k in ("image", "label")]
        )  # (M=2, N)

    def decode_key_modalities(self):
        return {"image": [0], "label": [1]}

    def decode_one(self, key, z, batch=None):
        if key == "image":
            return self.image_dec(z)
        if key == "label":
            return self.label_dec(z)
        raise KeyError(key)

    def nll_one(self, key, recon, batch, fold="b"):
        if key == "image":
            return ops.bernoulli_nll(
                recon, batch["image"], event_ndims=2, fold=fold
            )[None]
        if key == "label":
            return ops.categorical_nll(recon, batch["label"], fold=fold)[None]
        raise KeyError(key)

    def dummy_batch(self, n):
        return {
            "image": torch.zeros((n,) + self.image_hw, device=self.device),
            "label": torch.zeros((n,), dtype=torch.int64, device=self.device),
        }
