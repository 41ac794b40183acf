"""CelebA image + 18 binary attributes MVAE (port of ``mmvae_tpu/models/celeba.py``).

Conv encoder and transposed-conv decoder over 64x64 RGB images (NHWC, as
the JAX package keeps them); each of the 18 attributes is its own
Gaussian expert, so the PoE fuses up to 19 experts and the prior. The
attribute experts are one stacked bank each way
(``AttributeEncoderBank`` / ``AttributeDecoderBank``).

Modality order: ``image, attr_0 .. attr_17``. The batch carries the
attributes as one ``attrs`` key ``(B, 18)``, and the decode dict as one
``attrs`` key of logits. On the card the image encoder's first stage runs
in K4, the image BCE in K2 and the attribute BCE in K2 at rows of D = 1.
``space_to_depth=2`` folds 2x2 patches into the channels at the image
experts' input and output stages (the encoder's stage 0 a 2x2 ``Conv2d``
over 12 channels then, not K4), and ``upsample_mode="shuffle"`` swaps the
decoder's transposed convs for 2x2 convs and depth-to-space
(``mmvae_tpu/models/celeba.py:43-73``).
"""

from __future__ import annotations

import torch

from mmvae_torch import ops
from mmvae_torch.models.base import ModalitySpec, MVAEBase
from mmvae_torch.models.experts import (
    AttributeDecoderBank,
    AttributeEncoderBank,
    ConvEncoder,
    DeconvDecoder,
)

__all__ = ["CelebAMVAE", "N_ATTRS"]

N_ATTRS = 18


class CelebAMVAE(MVAEBase):
    def __init__(
        self,
        n_latents: int = 100,
        n_attrs: int = N_ATTRS,
        image_hw: tuple[int, int] = (64, 64),
        lambda_image: float = 1.0,
        lambda_attr: float = 10.0,
        conv_features: tuple[int, ...] = (32, 64, 128, 256),
        space_to_depth: int = 1,
        upsample_mode: str = "deconv",
        dtype: torch.dtype = torch.float32,
        tp_mesh=None,
    ):
        super().__init__()
        self.n_latents = n_latents
        self.n_attrs = n_attrs
        self.image_hw = tuple(image_hw)
        self.lambda_image = lambda_image
        self.lambda_attr = lambda_attr
        self.dtype = dtype
        self.tp_mesh = tp_mesh
        kw = dict(dtype=dtype, tp_mesh=tp_mesh)
        self.image_enc = ConvEncoder(
            n_latents, self.image_hw, conv_features, space_to_depth=space_to_depth, channels=3,
            **kw
        )
        self.image_dec = DeconvDecoder(
            n_latents, self.image_hw, features=tuple(reversed(conv_features)),
            upsample_mode=upsample_mode, channels=3, space_to_depth=space_to_depth, **kw
        )
        self.attr_enc = AttributeEncoderBank(n_latents, n_attrs, **kw)
        self.attr_dec = AttributeDecoderBank(n_latents, n_attrs, **kw)
        self._register_lambdas()

    def specs(self):
        return (ModalitySpec("image", "bernoulli", self.lambda_image),) + tuple(
            ModalitySpec(f"attr_{i}", "bernoulli", self.lambda_attr)
            for i in range(self.n_attrs)
        )

    def encode(self, batch):
        mu_i, lv_i = self.image_enc(batch["image"])  # (B, L)
        mu_a, lv_a = self.attr_enc(batch["attrs"])  # (B, 18, L)
        mu = torch.cat([mu_i[:, None], mu_a], dim=1)  # (B, 19, L)
        logvar = torch.cat([lv_i[:, None], lv_a], dim=1)
        return mu, logvar

    def decode(self, z, batch=None):
        return {"image": self.image_dec(z), "attrs": self.attr_dec(z)}

    def nll_all(self, recons, batch):
        return torch.cat(
            [self.nll_one(k, recons[k], batch) for k in ("image", "attrs")]
        )  # (19, N)

    def decode_key_modalities(self):
        return {"image": [0], "attrs": list(range(1, 1 + self.n_attrs))}

    def decode_one(self, key, z, batch=None):
        if key == "image":
            return self.image_dec(z)
        if key == "attrs":
            return self.attr_dec(z)
        raise KeyError(key)

    def nll_one(self, key, recon, batch, fold="b"):
        if key == "image":
            return ops.bernoulli_nll(
                recon, batch["image"], event_ndims=3, fold=fold
            )[None]
        if key == "attrs":
            # (N, 18) per-attribute NLLs -> 18 modality rows.
            return ops.bernoulli_nll(
                recon, batch["attrs"], event_ndims=0, fold=fold
            ).T
        raise KeyError(key)

    def dummy_batch(self, n):
        return {
            "image": torch.zeros((n, *self.image_hw, 3), device=self.device),
            "attrs": torch.zeros((n, self.n_attrs), device=self.device),
        }

    def decode_kinds(self):
        return {"image": "bernoulli", "attrs": "bernoulli"}

    def batch_modalities(self):
        return {
            "image": ["image"],
            "attrs": [f"attr_{i}" for i in range(self.n_attrs)],
        }
