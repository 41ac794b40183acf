"""CUB images + captions MVAE (port of ``mmvae_tpu/models/cub.py``).

Conv encoder and transposed-conv decoder over 64x64 RGB images (NHWC, as
the JAX package keeps them) and a word-level GRU caption encoder and
autoregressive decoder (embed 128, hidden 256, as in the JAX model), PoE
fusion. The vocabulary is ``mmvae_torch.data.vocab``'s (the synthetic
one: 23 ids). On the card the image encoder's first stage runs in K4, the
image BCE in K2 and the caption cross-entropy in K3. Only the
reference-shaped image stacks are ported (``upsample_mode="deconv"``).
"""

from __future__ import annotations

import torch

from mmvae_torch import ops
from mmvae_torch.models.base import ModalitySpec, MVAEBase
from mmvae_torch.models.experts import ConvEncoder, DeconvDecoder
from mmvae_torch.models.text import PAD, SeqDecoder, SeqEncoder

__all__ = ["CubMVAE", "TEXT_EMBED", "TEXT_HIDDEN"]

# The caption experts' widths, fixed in the JAX model.
TEXT_EMBED = 128
TEXT_HIDDEN = 256


class CubMVAE(MVAEBase):
    def __init__(
        self,
        n_latents: int = 128,
        vocab_size: int = 512,
        max_len: int = 32,
        image_hw: tuple[int, int] = (64, 64),
        lambda_image: float = 1.0,
        lambda_text: float = 5.0,
        conv_features: tuple[int, ...] = (32, 64, 128, 256),
    ):
        super().__init__()
        self.n_latents = n_latents
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.image_hw = tuple(image_hw)
        self.lambda_image = lambda_image
        self.lambda_text = lambda_text
        self.image_enc = ConvEncoder(n_latents, self.image_hw, conv_features, channels=3)
        self.image_dec = DeconvDecoder(
            n_latents, self.image_hw, features=tuple(reversed(conv_features)), channels=3
        )
        self.text_enc = SeqEncoder(n_latents, vocab_size, TEXT_EMBED, TEXT_HIDDEN)
        self.text_dec = SeqDecoder(n_latents, vocab_size, max_len, TEXT_EMBED, TEXT_HIDDEN)
        self._register_lambdas()

    def specs(self):
        return (
            ModalitySpec("image", "bernoulli", self.lambda_image),
            ModalitySpec("text", "seq", self.lambda_text),
        )

    def encode(self, batch):
        mu_i, lv_i = self.image_enc(batch["image"])
        mu_t, lv_t = self.text_enc(batch["text"])
        return torch.stack([mu_i, mu_t], dim=1), torch.stack([lv_i, lv_t], dim=1)

    def decode(self, z, batch=None):
        out = {"image": self.image_dec(z)}
        if batch is not None:
            out["text"] = self.text_dec(z, batch["text"])  # teacher-forced
        return out

    def generate_text(
        self,
        z: torch.Tensor,
        temperature: float | torch.Tensor = 1.0,
        generator: torch.Generator | None = None,
        rng=None,
    ) -> torch.Tensor:
        """Generated captions ``(B, max_len)``; see ``SeqDecoder.generate``."""
        return self.text_dec.generate(z, temperature, generator, rng)

    def nll_all(self, recons, batch):
        return torch.cat(
            [self.nll_one(k, recons[k], batch) for k in ("image", "text")]
        )  # (M=2, N)

    def decode_key_modalities(self):
        return {"image": [0], "text": [1]}

    def decode_one(self, key, z, batch=None):
        if key == "image":
            return self.image_dec(z)
        if key == "text":
            return self.text_dec(z, batch["text"])  # teacher-forced
        raise KeyError(key)

    def nll_one(self, key, recon, batch, fold="b"):
        if key == "image":
            return ops.bernoulli_nll(
                recon, batch["image"], event_ndims=3, fold=fold
            )[None]
        if key == "text":
            # Per-token CE summed over the non-PAD positions (STOP is
            # predicted).
            return ops.masked_seq_ce(recon, batch["text"], PAD, fold=fold)[None]
        raise KeyError(key)

    def dummy_batch(self, n):
        return {
            "image": torch.zeros((n, *self.image_hw, 3), device=self.device),
            "text": torch.zeros((n, self.max_len), dtype=torch.int64, device=self.device),
        }
