"""MultiMNIST MVAE (port of ``mmvae_tpu/models/multimnist.py``).

Conv encoder over the 50x50 composite-digit canvas and an autoregressive
GRU decoder over the digit string (up to 4 digits, then STOP), PoE
fusion. Digit tokens: PAD=0, START=1, STOP=2, digit d -> 3+d. The NLLs go
through ``mmvae_torch.ops``, so on the card the image BCE runs in K2 and
the digit-string cross-entropy in K3.
"""

from __future__ import annotations

import torch

from mmvae_torch import ops
from mmvae_torch.models.base import ModalitySpec, MVAEBase
from mmvae_torch.models.experts import ConvEncoder, DeconvDecoder
from mmvae_torch.models.text import PAD, SeqDecoder, SeqEncoder

__all__ = ["MultiMnistMVAE", "DIGIT_VOCAB", "SEQ_LEN"]

DIGIT_VOCAB = 13  # PAD, START, STOP + 10 digits
MAX_DIGITS = 4
SEQ_LEN = MAX_DIGITS + 1  # digits + STOP


class MultiMnistMVAE(MVAEBase):
    """``text_latent_dims > 0`` lets the text expert claim only the first
    ``text_latent_dims`` latent dims: on the rest its mu is 0 and its
    logvar +11, which the PoE clamp turns into ~zero precision, so those
    dims stay at the prior under text-only conditioning."""

    def __init__(
        self,
        n_latents: int = 64,
        image_hw: tuple[int, int] = (50, 50),
        max_len: int = SEQ_LEN,
        lambda_image: float = 1.0,
        lambda_text: float = 10.0,
        conv_features: tuple[int, ...] = (32, 64),
        text_embed: int = 64,
        text_hidden: int = 128,
        text_latent_dims: int = 0,
        dtype: torch.dtype = torch.float32,
        tp_mesh=None,
    ):
        super().__init__()
        self.n_latents = n_latents
        self.image_hw = tuple(image_hw)
        self.max_len = max_len
        self.lambda_image = lambda_image
        self.lambda_text = lambda_text
        self.text_latent_dims = text_latent_dims
        self.dtype = dtype
        self.tp_mesh = tp_mesh
        kw = dict(dtype=dtype)
        self.image_enc = ConvEncoder(n_latents, self.image_hw, conv_features, tp_mesh=tp_mesh,
                                     **kw)
        self.image_dec = DeconvDecoder(
            n_latents, self.image_hw, features=tuple(reversed(conv_features)), tp_mesh=tp_mesh,
            **kw
        )
        self.text_enc = SeqEncoder(n_latents, DIGIT_VOCAB, text_embed, text_hidden, **kw)
        self.text_dec = SeqDecoder(
            n_latents, DIGIT_VOCAB, max_len, text_embed, text_hidden, **kw
        )
        self._register_lambdas()
        self.register_buffer(
            "_content", torch.arange(n_latents) < text_latent_dims, persistent=False
        )

    def specs(self):
        return (
            ModalitySpec("image", "bernoulli", self.lambda_image),
            ModalitySpec("text", "seq", self.lambda_text),
        )

    def encode(self, batch):
        mu_i, lv_i = self.image_enc(batch["image"])
        mu_t, lv_t = self.text_enc(batch["text"])
        if self.text_latent_dims > 0:
            mu_t = torch.where(self._content, mu_t, 0.0)
            lv_t = torch.where(self._content, lv_t, 11.0)
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
        """Generated digit strings ``(B, max_len)``; see ``SeqDecoder.generate``."""
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
                recon, batch["image"], event_ndims=2, fold=fold
            )[None]
        if key == "text":
            # Per-token CE summed over the non-PAD positions (STOP is
            # predicted).
            return ops.masked_seq_ce(recon, batch["text"], PAD, fold=fold)[None]
        raise KeyError(key)

    def dummy_batch(self, n):
        return {
            "image": torch.zeros((n,) + self.image_hw, device=self.device),
            "text": torch.zeros((n, self.max_len), dtype=torch.int64, device=self.device),
        }
