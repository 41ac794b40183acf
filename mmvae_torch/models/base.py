"""Generic MVAE container: named modality experts + PoE fusion.

Port of ``mmvae_tpu/models/base.py``. Encoders run once per modality and
give a fixed-shape ``(batch, n_modalities, n_latents)`` expert stack;
``infer`` fuses any observed subset (a float presence mask) with the prior
by product of experts, and ``forward`` decodes EVERY modality, which is
what makes cross-modal generation free.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from mmvae_torch.core import product_of_experts, reparameterize

__all__ = ["ModalitySpec", "MVAEBase"]


class ModalitySpec(NamedTuple):
    """One modality (one PoE expert): its name, likelihood family
    (``"bernoulli"``, ``"categorical"``, ``"seq"``) and recon weight."""

    name: str
    kind: str
    lam: float = 1.0


class MVAEBase(nn.Module):
    """Base class of the experiment MVAEs.

    Subclasses define their experts and implement ``specs``, ``encode``
    (``batch -> (mu, logvar)``, each ``(B, M, L)``), ``decode``
    (``z -> {name: recon params}``), ``nll_all`` (``-> (M, N)``),
    ``dummy_batch`` and, for member-pruned decoding, the per-key trio
    ``decode_key_modalities`` / ``decode_one`` / ``nll_one``.

    ``fold`` in ``nll_one``: when the recon rows are a term tiling of the
    batch, the order of that tiling (see ``mmvae_torch.ops``); the targets
    are passed untiled.
    """

    def specs(self) -> tuple[ModalitySpec, ...]:
        raise NotImplementedError

    def encode(self, batch: dict[str, Any]):
        raise NotImplementedError

    def decode(self, z: torch.Tensor, batch: dict[str, Any] | None = None):
        raise NotImplementedError

    def nll_all(self, recons: dict[str, Any], batch: dict[str, Any]):
        raise NotImplementedError

    def dummy_batch(self, n: int) -> dict[str, torch.Tensor]:
        """Zero-filled batch of the right shapes and dtypes, on the model's
        device (for shape probing and absent modalities in generation)."""
        raise NotImplementedError

    def decode_kinds(self) -> dict[str, str]:
        """Decode-dict key -> likelihood kind, for postprocessing outputs."""
        return {s.name: s.kind for s in self.specs()}

    def decode_key_modalities(self) -> dict[str, list[int]] | None:
        """Decode-dict key -> the modality indices it covers, or None when
        the model has no per-key decode."""
        return None

    def decode_one(self, key: str, z: torch.Tensor, batch: dict[str, Any] | None = None):
        """Decode ONLY ``key`` (the value ``decode(z, batch)[key]`` holds)."""
        raise NotImplementedError

    def nll_one(self, key: str, recon, batch: dict[str, Any], fold: str = "b"):
        """NLL rows of the modalities ``key`` covers, ``(M_k, N)``."""
        raise NotImplementedError

    @property
    def n_modalities(self) -> int:
        return len(self.specs())

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _register_lambdas(self) -> None:
        """Keep the recon weights as a (non-persistent) buffer, so they
        move with the model: a tensor made from a list on each call would
        be a pageable host-to-device copy, which waits for the stream."""
        self.register_buffer(
            "_lambdas",
            torch.tensor([s.lam for s in self.specs()], dtype=torch.float32),
            persistent=False,
        )

    def lambdas(self) -> torch.Tensor:
        """``(M,)`` per-modality recon weights on the model's device."""
        return self._lambdas

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with Flax's default distributions for Dense layers:
        lecun-normal weights (truncated at two standard deviations) and
        zero biases; embeddings N(0, 1). ``generator`` lives on the
        parameters' device."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                # Flax's truncated lecun-normal rescales by the std of a
                # unit normal truncated to [-2, 2].
                std = (1.0 / m.in_features) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(
                    m.weight, std=std, a=-2 * std, b=2 * std,
                    generator=generator,
                )
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, generator=generator)

    def infer(self, batch: dict[str, Any], presence: torch.Tensor | None = None):
        """Fused ``(mu, logvar)`` of the observed subset and the prior, each
        ``(B, n_latents)``; ``presence`` is an optional ``(B, M)`` float
        mask (None: all observed)."""
        mu, logvar = self.encode(batch)
        return product_of_experts(mu, logvar, mask=presence)

    def forward(
        self,
        batch: dict[str, Any],
        presence: torch.Tensor | None = None,
        *,
        sample: bool = True,
        generator: torch.Generator | None = None,
        eps: torch.Tensor | None = None,
    ):
        """infer -> reparameterize -> decode ALL modalities.

        Returns ``(recons, mu, logvar)``.
        """
        mu, logvar = self.infer(batch, presence)
        z = reparameterize(mu, logvar, sample=sample, generator=generator, eps=eps)
        return self.decode(z, batch), mu, logvar
