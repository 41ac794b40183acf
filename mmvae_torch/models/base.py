"""Generic MVAE container: named modality experts + PoE fusion.

Port of ``mmvae_tpu/models/base.py``. Encoders run once per modality and
give a fixed-shape ``(batch, n_modalities, n_latents)`` expert stack;
``infer`` fuses any observed subset (a float presence mask) with the prior
by product of experts, and ``forward`` decodes EVERY modality, which is
what makes cross-modal generation free.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, NamedTuple

import torch
from torch import nn

from mmvae_torch.core import product_of_experts, reparameterize
from mmvae_torch.models.experts import AttributeDecoderBank, AttributeEncoderBank
from mmvae_torch.models.text import GRUExpert

__all__ = ["ModalitySpec", "MVAEBase"]


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # Flax's truncated lecun-normal rescales by the std of a unit normal
    # truncated to [-2, 2].
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def _flax_fan_in(w: torch.Tensor) -> int:
    """Flax's fan-in of a parameter kept in the Flax layout (contracting
    dim second to last, outputs last): ``shape[-2]`` times the product of
    the leading dims, i.e. ``numel / shape[-1]``. A stacked bank ``(A, E,
    H)`` has fan-in ``A * E``; a 2-D ``(A, H)`` one has ``A``."""
    return w.numel() // w.shape[-1]


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
    ``decode_key_modalities`` / ``decode_one`` / ``nll_one``; a model
    whose batch key carries several modalities overrides
    ``batch_modalities``.

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

    def batch_modalities(self) -> dict[str, list[str]]:
        """Batch key -> the modality names it carries, in column order
        (CelebA's ``attrs`` carries ``attr_0 .. attr_17``)."""
        return {s.name: [s.name] for s in self.specs()}

    def decode_key_modalities(self) -> dict[str, list[int]] | None:
        """Decode-dict key -> the modality indices it covers, or None when
        the model has no per-key decode."""
        return None

    def decode_one(self, key: str, z: torch.Tensor, batch: dict[str, Any] | None = None):
        """Decode ONLY ``key`` (the value ``decode(z, batch)[key]`` holds).

        ``batch`` carries the targets a teacher-forced decoder reads (the
        sequence modalities), with as many rows as ``z``."""
        raise NotImplementedError

    def nll_one(self, key: str, recon, batch: dict[str, Any], fold: str = "b"):
        """NLL rows of the modalities ``key`` covers, ``(M_k, N)``."""
        raise NotImplementedError

    @property
    def n_modalities(self) -> int:
        return len(self.specs())

    @contextlib.contextmanager
    def at_dtype(self, dtype: torch.dtype | None) -> Iterator[MVAEBase]:
        """Within the block, ``dtype`` (None: the model's own) is the compute
        dtype of the model and of every expert, as the model classes'
        ``dtype=`` gives it (the parameters stay as they are); on exit each
        takes back its own."""
        held = [(m, m.dtype) for m in self.modules() if "dtype" in vars(m)]
        if dtype is not None:
            for m, _ in held:
                m.dtype = dtype
        try:
            yield self
        finally:
            for m, own in held:
                m.dtype = own

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
        """Seeded init with Flax's default distributions: lecun-normal
        (truncated at two standard deviations) for Dense and Conv kernels,
        the GRU input projection, the attribute banks' weights and the
        residual trunks' kernels (Flax's fan-in of stacked parameters:
        ``S * depth * W`` for a trunk), zero trunk gates, orthogonal GRU recurrent weights,
        zero biases; ``nn.Embed`` tables N(0, 1/features) (Flax's
        ``variance_scaling(1, "fan_in", "normal", out_axis=0)``), the
        attribute embedding N(0, 0.02^2). ``generator`` lives on the
        parameters' device."""
        from mmvae_torch.models.pipeline import PipelineTrunk  # it imports this module

        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # Flax's fan-in is kh * kw * input channels: dim 1 of a
                # Conv2d weight (out, in, kh, kw), dim 0 of a
                # ConvTranspose2d weight (in, out, kh, kw).
                fan_in = m.weight[0].numel() if isinstance(m, nn.Conv2d) else (
                    m.weight.shape[0] * m.weight[0, 0].numel()
                )
                _lecun_normal_(m.weight, fan_in, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=m.embedding_dim**-0.5, generator=generator)
            elif isinstance(m, (AttributeEncoderBank, AttributeDecoderBank)):
                if isinstance(m, AttributeEncoderBank):
                    nn.init.normal_(m.embed, std=0.02, generator=generator)
                for w in (m.w1, m.w2):
                    _lecun_normal_(w, _flax_fan_in(w), generator)
                nn.init.zeros_(m.b1)
                nn.init.zeros_(m.b2)
            elif isinstance(m, PipelineTrunk):
                # Flax's fan-in of (S, depth, W, W) is S * depth * W.
                _lecun_normal_(m.kernels, _flax_fan_in(m.kernels), generator)
                nn.init.zeros_(m.biases)
                if m.alphas is not None:
                    nn.init.zeros_(m.alphas)
            elif isinstance(m, GRUExpert):
                _lecun_normal_(m.w_in, _flax_fan_in(m.w_in), generator)
                nn.init.orthogonal_(m.u_rec, generator=generator)
                nn.init.zeros_(m.b)

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
