"""Modality-subset masks for the multi-term ELBO (port of ``mmvae_tpu/core/subsets.py``)."""

from __future__ import annotations

import torch

__all__ = ["elbo_subset_masks", "random_subset_masks"]


def elbo_subset_masks(
    n_modalities: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Masks of the deterministic ELBO terms, ``(1 + n_modalities, n_modalities)``.

    Row 0 is the joint term (all modalities), rows 1..M the unimodal terms.
    """
    joint = torch.ones((1, n_modalities), dtype=dtype, device=device)
    unimodal = torch.eye(n_modalities, dtype=dtype, device=device)
    return torch.cat([joint, unimodal], dim=0)


def random_subset_masks(
    generator: torch.Generator | None,
    n_subsets: int,
    n_modalities: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``k`` random modality-combination masks, ``(k, n_modalities)``.

    Each entry is Bernoulli(0.5), drawn from ``generator`` on ``device``
    (by default the generator's; with no generator, that device's default
    one). The empty subset is allowed: its posterior is the prior, its KL 0
    and all its recon terms masked out.
    """
    if device is None and generator is not None:
        device = generator.device
    u = torch.rand((n_subsets, n_modalities), generator=generator, device=device)
    return (u < 0.5).to(dtype)
