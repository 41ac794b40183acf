"""Objective-aware posterior draw for generation (port of ``mmvae_tpu/core/mixture.py``).

Only the PoE objectives (``"mvae"``, ``"mvtcae"``) are ported; the mixture
objectives (``"mmvae"``, ``"mopoe"``) raise until their slice lands.
"""

from __future__ import annotations

import torch

from mmvae_torch.core.poe import product_of_experts
from mmvae_torch.core.sampling import reparameterize

__all__ = ["OBJECTIVES", "fuse_observed_z"]

OBJECTIVES = ("mvae", "mmvae", "mopoe", "mvtcae")


def fuse_observed_z(
    mu_e: torch.Tensor,
    lv_e: torch.Tensor,
    presence: torch.Tensor | None,
    objective: str = "mvae",
    *,
    sample: bool = True,
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
) -> torch.Tensor:
    """Posterior draw (or mean) from the observed experts, ``(B, L)``.

    ``"mvae"`` / ``"mvtcae"``: PoE of the observed experts plus the prior,
    then reparameterize (MVTCAE's inference posterior is the PoE).
    """
    if objective in ("mvae", "mvtcae"):
        mu, logvar = product_of_experts(mu_e, lv_e, mask=presence)
        return reparameterize(
            mu, logvar, sample=sample, generator=generator, eps=eps
        )
    if objective in OBJECTIVES:
        raise NotImplementedError(
            f"objective {objective!r} is not yet ported to mmvae_torch"
        )
    raise ValueError(f"unknown objective {objective!r}")
