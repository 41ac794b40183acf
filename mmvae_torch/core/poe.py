"""Product-of-experts Gaussian posterior fusion (port of ``mmvae_tpu/core/poe.py``).

Precision-weighted product of Gaussian experts with the unit-Gaussian
prior expert folded in analytically (T=1, mu=0), so any modality subset
-- the empty one included -- gives a valid posterior:

    T_i  = 1 / (var_i + eps)
    mu   = (sum_i mu_i * T_i) / (sum_i T_i)
    var  = 1 / (sum_i T_i)

Experts are a fixed-shape ``(..., n_experts, latent)`` tensor with a float
presence ``mask``: an absent expert contributes zero precision.
"""

from __future__ import annotations

import torch

__all__ = ["LOGVAR_BOUND", "PRECISION_EPS", "clamp_logvar", "product_of_experts"]

LOGVAR_BOUND = 11.0  # expert log-variances are clamped to +-this before inversion
PRECISION_EPS = 1e-8  # added to each expert's variance before inversion


def clamp_logvar(logvar: torch.Tensor) -> torch.Tensor:
    """``logvar`` clamped to [-LOGVAR_BOUND, LOGVAR_BOUND] as ``jnp.clip``
    clamps it in the JAX reference: a NaN stays NaN, and the gradient is 1
    inside the range, 0.5 at exactly the bound (``torch.clamp`` would pass
    1 there) and 0 beyond."""
    lo = logvar.new_full((), -LOGVAR_BOUND)
    hi = logvar.new_full((), LOGVAR_BOUND)
    return torch.minimum(torch.maximum(logvar, lo), hi)


def product_of_experts(
    mu: torch.Tensor,
    logvar: torch.Tensor,
    mask: torch.Tensor | None = None,
    eps: float = PRECISION_EPS,
    include_prior: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse Gaussian experts by precision-weighted product.

    Args:
      mu: ``(..., n_experts, latent)`` expert means (prior NOT included).
      logvar: same shape, expert log-variances; clamped to [-11, 11]
        before inversion by :func:`clamp_logvar`.
      mask: optional ``(..., n_experts)`` presence mask; an expert with
        mask 0 contributes nothing.
      eps: stabilizer added to variances before inversion.
      include_prior: fold in the unit-Gaussian prior expert.

    Returns:
      ``(mu_fused, logvar_fused)``, each of shape ``(..., latent)``.
    """
    precision = 1.0 / (torch.exp(clamp_logvar(logvar)) + eps)
    if mask is not None:
        precision = precision * mask.to(precision.dtype)[..., None]
    prior_t = 1.0 if include_prior else 0.0
    total_precision = prior_t + torch.sum(precision, dim=-2)
    mu_fused = torch.sum(mu * precision, dim=-2) / total_precision
    logvar_fused = -torch.log(total_precision)
    return mu_fused, logvar_fused
