"""Multi-term MVAE ELBO (port of ``mmvae_tpu/core/elbo.py``).

Per modality subset S (one ELBO "term"):

    L_S = sum_{m in S} lambda_m * NLL_m(dec_m(z_S), x_m)
          + beta * KL(q(z|S) || N(0, I))

and the loss is ``sum_S L_S`` meaned over the batch. The subset structure
arrives as a float ``(n_terms, n_modalities)`` mask matrix.
"""

from __future__ import annotations

import torch

__all__ = ["kl_std_normal", "kl_gauss_gauss", "elbo_terms"]


def kl_std_normal(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, diag exp(logvar)) || N(0, I)), summed over the last dim.

    ``-0.5 * sum(1 + logvar - mu^2 - exp(logvar))``, shape ``mu.shape[:-1]``.
    ``mmvae_torch.ops.kl_std_normal`` routes it through the CUDA kernel.
    """
    return -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar), dim=-1)


def kl_gauss_gauss(
    mu1: torch.Tensor,
    logvar1: torch.Tensor,
    mu2: torch.Tensor,
    logvar2: torch.Tensor,
) -> torch.Tensor:
    """KL(N(mu1, diag e^lv1) || N(mu2, diag e^lv2)), summed over the last dim."""
    return 0.5 * torch.sum(
        logvar2
        - logvar1
        + (torch.exp(logvar1) + (mu1 - mu2) ** 2) / torch.exp(logvar2)
        - 1.0,
        dim=-1,
    )


def elbo_terms(
    nll: torch.Tensor,
    kl: torch.Tensor,
    subset_masks: torch.Tensor,
    lambdas: torch.Tensor,
    beta: float,
    term_weights: torch.Tensor | None = None,
):
    """Combine per-term reconstruction NLLs and KLs into the total loss.

    Args:
      nll: ``(n_terms, n_modalities, batch)`` per-example recon NLLs.
      kl: ``(n_terms, batch)`` per-term KL to the prior.
      subset_masks: ``(n_terms, n_modalities)`` float masks; recon term
        (t, m) counts only when modality m is in subset t.
      lambdas: ``(n_modalities,)`` per-modality recon weights.
      beta: KL annealing factor.
      term_weights: optional ``(n_terms, batch)`` weights on each term.

    Returns:
      ``(loss, metrics)``: the batch-mean total loss (scalar) and the
      per-term batch means ``recon_per_term``, ``kl_per_term`` and
      ``elbo_per_term`` (each ``(n_terms,)``).
    """
    weights = subset_masks * lambdas[None, :]  # (T, M)
    recon_per_term = torch.einsum("tm,tmb->tb", weights, nll)  # (T, B)
    per_term = recon_per_term + beta * kl  # (T, B)
    if term_weights is not None:
        per_term = per_term * term_weights
    loss = torch.mean(torch.sum(per_term, dim=0))
    metrics = {
        "loss": loss,
        "recon_per_term": torch.mean(recon_per_term, dim=-1),
        "kl_per_term": torch.mean(kl, dim=-1),
        "elbo_per_term": torch.mean(per_term, dim=-1),
    }
    return loss, metrics
