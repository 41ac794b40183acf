"""Per-modality negative log-likelihoods (port of ``mmvae_tpu/core/likelihoods.py``).

Every function returns the per-example NLL of shape ``batch_shape`` (the
leading dims minus the event dims). These are the plain PyTorch versions;
``mmvae_torch.ops`` routes the BCE through the hand-written CUDA kernel.
"""

from __future__ import annotations

import torch

__all__ = ["bernoulli_nll", "categorical_nll", "gaussian_nll"]

_LOG_2PI = 1.8378770664093453  # log(2*pi)


def _sum_event(t: torch.Tensor, event_ndims: int) -> torch.Tensor:
    # ``sum(dim=())`` would reduce every dim: event_ndims=0 sums nothing.
    return torch.sum(t, dim=tuple(range(-event_ndims, 0))) if event_ndims else t


def bernoulli_nll(
    logits: torch.Tensor, x: torch.Tensor, event_ndims: int = 1
) -> torch.Tensor:
    """Sum of BCE-with-logits over the trailing ``event_ndims`` dims.

    Stable form ``max(l, 0) - l * x + log1p(exp(-|l|))``; targets may be
    soft (in [0, 1]).
    """
    x = x.to(logits.dtype)
    per_elem = (
        torch.clamp_min(logits, 0.0)
        - logits * x
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    return _sum_event(per_elem, event_ndims)


def categorical_nll(
    logits: torch.Tensor, labels: torch.Tensor, event_ndims: int = 0
) -> torch.Tensor:
    """Cross-entropy of integer ``labels`` under ``logits``.

    The class axis is the last axis of ``logits``; ``event_ndims`` counts
    the extra event dims of ``labels`` to sum over (0 for one label, 1 for
    a token sequence).
    """
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _sum_event(nll, event_ndims)


def gaussian_nll(
    mean: torch.Tensor,
    x: torch.Tensor,
    logvar: torch.Tensor | float = 0.0,
    event_ndims: int = 1,
) -> torch.Tensor:
    """Diagonal-Gaussian NLL summed over the trailing ``event_ndims`` dims."""
    logvar = torch.as_tensor(logvar, dtype=mean.dtype, device=mean.device)
    per_elem = 0.5 * (_LOG_2PI + logvar + (x - mean) ** 2 * torch.exp(-logvar))
    return _sum_event(per_elem, event_ndims)
