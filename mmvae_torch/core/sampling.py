"""Reparameterized Gaussian sampling (port of ``mmvae_tpu/core/sampling.py``)."""

from __future__ import annotations

import torch

__all__ = ["reparameterize"]


def reparameterize(
    mu: torch.Tensor,
    logvar: torch.Tensor,
    *,
    sample: bool,
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
) -> torch.Tensor:
    """``z = mu + eps * exp(0.5 * logvar)`` when sampling, else ``mu``.

    ``eps`` supplies the standard-normal noise from outside (tests feed the
    JAX and PyTorch sides the same numbers); otherwise it is drawn from
    ``generator``, which must live on ``mu``'s device.
    """
    if not sample:
        return mu
    if eps is None:
        eps = torch.randn(
            mu.shape, generator=generator, device=mu.device, dtype=mu.dtype
        )
    return mu + eps * torch.exp(0.5 * logvar)
