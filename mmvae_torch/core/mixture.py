"""Mixture-family posterior fusion (port of ``mmvae_tpu/core/mixture.py``).

The four objectives differ only in their fusion rule:

  * ``"mvae"`` / ``"mvtcae"``: the product of the observed experts and the
    prior (MVTCAE's inference posterior is the PoE; its cross-KLs are a
    training-time distillation);
  * ``"mmvae"`` (Shi et al. 2019): the uniform mixture of the unimodal
    posteriors;
  * ``"mopoe"`` (Sutter et al. 2021): the uniform mixture of the PoE of
    every nonempty modality subset, or of ``{joint} + {unimodal}`` past
    ``_MOPOE_POWERSET_MAX`` modalities.

Each mixture component's mask is multiplied by the observed-modality
presence (``c AND O``): that maps the powerset onto the powerset of the
observed set with a constant multiplicity, so the uniform mixture over the
nonempty effective rows is the uniform mixture over the observed subsets,
at fixed shapes for any presence. The components' posteriors, and the
PoE of mvae and mvtcae (one all-ones term), come from one ``ops.poe_kl``
call (its KL unused), so the card runs the fused kernel.
"""

from __future__ import annotations

import torch

from mmvae_torch import ops
from mmvae_torch.core.sampling import reparameterize

__all__ = [
    "OBJECTIVES",
    "component_masks",
    "posterior_components",
    "mixture_z",
    "fuse_observed_z",
]

OBJECTIVES = ("mvae", "mmvae", "mopoe", "mvtcae")

# Past this many modalities the 2^M - 1 subsets are too many components
# (CelebA's 19 modalities give 524,287); MoPoE's mixture then falls back to
# the {joint} + {unimodal} family, as its training objective does.
_MOPOE_POWERSET_MAX = 8


def component_masks(
    objective: str, n_modalities: int, device: torch.device | str | None = None
) -> torch.Tensor:
    """The mixture's component masks, ``(K, M)`` float32 on ``device``.

    ``"mmvae"``: the identity. ``"mopoe"``: every nonempty subset in bit
    order (row ``r`` holds modality ``m`` when bit ``m`` of ``r + 1`` is
    set, so the singleton of ``m`` is row ``2**m - 1``) for ``M <= 8``,
    else the joint row and the identity. ``"mvae"`` and ``"mvtcae"`` have
    no mixture and raise ``ValueError``. The rows are made on the device
    (no host upload), so a captured step may make them.
    """
    m = n_modalities
    if objective == "mmvae":
        return torch.eye(m, device=device)
    if objective == "mopoe":
        if m <= _MOPOE_POWERSET_MAX:
            bits = torch.arange(1, 2**m, device=device)
            return ((bits[:, None] >> torch.arange(m, device=device)) & 1).to(torch.float32)
        return torch.cat([torch.ones((1, m), device=device), torch.eye(m, device=device)])
    raise ValueError(f"objective {objective!r} has no mixture components")


def posterior_components(
    mu_e: torch.Tensor,
    lv_e: torch.Tensor,
    presence: torch.Tensor | None,
    comp_masks: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each mixture component fused against the observed set.

    ``mu_e``, ``lv_e``: ``(B, M, L)`` expert stack; ``presence``: ``(B,
    M)`` or None (all observed); ``comp_masks``: ``(K, M)``. Returns
    ``(mu_c, lv_c, weights)``: ``(B, K, L)`` component posteriors (a
    component with no observed expert is the prior) and a ``(B, K)`` 0/1
    float validity weight, 1 where the component holds an observed expert.
    """
    mu_c, lv_c, _ = ops.poe_kl(mu_e, lv_e, comp_masks, presence)  # (K, B, L)
    eff = comp_masks[None]  # (1, K, M)
    if presence is not None:
        eff = eff * presence[:, None].to(eff.dtype)  # (B, K, M)
    weights = (eff.sum(-1) > 0).to(torch.float32).expand(mu_e.shape[0], -1)
    return mu_c.transpose(0, 1), lv_c.transpose(0, 1), weights


def mixture_z(
    mu_c: torch.Tensor,
    lv_c: torch.Tensor,
    weights: torch.Tensor,
    *,
    sample: bool = True,
    generator: torch.Generator | None = None,
    component: torch.Tensor | None = None,
    eps: torch.Tensor | None = None,
    uniform: torch.Tensor | None = None,
) -> torch.Tensor:
    """A draw from, or the mean of, each example's Gaussian mixture, ``(B, L)``.

    ``sample=False``: the weight-averaged component means (the total weight
    clamped at 1, so a row with no valid component gives 0, the prior's
    mean). ``sample=True``: a component drawn uniformly over the valid
    ones, then reparameterized. ``component`` ``(B,)`` and ``eps`` ``(B,
    L)`` pass the index and the noise in (JAX draws them from the two
    halves of its key); otherwise both come from ``generator``, or the
    index from ``uniform`` ``(B,)`` in [0, 1) when given. A row with no
    valid component takes component 0, as ``jax.random.categorical`` over
    all ``-inf`` does; its posterior is the prior.
    """
    if not sample:
        total = torch.clamp(weights.sum(-1, keepdim=True), min=1.0)
        return (mu_c * weights[..., None]).sum(-2) / total
    if component is None:
        # The k-th valid component, k uniform in [0, n_valid): the count of
        # running totals at or below k.
        n_valid = weights.sum(-1)
        u = uniform
        if u is None:
            u = torch.rand(n_valid.shape, generator=generator, device=weights.device)
        k = torch.minimum(torch.floor(u * n_valid), torch.clamp(n_valid - 1, min=0))
        idx = (weights.cumsum(-1) <= k[:, None]).sum(-1)
        component = torch.where(n_valid > 0, idx, torch.zeros_like(idx))
    take = component.to(torch.int64)[:, None, None].expand(-1, 1, mu_c.shape[-1])
    mu = mu_c.gather(-2, take)[:, 0]
    lv = lv_c.gather(-2, take)[:, 0]
    return reparameterize(mu, lv, sample=True, generator=generator, eps=eps)


def fuse_observed_z(
    mu_e: torch.Tensor,
    lv_e: torch.Tensor,
    presence: torch.Tensor | None,
    objective: str = "mvae",
    *,
    sample: bool = True,
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
    component: torch.Tensor | None = None,
    uniform: torch.Tensor | None = None,
) -> torch.Tensor:
    """Posterior draw (or mean) from the observed experts, ``(B, L)``.

    ``"mvae"`` / ``"mvtcae"``: PoE of the observed experts plus the prior
    (``ops.poe_kl`` under one all-ones term), then reparameterize
    (``component`` and ``uniform`` unused). ``"mmvae"`` / ``"mopoe"``: the
    objective's mixture over the observed set (:func:`mixture_z`, which
    takes ``component``, ``eps`` and ``uniform``).
    """
    if objective in ("mvae", "mvtcae"):
        ones = mu_e.new_ones((1, mu_e.shape[-2]))
        mu_f, lv_f, _ = ops.poe_kl(mu_e, lv_e, ones, presence)
        return reparameterize(
            mu_f[0], lv_f[0], sample=sample, generator=generator, eps=eps
        )
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    comp = component_masks(objective, mu_e.shape[-2], device=mu_e.device)
    mu_c, lv_c, weights = posterior_components(mu_e, lv_e, presence, comp)
    return mixture_z(
        mu_c, lv_c, weights, sample=sample, generator=generator,
        component=component, eps=eps, uniform=uniform,
    )
