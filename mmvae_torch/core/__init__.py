"""Core math: PoE fusion, sampling, likelihoods, ELBO, subset masks."""

from mmvae_torch.core.elbo import elbo_terms, kl_gauss_gauss, kl_std_normal
from mmvae_torch.core.likelihoods import (
    bernoulli_nll,
    categorical_nll,
    gaussian_nll,
)
from mmvae_torch.core.mixture import OBJECTIVES, fuse_observed_z
from mmvae_torch.core.poe import product_of_experts
from mmvae_torch.core.sampling import reparameterize
from mmvae_torch.core.subsets import elbo_subset_masks, random_subset_masks

__all__ = [
    "product_of_experts",
    "reparameterize",
    "bernoulli_nll",
    "categorical_nll",
    "gaussian_nll",
    "kl_std_normal",
    "kl_gauss_gauss",
    "elbo_terms",
    "elbo_subset_masks",
    "random_subset_masks",
    "OBJECTIVES",
    "fuse_observed_z",
]
