"""Core math: PoE fusion, sampling, likelihoods, ELBO, subset masks, KL annealing,
the mixture objectives' posteriors, IWAE."""

from mmvae_torch.core.annealing import annealing_factor
from mmvae_torch.core.elbo import elbo_terms, kl_gauss_gauss, kl_std_normal
from mmvae_torch.core.likelihoods import (
    bernoulli_nll,
    categorical_nll,
    gaussian_nll,
)
from mmvae_torch.core.poe import product_of_experts
from mmvae_torch.core.sampling import reparameterize
from mmvae_torch.core.subsets import elbo_subset_masks, random_subset_masks

# Last: iwae and mixture reach the ops layer, which imports the modules above.
from mmvae_torch.core.iwae import iwae_bound  # noqa: E402
from mmvae_torch.core.mixture import (  # noqa: E402
    OBJECTIVES,
    component_masks,
    fuse_observed_z,
    mixture_z,
    posterior_components,
)

__all__ = [
    "annealing_factor",
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
    "component_masks",
    "posterior_components",
    "mixture_z",
    "fuse_observed_z",
    "iwae_bound",
]
