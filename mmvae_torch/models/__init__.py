"""Model library: per-modality experts and the experiment MVAEs ported so far."""

from mmvae_torch.models.base import ModalitySpec, MVAEBase
from mmvae_torch.models.celeba import CelebAMVAE
from mmvae_torch.models.cub import CubMVAE
from mmvae_torch.models.fashionmnist import FashionMnistMVAE
from mmvae_torch.models.mnist import MnistMVAE
from mmvae_torch.models.multimnist import MultiMnistMVAE

__all__ = [
    "MVAEBase",
    "ModalitySpec",
    "CelebAMVAE",
    "CubMVAE",
    "FashionMnistMVAE",
    "MnistMVAE",
    "MultiMnistMVAE",
]
