"""Model library: per-modality experts and the experiment MVAEs."""

from mmvae_torch.models.base import ModalitySpec, MVAEBase
from mmvae_torch.models.celeba import CelebAMVAE
from mmvae_torch.models.cub import CubMVAE
from mmvae_torch.models.fashionmnist import FashionMnistMVAE
from mmvae_torch.models.mnist import MnistMVAE
from mmvae_torch.models.multimnist import MultiMnistMVAE
from mmvae_torch.models.pipeline import DeepCubMVAE, DeepMnistMVAE, PipelineTrunk

__all__ = [
    "MVAEBase",
    "ModalitySpec",
    "CelebAMVAE",
    "CubMVAE",
    "DeepCubMVAE",
    "DeepMnistMVAE",
    "FashionMnistMVAE",
    "MnistMVAE",
    "MultiMnistMVAE",
    "PipelineTrunk",
]
