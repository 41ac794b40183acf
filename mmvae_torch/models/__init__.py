"""Model library: per-modality experts and the experiment MVAEs ported so far."""

from mmvae_torch.models.base import ModalitySpec, MVAEBase
from mmvae_torch.models.mnist import MnistMVAE

__all__ = ["MVAEBase", "ModalitySpec", "MnistMVAE"]
