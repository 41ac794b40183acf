"""Data: the seeded synthetic generators and eval batching."""

from mmvae_torch.data.pipelines import Dataset, load_dataset, stacked_epoch_padded
from mmvae_torch.data.synthetic import (
    CELEBA_ATTRS,
    make_celeba,
    make_mnist,
    make_multimnist,
)

__all__ = [
    "Dataset",
    "load_dataset",
    "stacked_epoch_padded",
    "make_mnist",
    "make_multimnist",
    "make_celeba",
    "CELEBA_ATTRS",
]
