"""Data: the seeded synthetic generators and eval batching."""

from mmvae_torch.data.pipelines import Dataset, load_dataset, stacked_epoch_padded
from mmvae_torch.data.synthetic import (
    CELEBA_ATTRS,
    cub_vocab,
    make_celeba,
    make_cub,
    make_fashionmnist,
    make_mnist,
    make_multimnist,
)
from mmvae_torch.data.vocab import Vocab

__all__ = [
    "Dataset",
    "load_dataset",
    "stacked_epoch_padded",
    "make_mnist",
    "make_fashionmnist",
    "make_multimnist",
    "make_celeba",
    "make_cub",
    "cub_vocab",
    "Vocab",
    "CELEBA_ATTRS",
]
