"""Data: the seeded synthetic MNIST generator and eval batching."""

from mmvae_torch.data.pipelines import Dataset, load_dataset, stacked_epoch_padded
from mmvae_torch.data.synthetic import make_mnist

__all__ = ["Dataset", "load_dataset", "stacked_epoch_padded", "make_mnist"]
