"""Data: mounted datasets and their distribution formats, the seeded
generators, storage dtypes, eval batching, presence dropout and the
host-planned grain epochs (``data/grain_pipeline.py``)."""

from mmvae_torch.data.formats import cub_data_vocab
from mmvae_torch.data.pipelines import (
    Dataset,
    dataset_astype,
    load_dataset,
    quantize_uint8,
    sample_presence,
    stacked_epoch,
    stacked_epoch_padded,
)
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
    "dataset_astype",
    "quantize_uint8",
    "stacked_epoch",
    "stacked_epoch_padded",
    "sample_presence",
    "make_mnist",
    "make_fashionmnist",
    "make_multimnist",
    "make_celeba",
    "make_cub",
    "cub_vocab",
    "cub_data_vocab",
    "Vocab",
    "CELEBA_ATTRS",
]
