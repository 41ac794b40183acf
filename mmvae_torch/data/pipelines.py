"""Datasets and eval batching (port of ``mmvae_tpu/data/pipelines.py``).

A :class:`Dataset` holds host numpy arrays; the entry points move the
stacked split to the device once. Only the seeded numpy generators are
ported. Where the JAX loader would read something else -- mounted data
under ``$MMVAE_DATA_DIR`` or the C++ generators of ``MMVAE_DATAGEN=native``
-- :func:`load_dataset` raises rather than score other data.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from mmvae_torch.data import synthetic

__all__ = ["Dataset", "load_dataset", "stacked_epoch_padded"]

_GENERATORS = {
    "mnist": synthetic.make_mnist,
    "fashionmnist": synthetic.make_fashionmnist,
    "multimnist": synthetic.make_multimnist,
    "celeba": synthetic.make_celeba,
    "cub": synthetic.make_cub,
}
# Datasets the JAX loader draws from its C++ generators under
# MMVAE_DATAGEN=native (not bit-identical to the numpy ones).
_NATIVE = ("multimnist", "celeba")
# Train and test are disjoint draws; the same seeds as the JAX package.
SPLIT_SEEDS = {"train": 0, "test": 1_000_003}
SPLIT_SIZES = {"train": 10000, "test": 2000}


class Dataset(NamedTuple):
    """A modality dict of host arrays, and its number of examples."""

    arrays: dict[str, np.ndarray]
    size: int


def load_dataset(
    name: str,
    split: str = "train",
    n: int | None = None,
    seed: int | None = None,
) -> Dataset:
    """The seeded synthetic split ``split`` of dataset ``name``.

    ``seed`` overrides the split's seed; ``n`` its size. Raises
    ``NotImplementedError`` where the JAX loader would not run its numpy
    generator: ``$MMVAE_DATA_DIR/<name>/<split>.npz`` exists, or
    ``$MMVAE_DATA_DIR/<name>/`` is a directory (the distribution formats),
    or ``MMVAE_DATAGEN=native`` selects the C++ generator of ``name``.
    """
    if name not in _GENERATORS:
        raise ValueError(f"unknown dataset {name!r}; have {list(_GENERATORS)}")
    if split not in SPLIT_SEEDS:
        raise ValueError(f"unknown split {split!r}; have {list(SPLIT_SEEDS)}")
    data_dir = os.environ.get("MMVAE_DATA_DIR", "")
    if data_dir and (os.path.exists(os.path.join(data_dir, name, f"{split}.npz"))
                     or os.path.isdir(os.path.join(data_dir, name))):
        raise NotImplementedError(
            f"mounted data for {name!r} under MMVAE_DATA_DIR={data_dir!r} is not "
            "yet ported to mmvae_torch (it would read the numpy generator instead)"
        )
    if os.environ.get("MMVAE_DATAGEN") == "native" and name in _NATIVE:
        raise NotImplementedError(
            f"MMVAE_DATAGEN=native for {name!r} is not yet ported to mmvae_torch"
        )
    arrays = _GENERATORS[name](
        n or SPLIT_SIZES[split],
        seed=SPLIT_SEEDS[split] if seed is None else seed,
    )
    return Dataset(arrays=arrays, size=len(next(iter(arrays.values()))))


def stacked_epoch_padded(
    dataset: Dataset, batch_size: int
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """The whole split stacked to ``(ceil(size / bs), bs, ...)``.

    The last batch is padded by wrapping to the front of the split, and a
    ``(n_steps, bs)`` float validity mask marks the real rows. Eval feeds
    the mask in as an all-modalities presence mask, so pad rows contribute
    exactly zero to every ELBO term, and the split mean is
    ``sum(batch means) * bs / size``.
    """
    size = dataset.size
    n_steps = -(-size // batch_size)
    total = n_steps * batch_size
    idx = (np.arange(total) % size).reshape(n_steps, batch_size)
    valid = (np.arange(total) < size).astype(np.float32)
    out = {k: np.asarray(v)[idx] for k, v in dataset.arrays.items()}
    return out, valid.reshape(n_steps, batch_size)
