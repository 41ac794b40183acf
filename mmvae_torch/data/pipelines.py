"""Datasets, storage dtypes and eval batching (port of ``mmvae_tpu/data/pipelines.py``).

:func:`load_dataset` reads what the JAX loader reads, in its order:

  1. ``$MMVAE_DATA_DIR/<name>/<split>.npz``, whose arrays are the
     modalities, as they are;
  2. else, where ``$MMVAE_DATA_DIR/<name>/`` is a directory, the dataset's
     distribution format (``data/formats.py``): MNIST's and
     FashionMNIST's IDX pairs, the MultiMNIST composite of real MNIST
     digits (from ``multimnist/`` or the sibling ``mnist/``), raw CelebA
     and raw CUB;
  3. else the seeded generators: numpy's (``data/synthetic.py``), or under
     ``MMVAE_DATAGEN=native`` the C++ ones for ``celeba`` and
     ``multimnist`` (``data/native.py``; a library that cannot be built
     raises, where the JAX loader falls back to numpy).

A :class:`Dataset` holds host arrays; the entry points move them to the
device. :func:`dataset_astype` stores the float modalities in bf16 or
quantized to uint8 (``data_dtype``); the step dequantizes in its graph
(``train/step.py::_dequant_data``). :func:`sample_presence` draws a
batch's modality-dropout mask.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from mmvae_torch.data import formats, synthetic

__all__ = ["Dataset", "load_dataset", "dataset_astype", "quantize_uint8", "DATA_DTYPES",
           "stacked_epoch", "stacked_epoch_padded", "sample_presence", "presence_from_keep"]

_GENERATORS = {
    "mnist": synthetic.make_mnist,
    "fashionmnist": synthetic.make_fashionmnist,
    "multimnist": synthetic.make_multimnist,
    "celeba": synthetic.make_celeba,
    "cub": synthetic.make_cub,
}
# Train and test are disjoint draws; the same seeds as the JAX package.
SPLIT_SEEDS = {"train": 0, "test": 1_000_003}
SPLIT_SIZES = {"train": 10000, "test": 2000}
# The storage dtypes of ``data_dtype`` for the float modalities.
DATA_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "uint8": torch.uint8}


class Dataset(NamedTuple):
    """A modality dict of host arrays, and its number of examples. A
    modality stored as bf16 (:func:`dataset_astype`) is a host tensor:
    numpy has no bf16."""

    arrays: dict[str, np.ndarray]
    size: int


def _mounted(name: str, split: str, n: int | None,
             gen_kwargs: dict[str, Any]) -> dict[str, np.ndarray] | None:
    """The mounted arrays of ``name``'s ``split`` under ``$MMVAE_DATA_DIR``:
    its ``.npz``, else its distribution format; None where neither is."""
    data_dir = os.environ.get("MMVAE_DATA_DIR", "")
    if not data_dir:
        return None
    d = os.path.join(data_dir, name)
    path = os.path.join(d, f"{split}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    if not os.path.isdir(d):
        return None
    if name in ("mnist", "fashionmnist"):
        return formats.load_mnist_idx(d, split)
    if name == "multimnist":
        # The generator's hw and max_digits apply to the composite.
        return formats.load_multimnist_composite(data_dir, split, n=n, **gen_kwargs)
    if name == "celeba":
        return formats.load_celeba_raw(d, split, n=n)
    return formats.load_cub_raw(d, split, n=n)


def _generator(name: str):
    """``name``'s generator: numpy's, or the C++ one under
    ``MMVAE_DATAGEN=native`` where there is one."""
    if os.environ.get("MMVAE_DATAGEN") == "native" and name in ("celeba", "multimnist"):
        from mmvae_torch.data import native

        return native.make_celeba_native if name == "celeba" else native.make_multimnist_native
    return _GENERATORS[name]


def load_dataset(
    name: str,
    split: str = "train",
    n: int | None = None,
    seed: int | None = None,
    gen_kwargs: dict[str, Any] | None = None,
) -> Dataset:
    """Split ``split`` of dataset ``name``: the mounted data (module
    docstring), else the seeded generator's.

    ``n`` cuts the split to its first ``n`` examples, mounted or generated
    (a generator makes only those). ``seed`` overrides a generator's split
    seed. ``gen_kwargs`` go to the generators (``hw=128``) and to the
    MultiMNIST composite (``hw``, ``max_digits``); other mounted data is
    returned as it is.
    """
    if name not in _GENERATORS:
        raise ValueError(f"unknown dataset {name!r}; have {list(_GENERATORS)}")
    if split not in SPLIT_SEEDS:
        raise ValueError(f"unknown split {split!r}; have {list(SPLIT_SEEDS)}")
    gen_kwargs = dict(gen_kwargs or {})
    arrays = _mounted(name, split, n, gen_kwargs)
    if arrays is None:
        arrays = _generator(name)(
            n or SPLIT_SIZES[split], seed=SPLIT_SEEDS[split] if seed is None else seed,
            **gen_kwargs)
    if n is not None:
        arrays = {k: v[:n] for k, v in arrays.items()}
    return Dataset(arrays=arrays, size=len(next(iter(arrays.values()))))


def quantize_uint8(v: np.ndarray) -> np.ndarray:
    """``round(clip(v, 0, 1) * 255)`` as uint8, computed in v's float type
    (float32 for the datasets), rounding half to even: the JAX quantizer's
    numpy branch. A uint8 leaf of a batch means quantized [0, 1] data (the
    step divides it by 255), so integer modalities never pass here."""
    return np.round(np.clip(v, 0.0, 1.0) * 255.0).astype(np.uint8)


def dataset_astype(dataset: Dataset, dtype: str | torch.dtype) -> Dataset:
    """``dataset`` with its float32 modalities stored as ``dtype``: bf16
    (half the bytes, round to nearest even) or uint8 (:func:`quantize_uint8`,
    a quarter; exact for 8-bit image data and 0/1 labels); float32 leaves
    it as it is. Integer modalities (labels, tokens) stay int32. One cast
    at load time."""
    dtype = DATA_DTYPES[dtype] if isinstance(dtype, str) else dtype
    if dtype == torch.float32:
        return dataset
    if dtype == torch.uint8:
        cast = quantize_uint8
    elif dtype == torch.bfloat16:
        # numpy has no bf16: the cast is torch's, kept as a host tensor.
        def cast(v):
            return torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
    else:
        raise ValueError(f"unknown data dtype {dtype}; have {list(DATA_DTYPES)}")
    return Dataset(
        arrays={k: cast(v) if v.dtype == np.float32 else v for k, v in dataset.arrays.items()},
        size=dataset.size,
    )


def stacked_epoch(
    dataset: Dataset, batch_size: int, rng: np.random.Generator | None = None
) -> dict[str, np.ndarray | torch.Tensor]:
    """One shuffled epoch stacked to ``(n_steps, batch, ...)`` (``stacked_epoch``,
    ``mmvae_tpu/data/pipelines.py:193-218``): the rows in the order of
    ``rng.permutation(size)`` (the loaded order without ``rng``), the
    remainder past ``n_steps * batch`` dropped. The epochs of a sharded
    (FSDP or tensor-parallel) run, as JAX's mesh epochs."""
    order = rng.permutation(dataset.size) if rng is not None else np.arange(dataset.size)
    n_steps = dataset.size // batch_size
    idx = order[: n_steps * batch_size].reshape(n_steps, batch_size)
    return {k: v[torch.from_numpy(idx)] if torch.is_tensor(v) else np.asarray(v)[idx]
            for k, v in dataset.arrays.items()}


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
    out = {k: v[torch.from_numpy(idx)] if torch.is_tensor(v) else np.asarray(v)[idx]
           for k, v in dataset.arrays.items()}
    return out, valid.reshape(n_steps, batch_size)


def presence_from_keep(keep: torch.Tensor) -> torch.Tensor:
    """Presence dropout's mask from a ``(B, M)`` keep draw: a row whose
    every modality was dropped keeps them all (``mmvae_tpu/train/step.py:1054-1057``)."""
    keep = keep.to(torch.bool)
    all_dropped = ~torch.any(keep, dim=-1, keepdim=True)
    return torch.where(all_dropped, True, keep).to(torch.float32)


def sample_presence(
    generator: torch.Generator | None,
    batch_size: int,
    n_modalities: int,
    p_drop: float = 0.0,
    *,
    keep: torch.Tensor | np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor | None:
    """Per-example modality-dropout mask ``(batch_size, n_modalities)``
    (``mmvae_tpu/data/pipelines.py:257-276``): each modality is kept with
    probability ``1 - p_drop``, drawn from ``generator`` on ``device`` (the
    generator's by default), or ``keep``, a boolean draw passed in (JAX's
    ``bernoulli``, for parity); an example that would lose every modality
    keeps them all. None when ``p_drop == 0``."""
    if p_drop <= 0.0:
        return None
    if keep is None:
        device = generator.device if device is None and generator is not None else device
        keep = torch.rand((batch_size, n_modalities), generator=generator, device=device)
        keep = keep < 1.0 - p_drop
    return presence_from_keep(torch.as_tensor(keep, device=device))
