"""Host-planned epochs of the grain backend (port of ``mmvae_tpu/data/grain_pipeline.py``).

An epoch is planned once in vectorized numpy (:func:`epoch_plan`: the
example order, truncated to whole batches, and the presence-dropout mask)
and each batch, or a segment of batches, is one gather a modality
(:func:`gather_batches`). The plan is ``np.random.default_rng``'s, so its
batches and masks equal the JAX package's to the bit.

The JAX package wraps a batch-granular source in ``grain.MapDataset``;
the port imports nothing beyond numpy and torch, and
:func:`make_grain_loader` returns the source itself, a sized iterable
over the same per-index batches (element ``i`` is batch ``i % steps`` of
epoch ``i // steps``, planned with the seed ``seed + epoch``).

A modality stored as bf16 (``data_dtype``) is a host tensor (numpy has no
bf16) and is gathered by torch's indexing; every other one is a numpy
array.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

from mmvae_torch.data.pipelines import Dataset

__all__ = [
    "epoch_plan",
    "gather_batches",
    "make_grain_loader",
    "GrainEpochIterator",
]


def epoch_plan(
    n: int,
    batch_size: int,
    seed: int,
    *,
    n_modalities: int = 0,
    p_drop: float = 0.0,
    shuffle: bool = True,
) -> tuple[np.ndarray, np.ndarray | None]:
    """One epoch's ``(perm, presence)``: ``perm`` the example order
    truncated to whole batches, ``presence`` the ``(S*B, M)`` float32
    modality-dropout mask, or None when ``p_drop == 0``. A row whose every
    modality was dropped gets ONE of them back, drawn at random (unlike the
    step's own dropout and :func:`~mmvae_torch.data.sample_presence`, which
    give all of them back). Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n) if shuffle else np.arange(n)
    steps = n // batch_size
    if steps == 0:
        raise ValueError(
            f"grain epoch yields no batches: dataset size {n} < batch_size {batch_size}")
    perm = perm[: steps * batch_size]
    presence = None
    if p_drop > 0.0:
        if n_modalities <= 0:
            raise ValueError("p_drop > 0 requires n_modalities")
        keep = rng.random((len(perm), n_modalities)) >= p_drop
        dead = ~keep.any(axis=1)
        if dead.any():
            rows = np.flatnonzero(dead)
            keep[rows, rng.integers(0, n_modalities, size=len(rows))] = True
        presence = keep.astype(np.float32)
    return perm, presence


def _take(v, idx: np.ndarray):
    return v[torch.from_numpy(idx)] if torch.is_tensor(v) else np.asarray(v)[idx]


def gather_batches(
    arrays: dict[str, Any],
    perm: np.ndarray,
    presence: np.ndarray | None,
    batch_size: int,
) -> dict[str, Any]:
    """``(S, B, ...)`` stacked batches of the rows ``perm``, one gather a
    modality, with the ``presence`` rows beside them when given."""
    steps = len(perm) // batch_size
    out = {k: _take(v, perm).reshape(steps, batch_size, *v.shape[1:]) for k, v in arrays.items()}
    if presence is not None:
        presence = presence[: steps * batch_size]
        out["presence"] = presence.reshape(steps, batch_size, presence.shape[-1])
    return out


class _BatchSource:
    """Random-access batch-granular source: element ``i`` is batch ``i %
    steps`` of epoch ``i // steps``, each epoch planned by
    :func:`epoch_plan` with the seed ``seed + epoch``; one epoch's plan is
    kept at a time."""

    def __init__(
        self,
        arrays: dict[str, Any],
        batch_size: int,
        *,
        names: list[str],
        p_drop: float,
        shuffle: bool,
        seed: int,
        num_epochs: int,
    ):
        self._arrays = arrays
        self._n = len(next(iter(arrays.values())))
        self._batch = batch_size
        self._steps = self._n // batch_size
        if self._steps == 0:
            raise ValueError(
                f"grain loader yielded no batches: train_size {self._n} < batch_size "
                f"{batch_size}")
        self._names = names
        self._p_drop = p_drop
        self._shuffle = shuffle
        self._seed = seed
        self._epochs = num_epochs
        self._plan_cache: tuple[int, Any] | None = None

    def __len__(self) -> int:
        return self._steps * self._epochs

    def _plan(self, epoch: int):
        if self._plan_cache is None or self._plan_cache[0] != epoch:
            self._plan_cache = (epoch, epoch_plan(
                self._n, self._batch, self._seed + epoch, n_modalities=len(self._names),
                p_drop=self._p_drop, shuffle=self._shuffle))
        return self._plan_cache[1]

    def __getitem__(self, i: int) -> dict[str, Any]:
        if not 0 <= i < len(self):
            raise IndexError(i)
        epoch, s = divmod(i, self._steps)
        perm, presence = self._plan(epoch)
        sl = slice(s * self._batch, (s + 1) * self._batch)
        batch = {k: _take(v, perm[sl]) for k, v in self._arrays.items()}
        if presence is not None:
            batch["presence"] = presence[sl]
        return batch

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return (self[i] for i in range(len(self)))


def make_grain_loader(
    dataset: Dataset | dict[str, Any],
    batch_size: int,
    *,
    modality_names: list[str] | None = None,
    p_modality_drop: float = 0.0,
    shuffle: bool = True,
    seed: int = 0,
    num_epochs: int | None = 1,
) -> _BatchSource:
    """A sized iterable of batch dicts ``{modality: (B, ...), ["presence":
    (B, M)]}`` over ``num_epochs`` epochs (the JAX loader's elements, each
    a pure function of ``seed`` and its index)."""
    arrays = dataset.arrays if isinstance(dataset, Dataset) else dataset
    arrays = {k: v if torch.is_tensor(v) else np.asarray(v) for k, v in arrays.items()}
    return _BatchSource(
        arrays, batch_size, names=modality_names or sorted(arrays), p_drop=p_modality_drop,
        shuffle=shuffle, seed=seed, num_epochs=num_epochs if num_epochs is not None else 1)


class GrainEpochIterator:
    """:func:`make_grain_loader`'s batches as an iterable (the JAX
    package's adapter to its ``epoch_batches`` interface)."""

    def __init__(self, *args, **kwargs):
        self._ds = make_grain_loader(*args, **kwargs)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return iter(self._ds)
