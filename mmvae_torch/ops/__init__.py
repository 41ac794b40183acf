"""Hot-path reductions: CUDA kernels on the card, plain PyTorch elsewhere.

Port of ``mmvae_tpu/ops/__init__.py``. Backend selection:
``set_backend("kernel" | "torch" | "auto")``. ``"auto"`` (the default)
runs the hand-written kernel for CUDA tensors and the plain version for
CPU tensors; ``"kernel"`` raises on a CPU tensor; ``"torch"`` runs the
plain version everywhere (the on-card reference the kernels are held
against).

Term-tiled targets: ``bernoulli_nll`` and ``categorical_nll`` accept
targets with fewer leading rows than the logits, ``k`` terms of one batch
folded into the rows in the order ``fold`` names (``"b"``: row
``b * k + t``, as the JAX ops layer assumes; ``"t"``: row ``t * B + b``,
the eval t-fold). The BCE kernel reads the untiled targets through its
row map; the tiled copy is made only on the plain path.
``masked_seq_ce`` (K3) is not ported yet.
"""

from __future__ import annotations

import math

import torch

from mmvae_torch.core.elbo import kl_std_normal as _kl_torch
from mmvae_torch.core.likelihoods import bernoulli_nll as _bern_torch
from mmvae_torch.core.likelihoods import categorical_nll as _cat_torch
from mmvae_torch.ops import kernels

__all__ = [
    "kl_std_normal",
    "bernoulli_nll",
    "categorical_nll",
    "set_backend",
    "get_backend",
]

_BACKENDS = ("kernel", "torch", "auto")
_FOLDS = {"t": kernels.FOLD_T, "b": kernels.FOLD_B}
_backend = "auto"


def set_backend(name: str) -> None:
    """Select the backend of every op: ``"kernel"``, ``"torch"`` or ``"auto"``."""
    global _backend
    if name not in _BACKENDS:
        raise ValueError(f"unknown ops backend {name!r}; have {_BACKENDS}")
    _backend = name


def get_backend() -> str:
    return _backend


def _use_kernel(t: torch.Tensor) -> bool:
    if _backend == "torch":
        return False
    if _backend == "kernel" and not t.is_cuda:
        raise ValueError(
            f"ops backend 'kernel' needs CUDA tensors, got one on {t.device}"
        )
    return t.is_cuda


def _rows(t: torch.Tensor, d: int) -> torch.Tensor:
    return t.reshape(-1, d).to(torch.float32).contiguous()


def _fold(rows: int, n_targets: int, fold: str) -> int:
    if rows == n_targets:
        return kernels.FOLD_NONE
    if fold not in _FOLDS:
        raise ValueError(f"unknown fold {fold!r}; have {list(_FOLDS)}")
    return _FOLDS[fold]


def kl_std_normal(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, e^logvar) || N(0, I)) summed over the last dim."""
    if not _use_kernel(mu):
        return _kl_torch(mu, logvar)
    d = mu.shape[-1]
    out = kernels.kl_std_normal_kernel(_rows(mu, d), _rows(logvar, d))
    return out.reshape(mu.shape[:-1])


def bernoulli_nll(
    logits: torch.Tensor,
    x: torch.Tensor,
    event_ndims: int = 1,
    fold: str = "b",
) -> torch.Tensor:
    """Summed BCE-with-logits over the trailing ``event_ndims`` dims.

    ``x`` may carry ``1/k`` of the logits' leading rows: a term tiling in
    the order ``fold`` names (see the module docstring). Tiled targets
    need exactly one batch dim.
    """
    mode = _fold(logits.shape[0], x.shape[0], fold)
    batch_shape = logits.shape[: logits.dim() - event_ndims]
    if mode != kernels.FOLD_NONE and (
        len(batch_shape) != 1 or x.shape[1:] != logits.shape[1:]
    ):
        raise ValueError(
            f"targets {tuple(x.shape)} are not a row tiling of logits "
            f"{tuple(logits.shape)} with one batch dim"
        )
    if not _use_kernel(logits):
        x = kernels.tile_rows(x, logits.shape[0], mode)
        return _bern_torch(logits, x, event_ndims)
    d = math.prod(logits.shape[logits.dim() - event_ndims:])
    out = kernels.bernoulli_nll_kernel(_rows(logits, d), _rows(x, d), mode)
    return out.reshape(batch_shape)


def categorical_nll(
    logits: torch.Tensor,
    labels: torch.Tensor,
    event_ndims: int = 0,
    fold: str = "b",
) -> torch.Tensor:
    """Cross-entropy of integer labels; term-tiled logits rows are matched
    by tiling the (small, integer) label rows in the order ``fold`` names."""
    mode = _fold(logits.shape[0], labels.shape[0], fold)
    labels = kernels.tile_rows(labels, logits.shape[0], mode)
    return _cat_torch(logits, labels, event_ndims)
