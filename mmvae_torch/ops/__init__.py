"""Hot-path reductions: CUDA kernels on the card, plain PyTorch elsewhere.

Port of ``mmvae_tpu/ops/__init__.py``. Backend selection:
``set_backend("kernel" | "torch" | "auto")``. ``"auto"`` (the default)
runs the hand-written kernel for CUDA tensors and the plain version for
CPU tensors; ``"kernel"`` raises on a CPU tensor; ``"torch"`` runs the
plain version everywhere (the on-card reference the kernels are held
against). The kernels have no backward yet: the kernel path raises
when grad mode is on and an input requires grad.

Term-tiled targets: ``bernoulli_nll``, ``categorical_nll`` and
``masked_seq_ce`` accept targets with fewer leading rows than the logits,
``k`` terms of one batch folded into the rows in the order ``fold`` names
(``"b"``: row ``b * k + t``, as the JAX ops layer assumes; ``"t"``: row
``t * B + b``, the eval t-fold). The BCE kernel reads the untiled targets
through its row map; the tiled copy is made only on the plain path. The
integer label and token rows are small, so they are tiled on both paths.

``conv4x4s2_swish`` is the first stage of the RGB image encoder (K4 on
the card): it takes the NHWC batch as it is and gives NCHW.

``poe_kl`` fuses the encoders' expert stack under the subset masks and
gives each term's posterior and its KL to the prior in one kernel (K1's
function as the PoE's epilogue); ``kl_std_normal`` stays K1 alone.
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
    "masked_seq_ce",
    "conv4x4s2_swish",
    "poe_kl",
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


def _use_kernel(op: str, t: torch.Tensor, *more: torch.Tensor) -> bool:
    """Whether ``op`` takes its kernel for inputs ``t, *more``.

    The kernels have no backward yet, so the kernel path raises where
    autograd would record the op: grad mode on and an input that requires
    grad. It never falls back to the plain path."""
    if _backend == "torch" or (_backend == "auto" and not t.is_cuda):
        return False
    if torch.is_grad_enabled() and any(x.requires_grad for x in (t, *more)):
        raise RuntimeError(
            f"ops.{op}: the kernel's backward is not yet ported to mmvae_torch; "
            "call it under torch.no_grad() or with set_backend('torch')"
        )
    if not t.is_cuda:
        raise ValueError(
            f"ops backend 'kernel' needs CUDA tensors, got one on {t.device}"
        )
    return True


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
    if not _use_kernel("kl_std_normal", mu, logvar):
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
    the order ``fold`` names (see the module docstring). Under ``"t"`` the
    tiling of dim 0 is a tiling of the flattened rows too, so any batch
    dims work, ``event_ndims=0`` included (the CelebA attributes: rows of
    D = 1). Under ``"b"`` the tiled targets need exactly one batch dim.
    """
    mode = _fold(logits.shape[0], x.shape[0], fold)
    batch_shape = logits.shape[: logits.dim() - event_ndims]
    if mode != kernels.FOLD_NONE and x.shape[1:] != logits.shape[1:]:
        raise ValueError(
            f"targets {tuple(x.shape)} are not a row tiling of logits "
            f"{tuple(logits.shape)}"
        )
    if mode == kernels.FOLD_B and len(batch_shape) != 1:
        raise ValueError(
            f"b-major tiled targets need one batch dim; logits "
            f"{tuple(logits.shape)} at event_ndims={event_ndims} have "
            f"{len(batch_shape)} (not yet ported to mmvae_torch)"
        )
    if not _use_kernel("bernoulli_nll", logits, x):
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


def masked_seq_ce(
    logits: torch.Tensor,
    tokens: torch.Tensor,
    pad_token: int = 0,
    fold: str = "b",
) -> torch.Tensor:
    """Token cross-entropy summed over the non-pad positions.

    ``logits``: ``(..., S, V)``; ``tokens``: ``(..., S)`` int -> ``(...,)``
    NLL, the sequence decoders' recon reduction (K3 on the card).
    Term-tiled logits rows are matched by tiling the token rows in the
    order ``fold`` names.
    """
    mode = _fold(logits.shape[0], tokens.shape[0], fold)
    tokens = kernels.tile_rows(tokens, logits.shape[0], mode)
    if not _use_kernel("masked_seq_ce", logits):
        return kernels.masked_seq_ce_torch(logits, tokens, pad_token)
    s, v = logits.shape[-2:]
    rows = logits.reshape(-1, s, v).to(torch.float32).contiguous()
    out = kernels.masked_seq_ce_kernel(rows, tokens.reshape(-1, s).contiguous(), pad_token)
    return out.reshape(logits.shape[:-2])


def conv4x4s2_swish(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """``swish(conv(x, weight, SAME, stride 2) + bias)``: ``x`` ``(B, H, W,
    C)`` NHWC, ``weight`` ``(F, C, 4, 4)`` OIHW -> ``(B, F, ceil(H/2),
    ceil(W/2))`` NCHW. The kernel takes C <= 4 and F = 32."""
    if not _use_kernel("conv4x4s2_swish", x, weight, bias):
        return kernels.conv4x4s2_swish_torch(x, weight, bias)
    return kernels.conv4x4s2_swish_kernel(x.contiguous(), weight.contiguous(), bias.contiguous())


def poe_kl(
    mu_e: torch.Tensor,
    lv_e: torch.Tensor,
    masks: torch.Tensor,
    presence: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked product of experts per subset term, with the unit-Gaussian
    prior and eps 1e-8, and each fused posterior's KL to N(0, I).

    ``mu_e``, ``lv_e``: ``(B, M, L)`` expert stack; ``masks``: ``(T, M)``
    subset masks; ``presence``: optional ``(B, M)`` float mask of the
    observed modalities. Returns ``(mu_f, lv_f, kl)``: ``(T, B, L)``,
    ``(T, B, L)`` and ``(T, B)``. A row with no expert present gives the
    prior and a KL of exactly 0."""
    more = (lv_e, masks) if presence is None else (lv_e, masks, presence)
    if not _use_kernel("poe_kl", mu_e, *more):
        return kernels.poe_kl_torch(mu_e, lv_e, masks, presence)

    def f32(t):
        return t.to(torch.float32).contiguous()

    return kernels.poe_kl_kernel(
        f32(mu_e), f32(lv_e), f32(masks), None if presence is None else f32(presence)
    )
