"""Hot-path reductions: CUDA kernels on the card, plain PyTorch elsewhere.

Port of ``mmvae_tpu/ops/__init__.py``. Backend selection:
``set_backend("kernel" | "torch" | "auto")``. ``"auto"`` (the default)
runs the hand-written kernel for CUDA tensors and the plain version for
CPU tensors; ``"kernel"`` raises on a CPU tensor; ``"torch"`` runs the
plain version everywhere (the on-card reference the kernels are held
against).

Gradients. ``kl_std_normal``, ``bernoulli_nll``, ``masked_seq_ce``,
``poe_kl`` and ``conv4x4s2_swish`` are ``torch.autograd.Function``s on
both paths: their backward runs the backward kernels where the forward
ran a kernel (``kl_rows_grad``, ``bce_rows_grad``, ``seq_ce_rows_grad``,
``poe_kl_bwd``, ``conv4x4s2_swish_bwd`` and ``conv4x4s2_swish_dx``) and
their plain versions where the forward ran the plain one, with the
analytic VJPs of the TPU kernels (``_kl_bwd``; ``_bce_bwd``: dlogits = g *
(sigmoid(l) - x); ``_seq_ce_bwd``: dlogits = g * (softmax(l) -
onehot(token)) on the non-pad tokens) and, for the conv, the gradient XLA
takes of stage 0 (dW, db and the image's dx from ``g * swish'(pre)``,
``pre`` recomputed; dx only where the image requires grad, as the cycle
term's re-encode of a render does). The targets of ``bernoulli_nll`` get
dx = -g * l on the plain path only; the kernel path raises when they
require grad. bf16 targets (a ``data_dtype="bfloat16"`` train split) reach
the BCE kernels and their VJP as they are; the kernels upcast them on load,
and the plain versions upcast them. The tokens of ``masked_seq_ce`` get no gradient.
bf16 logits, means and log-variances are read in f32 on both paths, as the
Pallas wrappers cast them outside their ``pallas_call``
(``mmvae_tpu/ops/kernels.py:145-146``, ``:175-177``, ``:246``): the values
are f32, and autograd hands each gradient back in its input's type.
``poe_kl`` differentiates the expert stack only and raises on both paths
when ``masks`` or ``presence`` requires grad.

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
from torch.autograd.function import once_differentiable

from mmvae_torch.core.elbo import kl_std_normal as _kl_torch
from mmvae_torch.core.likelihoods import bernoulli_nll as _bern_torch
from mmvae_torch.core.likelihoods import categorical_nll as _cat_torch
from mmvae_torch.ops import kernels
from mmvae_torch.ops.library import _f32  # the import registers the mmvae ops

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


def _records_grad(*ts: torch.Tensor | None) -> bool:
    """Whether autograd would record an op on ``ts``."""
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in ts)


def _kernel_path(t: torch.Tensor) -> bool:
    """Whether the backend rule sends an op on ``t`` to its kernel."""
    return _backend == "kernel" or (_backend == "auto" and t.is_cuda)


def _use_kernel(t: torch.Tensor) -> bool:
    """Whether an op on ``t`` takes its kernel: the backend rule, and on
    the kernel path ``t`` must be a CUDA tensor (it never falls back to the
    plain path)."""
    if not _kernel_path(t):
        return False
    if not t.is_cuda:
        raise ValueError(
            f"ops backend 'kernel' needs CUDA tensors, got one on {t.device}"
        )
    return True


def _rows(t: torch.Tensor, d: int) -> torch.Tensor:
    return t.reshape(-1, d).to(torch.float32).contiguous()


def _target_rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """BCE targets as the kernels read them: bf16 as it is (the kernels
    upcast it on load), any other type as f32."""
    return x.reshape(-1, d).contiguous() if x.dtype == torch.bfloat16 else _rows(x, d)


def _fold(rows: int, n_targets: int, fold: str) -> int:
    if rows == n_targets:
        return kernels.FOLD_NONE
    if fold not in _FOLDS:
        raise ValueError(f"unknown fold {fold!r}; have {list(_FOLDS)}")
    return _FOLDS[fold]


class _KlStdNormal(torch.autograd.Function):
    """K1 and its VJP (``_kl_bwd``); ``kernel`` picks the CUDA kernels."""

    @staticmethod
    def forward(ctx, mu, logvar, kernel: bool):
        ctx.kernel = kernel
        if not kernel:
            mu, logvar = mu.float(), logvar.float()
            ctx.save_for_backward(mu, logvar)
            return _kl_torch(mu, logvar)
        d = mu.shape[-1]
        mu_r, lv_r = _rows(mu, d), _rows(logvar, d)
        ctx.save_for_backward(mu_r, lv_r)
        ctx.shapes = (mu.shape, mu.dtype, logvar.dtype)
        return kernels.kl_std_normal_kernel(mu_r, lv_r).reshape(mu.shape[:-1])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mu, logvar = ctx.saved_tensors
        if not ctx.kernel:
            d_mu, d_lv = kernels.kl_rows_grad_torch(mu, logvar, g)
            return d_mu.sum_to_size(mu.shape), d_lv.sum_to_size(logvar.shape), None
        shape, mu_dtype, lv_dtype = ctx.shapes
        g = g.reshape(-1).to(torch.float32).contiguous()
        d_mu, d_lv = kernels.kl_rows_grad_kernel(mu, logvar, g)
        return d_mu.reshape(shape).to(mu_dtype), d_lv.reshape(shape).to(lv_dtype), None


def kl_std_normal(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, e^logvar) || N(0, I)) summed over the last dim."""
    kernel = _use_kernel(mu)
    return _KlStdNormal.apply(mu, logvar, kernel)


class _BernoulliNll(torch.autograd.Function):
    """K2 and its VJP (``_bce_bwd``): dlogits = g * (sigmoid(l) - x), and
    on the plain path dx = -g * l summed over the rows that read each
    target row. ``mode`` is the row map; ``kernel`` picks the kernels."""

    @staticmethod
    def forward(ctx, logits, x, event_ndims: int, mode: int, kernel: bool):
        ctx.kernel, ctx.mode, ctx.event_ndims = kernel, mode, event_ndims
        batch_shape = logits.shape[: logits.dim() - event_ndims]
        if not kernel:
            logits = logits.float()
            ctx.save_for_backward(logits, x)
            return _bern_torch(logits, kernels.tile_rows(x, logits.shape[0], mode), event_ndims)
        d = math.prod(logits.shape[logits.dim() - event_ndims:])
        l_rows, x_rows = _rows(logits, d), _target_rows(x, d)
        ctx.save_for_backward(l_rows, x_rows)
        ctx.shape, ctx.dtype = logits.shape, logits.dtype
        # b-major over examples of several rows: the rows an example holds.
        ctx.inner = math.prod(batch_shape[1:]) if mode == kernels.FOLD_B else 1
        return kernels.bernoulli_nll_kernel(l_rows, x_rows, mode, inner=ctx.inner).reshape(
            batch_shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        logits, x = ctx.saved_tensors
        if ctx.kernel:
            g = g.reshape(-1).to(torch.float32).contiguous()
            d_logits = kernels.bce_rows_grad_kernel(logits, x, g, ctx.mode, inner=ctx.inner)
            return d_logits.reshape(ctx.shape).to(ctx.dtype), None, None, None, None
        g = g.reshape(g.shape + (1,) * ctx.event_ndims)
        x_tiled = kernels.tile_rows(x, logits.shape[0], ctx.mode).to(logits.dtype)
        d_logits = g * (torch.sigmoid(logits) - x_tiled)
        d_x = None
        if ctx.needs_input_grad[1]:
            d_x = _untile_rows(-(g * logits), x.shape[0], ctx.mode).to(x.dtype)
        return d_logits, d_x, None, None, None


def _untile_rows(t: torch.Tensor, n_x: int, mode: int) -> torch.Tensor:
    """The transpose of ``kernels.tile_rows``: the rows of ``t`` that read
    each of ``n_x`` target rows, summed."""
    if mode == kernels.FOLD_NONE:
        return t
    k = t.shape[0] // n_x
    if mode == kernels.FOLD_T:
        return t.reshape((k, n_x) + t.shape[1:]).sum(0)
    return t.reshape((n_x, k) + t.shape[1:]).sum(1)


def bernoulli_nll(
    logits: torch.Tensor,
    x: torch.Tensor,
    event_ndims: int = 1,
    fold: str = "b",
) -> torch.Tensor:
    """Summed BCE-with-logits over the trailing ``event_ndims`` dims.

    ``x`` may carry ``1/k`` of the logits' leading rows: a term tiling in
    the order ``fold`` names (see the module docstring). Any batch dims
    work, ``event_ndims=0`` included (the CelebA attributes: rows of D =
    1). Under ``"t"`` the tiling of dim 0 is a tiling of the flattened
    rows too; under ``"b"`` with more than one batch dim the kernel reads
    the flattened rows through the b-major map over examples of
    ``prod(batch dims[1:])`` rows (``bce_rows_inner``), and its gradient
    through the same map (``bce_rows_grad_inner``).
    """
    mode = _fold(logits.shape[0], x.shape[0], fold)
    if mode != kernels.FOLD_NONE and x.shape[1:] != logits.shape[1:]:
        raise ValueError(
            f"targets {tuple(x.shape)} are not a row tiling of logits "
            f"{tuple(logits.shape)}"
        )
    # Refused before the device is checked: no kernel gives dx, on any
    # device.
    if _kernel_path(logits) and _records_grad(x):
        raise RuntimeError(
            "ops.bernoulli_nll: the kernel path has no gradient in the targets (dx); "
            "call it with targets that do not require grad, or with set_backend('torch')"
        )
    kernel = _use_kernel(logits)
    return _BernoulliNll.apply(logits, x, event_ndims, mode, kernel)


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
    kernel = _use_kernel(logits)
    return _MaskedSeqCe.apply(logits, tokens, pad_token, kernel)


class _MaskedSeqCe(torch.autograd.Function):
    """K3 and its VJP (``_seq_ce_bwd``) on tokens tiled to the logits'
    rows; ``kernel`` picks the CUDA kernels (``seq_ce_rows``,
    ``seq_ce_rows_grad``)."""

    @staticmethod
    def forward(ctx, logits, tokens, pad_token: int, kernel: bool):
        ctx.kernel, ctx.pad_token = kernel, pad_token
        if not kernel:
            ctx.save_for_backward(logits.float(), tokens)
            return kernels.masked_seq_ce_torch(logits.float(), tokens, pad_token)
        s, v = logits.shape[-2:]
        rows = logits.reshape(-1, s, v).to(torch.float32).contiguous()
        tok_rows = tokens.reshape(-1, s).contiguous()
        ctx.save_for_backward(rows, tok_rows)
        ctx.shape, ctx.dtype = logits.shape, logits.dtype
        return kernels.masked_seq_ce_kernel(rows, tok_rows, pad_token).reshape(logits.shape[:-2])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        logits, tokens = ctx.saved_tensors
        if not ctx.kernel:
            d_logits = kernels.masked_seq_ce_grad_torch(logits, tokens, ctx.pad_token, g)
            return d_logits, None, None, None
        g = g.reshape(-1).to(torch.float32).contiguous()
        d_logits = kernels.masked_seq_ce_grad_kernel(logits, tokens, ctx.pad_token, g)
        return d_logits.reshape(ctx.shape).to(ctx.dtype), None, None, None


def conv4x4s2_swish(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """``swish(conv(x, weight, SAME, stride 2) + bias)``: ``x`` ``(B, H, W,
    C)`` NHWC, ``weight`` ``(F, C, 4, 4)`` OIHW -> ``(B, F, ceil(H/2),
    ceil(W/2))`` NCHW, in the type ``x`` and ``weight`` promote to (a bf16
    batch and f32 weights give f32; all bf16, a bf16 model's stage 0, give
    bf16). The kernel takes C <= 4 and F = 32, 16 or 8 (a rank's share of
    stage 0's 32 channels under tensor parallelism); its backward kernels give
    the weight's and the bias's gradients in their types and, when the
    image requires grad, the image's (dx; f32 or all bf16). Where autograd records nothing, the kernel path is the op
    ``mmvae::conv4x4s2_swish``, which a trace keeps (``ops/library.py``)."""
    kernel = _use_kernel(x)
    if _records_grad(x, weight, bias):
        return _Conv4x4s2Swish.apply(x, weight, bias, kernel)
    if _backend == "torch":
        return kernels.conv4x4s2_swish_torch(x, weight, bias)
    return torch.ops.mmvae.conv4x4s2_swish(x, weight, bias)


class _Conv4x4s2Swish(torch.autograd.Function):
    """K4 and its backward; ``kernel`` picks the CUDA kernels
    (``conv4x4s2_swish``; ``conv4x4s2_swish_bwd`` for the weight and bias,
    ``conv4x4s2_swish_dx`` for the image where it needs a gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, kernel: bool):
        ctx.kernel = kernel
        if kernel:
            x, weight, bias = x.contiguous(), weight.contiguous(), bias.contiguous()
            out = torch.ops.mmvae.conv4x4s2_swish(x, weight, bias)
        else:
            out = kernels.conv4x4s2_swish_torch(x, weight, bias)
        ctx.save_for_backward(x, weight, bias)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        if ctx.kernel:
            d_w, d_b = kernels.conv4x4s2_swish_grad_kernel(x, weight, bias, g)
            d_x = None
            if ctx.needs_input_grad[0]:
                d_x = kernels.conv4x4s2_swish_input_grad_kernel(x, weight, bias, g)
            return d_x, d_w, d_b, None
        d_w, d_b = kernels.conv4x4s2_swish_grad_torch(x, weight, bias, g)
        d_x = None
        if ctx.needs_input_grad[0]:
            d_x = kernels.conv4x4s2_swish_input_grad_torch(x, weight, bias, g)
        return d_x, d_w.to(weight.dtype), d_b.to(bias.dtype), None


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
    prior and a KL of exactly 0. Where autograd records nothing, the
    kernel path is the op ``mmvae::poe_kl``, which a trace keeps
    (``ops/library.py``)."""
    if _records_grad(masks, presence):
        raise RuntimeError(
            "ops.poe_kl: the backward of masks and presence is not yet ported to "
            "mmvae_torch (only the expert stack is differentiated)"
        )
    kernel = _use_kernel(mu_e)
    if _records_grad(mu_e, lv_e):
        return _PoeKl.apply(mu_e, lv_e, masks, presence, kernel)
    if _backend == "torch":
        return kernels.poe_kl_torch(mu_e, lv_e, masks, presence)
    return torch.ops.mmvae.poe_kl(mu_e, lv_e, masks, presence)


class _PoeKl(torch.autograd.Function):
    """The fused PoE + KL and its backward in the expert stack; ``kernel``
    picks the CUDA kernels (``poe_kl``, ``poe_kl_bwd``)."""

    @staticmethod
    def forward(ctx, mu_e, lv_e, masks, presence, kernel: bool):
        ctx.kernel = kernel
        if kernel:
            ctx.dtypes = (mu_e.dtype, lv_e.dtype)
            mu_e, lv_e, masks, presence = (_f32(t) for t in (mu_e, lv_e, masks, presence))
            out = torch.ops.mmvae.poe_kl(mu_e, lv_e, masks, presence)
        else:
            out = kernels.poe_kl_torch(mu_e, lv_e, masks, presence)
        ctx.save_for_backward(mu_e, lv_e, masks, presence, out[0], out[1])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mu, g_lv, g_kl):
        saved = ctx.saved_tensors
        if not ctx.kernel:
            d_mu, d_lv = kernels.poe_kl_grad_torch(*saved, g_mu, g_lv, g_kl)
            return d_mu, d_lv, None, None, None
        d_mu, d_lv = kernels.poe_kl_grad_kernel(*saved, *(_f32(g) for g in (g_mu, g_lv, g_kl)))
        return d_mu.to(ctx.dtypes[0]), d_lv.to(ctx.dtypes[1]), None, None, None
