"""The multi-term MVAE loss, the train step and the eval step.

Port of ``mmvae_tpu/train/step.py`` for the inference slices and MNIST
training: the ``"mvae"`` objective under the t-major term fold
(``term_fold="t"``, the single-device path of both the JAX eval and the
JAX train step, ``step.py:532-578``) with member-pruned decoding
(``_member_prune_keys`` / ``_pruned_nll``) and an optional presence mask.

  * encoders run ONCE per modality -> ``(B, M, L)`` expert stack;
  * masked PoE fusion over the ``(T, M)`` subset masks -> ``(T, B, L)``,
    and the KL of all ``T * B`` posteriors, in one ``ops.poe_kl`` call:
    one kernel on the card, K1's function as the PoE's epilogue (the JAX
    step leaves the same fusion to XLA);
  * each decode key decodes only its possibly-member term rows, folded
    t-major into one ``(tk * B, L)`` batch;
  * each key's NLL is one ``ops`` call, so on the card one eval batch
    launches the fused PoE + KL once and each NLL kernel once per decode
    key (MNIST: K2; MultiMNIST: K2, K3; CelebA: K2 for the image and K2
    for the 18 attributes, and K4 in the image encoder).

One difference from the JAX code: the JAX t-fold broadcasts the targets to
the tiled rows (``_tile_terms_tmajor``, ``step.py:247``) and lets XLA fuse
the copy. Here the image, label and attribute targets go to ``nll_one``
UNTILED with ``fold="t"``; the BCE kernel reads target row ``r % B`` (for
the attributes, row ``r % (B * 18)`` of rows of D = 1) and the tiled copy
is never made. Only the small integer token rows are tiled.

Training (``make_train_step``, ``make_epoch_runner``) differentiates the
same loss with ``sample=True``. Its reductions are differentiable on both
paths (``mmvae_torch.ops``): on the card one MNIST step launches, besides
the models' own layers, the fused PoE + KL and K2 forward and their
backward kernels ``poe_kl_bwd`` and ``bce_rows_grad`` once each. K3 and K4
have no backward kernel yet, so training a config whose loss runs them
raises on the card (``ops``); no such config trains yet.

The other folds (``"b"``, ``"st"``), the decode-all pass, random subsets,
the mixture objectives, cross-recon, the cycle term and gradient
accumulation are not ported yet and raise.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from mmvae_torch import ops
from mmvae_torch.core import (
    OBJECTIVES,
    annealing_factor,
    elbo_subset_masks,
    elbo_terms,
    reparameterize,
)
from mmvae_torch.ops.kernels import FOLD_T, tile_rows
from mmvae_torch.train.state import TrainState, global_norm

__all__ = [
    "multi_term_loss",
    "make_train_step",
    "make_epoch_runner",
    "presence_from_keep",
    "make_eval_step",
    "make_eval_runner",
]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to mmvae_torch")


def _member_prune_keys(model, n_mod: int, n_terms: int):
    """Per-decode-key member term rows under the mvae mask layout.

    Row 0 is the joint term, rows 1..M the unimodal terms, rows 1+M.. the
    random ones. Decode key k's possibly-member rows are the joint row,
    its own modalities' unimodal rows and every random row. Returns
    ``{key: (rows, modality_indices)}``, or None without per-key decode.
    """
    km = model.decode_key_modalities()
    if km is None:
        return None
    n_static = 1 + n_mod
    return {
        key: (
            [0] + [1 + m for m in mods] + list(range(n_static, n_terms)),
            list(mods),
        )
        for key, mods in km.items()
    }


@functools.lru_cache(maxsize=64)
def _device_index(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """An index tensor on ``device``, made once. Made from a list on each
    call it would be a pageable host-to-device copy, and such a copy
    waits for the stream to drain."""
    return torch.tensor(values, device=device)


def _pruned_nll_t(model, z: torch.Tensor, data: dict, prune_keys) -> torch.Tensor:
    """Member-only decode+NLL under the t-major fold.

    ``z`` is ``(T, B, L)``; returns ``(T, M, B)`` with exact zeros at every
    entry outside a key's member rows (their recon mask is 0 too). The
    sequence targets are tiled t-major to each key's ``tk * B`` rows (the
    teacher-forced decoders read them, as ``_tile_terms_tmajor`` feeds
    them in the JAX step); the other targets stay untiled and are read
    through ``fold="t"``.
    """
    n_terms, b = z.shape[0], z.shape[1]
    seq_names = [s.name for s in model.specs() if s.kind == "seq"]
    out = z.new_zeros((n_terms, model.n_modalities, b))
    tiled_by_tk: dict[int, dict] = {}
    for key, (rows, mods) in prune_keys.items():
        tk = len(rows)
        if tk not in tiled_by_tk:
            tiled_by_tk[tk] = {
                **data,
                **{n: tile_rows(data[n], tk * b, FOLD_T) for n in seq_names},
            }
        targets = tiled_by_tk[tk]
        r = _device_index(tuple(rows), z.device)
        m = _device_index(tuple(mods), z.device)
        z_k = z.index_select(0, r).reshape(tk * b, -1)
        recon = model.decode_one(key, z_k, targets)
        nll_k = model.nll_one(key, recon, targets, fold="t")  # (M_k, tk * b)
        val = nll_k.reshape(len(mods), tk, b).transpose(0, 1)  # (tk, M_k, b)
        out[r[:, None], m[None, :]] = val
    return out


def multi_term_loss(
    model,
    batch: dict[str, Any],
    beta: float = 1.0,
    *,
    sample: bool = True,
    objective: str = "mvae",
    member_prune: bool = True,
    term_fold: str = "t",
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
):
    """Total multi-term ELBO loss (batch mean) and per-term metrics.

    ``batch`` maps modality names to targets, plus an optional
    ``"presence"`` key: a ``(B, M)`` float mask of the modalities each
    example carries. An unobserved modality contributes neither an expert
    nor a recon target; an example with no modality fuses to the prior
    and contributes exactly 0 (how eval masks its padding rows).

    ``sample=False`` takes z = posterior mean (eval). With ``sample=True``
    the noise comes from ``eps`` (``(T, B, L)``) or ``generator``.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    if objective != "mvae":
        raise _not_ported(f"objective {objective!r}")
    if term_fold != "t":
        raise _not_ported(f"term_fold {term_fold!r}")
    prune_keys = None
    if member_prune:
        prune_keys = _member_prune_keys(model, model.n_modalities, 1 + model.n_modalities)
    if prune_keys is None:
        raise _not_ported("the decode-all pass (member_prune=False)")

    presence = batch.get("presence")
    data = {k: v for k, v in batch.items() if k != "presence"}
    masks = elbo_subset_masks(model.n_modalities, device=model.device)  # (T, M)

    mu_e, lv_e = model.encode(data)  # (B, M, L)
    # (T, B, L) posteriors under the masks times the presence, (T, B) KLs
    fused_mu, fused_lv, kl = ops.poe_kl(mu_e, lv_e, masks, presence)
    z = reparameterize(
        fused_mu, fused_lv, sample=sample, generator=generator, eps=eps
    )
    nll = _pruned_nll_t(model, z, data, prune_keys)  # (T, M, B)
    if presence is not None:
        nll = nll * presence.T[None]  # unobserved modalities are no targets
    return elbo_terms(nll, kl, masks, model.lambdas(), beta)


def presence_from_keep(keep: torch.Tensor) -> torch.Tensor:
    """Presence dropout's mask from a ``(B, M)`` keep draw: a row whose
    every modality was dropped keeps them all (``step.py:1054-1057``)."""
    keep = keep.to(torch.bool)
    all_dropped = ~torch.any(keep, dim=-1, keepdim=True)
    return torch.where(all_dropped, True, keep).to(torch.float32)


def make_train_step(
    model,
    *,
    n_random_subsets: int = 0,
    annealing_steps: int = 0,
    p_modality_drop: float = 0.0,
    objective: str = "mvae",
    member_prune: bool = True,
    term_fold: str = "t",
    generator: torch.Generator | None = None,
) -> Callable:
    """The train step ``(state, batch, eps=None, keep=None) -> (state,
    metrics)`` of ``_train_step_impl`` (``step.py:1022-1093``).

    beta is ``annealing_factor(state.step, annealing_steps)``. With
    ``p_modality_drop > 0`` and no ``"presence"`` in the batch, each
    example keeps each modality with probability ``1 - p_modality_drop``
    (``keep``, ``(B, M)``, or a draw from ``generator``), and a row with
    none kept keeps all. The loss is :func:`multi_term_loss` with
    ``sample=True``, its noise ``eps`` (``(T, B, L)``) or a draw from
    ``generator`` (on the model's device). Then one update of ``state``
    (:meth:`TrainState.apply_gradients`). The metrics are the loss terms,
    ``beta`` and ``grad_norm``, the global norm of the raw gradients
    before clipping. Only ``term_fold="t"`` is ported; the others raise.
    """
    if term_fold != "t":
        raise _not_ported(f"term_fold {term_fold!r}")
    if n_random_subsets:
        raise _not_ported("n_random_subsets > 0 (random subset terms)")

    def train_step(state: TrainState, batch, eps=None, keep=None):
        beta = annealing_factor(state.step, annealing_steps)
        if p_modality_drop > 0.0 and "presence" not in batch:
            if keep is None:
                b = next(iter(batch.values())).shape[0]
                u = torch.rand(
                    (b, model.n_modalities), generator=generator, device=model.device
                )
                keep = u < 1.0 - p_modality_drop
            batch = dict(batch, presence=presence_from_keep(keep))
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = multi_term_loss(
            state.model, batch, beta, sample=True, objective=objective,
            member_prune=member_prune, term_fold=term_fold, generator=generator,
            eps=eps,
        )
        loss.backward()
        params = list(state.model.parameters())
        for p in params:  # a parameter the loss does not reach has gradient 0
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm([p.grad for p in params])
        metrics["beta"] = torch.full((), beta, device=loss.device)
        state.apply_gradients()
        return state, metrics

    return train_step


def make_epoch_runner(model, **step_kwargs) -> Callable:
    """An epoch over pre-stacked ``(n_steps, B, ...)`` batches, one
    :func:`make_train_step` step at a time (the JAX runner's ``lax.scan``,
    ``step.py:1096``, as a plain loop). Returns ``run(state, batches) ->
    (state, metrics)`` with every metric stacked over the steps."""
    train_step = make_train_step(model, **step_kwargs)

    def run(state, batches):
        n_steps = next(iter(batches.values())).shape[0]
        per_step = []
        for i in range(n_steps):
            state, metrics = train_step(state, {k: v[i] for k, v in batches.items()})
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return run


def make_eval_step(
    model, objective: str = "mvae"
) -> Callable[[dict[str, Any]], dict[str, torch.Tensor]]:
    """Eval step: full ELBO at beta = 1 with z = posterior mean.

    Returns ``eval_step(batch) -> metrics``, run without autograd.
    """

    @torch.no_grad()
    def eval_step(batch):
        _, metrics = multi_term_loss(
            model, batch, 1.0, sample=False, objective=objective
        )
        return metrics

    return eval_step


def make_eval_runner(
    model, objective: str = "mvae"
) -> Callable[[dict[str, Any]], dict[str, torch.Tensor]]:
    """Eval over pre-stacked ``(n_batches, B, ...)`` tensors, one batch at
    a time. Returns ``run(batches) -> metrics`` with every metric stacked
    over the batches (the JAX runner's ``lax.scan`` as a plain loop)."""
    eval_step = make_eval_step(model, objective)

    def run(batches):
        n_steps = next(iter(batches.values())).shape[0]
        per_step = [
            eval_step({k: v[i] for k, v in batches.items()})
            for i in range(n_steps)
        ]
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return run
