"""The multi-term MVAE loss, the train step and the eval step.

Port of ``mmvae_tpu/train/step.py`` for the inference slices and the
MNIST, FashionMNIST, MultiMNIST, CelebA and CUB training slices: the ``"mvae"`` objective
under the t-major term fold (``term_fold="t"``, the single-device path of
both the JAX eval and the JAX train step, ``step.py:532-578``) with an
optional presence mask.

  * encoders run ONCE per modality -> ``(B, M, L)`` expert stack;
  * the ``(T, M)`` subset masks: the joint, the M unimodal terms and, in
    training, ``n_random_subsets`` random ones (CelebA: T = 1 + 19 + 4);
  * masked PoE fusion over the ``(T, M)`` subset masks -> ``(T, B, L)``,
    and the KL of all ``T * B`` posteriors, in one ``ops.poe_kl`` call:
    one kernel on the card, K1's function as the PoE's epilogue (the JAX
    step leaves the same fusion to XLA);
  * member-pruned decoding (``_member_prune_keys`` / ``_pruned_nll``): each
    decode key decodes only its possibly-member term rows, folded t-major
    into one ``(tk * B, L)`` batch; or, under ``cross_recon`` or
    ``member_prune=False``, the decode-all pass: every key decodes all
    ``T * B`` rows once;
  * each key's NLL is one ``ops`` call, so on the card one eval batch
    launches the fused PoE + KL once and each NLL kernel once per decode
    key (MNIST: K2; MultiMNIST: K2, K3; CelebA: K2 for the image and K2
    for the 18 attributes, and K4 in the image encoder);
  * ``cross_recon``: every modality is a target of every subset term,
    cross entries weighed by ``cross_recon_weight`` (``step.py:762-778``);
  * the cycle term (``cycle_weight > 0``, ``step.py:811-937``): each
    sequence modality's unimodal z is rendered into the bernoulli
    modalities, re-encoded with only those observed, and the sequence is
    read back from the posterior mean; its CE joins the loss.

One difference from the JAX code: the JAX t-fold broadcasts the targets to
the tiled rows (``_tile_terms_tmajor``, ``step.py:247``) and lets XLA fuse
the copy. Here the image, label and attribute targets go to ``nll_one``
UNTILED with ``fold="t"``; the BCE kernel reads target row ``r % B`` (for
the attributes, row ``r % (B * 18)`` of rows of D = 1) and the tiled copy
is never made. Only the small integer token rows are tiled.

Training (``make_train_step``, ``make_epoch_runner``) differentiates the
same loss with ``sample=True``. On the card an epoch and an eval split
each run as replays of one captured CUDA graph (``_StepGraph``), the
counterpart of the JAX runners' one ``lax.scan`` program; the CPU runs
them as eager loops. Its reductions are differentiable on both
paths (``mmvae_torch.ops``): on the card one MNIST step launches, besides
the models' own layers, the fused PoE + KL and K2 forward and their
backward kernels ``poe_kl_bwd`` and ``bce_rows_grad`` once each; one
``multimnist`` step (cross-recon, the cycle term on both render forms)
the fused PoE + KL three times (the loss, two re-reads), K2 once and K3
three times, and each one's backward kernel as often; one ``celeba`` step
(4 random subsets, T = 24) the fused PoE + KL once, K2 twice (the image's
6 member terms, the attributes' 23), K4 once (stage 0 of the image
encoder), and each one's backward kernel as often (K4's in its weight
and bias); one ``cub`` step (cross-recon, the cycle term on the soft
render) the fused PoE + KL twice (the loss, the re-read), K2 once, K3
twice and K4 twice (the encode, the re-encode of the render), each one's
backward kernel as often, and K4's input gradient once (the re-encode's
input is the render).

The IWAE runner (``make_iwae_step``, ``make_iwae_runner``) runs
``core.iwae_bound`` over an eval split, its k samples folded b-major, on
the same graph machinery; on the card one of its batches launches the
fused PoE + KL once and each NLL kernel once per decode key through the
b-major row maps (CelebA: K2 twice, the attributes through the map over
examples of 18 rows; MultiMNIST and CUB: K2 and K3), and K4 once on
CelebA and CUB.

The other train folds (``"b"``, ``"st"``) and the mixture objectives are not
ported yet and raise; ``cross_recon_stopgrad``,
``unimodal_align_weight``, ``cycle_contrast_weight`` and gradient
accumulation are not taken yet.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.func import functional_call

from mmvae_torch import ops
from mmvae_torch.core import (
    OBJECTIVES,
    annealing_factor,
    elbo_subset_masks,
    elbo_terms,
    iwae_bound,
    random_subset_masks,
    reparameterize,
)
from mmvae_torch.ops import kernels
from mmvae_torch.ops.kernels import FOLD_T, tile_rows
from mmvae_torch.train.state import TrainState, global_norm

__all__ = [
    "multi_term_loss",
    "make_train_step",
    "make_epoch_runner",
    "presence_from_keep",
    "make_eval_step",
    "make_eval_runner",
    "make_iwae_step",
    "make_iwae_runner",
]

_BINARIZE = (False, True, "both")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to mmvae_torch")


def _check_ported(objective: str, term_fold: str) -> None:
    """Raise on an objective or a fold not ported yet."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    if objective != "mvae":
        raise _not_ported(f"objective {objective!r}")
    if term_fold != "t":
        raise _not_ported(f"term_fold {term_fold!r}")


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
def _device_tensor(
    values: tuple, device: torch.device, dtype: torch.dtype = torch.int64
) -> torch.Tensor:
    """A constant tensor on ``device``, made once. Made from a list on each
    call it would be a pageable host-to-device copy, and such a copy
    waits for the stream to drain."""
    return torch.tensor(values, dtype=dtype, device=device)


def _seq_tiled(model, data: dict, n_rows: int) -> dict:
    """``data`` with each sequence modality's tokens tiled t-major to
    ``n_rows`` rows: the teacher-forced decoders read them (as
    ``_tile_terms_tmajor`` feeds them in the JAX step)."""
    seq_names = [s.name for s in model.specs() if s.kind == "seq"]
    return {**data, **{n: tile_rows(data[n], n_rows, FOLD_T) for n in seq_names}}


def _pruned_nll_t(model, z: torch.Tensor, data: dict, prune_keys) -> torch.Tensor:
    """Member-only decode+NLL under the t-major fold.

    ``z`` is ``(T, B, L)``; returns ``(T, M, B)`` with exact zeros at every
    entry outside a key's member rows (their recon mask is 0 too). The
    sequence targets are tiled t-major to each key's ``tk * B`` rows; the
    other targets stay untiled and are read through ``fold="t"``.
    """
    n_terms, b = z.shape[0], z.shape[1]
    out = z.new_zeros((n_terms, model.n_modalities, b))
    tiled_by_tk: dict[int, dict] = {}
    for key, (rows, mods) in prune_keys.items():
        tk = len(rows)
        if tk not in tiled_by_tk:
            tiled_by_tk[tk] = _seq_tiled(model, data, tk * b)
        targets = tiled_by_tk[tk]
        r = _device_tensor(tuple(rows), z.device)
        m = _device_tensor(tuple(mods), z.device)
        z_k = z.index_select(0, r).reshape(tk * b, -1)
        recon = model.decode_one(key, z_k, targets)
        nll_k = model.nll_one(key, recon, targets, fold="t")  # (M_k, tk * b)
        val = nll_k.reshape(len(mods), tk, b).transpose(0, 1)  # (tk, M_k, b)
        out[r[:, None], m[None, :]] = val
    return out


def _decode_all_nll_t(model, z: torch.Tensor, data: dict) -> torch.Tensor:
    """The decode-all pass under the t-major fold (``step.py:565-576``):
    every decode key decodes all ``T * B`` rows of ``z`` ``(T, B, L)``
    once, the sequence targets tiled t-major and the others read untiled
    through ``fold="t"``. Returns ``(T, M, B)``."""
    n_terms, b = z.shape[0], z.shape[1]
    targets = _seq_tiled(model, data, n_terms * b)
    z_flat = z.reshape(n_terms * b, -1)
    order, rows = [], []
    for key, mods in model.decode_key_modalities().items():
        recon = model.decode_one(key, z_flat, targets)
        rows.append(model.nll_one(key, recon, targets, fold="t"))  # (M_k, T * B)
        order += mods
    if order != list(range(model.n_modalities)):
        raise _not_ported("decode keys out of modality order")
    return torch.cat(rows).reshape(model.n_modalities, n_terms, b).transpose(0, 1)


class _Method(torch.nn.Module):
    """``model.<method>(*args)`` as the forward of a module that holds the
    model, so that ``torch.func.functional_call`` can run any method of the
    model on other parameters."""

    def __init__(self, model, method: str):
        super().__init__()
        self.model, self.method = model, method

    def forward(self, *args):
        return getattr(self.model, self.method)(*args)


def _decoders_detached(model, method: str, *args, live: frozenset = frozenset()):
    """``model.<method>(*args)`` with the parameters of every decoder
    submodule (a top-level name that contains ``dec``, as
    ``_sg_decoder_params`` picks them, ``step.py:274-287``) but those named
    in ``live`` detached. The gradient still flows through the decoders'
    activations to their inputs and on to the encoders; only the decoders'
    weights get none of it."""
    detached = {
        f"model.{name}": p.detach()
        for name, p in model.named_parameters()
        if "dec" in name.split(".", 1)[0] and name.split(".", 1)[0] not in live
    }
    return functional_call(_Method(model, method), detached, args)


def _straight_through(p: torch.Tensor) -> torch.Tensor:
    """The cycle render's hard form (``step.py:885-900``): the 0/1
    threshold at 0.5 forward, the identity backward."""
    return p + ((p > 0.5).to(p.dtype) - p).detach()


def _cycle_ce(
    model, z: torch.Tensor, data: dict, presence: torch.Tensor | None,
    render_grad: bool, binarize: bool | str,
) -> torch.Tensor:
    """The cycle term's CE (``step.py:811-937``, the mvae objective): for
    each sequence modality s, its unimodal term's z is rendered into the
    bernoulli modalities (their decoders live only with ``render_grad``),
    as the soft render sigmoid(logits), its straight-through 0/1 threshold
    or both (``binarize`` False, True, "both"). Each form is re-encoded
    with the bernoulli modalities alone observed (one ``ops.poe_kl`` call,
    T = 1: only the posterior mean is used) and s is read back,
    teacher-forced from that mean, with every decoder detached. The CE
    (the two forms' averaged under "both"), times s's presence where given,
    is meaned over the batch and weighed by lambda_s."""
    specs = model.specs()
    seq_idx = [i for i, s in enumerate(specs) if s.kind == "seq"]
    ber_idx = [i for i, s in enumerate(specs) if s.kind == "bernoulli"]
    if not seq_idx or not ber_idx:
        raise ValueError("cycle_weight needs a seq and a bernoulli modality")
    # Re-encode presence: only the rendered modalities are observed.
    ber_mask = _device_tensor(
        ((tuple(float(i in ber_idx) for i in range(len(specs)))),), z.device, torch.float32)
    live = frozenset(f"{specs[m].name}_dec" for m in ber_idx) if render_grad else frozenset()
    key_of = {m: (key, j) for key, mods in model.decode_key_modalities().items()
              for j, m in enumerate(mods)}
    lambdas = model.lambdas()

    def re_read_ce(rb: dict, s_i: int) -> torch.Tensor:
        mu2, lv2 = model.encode(rb)
        mu_f2 = ops.poe_kl(mu2, lv2, ber_mask)[0][0]  # (B, L); z = posterior mean
        key, j = key_of[s_i]
        recon = _decoders_detached(model, "decode_one", key, mu_f2, data)
        return model.nll_one(key, recon, data)[j]  # (B,)

    cycle_ce = z.new_zeros(())
    for s_i in seq_idx:
        z_s = z[1 + s_i]  # the mvae unimodal term of s
        soft, hard = dict(data), dict(data)
        for m_i in ber_idx:
            name = specs[m_i].name
            p = torch.sigmoid(_decoders_detached(model, "decode_one", name, z_s, data, live=live))
            soft[name], hard[name] = p, _straight_through(p)
        if binarize == "both":
            ce = 0.5 * (re_read_ce(soft, s_i) + re_read_ce(hard, s_i))
        else:
            ce = re_read_ce(hard if binarize else soft, s_i)
        if presence is not None:
            ce = ce * presence[:, s_i]
        cycle_ce = cycle_ce + lambdas[s_i] * torch.mean(ce)
    return cycle_ce


def multi_term_loss(
    model,
    batch: dict[str, Any],
    beta: float = 1.0,
    *,
    sample: bool = True,
    cross_recon: bool = False,
    cross_recon_weight: float = 1.0,
    cycle_weight: float = 0.0,
    cycle_render_grad: bool = False,
    cycle_render_binarize: bool | str = False,
    objective: str = "mvae",
    member_prune: bool = True,
    term_fold: str = "t",
    n_random_subsets: int = 0,
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
    subset_masks: torch.Tensor | None = None,
):
    """Total multi-term ELBO loss (batch mean) and per-term metrics.

    ``batch`` maps modality names to targets, plus an optional
    ``"presence"`` key: a ``(B, M)`` float mask of the modalities each
    example carries. An unobserved modality contributes neither an expert
    nor a recon target; an example with no modality fuses to the prior
    and contributes exactly 0 (how eval masks its padding rows).

    The terms are the joint, the M unimodal ones and ``n_random_subsets``
    random subsets (``step.py:483-496``): ``subset_masks`` ``(k, M)``, or a
    Bernoulli(0.5) draw from ``generator`` before the noise's; an empty
    subset fuses to the prior (KL 0) and reconstructs nothing. ``T = 1 + M
    + k``.

    ``sample=False`` takes z = posterior mean (eval). With ``sample=True``
    the noise comes from ``eps`` (``(T, B, L)``) or ``generator``.
    ``cross_recon``, ``cross_recon_weight``, ``cycle_weight``,
    ``cycle_render_grad`` and ``cycle_render_binarize`` are those of the
    JAX loss (module docstring); with ``cycle_weight > 0`` the metrics
    carry ``cycle_ce``.
    """
    _check_ported(objective, term_fold)
    if cycle_weight > 0.0 and cycle_render_binarize not in _BINARIZE:
        raise ValueError(
            "cycle_render_binarize must be False, True, or 'both'; "
            f"got {cycle_render_binarize!r}"
        )
    n_mod = model.n_modalities
    masks = elbo_subset_masks(n_mod, device=model.device)  # (1 + M, M)
    if n_random_subsets > 0:
        if subset_masks is None:
            subset_masks = random_subset_masks(
                generator, n_random_subsets, n_mod, device=model.device)
        masks = torch.cat([masks, subset_masks.to(masks.dtype)])  # (T, M)
    prune_keys = None
    if member_prune and not cross_recon:
        prune_keys = _member_prune_keys(model, n_mod, masks.shape[0])

    presence = batch.get("presence")
    data = {k: v for k, v in batch.items() if k != "presence"}

    mu_e, lv_e = model.encode(data)  # (B, M, L)
    # (T, B, L) posteriors under the masks times the presence, (T, B) KLs
    fused_mu, fused_lv, kl = ops.poe_kl(mu_e, lv_e, masks, presence)
    z = reparameterize(
        fused_mu, fused_lv, sample=sample, generator=generator, eps=eps
    )
    if prune_keys is not None:
        nll = _pruned_nll_t(model, z, data, prune_keys)  # (T, M, B)
    else:
        nll = _decode_all_nll_t(model, z, data)
    if presence is not None:
        nll = nll * presence.T[None]  # unobserved modalities are no targets
    recon_masks = masks
    if cross_recon:
        # Every modality is a target of every nonempty subset term; cross
        # entries weigh cross_recon_weight.
        nonempty = (masks.sum(-1, keepdim=True) > 0).to(masks.dtype)
        recon_masks = (masks + cross_recon_weight * (1.0 - masks)) * nonempty
    loss, metrics = elbo_terms(nll, kl, recon_masks, model.lambdas(), beta)
    if cycle_weight > 0.0:
        cycle_ce = _cycle_ce(model, z, data, presence, cycle_render_grad,
                             cycle_render_binarize)
        loss = loss + cycle_weight * cycle_ce
        metrics = dict(metrics, loss=loss, cycle_ce=cycle_ce)
    return loss, metrics


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
    cross_recon: bool = False,
    cross_recon_weight: float = 1.0,
    cycle_weight: float = 0.0,
    cycle_render_grad: bool = False,
    cycle_render_binarize: bool | str = False,
    objective: str = "mvae",
    member_prune: bool = True,
    term_fold: str = "t",
    generator: torch.Generator | None = None,
) -> Callable:
    """The train step ``(state, batch, eps=None, keep=None,
    subset_masks=None) -> (state, metrics)`` of ``_train_step_impl``
    (``step.py:1022-1093``).

    beta is ``annealing_factor(state.device_step, annealing_steps)``, read
    on the device. With
    ``p_modality_drop > 0`` and no ``"presence"`` in the batch, each
    example keeps each modality with probability ``1 - p_modality_drop``
    (``keep``, ``(B, M)``, or a draw from ``generator``), and a row with
    none kept keeps all. The loss is :func:`multi_term_loss` with
    ``sample=True`` and the loss knobs given here, its ``n_random_subsets``
    masks ``subset_masks`` (``(k, M)``) or a draw from ``generator``, its
    noise ``eps`` (``(T, B, L)``) or a draw from ``generator`` (on the
    model's device).
    Then one update of ``state`` (:meth:`TrainState.apply_gradients`). The
    metrics are the loss terms, ``beta`` and ``grad_norm``, the global
    norm of the raw gradients before clipping. Only the mvae objective and
    ``term_fold="t"`` are ported; the others raise here.
    """
    _check_ported(objective, term_fold)
    loss_kwargs = dict(
        n_random_subsets=n_random_subsets, cross_recon=cross_recon, cross_recon_weight=cross_recon_weight,
        cycle_weight=cycle_weight, cycle_render_grad=cycle_render_grad,
        cycle_render_binarize=cycle_render_binarize, objective=objective,
        member_prune=member_prune, term_fold=term_fold,
    )

    def train_step(state: TrainState, batch, eps=None, keep=None, subset_masks=None):
        beta = annealing_factor(state.device_step, annealing_steps)
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
            state.model, batch, beta, sample=True, generator=generator, eps=eps,
            subset_masks=subset_masks, **loss_kwargs,
        )
        loss.backward()
        params = list(state.model.parameters())
        for p in params:  # a parameter the loss does not reach has gradient 0
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm([p.grad for p in params])
        metrics["beta"] = beta
        state.apply_gradients()
        return state, metrics

    return train_step


def _use_graph(model, graph: bool | None) -> bool:
    """Whether a runner over ``model`` replays a CUDA graph: on the card
    unless ``graph=False`` asks for the eager loop; never on the CPU."""
    on_card = model.device.type == "cuda"
    if graph and not on_card:
        raise ValueError(f"a CUDA graph runner needs the model on the card, not {model.device}")
    return on_card if graph is None else graph


def _rows(batches: dict[str, torch.Tensor]) -> int:
    return next(iter(batches.values())).shape[0]


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a train step reads or updates in place besides the
    batch and the activations: a CUDA graph holds their addresses."""
    out = [*state.model.parameters(), *state.model.buffers(), state.device_step]
    if state.ema_model is not None:
        out += list(state.ema_model.parameters())
    for per_param in state.optimizer.state.values():
        out += [v for v in per_param.values() if torch.is_tensor(v)]
    return out


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every runner on ``device`` runs its first row and
    its capture on. One for the process: cuBLAS keeps a workspace for each
    stream it has run on until the process ends, so a new stream for each
    runner would leave one behind for each runner built."""
    return torch.cuda.Stream(device=device)


class _StepGraph:
    """``fn(batch) -> metrics`` over the rows of stacked ``(n, B, ...)``
    inputs as replays of one CUDA graph: the counterpart of the body of
    the JAX runners' ``lax.scan`` (``step.py:1096``, ``:1163``, ``:1580``).

    The captured body reads row ``idx`` of static copies of the inputs
    (``index_select`` by a device index), writes each metric at row
    ``idx`` of static ``(n, ...)`` outputs and advances ``idx``, all on the
    device, so one replay follows another with no launch from the host
    between them. The first call runs row 0 eagerly on a side stream, as
    a real step: it builds the kernels and makes the cached constants and
    the optimizer's state, which must exist before capture (a pageable
    upload or a sync under capture raises). It then captures the body on
    that stream and replays it for the other rows. A later call copies its
    inputs into the static ones (one copy each), zeroes ``idx`` and
    replays every row. A capture that fails raises; nothing falls back to
    the eager loop.

    ``generator`` (the noise and dropout draws) is registered with the
    graph, so each replay draws the numbers an eager step would and
    advances the generator's state as one would. ``kernels.LAUNCHES``
    counts a launch when Python makes it, so the capture's counts are
    taken back and each replay adds them again. The graph holds the
    addresses of the tensors it reads: the tensors ``tensors()`` gives at
    each call must be those the capture saw, else the call raises.
    """

    def __init__(self, fn: Callable, generator: torch.Generator | None = None):
        self._fn, self._generator = fn, generator
        self._graph = None

    def _body(self) -> None:
        batch = {k: v.index_select(0, self._idx)[0] for k, v in self._inputs.items()}
        metrics = self._fn(batch)
        if self._outputs is None:
            n = _rows(self._inputs)
            self._outputs = {k: v.new_empty((n, *v.shape)) for k, v in metrics.items()}
        for k, v in metrics.items():
            self._outputs[k].index_copy_(0, self._idx, v.unsqueeze(0))
        self._idx.add_(1)

    def _capture(self, batches: dict[str, torch.Tensor]) -> int:
        """Row 0 eagerly, then the capture; returns the rows left."""
        device = next(iter(batches.values())).device
        self._inputs = {k: v.clone() for k, v in batches.items()}
        self._idx = torch.zeros(1, dtype=torch.int64, device=device)
        self._outputs = None
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._body()
        graph = torch.cuda.CUDAGraph()
        if self._generator is not None:
            graph.register_generator_state(self._generator)
        counts = dict(kernels.LAUNCHES)
        constants = _device_tensor.cache_info().currsize
        # Under capture the allocator takes new memory for the graph's pool
        # but frees none it has cached (neither free blocks nor the pools of
        # graphs already gone), so the capture starts with that cache given
        # back. ``torch.cuda.graph`` would also collect garbage each time;
        # no runner leaves any.
        torch.cuda.empty_cache()
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                self._body()
            finally:
                graph.capture_end()
        self._launches = {k: kernels.LAUNCHES[k] - n for k, n in counts.items()}
        kernels.LAUNCHES.update(counts)
        if _device_tensor.cache_info().currsize != constants:
            raise RuntimeError("a constant was made under capture: its upload is not in the graph")
        torch.cuda.current_stream(device).wait_stream(side)
        self._graph = graph
        return _rows(batches) - 1

    def __call__(
        self, batches: dict[str, torch.Tensor], tensors: Callable[[], list] = list
    ) -> dict[str, torch.Tensor]:
        """Every row of ``batches`` through ``fn``; each metric stacked."""
        if self._graph is None:
            replays = self._capture(batches)
            self._addresses = [t.data_ptr() for t in tensors()]
        else:
            if [t.data_ptr() for t in tensors()] != self._addresses:
                raise RuntimeError(
                    "the state's tensors moved since the graph was captured "
                    "(a reload with assign=True, a move, a new optimizer): build a new runner")
            for k, v in batches.items():
                if v.shape != self._inputs[k].shape:
                    raise ValueError(
                        f"{k}: {tuple(v.shape)} is not the captured {tuple(self._inputs[k].shape)}")
                self._inputs[k].copy_(v)
            self._idx.zero_()
            replays = _rows(batches)
        for _ in range(replays):
            self._graph.replay()
        for k, n in self._launches.items():
            kernels.LAUNCHES[k] += n * replays
        return {k: v.clone() for k, v in self._outputs.items()}


def make_epoch_runner(model, *, graph: bool | None = None, **step_kwargs) -> Callable:
    """An epoch over pre-stacked ``(n_steps, B, ...)`` batches of
    :func:`make_train_step` steps (``step_kwargs``). Returns ``run(state,
    batches) -> (state, metrics)`` with every metric stacked over the
    steps.

    On the card the epoch is the JAX runner's one program (``lax.scan``,
    ``step.py:1096``) as replays of one captured step (:class:`_StepGraph`:
    the first call's first step runs eagerly, as a real step, before the
    capture); every call must then pass the same ``state``, its tensors
    where they were. ``graph=False`` asks for the eager loop on the card,
    one step at a time, which the CPU always runs.

    ``batches`` may carry ``"eps"``, ``(n_steps, T, B, L)``, and
    ``"subset_masks"``, ``(n_steps, k, M)``: each step's posterior noise and
    random subset masks in place of a draw (how a parity run feeds two
    devices the same numbers).
    """
    train_step = make_train_step(model, **step_kwargs)
    fed = ("eps", "subset_masks")

    def step(state, batch):
        data = {k: v for k, v in batch.items() if k not in fed}
        return train_step(state, data, eps=batch.get("eps"),
                          subset_masks=batch.get("subset_masks"))

    if not _use_graph(model, graph):
        def run(state, batches):
            per_step = []
            for i in range(_rows(batches)):
                state, metrics = step(state, {k: v[i] for k, v in batches.items()})
                per_step.append(metrics)
            return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

        return run

    graphed = None

    def run_graph(state, batches):
        nonlocal graphed
        if graphed is None:
            graphed = _StepGraph(lambda batch: step(state, batch)[1],
                                 step_kwargs.get("generator"))
        first_step = state.step
        metrics = graphed(batches, lambda: _state_tensors(state))
        state.step = first_step + _rows(batches)  # the capture pass also counted one
        return state, metrics

    return run_graph


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
    model, objective: str = "mvae", *, graph: bool | None = None
) -> Callable[[dict[str, Any]], dict[str, torch.Tensor]]:
    """Eval over pre-stacked ``(n_batches, B, ...)`` tensors. Returns
    ``run(batches) -> metrics`` with every metric stacked over the
    batches.

    On the card the split is the JAX runner's one program (``lax.scan``,
    ``step.py:1580``) as replays of one captured eval batch
    (:class:`_StepGraph`), which reads ``model``'s parameters where they
    are: a runner built once serves every later eval of the same model,
    updated in place. ``graph=False`` asks for the eager loop on the card,
    one batch at a time, which the CPU always runs.
    """
    return _split_runner(make_eval_step(model, objective), model, graph)


def _split_runner(step: Callable, model, graph: bool | None,
                  generator: torch.Generator | None = None) -> Callable:
    """``step`` over the rows of pre-stacked ``(n_batches, B, ...)``
    tensors, every metric stacked: replays of one captured batch on the
    card (:class:`_StepGraph`, reading ``model``'s parameters where they
    are, ``generator`` registered with the graph), else the eager loop."""
    if not _use_graph(model, graph):
        def run(batches):
            per_step = [step({k: v[i] for k, v in batches.items()})
                        for i in range(_rows(batches))]
            return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

        return run

    graphed = _StepGraph(step, generator)
    return lambda batches: graphed(batches, lambda: [*model.parameters(), *model.buffers()])


def make_iwae_step(
    model, k: int = 64, generator: torch.Generator | None = None
) -> Callable[[dict[str, Any]], dict[str, torch.Tensor]]:
    """IWAE step: ``iwae_step(batch) -> {"log_likelihood": (B,)}``, each
    example's estimate (``core.iwae_bound``) times its row of the batch's
    ``valid`` mask, so a pad row gives exactly 0 (the JAX ``scan`` body,
    ``mmvae_tpu/api.py:1278-1285``). The noise is ``batch["eps"]``
    ``(B, k, L)`` when the batch carries it, else a draw from
    ``generator``. Run without autograd."""

    @torch.no_grad()
    def iwae_step(batch):
        data = {name: v for name, v in batch.items() if name not in ("valid", "eps")}
        ll = iwae_bound(model, data, k, generator=generator, eps=batch.get("eps"))
        return {"log_likelihood": ll * batch["valid"]}

    return iwae_step


def make_iwae_runner(
    model, k: int = 64, *, graph: bool | None = None,
    generator: torch.Generator | None = None,
) -> Callable[[dict[str, Any]], dict[str, torch.Tensor]]:
    """IWAE over pre-stacked ``(n_batches, B, ...)`` tensors with a
    ``valid`` ``(n_batches, B)`` mask and optionally ``eps`` ``(n_batches,
    B, k, L)``. Returns ``run(batches) -> {"log_likelihood": (n_batches,
    B)}``, pad rows 0.

    On the card the split is the JAX ``log_likelihood``'s one program
    (``lax.scan``, ``mmvae_tpu/api.py:1274-1290``) as replays of one
    captured batch (:class:`_StepGraph`), which reads ``model``'s
    parameters where they are; ``generator`` is registered with the
    graph, so each replay draws the noise an eager batch would.
    ``graph=False`` asks for the eager loop on the card, one batch at a
    time, which the CPU always runs.
    """
    return _split_runner(make_iwae_step(model, k, generator), model, graph, generator)
