"""The multi-term loss, the train step and the eval step.

Port of ``mmvae_tpu/train/step.py``: all four objectives (``"mvae"``,
``"mmvae"``, ``"mopoe"``, ``"mvtcae"``) and every loss knob of the JAX
``multi_term_loss``, with an optional presence mask, under its three term
folds: t-major (``term_fold="t"``, the single-device path of both the JAX
eval and the JAX train step, ``step.py:532-578``), b-major (``"b"``,
``:579-631``) and shard-local t-major (``"st"``, ``:632-697``), and data
parallel over a mesh of processes (``parallel.make_mesh``): each rank
runs its rows of the global batch, and the step reduces the gradient once.

  * encoders run ONCE per modality -> ``(B, M, L)`` expert stack;
  * the ``(T, M)`` term masks: under mvae the joint, the M unimodal terms
    and, in training, ``n_random_subsets`` random ones (CelebA: T = 1 + 19
    + 4); under mmvae and mopoe the mixture's components
    (``core.component_masks``: the identity; every nonempty subset, or
    the joint and the unimodal rows past 8 modalities); under mvtcae the
    joint (decoded) and the unimodal rows (read by the cross-KLs);
  * masked PoE fusion over the masks -> ``(T, B, L)``, and the KL of all
    ``T * B`` posteriors, in one ``ops.poe_kl`` call: one kernel on the
    card, K1's function as the PoE's epilogue (the JAX step leaves the
    same fusion to XLA);
  * member-pruned decoding (``_member_prune_keys`` / ``_pruned_nll``,
    mvae only): each decode key decodes only its possibly-member term
    rows, folded t-major into one ``(tk * B, L)`` batch; or, under
    ``cross_recon``, ``member_prune=False`` or any other objective, the
    decode-all pass: every key decodes all ``T * B`` rows once;
  * each key's NLL is one ``ops`` call, so on the card one eval batch
    launches the fused PoE + KL once and each NLL kernel once per decode
    key (MNIST: K2; MultiMNIST: K2, K3; CelebA: K2 for the image and K2
    for the 18 attributes, and K4 in the image encoder);
  * mixture objectives: every modality is a target of every term, and
    each example's terms are averaged over its valid ones
    (``step.py:746-761``); mvtcae mixes the KL with the cross-KLs of the
    joint to each observed unimodal posterior (``step.py:704-726``);
  * ``cross_recon``: every modality is a target of every subset term,
    cross entries weighed by ``cross_recon_weight`` (``step.py:762-778``),
    and with ``cross_recon_stopgrad`` taken from a second decode-all pass
    on detached decoders (``step.py:731-745``);
  * ``unimodal_align_weight``: the non-joint posteriors pulled toward the
    detached joint one (``step.py:787-810``);
  * the cycle term (``cycle_weight > 0``, ``step.py:811-937``): each
    sequence modality's unimodal z is rendered into the bernoulli
    modalities, re-encoded with only those observed, and the sequence is
    read back from the posterior mean; its CE joins the loss, and with
    ``cycle_contrast_weight`` the render's moment gap to the true image.

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
them as eager loops. Every constant a step makes is made on the device or
cached before the capture (``_device_tensor``). Its reductions are
differentiable on both
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
input is the render). A mixture step launches what the decode-all pass
of its T terms does: one MNIST mmvae, mopoe or mvtcae step the fused PoE
+ KL and K2 once each, forward and backward; one CelebA mopoe step (T =
20) the fused PoE + KL once, K2 twice (the image and the attributes on
all 20 terms) and K4 once.

The IWAE runner (``make_iwae_step``, ``make_iwae_runner``) runs
``core.iwae_bound`` over an eval split, its k samples folded b-major, on
the same graph machinery; on the card one of its batches launches the
fused PoE + KL once and each NLL kernel once per decode key through the
b-major row maps (CelebA: K2 twice, the attributes through the map over
examples of 18 rows; MultiMNIST and CUB: K2 and K3), and K4 once on
CelebA and CUB. Its proposal is the joint PoE posterior under every
objective, as in the JAX package.

Under ``"b"`` the decoders read rows ``b * T + t``, and the NLL kernels
read the untiled targets through their b-major maps (CelebA's attributes
through K2's map over examples of 18 rows, forward and backward); under
``"st"`` each rank folds its own rows t-major, as ``"t"`` does. Both take
the fused PoE + KL's ``(T, B, L)`` posteriors through a ``(B, T, L)``
view and draw the noise in that layout. With a mesh the step all-reduces
one flat buffer of every gradient and loss metric (a graph on the card
holds the NCCL collective), and the eval and IWAE runners reduce their
stacked values once after the split. A sharded state steps on its blocks
(FSDP: an all-gather of the parameters before the forward and a
reduce-scatter of the gradients after the backward; tensor parallelism:
the model group's collectives inside the layers, the all-reduce over the
data group), on the same runners (``make_train_step``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.func import functional_call

from mmvae_torch import ops
from mmvae_torch.core import (
    OBJECTIVES,
    annealing_factor,
    component_masks,
    elbo_subset_masks,
    elbo_terms,
    iwae_bound,
    kl_gauss_gauss,
    random_subset_masks,
    reparameterize,
)
from mmvae_torch.core.mixture import _MOPOE_POWERSET_MAX
from mmvae_torch.data.pipelines import presence_from_keep, sample_presence
from mmvae_torch.ops import kernels
from mmvae_torch.ops.kernels import FOLD_B, FOLD_T, tile_rows
from mmvae_torch.parallel.pp import is_pipelined
from mmvae_torch.train.state import TrainState

__all__ = [
    "multi_term_loss",
    "make_train_step",
    "make_epoch_runner",
    "make_gather_epoch_runner",
    "epoch_order",
    "presence_from_keep",
    "make_eval_step",
    "make_eval_runner",
    "make_iwae_step",
    "make_iwae_runner",
]

_BINARIZE = (False, True, "both")
TERM_FOLDS = ("t", "b", "st")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to mmvae_torch")


def _check_fold(objective: str, term_fold: str, mesh) -> None:
    """Raise on an unknown objective or fold, and on ``"st"`` without a
    mesh (``step.py:641-642``)."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    if term_fold not in TERM_FOLDS:
        raise ValueError(f"unknown term_fold {term_fold!r}; have {TERM_FOLDS}")
    if term_fold == "st" and mesh is None:
        raise ValueError("term_fold='st' requires a mesh")


def _draw(make: Callable, shape: tuple, mesh, dim: int = 0) -> torch.Tensor:
    """``make(shape)``, a draw whose axis ``dim`` is the batch: with a mesh
    drawn at the global shape (that axis times the ranks) and this rank's
    rows kept, so every world size draws the same numbers from a generator
    kept in lockstep (``mmvae_tpu/train/step.py:579-598``); on a ``(data,
    model)`` mesh the ranks of a model group keep the same rows."""
    if mesh is None or mesh.n_shards == 1:
        return make(shape)
    glob = list(shape)
    glob[dim] *= mesh.n_shards
    return mesh.rows(make(tuple(glob)), dim)


def _randn(generator, device, dtype) -> Callable:
    return lambda shape: torch.randn(shape, generator=generator, device=device, dtype=dtype)


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


def _dequant_data(data: dict, dtype: torch.dtype = torch.float32) -> dict:
    """uint8 leaves of a batch (a ``data_dtype="uint8"`` train split:
    quantized [0, 1] data, ``data/pipelines.py::quantize_uint8``) in [0, 1]
    in ``dtype``, the model's compute dtype, inside the step
    (``mmvae_tpu/train/step.py:127-152``, ``:520``), so the epoch's gathers
    move uint8. A division by 255 in ``dtype``, not a product with its
    reciprocal, so 255 gives exactly 1 and each value what a division in
    ``dtype`` gives; the divisor is a device tensor, because torch on the
    card takes a CPU scalar divisor as a product with its reciprocal. Other
    leaves stay as they are: bf16 meets an f32 model as Flax's
    ``promote_dtype`` meets it (``models/experts.py``), and goes to the BCE
    kernel and K4 as it is."""
    return {
        k: v.to(dtype) / _device_tensor((255.0,), v.device, dtype)
        if v.dtype == torch.uint8 else v
        for k, v in data.items()
    }


def _seq_tiled(model, data: dict, n_rows: int, fold: int = FOLD_T) -> dict:
    """``data`` with each sequence modality's tokens tiled to ``n_rows``
    rows, t-major (``FOLD_T``, as ``_tile_terms_tmajor`` feeds them in the
    JAX step) or b-major (``FOLD_B``, ``_tile_terms``): the teacher-forced
    decoders read them."""
    seq_names = [s.name for s in model.specs() if s.kind == "seq"]
    return {**data, **{n: tile_rows(data[n], n_rows, fold) for n in seq_names}}


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


def _pruned_nll_b(model, z: torch.Tensor, data: dict, prune_keys) -> torch.Tensor:
    """Member-only decode+NLL under the b-major fold (``_pruned_nll``'s
    ``"b"`` layout, ``step.py:205-272``): ``z`` is ``(B, T, L)``, each
    key's member rows folded b-major into ``B * tk`` rows, the sequence
    targets tiled b-major and the others read untiled through ``fold="b"``
    (CelebA's attributes through the map over examples of 18 rows).
    Returns ``(T, M, B)``, exact zeros outside the member rows."""
    b, n_terms = z.shape[0], z.shape[1]
    out = z.new_zeros((n_terms, model.n_modalities, b))
    tiled_by_tk: dict[int, dict] = {}
    for key, (rows, mods) in prune_keys.items():
        tk = len(rows)
        if tk not in tiled_by_tk:
            tiled_by_tk[tk] = _seq_tiled(model, data, b * tk, FOLD_B)
        targets = tiled_by_tk[tk]
        r = _device_tensor(tuple(rows), z.device)
        m = _device_tensor(tuple(mods), z.device)
        z_k = z.index_select(1, r).reshape(b * tk, -1)
        recon = model.decode_one(key, z_k, targets)
        nll_k = model.nll_one(key, recon, targets, fold="b")  # (M_k, b * tk)
        val = nll_k.reshape(len(mods), b, tk).permute(2, 0, 1)  # (tk, M_k, b)
        out[r[:, None], m[None, :]] = val
    return out


def _decode_all_nll_b(model, z: torch.Tensor, data: dict) -> torch.Tensor:
    """The decode-all pass under the b-major fold (``step.py:602-631``):
    every decode key decodes all ``B * T`` rows of ``z`` ``(B, T, L)``
    once, row ``b * T + t``. Returns ``(T, M, B)``."""
    b, n_terms = z.shape[0], z.shape[1]
    targets = _seq_tiled(model, data, b * n_terms, FOLD_B)
    z_flat = z.reshape(b * n_terms, -1)
    order, rows = [], []
    for key, mods in model.decode_key_modalities().items():
        recon = model.decode_one(key, z_flat, targets)
        rows.append(model.nll_one(key, recon, targets, fold="b"))  # (M_k, B * T)
        order += mods
    if order != list(range(model.n_modalities)):
        raise _not_ported("decode keys out of modality order")
    return torch.cat(rows).reshape(model.n_modalities, b, n_terms).permute(2, 0, 1)


def _pruned_nll(model, z: torch.Tensor, data: dict, prune_keys, term_fold: str) -> torch.Tensor:
    """The member-only pass of ``term_fold`` on ``z`` in its layout (as
    :func:`_decode_all_nll` takes it). Returns ``(T, M, B)``."""
    if term_fold == "b":
        return _pruned_nll_b(model, z, data, prune_keys)
    return _pruned_nll_t(model, z if term_fold == "t" else z.transpose(0, 1), data, prune_keys)


def _decode_all_nll(model, z: torch.Tensor, data: dict, term_fold: str) -> torch.Tensor:
    """The decode-all pass of ``term_fold`` on ``z`` in its layout: ``(T,
    B, L)`` under ``"t"``, ``(B, T, L)`` under ``"b"`` and ``"st"`` (whose
    rank-local rows fold t-major). Returns ``(T, M, B)``."""
    if term_fold == "b":
        return _decode_all_nll_b(model, z, data)
    return _decode_all_nll_t(model, z if term_fold == "t" else z.transpose(0, 1), data)


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
    """``fn(model, *args)`` (``fn`` a function, or the name of a method of
    the model) as the forward of a module that holds the model, so that
    ``torch.func.functional_call`` can run it on other parameters."""

    def __init__(self, model, fn: str | Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        if callable(self.fn):
            return self.fn(self.model, *args)
        return getattr(self.model, self.fn)(*args)


def _decoders_detached(model, fn: str | Callable, *args, live: frozenset = frozenset()):
    """``fn(model, *args)`` (``fn`` as :class:`_Method` takes it) with the
    parameters of every decoder submodule (a top-level name that contains
    ``dec``, as ``_sg_decoder_params`` picks them, ``step.py:274-287``) but
    those named in ``live`` detached. The gradient still flows through the
    decoders' activations to their inputs and on to the encoders; only the
    decoders' weights get none of it."""
    detached = {
        f"model.{name}": p.detach()
        for name, p in model.named_parameters()
        if "dec" in name.split(".", 1)[0] and name.split(".", 1)[0] not in live
    }
    return functional_call(_Method(model, fn), detached, args)


def _straight_through(p: torch.Tensor) -> torch.Tensor:
    """The cycle render's hard form (``step.py:885-900``): the 0/1
    threshold at 0.5 forward, the identity backward."""
    return p + ((p > 0.5).to(p.dtype) - p).detach()


def _unimodal_term_row(objective: str, n_mod: int, m_i: int) -> int:
    """The row of modality ``m_i``'s unimodal term in the objective's masks
    (``step.py:156-172``): the identity's row under mmvae, the singleton's
    bit-order row ``2**m_i - 1`` under mopoe's powerset, else ``1 + m_i``
    (the mvae layout, and mopoe's fallback family past 8 modalities)."""
    if objective == "mmvae":
        return m_i
    if objective == "mopoe" and n_mod <= _MOPOE_POWERSET_MAX:
        return 2**m_i - 1
    return 1 + m_i


def _moment_gap(render: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The cycle contrast penalty of each example (``step.py:897-913``):
    the squared gaps between the render's and the true image's pixel mean
    and population std (``jnp.std``'s, ``correction=0``), ``(B,)``."""
    x = target.to(render.dtype)
    dims = tuple(range(1, render.ndim))
    dm = render.mean(dims) - x.mean(dims)
    dsd = render.std(dims, correction=0) - x.std(dims, correction=0)
    return dm * dm + dsd * dsd


def _cycle_terms(
    model, z_of: dict[int, torch.Tensor], data: dict, presence: torch.Tensor | None,
    render_grad: bool, binarize: bool | str, contrast: bool,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The cycle term's CE and, with ``contrast``, its contrast penalty
    (``step.py:811-937``): for each sequence modality s, its unimodal z
    ``z_of[s]`` is rendered into the bernoulli modalities (their decoders
    live only with ``render_grad``), as the soft render sigmoid(logits),
    its straight-through 0/1 threshold or both (``binarize`` False, True,
    "both"). Each form is re-encoded with the bernoulli modalities alone
    observed (one ``ops.poe_kl`` call, T = 1: only the posterior mean is
    used) and s is read back, teacher-forced from that mean, with every
    decoder detached. The CE (the two forms' averaged under "both"), times
    s's presence where given, is meaned over the batch and weighed by
    lambda_s. The contrast penalty (:func:`_moment_gap`) is taken on the
    soft render of each bernoulli modality, times s's presence, meaned
    over the batch and summed."""
    specs = model.specs()
    seq_idx = [i for i, s in enumerate(specs) if s.kind == "seq"]
    ber_idx = [i for i, s in enumerate(specs) if s.kind == "bernoulli"]
    # Re-encode presence: only the rendered modalities are observed.
    ber_mask = _device_tensor(
        ((tuple(float(i in ber_idx) for i in range(len(specs)))),), model.device, torch.float32)
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

    zero = next(iter(z_of.values())).new_zeros(())
    cycle_ce, cycle_contrast = zero, zero if contrast else None
    for s_i in seq_idx:
        z_s = z_of[s_i]
        soft, hard = dict(data), dict(data)
        for m_i in ber_idx:
            name = specs[m_i].name
            p = torch.sigmoid(_decoders_detached(model, "decode_one", name, z_s, data, live=live))
            soft[name], hard[name] = p, _straight_through(p)
            if contrast:
                pen = _moment_gap(p, data[name])
                if presence is not None:
                    pen = pen * presence[:, s_i]
                cycle_contrast = cycle_contrast + torch.mean(pen)
        if binarize == "both":
            ce = 0.5 * (re_read_ce(soft, s_i) + re_read_ce(hard, s_i))
        else:
            ce = re_read_ce(hard if binarize else soft, s_i)
        if presence is not None:
            ce = ce * presence[:, s_i]
        cycle_ce = cycle_ce + lambdas[s_i] * torch.mean(ce)
    return cycle_ce, cycle_contrast


def _check_knobs(
    model, objective: str, *, n_random_subsets: int, cross_recon: bool,
    cross_recon_stopgrad: bool, unimodal_align_weight: float, cycle_weight: float,
    cycle_render_binarize, cycle_contrast_weight: float,
) -> None:
    """The JAX loss's ``ValueError``s on knobs that do not go together
    (``step.py:473-516``, ``:817-825``, ``:943-947``)."""
    if objective == "mvae":
        if cross_recon_stopgrad and not cross_recon:
            raise ValueError("cross_recon_stopgrad=True requires cross_recon=True")
    elif n_random_subsets or cross_recon or cross_recon_stopgrad or unimodal_align_weight:
        raise ValueError(
            "n_random_subsets/cross_recon*/unimodal_align_weight are mvae term-structure "
            f"knobs; the {objective!r} objective has its own cross-modal mechanism "
            "(mixture decode-all / the alpha cross-KLs)")
    if cycle_weight > 0.0:
        kinds = [s.kind for s in model.specs()]
        if "seq" not in kinds or "bernoulli" not in kinds:
            raise ValueError("cycle_weight needs a seq and a bernoulli modality")
        if cycle_render_binarize not in _BINARIZE:
            raise ValueError(
                "cycle_render_binarize must be False, True, or 'both'; "
                f"got {cycle_render_binarize!r}")
    elif cycle_contrast_weight > 0.0:
        raise ValueError(
            "cycle_contrast_weight requires cycle_weight > 0 "
            "(the penalty applies to the cycle term's render)")


def _term_present(masks: torch.Tensor, presence: torch.Tensor | None, b: int) -> torch.Tensor:
    """``(T, B)`` bool: whether term t of example b holds an observed
    modality (its presence-effective mask is nonempty)."""
    if presence is None:
        return (masks.sum(-1) > 0)[:, None].expand(-1, b)
    return (masks[:, None, :] * presence[None]).sum(-1) > 0


def multi_term_loss(
    model,
    batch: dict[str, Any],
    beta: float = 1.0,
    *,
    sample: bool = True,
    cross_recon: bool = False,
    cross_recon_weight: float = 1.0,
    cross_recon_stopgrad: bool = False,
    unimodal_align_weight: float = 0.0,
    cycle_weight: float = 0.0,
    cycle_render_grad: bool = False,
    cycle_contrast_weight: float = 0.0,
    cycle_render_binarize: bool | str = False,
    objective: str = "mvae",
    mvtcae_alpha: float = 0.9,
    member_prune: bool = True,
    term_fold: str = "t",
    n_random_subsets: int = 0,
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
    subset_masks: torch.Tensor | None = None,
    cycle_eps: torch.Tensor | None = None,
    mesh=None,
):
    """Total multi-term ELBO loss (batch mean) and per-term metrics.

    ``batch`` maps modality names to targets (uint8 ones are quantized
    [0, 1] data, dequantized first: :func:`_dequant_data`), plus an optional
    ``"presence"`` key: a ``(B, M)`` float mask of the modalities each
    example carries. An unobserved modality contributes neither an expert
    nor a recon target; an example with no modality fuses to the prior
    and contributes exactly 0 (how eval masks its padding rows).

    The terms follow ``objective`` (``step.py:473-516``):

      * ``"mvae"``: the joint, the M unimodal ones and ``n_random_subsets``
        random subsets (``subset_masks`` ``(k, M)``, or a Bernoulli(0.5)
        draw from ``generator`` before the noise's; an empty subset fuses
        to the prior, KL 0, and reconstructs nothing), each reconstructing
        its own modalities (with ``cross_recon``, every modality); ``T = 1
        + M + k``;
      * ``"mmvae"`` / ``"mopoe"``: one term per mixture component
        (``core.component_masks``), every modality reconstructed from each,
        and each example's terms averaged over its valid components (those
        holding an observed modality);
      * ``"mvtcae"``: one term, the joint posterior reconstructing every
        modality, its KL ``(1 - a) KL(q_joint || p) + a mean_m KL(q_joint ||
        q_m)`` over the observed modalities, ``a = mvtcae_alpha``; the
        metrics carry ``cross_kl``. The joint and the unimodal posteriors
        come from one ``ops.poe_kl`` call under the mvae masks; only the
        joint row is decoded.

    ``sample=False`` takes z = posterior mean (eval). With ``sample=True``
    the noise comes from ``eps`` or ``generator``, in the layout of the
    fold's posteriors: ``(T, B, L)`` under ``term_fold="t"``, ``(B, T,
    L)`` under ``"b"`` and ``"st"`` (JAX's layouts, so a parity run can
    pass JAX's noise in).

    ``term_fold`` (``step.py:532-697``) folds the terms into the decoders'
    rows: ``"t"`` t-major (row ``t * B + b``), ``"b"`` b-major (row ``b *
    T + t``; the targets stay untiled and the NLL kernels read them through
    their b-major maps), ``"st"`` (needs ``mesh``) the posteriors and the
    draw in the ``"b"`` layout and each rank's own rows folded t-major.
    The fused PoE + KL is one ``ops.poe_kl`` call under every fold; ``"b"``
    and ``"st"`` read its ``(T, B, L)`` posteriors through a ``(B, T, L)``
    view. ``mesh`` (``parallel.make_mesh``): ``batch`` holds this rank's
    rows of the global batch, and every draw (the noise, the mvtcae cycle
    noise) is made at the global shape and this rank's rows kept; the
    loss is this rank's mean, which the train step averages over the
    ranks. ``eps`` and ``cycle_eps`` passed in are this rank's rows.
    ``cross_recon``, ``cross_recon_weight``, ``cycle_weight``,
    ``cycle_render_grad`` and ``cycle_render_binarize`` are those of the
    JAX loss (module docstring); with ``cycle_weight > 0`` the metrics
    carry ``cycle_ce``. The cycle term reads each sequence modality's
    unimodal term under the objective (``_unimodal_term_row``); under
    ``"mvtcae"`` it draws z from the unimodal posterior with noise
    ``cycle_eps`` (``(S, B, L)``, one row per sequence modality in order)
    or from ``generator``.

    ``cross_recon_stopgrad`` (needs ``cross_recon``): a second decode-all
    pass on detached decoders gives the cross entries, so their gradient
    reaches the encoders only. ``unimodal_align_weight``: ``w * beta *
    KL(q(z|S) || sg(q(z|joint)))`` summed over the non-joint terms S that
    hold an observed modality and meaned over the batch (metric
    ``align_kl``). ``cycle_contrast_weight`` (needs ``cycle_weight``): the
    moment gap of the soft render to the true image (metric
    ``cycle_contrast``). The mixture objectives refuse ``n_random_subsets``,
    ``cross_recon*`` and ``unimodal_align_weight`` as the JAX loss does.
    """
    _check_fold(objective, term_fold, mesh)
    _check_knobs(
        model, objective, n_random_subsets=n_random_subsets, cross_recon=cross_recon,
        cross_recon_stopgrad=cross_recon_stopgrad, unimodal_align_weight=unimodal_align_weight,
        cycle_weight=cycle_weight, cycle_render_binarize=cycle_render_binarize,
        cycle_contrast_weight=cycle_contrast_weight)
    n_mod = model.n_modalities
    if objective in ("mvae", "mvtcae"):
        masks = elbo_subset_masks(n_mod, device=model.device)  # (1 + M, M)
    else:
        masks = component_masks(objective, n_mod, device=model.device)  # (K, M)
    if n_random_subsets > 0:
        if subset_masks is None:
            subset_masks = random_subset_masks(
                generator, n_random_subsets, n_mod, device=model.device)
        masks = torch.cat([masks, subset_masks.to(masks.dtype)])  # (T, M)

    presence = batch.get("presence")  # used as it is, never dequantized
    data = _dequant_data({k: v for k, v in batch.items() if k != "presence"},
                         getattr(model, "dtype", torch.float32))

    mu_e, lv_e = model.encode(data)  # (B, M, L)
    # (T, B, L) posteriors under the masks times the presence, (T, B) KLs
    fused_mu, fused_lv, kl = ops.poe_kl(mu_e, lv_e, masks, presence)
    if objective == "mvtcae":
        # Row 0 (the joint) is the one term; rows 1..M are the unimodal
        # posteriors the cross-KLs and the cycle term read.
        uni_mu, uni_lv = fused_mu[1:], fused_lv[1:]  # (M, B, L)
        fused_mu, fused_lv, kl, masks = fused_mu[:1], fused_lv[:1], kl[:1], masks[:1]
    b = fused_mu.shape[1]
    if term_fold == "t":
        q_mu, q_lv = fused_mu, fused_lv  # (T, B, L)
    else:
        # (B, T, L), the layout of the JAX fusion under "b" and "st"
        # (``step.py:579-598``): the kernel's (T, B, L) through a view.
        q_mu, q_lv = fused_mu.transpose(0, 1), fused_lv.transpose(0, 1)
    if sample and eps is None:
        eps = _draw(_randn(generator, q_mu.device, q_mu.dtype), tuple(q_mu.shape), mesh,
                    1 if term_fold == "t" else 0)
    z = reparameterize(q_mu, q_lv, sample=sample, eps=eps)
    if member_prune and objective == "mvae" and not cross_recon:
        prune_keys = _member_prune_keys(model, n_mod, masks.shape[0])
    else:
        prune_keys = None
    if prune_keys is not None:
        nll = _pruned_nll(model, z, data, prune_keys, term_fold)  # (T, M, B)
    else:
        nll = _decode_all_nll(model, z, data, term_fold)
    if presence is not None:
        nll = nll * presence.T[None]  # unobserved modalities are no targets
    if cross_recon_stopgrad:
        # The cross entries from detached decoders: the same values, a
        # gradient that reaches the encoders only (``step.py:731-745``).
        nll_sg = _decoders_detached(model, _decode_all_nll, z, data, term_fold)
        if presence is not None:
            nll_sg = nll_sg * presence.T[None]
        own = masks[:, :, None]
        nll = own * nll + (1.0 - own) * nll_sg
    present = _term_present(masks, presence, b)  # (T, B)
    term_weights = None
    if objective != "mvae":
        # Every modality is a target of every term, and each example's
        # terms are averaged over its valid ones (``step.py:746-761``).
        recon_masks = torch.ones_like(masks)
        valid = present.to(nll.dtype)
        term_weights = valid / torch.clamp(valid.sum(0, keepdim=True), min=1.0)
    elif cross_recon:
        # Every modality is a target of every nonempty subset term; cross
        # entries weigh cross_recon_weight.
        nonempty = (masks.sum(-1, keepdim=True) > 0).to(masks.dtype)
        recon_masks = (masks + cross_recon_weight * (1.0 - masks)) * nonempty
    else:
        recon_masks = masks
    if objective == "mvtcae":
        # KL(q_joint || q_m) for each observed m, averaged over them.
        cross = kl_gauss_gauss(fused_mu, fused_lv, uni_mu, uni_lv)  # (M, B)
        obs = present.new_ones((n_mod, b)) if presence is None else presence.T > 0
        obs = obs.to(cross.dtype)
        cross_kl = (cross * obs).sum(0) / torch.clamp(obs.sum(0), min=1.0)  # (B,)
        kl = (1.0 - mvtcae_alpha) * kl + mvtcae_alpha * cross_kl[None]
    loss, metrics = elbo_terms(nll, kl, recon_masks, model.lambdas(), beta, term_weights)
    if objective == "mvtcae":
        metrics["cross_kl"] = torch.mean(cross_kl)
    if unimodal_align_weight > 0.0:
        # Each non-joint term's posterior pulled toward the detached joint
        # one, ramped by beta (``step.py:787-810``); the metric is the raw KL.
        align = kl_gauss_gauss(fused_mu[1:], fused_lv[1:],
                               fused_mu[:1].detach(), fused_lv[:1].detach())  # (T - 1, B)
        align_kl = torch.mean(torch.sum(align * present[1:].to(align.dtype), dim=0))
        loss = loss + unimodal_align_weight * beta * align_kl
        metrics = dict(metrics, loss=loss, align_kl=align_kl)
    if cycle_weight > 0.0:
        seq_idx = [i for i, s in enumerate(model.specs()) if s.kind == "seq"]
        if objective == "mvtcae":
            # No unimodal term is decoded: draw the s-only latent from the
            # unimodal posterior, with its own noise (``step.py:855-865``).
            z_of = {}
            for j, s_i in enumerate(seq_idx):
                c_eps = None if cycle_eps is None else cycle_eps[j]
                if sample and c_eps is None:
                    c_eps = _draw(_randn(generator, uni_mu.device, uni_mu.dtype),
                                  tuple(uni_mu[s_i].shape), mesh)
                z_of[s_i] = reparameterize(uni_mu[s_i], uni_lv[s_i], sample=sample, eps=c_eps)
        else:
            rows = {s_i: _unimodal_term_row(objective, n_mod, s_i) for s_i in seq_idx}
            z_of = {s_i: z[r] if term_fold == "t" else z[:, r] for s_i, r in rows.items()}
        cycle_ce, cycle_contrast = _cycle_terms(
            model, z_of, data, presence, cycle_render_grad, cycle_render_binarize,
            cycle_contrast_weight > 0.0)
        loss = loss + cycle_weight * cycle_ce
        metrics = dict(metrics, loss=loss, cycle_ce=cycle_ce)
        if cycle_contrast is not None:
            loss = loss + cycle_contrast_weight * cycle_contrast
            metrics = dict(metrics, loss=loss, cycle_contrast=cycle_contrast)
    return loss, metrics


def make_train_step(
    model,
    *,
    n_random_subsets: int = 0,
    annealing_steps: int = 0,
    p_modality_drop: float = 0.0,
    cross_recon: bool = False,
    cross_recon_weight: float = 1.0,
    cross_recon_stopgrad: bool = False,
    unimodal_align_weight: float = 0.0,
    cycle_weight: float = 0.0,
    cycle_render_grad: bool = False,
    cycle_contrast_weight: float = 0.0,
    cycle_render_binarize: bool | str = False,
    objective: str = "mvae",
    mvtcae_alpha: float = 0.9,
    member_prune: bool = True,
    term_fold: str = "t",
    generator: torch.Generator | None = None,
    mesh=None,
) -> Callable:
    """The train step ``(state, batch, eps=None, keep=None,
    subset_masks=None, cycle_eps=None, commit=None) -> (state, metrics)``
    of ``_train_step_impl`` (``step.py:1022-1093``).

    beta is ``annealing_factor(state.device_step, annealing_steps)``, read
    on the device. With
    ``p_modality_drop > 0`` and no ``"presence"`` in the batch, each
    example keeps each modality with probability ``1 - p_modality_drop``
    (``keep``, ``(B, M)``, or a draw from ``generator``), and a row with
    none kept keeps all. The loss is :func:`multi_term_loss` with
    ``sample=True`` and the loss knobs given here, its ``n_random_subsets``
    masks ``subset_masks`` (``(k, M)``) or a draw from ``generator``, its
    noise ``eps`` (in the fold's layout, :func:`multi_term_loss`) and, for
    the cycle term under mvtcae, ``cycle_eps`` (``(S, B, L)``) or draws
    from ``generator`` (on the model's device).
    Then one micro-step of ``state`` (:meth:`TrainState.apply_gradients`:
    an update, or with the state's ``accum_steps > 1`` the gradients into
    its running mean and an update on the commit micro-step, ``commit``
    when given). The metrics are the loss terms, ``beta`` and
    ``grad_norm``, the global norm of the micro-batch's raw gradients
    before clipping.

    With a ``mesh`` (``parallel.make_mesh``) the batch is this rank's rows
    of the global batch and the step is one rank's part of the JAX step on
    a data mesh: the dropout ``keep`` and every noise are drawn at the
    global shape and this rank's rows kept (``generator`` in lockstep on
    every rank), and after the backward every gradient and every loss
    metric goes into one flat buffer, all-reduced once (a sum, then a
    division by the ranks: the mean of the ranks' means is the global
    batch's mean, as GSPMD's reduction gives it). ``grad_norm``, clipping,
    the EMA and each micro-step of accumulation then read the averaged
    gradient on every rank.

    A sharded state (``state.layout``) takes the same step on its blocks.
    Under FSDP (a data ``mesh``) the step first gathers the blocks into the
    working copy of the whole parameters (``state.compute_model``, one
    all-gather), computes the loss and the backward on it, reduces each
    sharded gradient to this rank's block (one reduce-scatter, a mean over
    the ranks) and the replicated ones with the metrics in the all-reduce.
    Under tensor parallelism (a ``(data, model)`` ``mesh`` and a model built
    with it) the model's layers run their model-group collectives inside
    the forward and the backward, and the all-reduce spans the data group
    only. Under pipeline parallelism (a ``(data, pipe)`` ``mesh``) the
    trunks run the schedule over the pipe group and each rank holds its
    stages, whose gradients are averaged over the data group; the rest and
    the metrics are averaged over every rank of the mesh, so that the ranks
    of a pipe group, which hold the same rows, keep their copies of the
    replicated parameters equal to the bit whatever algorithm each rank's
    convolutions took. ``grad_norm`` and the clipping read the whole tree's
    norm.
    """
    _check_fold(objective, term_fold, mesh)
    _check_knobs(
        model, objective, n_random_subsets=n_random_subsets, cross_recon=cross_recon,
        cross_recon_stopgrad=cross_recon_stopgrad, unimodal_align_weight=unimodal_align_weight,
        cycle_weight=cycle_weight, cycle_render_binarize=cycle_render_binarize,
        cycle_contrast_weight=cycle_contrast_weight)
    loss_kwargs = dict(
        n_random_subsets=n_random_subsets, cross_recon=cross_recon,
        cross_recon_weight=cross_recon_weight, cross_recon_stopgrad=cross_recon_stopgrad,
        unimodal_align_weight=unimodal_align_weight, cycle_weight=cycle_weight,
        cycle_render_grad=cycle_render_grad, cycle_contrast_weight=cycle_contrast_weight,
        cycle_render_binarize=cycle_render_binarize, objective=objective,
        mvtcae_alpha=mvtcae_alpha, member_prune=member_prune, term_fold=term_fold, mesh=mesh,
    )

    def train_step(state: TrainState, batch, eps=None, keep=None, subset_masks=None,
                   cycle_eps=None, commit=None):
        layout = state.layout
        fsdp = layout is not None and layout.work is not None
        compute = state.compute_model
        if fsdp:  # the whole parameters from every rank's blocks
            layout.gather_into(state.model, compute)
            for p in compute.parameters():
                p.grad = None
        beta = annealing_factor(state.device_step, annealing_steps)
        if p_modality_drop > 0.0 and "presence" not in batch:
            b = next(iter(batch.values())).shape[0]
            if keep is None:
                presence = _draw(lambda shape: sample_presence(
                    generator, shape[0], shape[1], p_modality_drop, device=model.device),
                    (b, model.n_modalities), mesh)
            else:
                presence = sample_presence(generator, b, model.n_modalities, p_modality_drop,
                                           keep=keep, device=model.device)
            batch = dict(batch, presence=presence)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = multi_term_loss(
            compute, batch, beta, sample=True, generator=generator, eps=eps,
            subset_masks=subset_masks, cycle_eps=cycle_eps, **loss_kwargs,
        )
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if fsdp:
            # The sharded gradients to the blocks (a reduce-scatter); the
            # replicated ones with the metrics in the all-reduce.
            rest = layout.reduce_scatter_grads(compute, state.model)
            metrics = _all_reduce_mean(rest, metrics, mesh)
        else:
            named = list(state.model.named_parameters())
            for _, p in named:  # a parameter the loss does not reach has gradient 0
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if mesh is not None:
                staged = layout is not None and layout.kind == "pp"
                own = {n for n, _ in named if staged and layout.sharded(n)}
                metrics = _all_reduce_mean([p.grad for n, p in named if n not in own], metrics,
                                           mesh, staged=[p.grad for n, p in named if n in own])
        metrics["grad_norm"] = state.grad_norm()
        metrics["beta"] = beta
        state.apply_gradients(commit)
        return state, metrics

    return train_step


def _mean_over(parts: list[torch.Tensor], group, n: int) -> list[torch.Tensor]:
    """``parts`` averaged over the ``n`` ranks of ``group`` in one
    all-reduce of one flat f32 buffer (a sum, then a division: gloo has no
    average): flat views of the means, in order."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in parts])
    dist.all_reduce(flat, group=group)
    flat = flat / _device_tensor((float(n),), flat.device, torch.float32)
    return list(flat.split([t.numel() for t in parts]))


def _all_reduce_mean(grads: list[torch.Tensor], metrics: dict[str, torch.Tensor],
                     mesh, staged: list[torch.Tensor] = ()) -> dict[str, torch.Tensor]:
    """``grads`` (in place) and ``metrics`` averaged over the mesh's batch
    shards in one all-reduce over its data group. Returns the averaged
    metrics. With ``staged`` (pipeline parallelism: the gradients of this
    rank's stages, which the other ranks of its pipe group do not hold)
    those are averaged over the data group, and ``grads`` and ``metrics``
    over every rank of the mesh: each pipe group's ranks hold the same
    rows, so that is the same mean, and every rank reads the same bits."""
    group, n = mesh.data_group, mesh.n_shards
    if staged:
        if n > 1:
            for g, m in zip(staged, _mean_over(staged, group, n)):
                g.copy_(m.view_as(g))
        group, n = mesh.group, mesh.size
    means = _mean_over([*grads, *metrics.values()], group, n)
    for g, m in zip(grads, means):
        g.copy_(m.view_as(g))
    return {k: m.view_as(v).to(v.dtype) for (k, v), m in zip(metrics.items(), means[len(grads):])}


def _use_graph(model, graph: bool | None, mesh=None) -> bool:
    """Whether a runner over ``model`` replays a CUDA graph: on the card
    unless ``graph=False`` asks for the eager loop; never on the CPU. With a
    mesh whose group is not NCCL's (gloo syncs the host in each collective,
    which a graph cannot hold) the card runs the eager loop, and
    ``graph=True`` raises. So does a model whose trunks run the pipeline
    schedule (``parallel.pp``): whether a graph holds NCCL's sends and
    receives has not been tried on cards."""
    on_card = model.device.type == "cuda"
    if graph and not on_card:
        raise ValueError(f"a CUDA graph runner needs the model on the card, not {model.device}")
    capturable = mesh is None or mesh.backend == "nccl"
    if graph and not capturable:
        raise ValueError(f"a CUDA graph runner cannot hold a {mesh.backend} collective")
    if is_pipelined(model):
        if graph:
            raise ValueError("a CUDA graph runner does not hold the pipeline schedule's sends")
        return False
    return on_card and capturable if graph is None else graph


def _rows(batches: dict[str, torch.Tensor]) -> int:
    return next(iter(batches.values())).shape[0]


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every runner on ``device`` runs its first row and
    its capture on. One for the process: cuBLAS keeps a workspace for each
    stream it has run on until the process ends, so a new stream for each
    runner would leave one behind for each runner built."""
    return torch.cuda.Stream(device=device)


class _StepGraph:
    """``fn(batch, body) -> metrics`` over the rows of stacked ``(n, B,
    ...)`` inputs as replays of captured CUDA graphs, one a body: the
    counterpart of the body of the JAX runners' ``lax.scan``
    (``step.py:1096``, ``:1163``, ``:1580``). A runner has one body (an
    eval batch, a train step), or two (under gradient accumulation, a
    micro-step and a micro-step that commits the update); each call names
    the body of each row.

    A captured body reads row ``idx`` of static copies of the inputs
    (``index_select`` by a device index), writes each metric at row
    ``idx`` of static ``(n, ...)`` outputs and advances ``idx``, all on the
    device, so one replay follows another with no launch from the host
    between them. The bodies share the inputs, ``idx``, the outputs and
    one memory pool: they are replayed one at a time, and what one leaves
    alive the other only reads. The first call runs its rows eagerly on a
    side stream, as real steps, until each body has run once: that builds
    the kernels and makes the cached constants and the optimizer's state,
    which must exist before capture (a pageable upload or a sync under
    capture raises). It then captures each body on that stream and replays
    them for the other rows (a call whose rows run out first captures
    nothing, and the next call starts again). A later call copies its
    inputs into the static ones (one copy each, ordered on the stream
    after the replays that read them before), zeroes ``idx`` and replays
    every row; a call of fewer rows than the capture's (the short last
    segment of a streamed epoch) fills the leading rows and replays only
    those, so no step runs on a row it was not given. A capture that fails
    raises; nothing falls back to the eager loop.

    ``generator`` (the noise and dropout draws) is registered with every
    graph, so each replay draws the numbers an eager step would and
    advances the generator's state as one would. ``kernels.LAUNCHES``
    counts a launch when Python makes it, so each capture's counts are
    taken back and each replay of its body adds them again. The graphs
    hold the addresses of the tensors they read: the tensors ``tensors()``
    gives at each call must be those the capture saw, else the call
    raises.
    """

    def __init__(self, fn: Callable, generator: torch.Generator | None = None,
                 bodies: int = 1):
        self._fn, self._generator, self._bodies = fn, generator, bodies
        self._graphs = None

    def _body(self, body: int) -> None:
        batch = {k: v.index_select(0, self._idx)[0] for k, v in self._inputs.items()}
        metrics = self._fn(batch, body)
        if self._outputs is None:
            n = _rows(self._inputs)
            self._outputs = {k: v.new_empty((n, *v.shape)) for k, v in metrics.items()}
        for k, v in metrics.items():
            self._outputs[k].index_copy_(0, self._idx, v.unsqueeze(0))
        self._idx.add_(1)

    def _capture(self, batches: dict[str, torch.Tensor], which: list[int]) -> int:
        """Rows eagerly until every body has run, then the captures;
        returns the rows run eagerly (all of them when no capture)."""
        device = next(iter(batches.values())).device
        self._inputs = {k: v.clone() for k, v in batches.items()}
        self._idx = torch.zeros(1, dtype=torch.int64, device=device)
        self._outputs = None
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        ran: set[int] = set()
        eager = 0
        with torch.cuda.stream(side):
            while eager < len(which) and len(ran) < self._bodies:
                self._body(which[eager])
                ran.add(which[eager])
                eager += 1
        torch.cuda.current_stream(device).wait_stream(side)
        if len(ran) < self._bodies:
            return eager
        counts = dict(kernels.LAUNCHES)
        constants = _device_tensor.cache_info().currsize
        # Under capture the allocator takes new memory for the graph's pool
        # but frees none it has cached (neither free blocks nor the pools of
        # graphs already gone), so the capture starts with that cache given
        # back. ``torch.cuda.graph`` would also collect garbage each time;
        # no runner leaves any.
        torch.cuda.empty_cache()
        pool = torch.cuda.graph_pool_handle()
        graphs, self._launches = [], []
        for body in range(self._bodies):
            graph = torch.cuda.CUDAGraph()
            if self._generator is not None:
                graph.register_generator_state(self._generator)
            before = dict(kernels.LAUNCHES)
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool)
                try:
                    self._body(body)
                finally:
                    graph.capture_end()
            self._launches.append({k: kernels.LAUNCHES[k] - n for k, n in before.items()})
            graphs.append(graph)
        kernels.LAUNCHES.update(counts)
        if _device_tensor.cache_info().currsize != constants:
            raise RuntimeError("a constant was made under capture: its upload is not in the graph")
        torch.cuda.current_stream(device).wait_stream(side)
        self._graphs = graphs
        return eager

    def __call__(
        self, batches: dict[str, torch.Tensor], tensors: Callable[[], list] = list,
        which: list[int] | None = None,
    ) -> dict[str, torch.Tensor]:
        """Every row of ``batches`` through ``fn``, row ``i`` through body
        ``which[i]`` (all body 0 by default); each metric stacked."""
        n = _rows(batches)
        which = [0] * n if which is None else which
        if self._graphs is None:
            start = self._capture(batches, which)
            if self._graphs is not None:
                self._addresses = [t.data_ptr() for t in tensors()]
        else:
            if [t.data_ptr() for t in tensors()] != self._addresses:
                raise RuntimeError(
                    "the state's tensors moved since the graph was captured "
                    "(a reload with assign=True, a move, a new optimizer): build a new runner")
            for k, v in batches.items():
                want = self._inputs[k].shape
                if v.shape[1:] != want[1:] or v.shape[0] > want[0]:
                    raise ValueError(
                        f"{k}: {tuple(v.shape)} is not the captured {tuple(want)} "
                        "or fewer of its rows")
                self._inputs[k][:n].copy_(v)
            self._idx.zero_()
            start = 0
        for body in which[start:]:
            self._graphs[body].replay()
            for k, m in self._launches[body].items():
                kernels.LAUNCHES[k] += m
        return {k: v[:n].clone() for k, v in self._outputs.items()}


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
    one step at a time, which the CPU always runs. Under gradient
    accumulation (the state's ``accum_steps = k > 1``) the card captures
    two steps, a micro-step and a micro-step that commits the update, and
    replays each row's in the order the host reads from ``state.step``
    (row ``i`` commits when ``(state.step + i) % k == k - 1``); an update
    may straddle two calls.

    ``batches`` may carry ``"eps"``, ``(n_steps, T, B, L)`` (``(n_steps,
    B, T, L)`` under the ``"b"`` and ``"st"`` folds), ``"subset_masks"``,
    ``(n_steps, k, M)``, ``"cycle_eps"``, ``(n_steps, S, B, L)``, and
    ``"keep"``, ``(n_steps, B, M)``: each step's posterior noise, random
    subset masks, mvtcae cycle noise and dropout draw in place of a draw
    (how a parity run feeds two devices the same numbers). With a ``mesh``
    in ``step_kwargs`` every batch is this rank's rows, and the card
    replays a graph with the step's all-reduce inside where the group is
    NCCL's (``_use_graph``).
    """
    train_step = make_train_step(model, **step_kwargs)
    fed = ("eps", "subset_masks", "cycle_eps", "keep")

    def step(state, batch, commit=None):
        data = {k: v for k, v in batch.items() if k not in fed}
        return train_step(state, data, commit=commit, **{k: batch.get(k) for k in fed})

    if not _use_graph(model, graph, step_kwargs.get("mesh")):
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
        k = state.accum_steps
        if graphed is None:
            # Body 1 commits the update (k > 1 only).
            graphed = _StepGraph(
                lambda batch, body: step(state, batch, None if k == 1 else body == 1)[1],
                step_kwargs.get("generator"), bodies=1 if k == 1 else 2)
        first_step = state.step
        which = [int(k > 1 and (first_step + i) % k == k - 1) for i in range(_rows(batches))]
        metrics = graphed(batches, state.tensors, which)
        state.step = first_step + _rows(batches)  # the capture passes also counted
        return state, metrics

    return run_graph


SHUFFLE_MODES = ("roll", "block")


def epoch_order(
    pos: torch.Tensor,
    epoch_i: int,
    n_steps: int,
    batch_size: int,
    *,
    reshuffle_every: int = 1,
    shuffle_mode: str = "roll",
    shuffle_granularity: int = 1,
    force_shuffle: bool = False,
    generator: torch.Generator | None = None,
    draws: dict[str, Any] | None = None,
    n_shards: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One epoch of ``make_gather_epoch_runner``'s order
    (``mmvae_tpu/train/step.py:1306-1530``): ``(pos, rows)``.

    ``pos`` (CPU int64, ``(size,)``) is the persisted arrangement of the
    split, the rows of the loaded split in the order the JAX runner keeps
    its donated arrays; the new one is returned, with ``rows`` ``(n_steps,
    batch_size)``, the loaded rows each step of the epoch reads. Epoch
    ``epoch_i`` (``state.step // n_steps``) is a true shuffle when
    ``epoch_i % reshuffle_every == 0`` or ``force_shuffle``: ``pos`` is
    permuted, by rows, or under ``shuffle_granularity = G > 1`` that divides
    the size, rolled by an offset below G and permuted by G-row groups. The
    epochs between ``"roll"`` ``pos`` by an offset in ``[1, size)``, or
    under ``"block"`` leave it and read batch ``s`` at the block
    ``block_order[s]``. Every other epoch's steps read ``pos``'s leading
    ``n_steps * batch_size`` rows in order.

    Each draw is taken from ``generator`` (CPU) when it is needed, or from
    ``draws`` (how a parity run feeds the JAX runner's ``jax.random``
    draws): ``"order"`` (a permutation of the rows or the groups),
    ``"group_offset"``, ``"roll_offset"``, ``"block_order"`` (a permutation
    of the steps).

    ``n_shards > 1`` (``step.py:1339-1450``): ``pos`` is ``n_shards``
    contiguous shards, and everything happens within each: a true shuffle
    permutes each shard by its own order (``"order"`` ``(n_shards,
    n_groups)``; by groups of G rows where G divides the shard, after a
    roll of every shard by one ``"group_offset"``), the epochs between roll
    each shard by one ``"roll_offset"`` in ``[1, per)`` or, under
    ``"block"``, read block ``block_order[s]`` of every shard, and batch
    ``s`` is ``batch_size / n_shards`` rows of each shard, shard-major (the
    JAX runner's stratified batches). A rank of a mesh of ``n_shards``
    ranks keeps its shard's block of each batch (``Mesh.rows`` along dim
    1). The size and ``batch_size`` must divide over the shards.
    """
    if shuffle_mode not in SHUFFLE_MODES:
        raise ValueError(f"unknown shuffle_mode {shuffle_mode!r}; have {SHUFFLE_MODES}")
    draws = draws or {}
    size, gran = pos.shape[0], max(int(shuffle_granularity), 1)

    def draw(key: str, make: Callable[[], Any]):
        return draws[key] if key in draws else make()

    def randint(lo: int, hi: int) -> int:
        return int(torch.randint(lo, hi, (1,), generator=generator))

    if n_shards > 1:
        return _sharded_order(pos, epoch_i, n_steps, batch_size, n_shards, reshuffle_every,
                              shuffle_mode, gran, force_shuffle, draw, randint, generator)
    n_used = n_steps * batch_size
    if reshuffle_every <= 1 or epoch_i % reshuffle_every == 0 or force_shuffle:
        if gran <= 1 or size % gran:
            order = draw("order", lambda: torch.randperm(size, generator=generator))
            pos = pos[torch.as_tensor(order)]
        else:
            order = draw("order", lambda: torch.randperm(size // gran, generator=generator))
            off = draw("group_offset", lambda: randint(0, gran))
            groups = torch.roll(pos, int(off)).reshape(size // gran, gran)
            pos = groups[torch.as_tensor(order)].reshape(size)
    elif shuffle_mode == "roll":
        pos = torch.roll(pos, int(draw("roll_offset", lambda: randint(1, size))))
    else:
        block = torch.as_tensor(draw("block_order", lambda: torch.randperm(
            n_steps, generator=generator)))
        starts = block * batch_size
        return pos, pos[starts[:, None] + torch.arange(batch_size)]
    return pos, pos[:n_used].reshape(n_steps, batch_size)


def _sharded_order(pos, epoch_i, n_steps, batch_size, n_shards, reshuffle_every,
                   shuffle_mode, gran, force_shuffle, draw, randint, generator):
    """:func:`epoch_order` over ``n_shards`` shards (its docstring)."""
    size = pos.shape[0]
    if size % n_shards or batch_size % n_shards:
        raise ValueError(f"dataset size {size} and batch size {batch_size} must both divide "
                         f"over {n_shards} shards")
    per, b_local = size // n_shards, batch_size // n_shards
    shards = pos.reshape(n_shards, per)
    is_shuffle = reshuffle_every <= 1 or epoch_i % reshuffle_every == 0 or force_shuffle
    if is_shuffle:
        g = gran if per % gran == 0 else 1
        n_groups = per // g
        order = torch.as_tensor(draw("order", lambda: torch.stack(
            [torch.randperm(n_groups, generator=generator) for _ in range(n_shards)])))
        if g > 1:
            shards = torch.roll(shards, int(draw("group_offset", lambda: randint(0, g))), 1)
        groups = shards.reshape(n_shards, n_groups, g)
        idx = order.reshape(n_shards, n_groups, 1).expand(-1, -1, g)
        shards = torch.gather(groups, 1, idx).reshape(n_shards, per)
    if shuffle_mode == "block" and reshuffle_every > 1:
        if is_shuffle:
            starts = torch.arange(n_steps) * b_local
        else:
            starts = torch.as_tensor(draw("block_order", lambda: torch.randperm(
                n_steps, generator=generator))) * b_local
        rows = shards[:, starts[:, None] + torch.arange(b_local)]  # (n_shards, n_steps, b_local)
    else:
        if not is_shuffle:
            shards = torch.roll(shards, int(draw("roll_offset", lambda: randint(1, per))), 1)
        rows = shards[:, :n_steps * b_local].reshape(n_shards, n_steps, b_local)
    return shards.reshape(size), rows.permute(1, 0, 2).reshape(n_steps, batch_size)


def make_gather_epoch_runner(
    model,
    n_steps: int,
    batch_size: int,
    *,
    reshuffle_every: int = 1,
    shuffle_mode: str = "roll",
    shuffle_granularity: int = 1,
    order: torch.Generator | None = None,
    graph: bool | None = None,
    n_shards: int = 1,
    mesh=None,
    term_fold: str | None = None,
    **step_kwargs,
) -> Callable:
    """The JAX ``make_gather_epoch_runner`` (``mmvae_tpu/train/step.py:
    1163-1543``): ``run(state, arrays, pos=None, force_shuffle=False,
    draws=None) -> (state, pos, metrics)``.

    ``arrays`` is the loaded split on the device, which stays as it is;
    ``pos`` the persisted arrangement (None: the loaded order), which
    :func:`epoch_order` advances from ``order``'s draws (or ``draws``) at
    the epoch ``state.step // n_steps``. The epoch's batches, one gather a
    modality by the rows it gives, then run through
    :func:`make_epoch_runner` (``graph``, ``step_kwargs``). The JAX runner
    moves its donated arrays (a gather, a roll) where the port moves only
    ``pos``: the rows each step reads are the same.

    ``n_shards > 1`` takes :func:`epoch_order`'s per-shard order; a
    ``mesh`` whose ranks divide ``batch_size`` is the shard count. With a
    mesh, ``arrays`` is this rank's contiguous block of the split (shard
    ``mesh.rank``), ``pos`` the whole split's arrangement (the same on
    every rank: each draws every shard's order from ``order`` in lockstep
    and keeps its own), and each step reads the rank's rows of the global
    batch. ``term_fold`` (None) follows JAX (``step.py:1269-1277``):
    ``"t"`` at one shard (the mesh dropped), ``"st"`` with a mesh in
    hand, ``"b"`` with only ``n_shards``.
    """
    if shuffle_mode not in SHUFFLE_MODES:
        raise ValueError(f"unknown shuffle_mode {shuffle_mode!r}; have {SHUFFLE_MODES}")
    if mesh is not None and n_shards <= 1 and batch_size % mesh.size == 0:
        n_shards = mesh.size
    if term_fold is None:
        term_fold = "t" if n_shards <= 1 else ("st" if mesh is not None else "b")
    if mesh is not None and mesh.size == 1 and term_fold == "t":
        mesh = None
    if mesh is not None and n_shards != mesh.size:
        raise ValueError(f"batch size {batch_size} in {n_shards} shards on a mesh of "
                         f"{mesh.size} ranks: the shards must be the ranks")
    runner = make_epoch_runner(model, graph=graph, term_fold=term_fold, mesh=mesh, **step_kwargs)

    def run(state, arrays, pos=None, force_shuffle=False, draws=None):
        local = _rows(arrays)
        size = local * (1 if mesh is None else mesh.size)
        if pos is None:
            pos = torch.arange(size)
        pos, rows = epoch_order(
            pos, state.step // n_steps, n_steps, batch_size,
            reshuffle_every=reshuffle_every, shuffle_mode=shuffle_mode,
            shuffle_granularity=shuffle_granularity, force_shuffle=force_shuffle,
            generator=order, draws=draws, n_shards=n_shards)
        if mesh is not None:
            rows = mesh.rows(rows, 1) - mesh.rank * local
        rows = rows.to(next(iter(arrays.values())).device)
        state, metrics = runner(state, {k: v[rows] for k, v in arrays.items()})
        return state, pos, metrics

    return run


def make_eval_step(
    model, objective: str = "mvae", mvtcae_alpha: float = 0.9, term_fold: str = "t",
) -> Callable[[dict[str, Any]], dict[str, torch.Tensor]]:
    """Eval step: full ELBO of ``objective`` at beta = 1 with z = posterior
    mean (each mixture component's mean for mmvae and mopoe), under
    ``term_fold`` (``"t"`` or ``"b"``).

    Returns ``eval_step(batch) -> metrics``, run without autograd.
    """

    @torch.no_grad()
    def eval_step(batch):
        _, metrics = multi_term_loss(
            model, batch, 1.0, sample=False, objective=objective, mvtcae_alpha=mvtcae_alpha,
            term_fold=term_fold,
        )
        return metrics

    return eval_step


def _mesh_gather_rows(values: torch.Tensor, mesh) -> torch.Tensor:
    """``(n_batches, b)`` per-example values of this rank's rows into the
    ``(n_batches, b * size)`` global batches, in one all-reduce of a buffer
    that holds each rank's block and zeros elsewhere (exact: each entry
    adds one value to zeros)."""
    n, b = values.shape
    out = values.new_zeros((n, b * mesh.size))
    out[:, mesh.rank * b:(mesh.rank + 1) * b] = values
    dist.all_reduce(out, group=mesh.group)
    return out


def make_eval_runner(
    model, objective: str = "mvae", mvtcae_alpha: float = 0.9, *, graph: bool | None = None,
    mesh=None,
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

    With a ``mesh`` each batch is this rank's rows of the global batch,
    evaluated under the ``"b"`` fold (``step.py:1580-1615``), and the
    stacked metrics are averaged over the ranks once, after the split:
    every rank returns the global batches' metrics.
    """
    if mesh is None:
        return _split_runner(make_eval_step(model, objective, mvtcae_alpha), model, graph)
    run = _split_runner(make_eval_step(model, objective, mvtcae_alpha, "b"), model, graph)
    # A rank's batch mean of its equal share of each batch: the mean over
    # the ranks is the global batch's.
    return lambda batches: _all_reduce_mean([], run(batches), mesh)


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

    graphed = _StepGraph(lambda batch, body: step(batch), generator)
    return lambda batches: graphed(batches, lambda: [*model.parameters(), *model.buffers()])


def make_iwae_step(
    model, k: int = 64, generator: torch.Generator | None = None, mesh=None,
) -> Callable[[dict[str, Any]], dict[str, torch.Tensor]]:
    """IWAE step: ``iwae_step(batch) -> {"log_likelihood": (B,)}``, each
    example's estimate (``core.iwae_bound``) times its row of the batch's
    ``valid`` mask, so a pad row gives exactly 0 (the JAX ``scan`` body,
    ``mmvae_tpu/api.py:1278-1285``). The noise is ``batch["eps"]``
    ``(B, k, L)`` when the batch carries it, else a draw from
    ``generator`` (with a ``mesh``, the global batch's noise and this
    rank's rows of it). Run without autograd."""

    @torch.no_grad()
    def iwae_step(batch):
        data = {name: v for name, v in batch.items() if name not in ("valid", "eps")}
        ll = iwae_bound(model, data, k, generator=generator, eps=batch.get("eps"), mesh=mesh)
        return {"log_likelihood": ll * batch["valid"]}

    return iwae_step


def make_iwae_runner(
    model, k: int = 64, *, graph: bool | None = None,
    generator: torch.Generator | None = None, mesh=None,
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

    With a ``mesh`` each batch (and ``eps``) is this rank's rows of the
    global batch (its IWAE samples b-major, as on one device), and the
    per-example values come back as the global batches', gathered once
    after the split (``mmvae_tpu/api.py:1240-1244``).
    """
    run = _split_runner(make_iwae_step(model, k, generator, mesh), model, graph, generator)
    if mesh is None:
        return run
    return lambda batches: {"log_likelihood": _mesh_gather_rows(
        run(batches)["log_likelihood"], mesh)}
