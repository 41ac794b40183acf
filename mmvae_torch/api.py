"""User-facing entry points (port of ``mmvae_tpu/api.py``).

  * :func:`train` -- train a config from its seeded init (``api.py:414``),
    into a workdir (``config.json``, ``metrics.jsonl``, checkpoints) when
    one is given, and resume from it; with gradient accumulation, the
    cosine LR schedule, ``nan_rollback`` and overlapped saves
    (``ckpt_async``) where the config asks for them;
  * :func:`eval_elbo` -- mean multi-term ELBO over a split (``api.py:1013``);
  * :func:`log_likelihood` -- mean IWAE estimate of log p(x) over a split
    (``api.py:1212``), both with the split on the device whole or in
    segments (``segment_steps``);
  * :func:`generate` -- cross-modal generation from any observed subset
    (``api.py:1504``);
  * :func:`sample` -- unconditional samples (``api.py:1474``).

Every entry point runs on ``device``, which defaults to the card
(``torch.device("cuda")``) and raises when there is none; pass
``device="cpu"`` to run on the CPU. On the card an epoch and an eval split
each run as replays of one captured CUDA graph (``train/step.py``). Weights
come from a ``model`` the caller built (``configs.build_model``, or
``convert.from_flax_params`` loaded into it), a ``state_dict``,
:func:`train`'s result, or a ``workdir`` :func:`train` wrote (its best
checkpoint by default, the EMA weights where they are tracked).

``dtype`` (every entry point) is the compute dtype of the experts, as in
the JAX package: ``torch.float32`` or ``torch.bfloat16``; the parameters
and the losses stay float32. It is an argument of the call, not a config
field: a workdir trained at float32 evaluates at bfloat16. ``None`` keeps
a given model's dtype (float32 for a model built here); a dtype given with
a ``model`` holds for the call alone (``MVAEBase.at_dtype``), and the
model keeps its own.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from mmvae_torch.configs import ExperimentConfig, build_model, get_config
from mmvae_torch.core import fuse_observed_z
from mmvae_torch.data import (
    Dataset,
    dataset_astype,
    load_dataset,
    stacked_epoch,
    stacked_epoch_padded,
)
from mmvae_torch.data.grain_pipeline import epoch_plan, gather_batches
from mmvae_torch.device import resolve_device
from mmvae_torch.parallel import (
    fsdp_shard,
    make_mesh,
    make_mesh_2d,
    multihost,
    replicate,
    shard_batch,
    tp_shard,
)
from mmvae_torch.train import (
    TrainState,
    create_train_state,
    make_epoch_runner,
    make_eval_runner,
    make_gather_epoch_runner,
    make_iwae_runner,
)
from mmvae_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    latest_epoch,
    load_checkpoint,
    save_checkpoint,
)
from mmvae_torch.train.state import learning_rate
from mmvae_torch.train.metrics import AverageMeter, MetricsWriter

__all__ = [
    "TrainResult",
    "train",
    "step_options",
    "eval_elbo",
    "log_likelihood",
    "generate",
    "sample",
    "load_run_config",
    "resolve_eval_segments",
]


def _save_run_config(workdir: str, config: ExperimentConfig) -> None:
    """The config beside the checkpoints, so that eval, generate and
    sample rebuild the model that was trained."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2)


def _tuplify(obj):
    """JSON makes tuples lists; the models take tuples (``conv_features``)."""
    if isinstance(obj, list):
        return tuple(_tuplify(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _tuplify(v) for k, v in obj.items()}
    return obj


def load_run_config(workdir: str) -> ExperimentConfig | None:
    """The config :func:`train` saved in ``workdir``, or None if absent."""
    path = os.path.join(workdir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    d["model_kwargs"] = _tuplify(d.get("model_kwargs", {}))
    d["data_kwargs"] = _tuplify(d.get("data_kwargs", {}))
    return ExperimentConfig(**d)


def resolve_eval_segments(config: ExperimentConfig) -> int:
    """The eval split's segments of the config (``mmvae_tpu/api.py:84-98``):
    ``eval_segment_steps``, its -1 (auto) resolving to ``grain_stream_steps``
    on the grain backend (a split big enough to stream for training is not
    put on the device whole for eval either), else to 0, the whole split on
    the device."""
    segs = config.eval_segment_steps
    if segs < 0:
        segs = config.grain_stream_steps if config.data_backend == "grain" else 0
    return segs


def _resolve_with_workdir(config, workdir: str | None) -> ExperimentConfig:
    """The workdir's saved config when the caller names the config it was
    trained from, else the named or given config."""
    if isinstance(config, str) and workdir is not None:
        stored = load_run_config(workdir)
        if stored is not None and stored.name == config:
            return stored
    return get_config(config) if isinstance(config, str) else config


def _load_params(config: ExperimentConfig, model, workdir: str, which: str = "best"):
    """``model`` with the weights of ``workdir``'s checkpoint ``which``:
    the EMA shadow when the config tracks one (the eval weights), else
    the trained parameters."""
    state = create_train_state(
        model, config.learning_rate, grad_clip=config.grad_clip, ema_decay=config.ema_decay
    )
    state, _ = load_checkpoint(workdir, state, which=which)
    return state.eval_model


def _resolve(config, model, state_dict, device, workdir=None, which="best"):
    """The config, the model with its weights (one built here at float32),
    and the device. With no ``model`` and no ``state_dict`` the weights
    come from ``workdir``."""
    config = _resolve_with_workdir(config, workdir)
    device = resolve_device(device)
    if model is None:
        if state_dict is None and workdir is None:
            raise ValueError("need a model, a state_dict or a workdir")
        model = build_model(config, device=device)
        if state_dict is None:
            model = _load_params(config, model, workdir, which)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return config, model.to(device), device


def eval_elbo(
    config: str | ExperimentConfig,
    *,
    model=None,
    state_dict: dict[str, torch.Tensor] | None = None,
    workdir: str | None = None,
    which: str = "best",
    dataset: Dataset | None = None,
    split: str = "test",
    batch_size: int | None = None,
    device: torch.device | str | None = None,
    segment_steps: int = 0,
    dtype: torch.dtype | None = None,
    mesh=None,
) -> float:
    """Mean multi-term ELBO over a split, beta = 1 and z = posterior mean.

    The weights are ``model``'s, ``state_dict``'s, or those of
    ``workdir``'s checkpoint ``which`` ("best", else "last"; the EMA
    weights where tracked), whose saved config is used when ``config``
    names it. ``dataset`` defaults to the config's synthetic ``split``
    ("test" or "train") of ``config.test_size`` examples
    (``mmvae_tpu/api.py:1020``; mounted data where there is some, the
    config's ``data_kwargs`` to the generators).
    The split is padded to whole batches (wrapping to its front); the
    validity mask is the presence mask, so pad rows contribute 0 and the
    result is ``sum(batch losses) * bs / size``, the batch losses summed in
    float64 in the order of the batches.
    ``segment_steps = K > 0`` keeps the padded split on the host and copies
    it to the device K batches at a time, each segment one call of the
    runner (the last padded with batches of no example, so one capture
    serves them all): O(K) batches of device memory, the same result to
    the bit (``mmvae_tpu/api.py:1114-1145``); 0 puts the whole split on
    the device. ``dtype``: the compute dtype (see the module docstring).
    ``mesh`` (``parallel.make_mesh``, every rank calling): the batch size
    is rounded up to the ranks (``mmvae_tpu/api.py:1069-1111``; the pad
    rows are masked, so the ELBO is exact at any size), each rank
    evaluates its rows of every batch under the ``"b"`` fold, and the
    batch losses are averaged over the ranks once: every rank returns the
    same value, the single-process one up to the order of the sums.
    """
    config, model, device = _resolve(config, model, state_dict, device, workdir, which)
    if dataset is None:
        dataset = load_dataset(config.dataset, split, n=config.test_size,
                               gen_kwargs=config.data_kwargs)
    batch_size = _mesh_batch(min(batch_size or config.batch_size, dataset.size), mesh)
    stacked = _padded_split(dataset, batch_size, model.n_modalities,
                            device if segment_steps <= 0 else None)
    if mesh is not None:
        stacked = shard_batch(stacked, mesh, dim=1)
    with model.at_dtype(dtype):
        runner = make_eval_runner(model, config.objective, config.mvtcae_alpha, mesh=mesh)
        return _split_elbo(runner, stacked, dataset.size, segment_steps, device, batch_size)


def _mesh_batch(batch_size: int, mesh) -> int:
    """``batch_size`` rounded up to a multiple of the mesh's ranks (itself
    without a mesh)."""
    return batch_size if mesh is None else -(-batch_size // mesh.size) * mesh.size


def _padded_split(
    dataset: Dataset, batch_size: int, n_modalities: int, device: torch.device | None
) -> dict[str, torch.Tensor]:
    """The split stacked into whole batches on ``device`` (on the host where
    it is None), the last padded, with the validity mask as an
    all-modalities ``presence``."""
    stacked = _valid_split(dataset, batch_size, device)
    stacked["presence"] = stacked.pop("valid")[..., None].expand(-1, -1, n_modalities)
    return stacked


def _valid_split(
    dataset: Dataset, batch_size: int, device: torch.device | None
) -> dict[str, torch.Tensor]:
    """The split stacked into whole batches on ``device`` (on the host where
    it is None), the last padded (wrapping to its front), with its
    ``(n_batches, bs)`` ``valid`` mask."""
    batches, valid = stacked_epoch_padded(dataset, batch_size)
    stacked = {k: torch.as_tensor(v, device=device) for k, v in batches.items()}
    stacked["valid"] = torch.as_tensor(valid, device=device)
    return stacked


def _segment(v: torch.Tensor, start: int, rows: int, device: torch.device) -> torch.Tensor:
    """Batches ``start .. start + rows`` of a stacked split on ``device``,
    padded with zero batches past its end."""
    part = v[start:start + rows]
    if part.shape[0] < rows:
        part = torch.cat([part, part.new_zeros((rows - part.shape[0], *part.shape[1:]))])
    return part.to(device)


def _split_values(runner: Callable, key: str, stacked: dict[str, torch.Tensor],
                  segment_steps: int, device: torch.device) -> torch.Tensor:
    """``runner(stacked)[key]``, one row a batch, in float64 on the host: the
    stacked split in one call (``segment_steps <= 0``), or in calls of
    ``segment_steps`` batches, each segment copied to ``device`` before its
    call and the last padded with zero batches (all pad: presence and
    validity 0), whose rows are dropped."""
    n = next(iter(stacked.values())).shape[0]
    seg = n if segment_steps <= 0 else min(segment_steps, n)
    parts = [runner({k: _segment(v, s, seg, device) for k, v in stacked.items()})[key]
             for s in range(0, n, seg)]
    return torch.cat([p.double().cpu() for p in parts])[:n]


def _split_elbo(runner: Callable, stacked: dict[str, torch.Tensor], size: int,
                segment_steps: int = 0, device: torch.device | None = None,
                batch_size: int | None = None) -> float:
    """Mean ELBO of a :func:`_padded_split` of ``size`` examples through an
    eval ``runner`` (``make_eval_runner``), whole or in segments
    (:func:`_split_values`): the pad rows contribute 0, so it is ``sum(batch
    losses) * bs / size``, summed in float64. ``batch_size`` is the global
    batch's where ``stacked`` holds one rank's rows of it."""
    losses = _split_values(runner, "loss", stacked, segment_steps, device)
    return float(losses.sum()) * (batch_size or stacked["presence"].shape[1]) / size


def log_likelihood(
    config: str | ExperimentConfig,
    *,
    model=None,
    state_dict: dict[str, torch.Tensor] | None = None,
    workdir: str | None = None,
    which: str = "best",
    dataset: Dataset | None = None,
    split: str = "test",
    k: int = 64,
    batch_size: int | None = None,
    seed: int = 0,
    device: torch.device | str | None = None,
    eps: torch.Tensor | None = None,
    segment_steps: int = 0,
    dtype: torch.dtype | None = None,
    mesh=None,
) -> float:
    """Mean IWAE estimate of the joint marginal log p(x) over a split.

    The MVAE paper's importance-sampled test log-likelihood (natural log,
    per example; ``core/iwae.py``), with ``k`` samples from the joint PoE
    posterior under every objective (``mmvae_tpu/api.py:1234-1238``: for a
    mixture-trained model still a valid bound, comparable across
    objectives). The weights come as in :func:`eval_elbo`; ``dataset``
    defaults to the config's synthetic ``split`` ("test" or "train") of
    ``config.test_size`` examples (``mmvae_tpu/api.py:1219``). The split is padded to
    whole batches and the pad rows are multiplied out by the validity
    mask, so the result is the sum over the examples / ``dataset.size``.
    The noise is drawn batch after batch from a generator on ``device``
    seeded with ``seed``; ``eps`` ``(n_batches, bs, k, L)`` passes it in
    (the JAX ``log_likelihood`` draws batch ``i``'s from
    ``fold_in(key(seed), i)``, which torch cannot reproduce).
    ``segment_steps`` is :func:`eval_elbo`'s: the split (and ``eps``) on the
    host, copied to the device a segment at a time, the same result to the
    bit (the batches draw the generator's noise in the same order; the
    pad batches of the last segment draw after them). The per-example
    values are summed in float64. ``dtype``: the compute dtype (see the
    module docstring). ``mesh`` (every rank calling): the batch size is
    rounded up to the ranks as in :func:`eval_elbo`, each rank takes its
    rows of every batch (and of ``eps``, whose batch axis is then the
    rounded one) with the noise drawn at the global shape, and the
    per-example values are gathered over the ranks once: every rank
    returns the same value, the single-process one up to the order of the
    sums (``mmvae_tpu/api.py:1240-1244``).
    """
    config, model, device = _resolve(config, model, state_dict, device, workdir, which)
    if dataset is None:
        dataset = load_dataset(config.dataset, split, n=config.test_size,
                               gen_kwargs=config.data_kwargs)
    batch_size = _mesh_batch(min(batch_size or config.batch_size, dataset.size), mesh)
    home = device if segment_steps <= 0 else None
    stacked = _valid_split(dataset, batch_size, home)
    if eps is not None:
        eps = torch.as_tensor(eps, dtype=torch.float32, device=home)
        want = (*stacked["valid"].shape, k, model.n_latents)
        if tuple(eps.shape) != want:
            raise ValueError(f"eps must be {want}, got {tuple(eps.shape)}")
        stacked["eps"] = eps
    if mesh is not None:
        stacked = shard_batch(stacked, mesh, dim=1)
    with model.at_dtype(dtype):
        runner = make_iwae_runner(
            model, k, generator=torch.Generator(device=device).manual_seed(seed), mesh=mesh)
        values = _split_values(runner, "log_likelihood", stacked, segment_steps, device)
    return float(values.sum()) / dataset.size


DATA_BACKENDS = ("device", "grain")


def _grain_seed(seed: int, epoch: int, rollbacks: int) -> int:
    """The grain backend's plan seed of an epoch (``mmvae_tpu/api.py:119-128``):
    epoch-indexed, so a resumed run replays the same orders; a rollback's
    retry perturbs it. The train loop and the stream's prefetch share it."""
    return seed * 100003 + epoch + rollbacks * 7919


def _cast_source_arrays(arrays: dict[str, Any], data_dtype: str) -> dict[str, Any]:
    """The source arrays with the ``data_dtype`` cast applied once
    (``mmvae_tpu/api.py:130-161``), through :func:`~mmvae_torch.data.dataset_astype`,
    the device backend's cast: a gather of the cast rows equals the cast of
    the gathered rows, so the batches are those of gather-then-cast. The
    presence mask is the plan's and stays float32."""
    if data_dtype == "float32":
        return arrays
    size = len(next(iter(arrays.values())))
    return dataset_astype(Dataset(arrays=arrays, size=size), data_dtype).arrays


def _grain_epoch_host(train_ds: Dataset, config: ExperimentConfig, model, seed: int,
                      arrays: dict[str, Any] | None = None) -> dict[str, Any]:
    """The host half of a grain epoch (``mmvae_tpu/api.py:163-195``): the plan
    of ``seed`` (``grain_pipeline.epoch_plan``), then one gather a modality,
    into ``(steps, B, ...)`` batches with the plan's ``presence`` where
    ``p_modality_drop > 0``. ``arrays`` passes the source arrays already
    cast; else the cast applies here."""
    if arrays is None:
        arrays = _cast_source_arrays(dict(train_ds.arrays), config.data_dtype)
    perm, presence = epoch_plan(train_ds.size, config.batch_size, seed,
                                n_modalities=model.n_modalities, p_drop=config.p_modality_drop)
    return gather_batches(arrays, perm, presence, config.batch_size)


class _GrainStream:
    """The grain backend's epochs, in segments of ``grain_stream_steps``
    batches (0: the whole epoch) (``mmvae_tpu/api.py:242-406``).

    One worker thread gathers segment k + 1 on the host (numpy only: a bf16
    modality is held as its int16 bits) while the device trains segment k;
    the main thread copies each segment to the device (through pinned
    memory on the card, so the copy is queued behind segment k's replays
    and the host goes on) and calls the runner, whose graph copies it into
    its static inputs in stream order after the replays that read the
    segment before. The last segment of an epoch that ``grain_stream_steps``
    does not divide is shorter: the graph runner replays only its rows.

    Every segment is a pure function of ``(seed, k)`` over the epoch's one
    plan, and the runner over consecutive segments is the runner over the
    epoch with the state threaded through, so the streamed epoch equals the
    whole one to the bit. A ``take`` whose key was not scheduled (the first
    epoch, a rollback's retry) gathers inline: a miss. ``hits`` and
    ``misses`` count the takes.
    """

    def __init__(self, train_ds: Dataset, config: ExperimentConfig, model,
                 device: torch.device, mesh=None):
        arrays = _cast_source_arrays(dict(train_ds.arrays), config.data_dtype)
        self._bf16 = {k for k, v in arrays.items() if torch.is_tensor(v)}
        self._arrays = {k: v.view(torch.int16).numpy() if k in self._bf16 else np.asarray(v)
                        for k, v in arrays.items()}
        self._size, self._bs = train_ds.size, config.batch_size
        self._n_modalities, self._p_drop = model.n_modalities, config.p_modality_drop
        self._device, self._mesh = device, mesh
        self._steps = train_ds.size // config.batch_size
        if self._steps == 0:
            raise ValueError(f"grain epoch yields no batches: train_size {train_ds.size} < "
                             f"batch_size {config.batch_size}")
        seg = config.grain_stream_steps
        self._seg_steps = self._steps if seg <= 0 else min(seg, self._steps)
        self._n_segs = -(-self._steps // self._seg_steps)
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="grain-stream")
        self._key: tuple[int, int] | None = None
        self._fut = None
        self._plans: dict[int, tuple] = {}
        self._plan_lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @property
    def hit_rate(self) -> float:
        """The share of takes the worker had gathered (NaN before the first)."""
        n = self.hits + self.misses
        return self.hits / n if n else float("nan")

    def _plan(self, seed: int):
        """The plan of ``seed``, kept for the newest few epochs (the current
        one and the next one's prefetch)."""
        with self._plan_lock:
            if seed not in self._plans:
                while len(self._plans) > 4:
                    del self._plans[next(iter(self._plans))]
                self._plans[seed] = epoch_plan(self._size, self._bs, seed,
                                               n_modalities=self._n_modalities,
                                               p_drop=self._p_drop)
            return self._plans[seed]

    def _host_seg(self, seed: int, k: int) -> dict[str, np.ndarray]:
        perm, presence = self._plan(seed)
        lo = k * self._seg_steps * self._bs
        hi = min((k + 1) * self._seg_steps, self._steps) * self._bs
        return gather_batches(self._arrays, perm[lo:hi],
                              None if presence is None else presence[lo:hi], self._bs)

    def schedule(self, key: tuple[int, int]) -> None:
        if self._fut is not None and self._key == key:
            return
        self._key = key
        self._fut = self._pool.submit(self._host_seg, *key)

    def take(self, key: tuple[int, int]) -> dict[str, np.ndarray]:
        fut, hit = self._fut, self._key == key
        self._fut = self._key = None
        if fut is not None and hit:
            self.hits += 1
            return fut.result()
        if fut is not None:
            fut.cancel()
        self.misses += 1
        return self._host_seg(*key)

    def _upload(self, host: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """A segment on the device; with a mesh, this rank's rows of each of
        its global batches."""
        out = {}
        for k, v in host.items():
            t = torch.from_numpy(v)
            if k in self._bf16:
                t = t.view(torch.bfloat16)
            if self._mesh is not None:
                t = self._mesh.rows(t, 1).contiguous()
            on_card = self._device.type == "cuda"
            out[k] = t.pin_memory().to(self._device, non_blocking=True) if on_card else t
        return out

    def run_epoch(self, state: TrainState, runner: Callable, seed: int,
                  next_seed: int | None = None):
        """One epoch through ``runner`` a segment at a time: ``(state,
        metrics)``, each metric stacked over the epoch's steps. Each
        segment's take schedules the next one's gather, and the last
        segment the next epoch's first (``next_seed``)."""
        parts = []
        for k in range(self._n_segs):
            host = self.take((seed, k))
            if k + 1 < self._n_segs:
                self.schedule((seed, k + 1))
            elif next_seed is not None:
                self.schedule((next_seed, 0))
            state, metrics = runner(state, self._upload(host))
            parts.append(metrics)
        if len(parts) == 1:
            return state, parts[0]
        return state, {key: torch.cat([m[key] for m in parts]) for key in parts[0]}

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class TrainResult(NamedTuple):
    config: ExperimentConfig
    model: Any
    state: TrainState
    best_test_elbo: float
    history: list[dict[str, float]]


def step_options(config: ExperimentConfig) -> dict[str, Any]:
    """The keywords of ``make_train_step`` (and ``make_epoch_runner``) that
    ``config`` sets: the random subset terms, presence dropout and the
    loss's options (``mmvae_tpu/api.py:591-613``)."""
    return dict(
        n_random_subsets=config.n_random_subsets,
        p_modality_drop=config.p_modality_drop,
        cross_recon=config.cross_recon,
        cross_recon_weight=config.cross_recon_weight,
        cross_recon_stopgrad=config.cross_recon_stopgrad,
        unimodal_align_weight=config.unimodal_align_weight,
        cycle_weight=config.cycle_weight,
        cycle_render_grad=config.cycle_render_grad,
        cycle_contrast_weight=config.cycle_contrast_weight,
        cycle_render_binarize=config.cycle_render_binarize,
        objective=config.objective,
        mvtcae_alpha=config.mvtcae_alpha,
        member_prune=config.member_prune,
    )


# The loss terms besides the ELBO that an epoch's history record carries
# where the config's loss has them, and those a train record carries
# (``mmvae_tpu/api.py:803-840``).
_EXTRA_TRAIN_METRICS = ("cycle_ce", "cycle_contrast", "align_kl", "cross_kl")
_TRAIN_RECORD_EXTRAS = ("align_kl", "cycle_ce", "cycle_contrast")
_TRAIN_RECORD = ("loss", "beta", "grad_norm", "elbo_per_term", "kl_per_term", "recon_per_term")

# Folded into the seeds of a retry after a rollback (with the count of
# rollbacks), as the JAX loop folds it into its key (``api.py:893``).
ROLLBACK_TAG = 0xBAD0


def _fold(seed: int, tag: int) -> int:
    """A 63-bit seed from ``seed`` and ``tag``."""
    return int(np.random.SeedSequence([seed % 2**64, tag]).generate_state(1, np.uint64)[0]) >> 1


def _perturb(generator: torch.Generator, tag: int) -> None:
    """Reseed ``generator`` from a number drawn from it and ``tag``, so a
    retry does not replay the draws of the epoch that blew up."""
    drawn = int(torch.randint(2**62, (1,), generator=generator, device=generator.device))
    generator.manual_seed(_fold(drawn, tag))


def _fetch(metrics: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """An epoch's stacked metrics on the host, in one copy from the device."""
    n = metrics["loss"].shape[0]
    flat = torch.cat([v.reshape(n, -1).to(torch.float32) for v in metrics.values()], 1)
    flat, out, at = flat.cpu().numpy(), {}, 0
    for k, v in metrics.items():
        width = v[0].numel()
        out[k] = flat[:, at:at + width].reshape(v.shape)
        at += width
    return out


def _train_records(metrics: dict[str, np.ndarray], epoch: int, base_step: int,
                   log_interval: int) -> list[dict[str, Any]]:
    """One ``{"kind": "train", ...}`` record every ``log_interval`` steps
    of the epoch, step ``i`` of the epoch numbered ``base_step + i + 1``
    (``mmvae_tpu/api.py:803-840``)."""
    records = []
    for i in range(0, len(metrics["loss"]), log_interval):
        rec = {"kind": "train", "epoch": epoch, "step": base_step + i + 1}
        rec.update({k: metrics[k][i] for k in _TRAIN_RECORD})
        rec.update({k: metrics[k][i] for k in _TRAIN_RECORD_EXTRAS if k in metrics})
        records.append(rec)
    return records


def train(
    config: str | ExperimentConfig,
    workdir: str | None = None,
    *,
    seed: int = 0,
    device: torch.device | str | None = None,
    resume: bool = False,
    verbose: bool = True,
    fault_hook: Callable | None = None,
    dtype: torch.dtype | None = None,
    use_mesh: bool = True,
) -> TrainResult:
    """Train ``config`` from its seeded init, evaluating the test split
    after each epoch (``mmvae_tpu/api.py:414``).

    On the device backend (``data_backend="device"``) the train split is
    on ``device`` and each epoch's order comes from a ``torch.Generator``
    seeded with ``seed``, in whole batches: a fresh permutation of the split
    each epoch at the JAX defaults (``reshuffle_every=1``,
    ``shuffle_granularity=1``), else the JAX runner's persisted order, truly
    reshuffled every ``reshuffle_every`` epochs (by groups of
    ``shuffle_granularity`` rows) and between them rolled, or read in a new
    batch order (``shuffle_mode``; ``train/step.py::epoch_order``). On the
    grain backend the split stays on the host and each epoch is planned
    there from ``_grain_seed(seed, epoch, rollbacks)`` (its order and its
    presence mask, ``data/grain_pipeline.py``) and delivered in segments of
    ``grain_stream_steps`` batches by :class:`_GrainStream`; its eval
    records carry ``stream_hit_rate``, and ``reshuffle_every > 1`` warns
    that it does not apply. Beta ramps over ``annealing_epochs * steps_per_epoch`` steps;
    the posterior noise and any presence dropout come from a generator on
    ``device`` seeded with ``seed``. The train split is loaded with the
    config's ``data_kwargs`` (mounted data where there is some) and its
    float modalities stored once as ``data_dtype`` ("bfloat16" or "uint8":
    half or a quarter of the bytes the card holds and each step reads; the
    step dequantizes uint8 in its graph, and bf16 targets go to the BCE
    kernel as they are); the test split stays float32 and is evaluated
    whole on the device or in segments of ``resolve_eval_segments(config)``
    batches (:func:`eval_elbo`). ``accum_steps > 1`` averages the
    gradients of that many steps before each update (an update may span
    two epochs); ``lr_schedule="cosine"`` warms the rate up over
    ``warmup_epochs`` and decays it over the run, in updates of the loaded
    split (``train/state.py::learning_rate``). On the card each epoch and
    each test eval run as replays of captured CUDA graphs (the eval graph
    is built once a run, on the EMA shadow when one is tracked, which the
    test ELBO is computed on). ``fault_hook(epoch, state) -> state`` is
    called after each epoch's train pass. ``dtype`` is the experts' compute
    dtype (None: float32; ``mmvae_tpu/api.py:419``): the parameters, Adam's
    state and the loss stay float32, a uint8 split dequantizes to it, and
    the checkpoints are the same at either.

    With a ``workdir``: ``config.json`` is written first; ``metrics.jsonl``
    gets a ``{"kind": "train", ...}`` record every ``log_interval`` steps
    of each epoch and one ``{"kind": "eval", ...}`` record an epoch (with
    ``ckpt_saved`` and ``ckpt_skipped`` under ``ckpt_async``); a checkpoint
    (``train/checkpoint.py``: the state and both generators) is saved
    every ``config.ckpt_every`` epochs and at the last, the best pointer
    naming the best saved epoch. ``ckpt_async`` stages every save but the
    last with an ``AsyncCheckpointWriter`` and saves the last synchronously.
    ``resume=True`` continues from the last checkpoint at the next epoch,
    with the best test ELBO restored.

    ``nan_rollback = n > 0`` (needs a workdir, ``mmvae_tpu/api.py:857-933``):
    an epoch whose train loss is not finite skips its eval, and one whose
    train loss or test ELBO is not finite is rolled back: the last
    checkpoint is restored (or, before the first, the model is built anew
    from a seed folded with ``ROLLBACK_TAG + rollbacks`` and the run starts
    again at epoch 1), both generators are reseeded with that tag, an
    ``{"kind": "event", "event": "nan_rollback", ...}`` record is written
    and the run goes on; the ``n + 1``-th such epoch raises
    ``RuntimeError``. The runners are built anew after a rollback (the
    restore makes Adam's moments anew).

    Data parallelism (``use_mesh``, ``mmvae_tpu/api.py:505``): where the
    process group (``parallel.multihost.initialize``) has more than one
    rank, every rank runs this call and the mesh (``parallel.make_mesh``)
    engages. Each rank holds the parameters, the optimizer state and the
    generators (seeded alike, so their draws stay in lockstep), and each
    step reduces the gradient once over the ranks (``train/step.py``). On
    the device backend the split is shuffled once on the host with
    ``np.random.default_rng(seed ^ 0x5EED)`` and each rank keeps its
    contiguous block (``mmvae_tpu/api.py:650-665``): the size and the batch
    must divide over the ranks, and the epochs take the per-shard orders
    and the ``"st"`` fold (``make_gather_epoch_runner``); on the grain
    backend each rank uploads its rows of every batch of the global plan,
    under the ``"b"`` fold. The test eval runs sharded (``eval_elbo``'s
    ``mesh``), every rank getting the same all-reduced ELBO, which the
    best tracking reads (the JAX multi-process run evaluates
    process-locally instead, ``:702``: the same value up to the order of
    the sums). Only rank 0 writes the config, the metrics and the
    checkpoints (each save fenced by a barrier; ``ckpt_async`` saves
    synchronously there, as the JAX multi-host run does), and every rank
    reads on resume and rollback. On the card the NCCL group's collective
    is captured in the epoch's graph; a gloo group runs the eager loop.
    ``use_mesh=False`` runs each process alone.

    FSDP and tensor parallelism (``config.fsdp``, ``config.tp``,
    ``mmvae_tpu/api.py:454-470``, ``:565-583``): ``tp < 1`` raises
    ``ValueError``, as do ``tp > 1`` with ``fsdp``, and ``tp > 1`` without
    ``use_mesh`` or with ranks that ``tp`` does not divide. ``fsdp`` on a
    multi-process mesh shards the state over it (``parallel.fsdp_shard``);
    ``tp > 1`` folds the ranks into a ``(data, model)`` mesh
    (``parallel.make_mesh_2d``), builds the model with it and shards the
    state over its model groups (``parallel.tp_shard``). The state is made
    equal on every rank first (rank 0's init), then cut; a resume and a
    rollback restore cut the whole checkpoint again. Both take JAX's
    pre-stacked epochs (``data.stacked_epoch``, shuffled by
    ``np.random.default_rng(seed)``, each rank its data shard's rows) under
    the ``"b"`` fold (the grain backend streams as under DP). The test eval
    runs on a model of the whole parameters, gathered from the blocks before
    each eval, sharded over every rank as a DP eval of those parameters;
    the checkpoints hold the whole tree (rank 0 writes), and the returned
    ``model`` holds the whole live parameters (the ``state`` keeps the
    blocks).

    Returns the config, the model (the live parameters), the train state,
    the best test ELBO and one history record per epoch this call ran (its
    mean train loss; its mean ``cycle_ce``, ``cycle_contrast``, ``align_kl``
    and ``cross_kl`` where the config's loss has them; and its test ELBO).
    """
    if isinstance(config, str):
        config = get_config(config)
    if config.nan_rollback > 0 and workdir is None:
        raise ValueError("nan_rollback needs a workdir: the rollback source is the "
                         "per-epoch checkpoint")
    if config.data_backend not in DATA_BACKENDS:
        raise ValueError(f"unknown data_backend {config.data_backend!r}; have {DATA_BACKENDS}")
    grain = config.data_backend == "grain"
    if config.reshuffle_every > 1 and grain:
        warnings.warn("reshuffle_every>1 only applies to the in-program gather path (device "
                      "backend); this run shuffles every epoch", stacklevel=2)
    device = resolve_device(device)
    tp = config.tp
    world = multihost.process_count()
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp > 1 and config.fsdp:
        raise ValueError("tp>1 and fsdp are mutually exclusive")
    if tp > 1 and (not use_mesh or world % tp):
        raise ValueError(f"tp={tp} needs use_mesh and a device count divisible by tp "
                         f"(have {world})")
    # The eval's (and DP's) mesh: every rank a data shard.
    mesh = eval_mesh = make_mesh() if use_mesh and world > 1 else None
    if tp > 1:
        mesh = make_mesh_2d(tp)
    sharded = mesh is not None and (config.fsdp or tp > 1)
    primary = multihost.is_primary()
    if workdir is not None and primary:
        _save_run_config(workdir, config)
    train_ds = load_dataset(config.dataset, "train", n=config.train_size,
                            gen_kwargs=config.data_kwargs)
    if not grain:
        # The float modalities of the train split stored once as data_dtype
        # (the test split stays f32, as the model does); the grain stream
        # casts its host copy itself.
        train_ds = dataset_astype(train_ds, config.data_dtype)
    test_ds = load_dataset(config.dataset, "test", n=config.test_size,
                           gen_kwargs=config.data_kwargs)
    eval_segs = resolve_eval_segments(config)
    bs = config.batch_size
    steps_per_epoch = train_ds.size // bs
    if steps_per_epoch == 0:
        raise ValueError(f"train split of {train_ds.size} holds no batch of {bs}")
    lr = learning_rate(config, steps_per_epoch)

    dtype = dtype or torch.float32

    def fresh_state(model_seed: int) -> TrainState:
        state = create_train_state(
            build_model(config, seed=model_seed, device=device, dtype=dtype,
                        tp_mesh=mesh if tp > 1 else None),
            lr,
            grad_clip=config.grad_clip, ema_decay=config.ema_decay,
            accum_steps=config.accum_steps,
        )
        if not sharded:
            return state
        replicate(state.tensors(), eval_mesh)
        return fsdp_shard(state, mesh) if config.fsdp else tp_shard(state, mesh)

    def replicated(state: TrainState) -> TrainState:
        if mesh is not None and not sharded:
            replicate(state.tensors(), mesh)
        return state

    state = replicated(fresh_state(seed))
    noise = torch.Generator(device=device).manual_seed(seed)
    order = torch.Generator().manual_seed(seed)
    generators = {"order": order, "noise": noise}
    start_epoch, best = 1, float("inf")
    if resume and workdir is not None and latest_epoch(workdir) is not None:
        # Before any runner: a CUDA graph holds the addresses of what the
        # load makes anew (Adam's moments).
        state, extra = load_checkpoint(workdir, state, which="last", generators=generators)
        state = replicated(state)
        start_epoch = int(extra["epoch"]) + 1
        best = float(extra["best_test_elbo"])
    # The best checkpoint pointer can only name an epoch that was saved.
    best_saved = best
    # The pre-stacked epochs' orders: epoch e takes the e-th permutation,
    # a resumed run too.
    np_rng = np.random.default_rng(seed)
    for _ in range(start_epoch - 1 if sharded else 0):
        np_rng.permutation(train_ds.size)

    # A sharded run evaluates (and returns) a model of the whole parameters.
    whole = build_model(config, seed=seed, device=device, dtype=dtype) if sharded else None

    def runners(state: TrainState) -> tuple[Callable, Callable]:
        step_kw = dict(annealing_steps=config.annealing_epochs * steps_per_epoch,
                       generator=noise, **step_options(config))
        if grain or sharded:
            train_runner = make_epoch_runner(state.compute_model, mesh=mesh,
                                             term_fold="t" if mesh is None else "b", **step_kw)
        else:
            train_runner = make_gather_epoch_runner(
                state.model, steps_per_epoch, bs, reshuffle_every=config.reshuffle_every,
                shuffle_mode=config.shuffle_mode,
                shuffle_granularity=config.shuffle_granularity, order=order, mesh=mesh,
                **step_kw)
        evaluated = state.eval_model if whole is None else whole
        return train_runner, make_eval_runner(evaluated, config.objective,
                                              config.mvtcae_alpha, mesh=eval_mesh)

    if mesh is not None and (bs % mesh.n_shards or (not grain and not sharded
                                                    and train_ds.size % mesh.n_shards)):
        raise ValueError(f"batch size {bs} and train size {train_ds.size} must divide over "
                         f"{mesh.n_shards} ranks")
    runner, evaluate = runners(state)
    stream = _GrainStream(train_ds, config, state.model, device, mesh) if grain else None
    train_arrays = None
    if not grain and not sharded:
        train_arrays = {k: torch.as_tensor(v) for k, v in train_ds.arrays.items()}
        if mesh is not None:
            # One host shuffle, so each rank's block is a random shard.
            perm = torch.as_tensor(np.random.default_rng(seed ^ 0x5EED).permutation(
                train_ds.size))
            train_arrays = shard_batch({k: v[perm] for k, v in train_arrays.items()}, mesh)
        train_arrays = {k: v.to(device) for k, v in train_arrays.items()}
    # The persisted arrangement of the split (None: the loaded order). With
    # neither a reshuffle period nor groups, each epoch permutes the loaded
    # order afresh: the same law as permuting the last epoch's, and an
    # epoch's order then does not depend on the epochs before (a resume
    # continues it exactly). The first epoch of this call, and a rollback's
    # retry, shuffle for real (the JAX loop's force_shuffle).
    persist = config.reshuffle_every > 1 or config.shuffle_granularity > 1
    pos, force_shuffle = None, True
    eval_bs = _mesh_batch(min(bs, test_ds.size), eval_mesh)
    test_split = _padded_split(test_ds, eval_bs, state.model.n_modalities,
                               device if eval_segs == 0 else None)
    if eval_mesh is not None:
        test_split = shard_batch(test_split, eval_mesh, dim=1)
    writer = MetricsWriter(workdir) if workdir is not None and primary else None
    ckpt_writer = None
    if config.ckpt_async and workdir is not None:
        if multihost.process_count() == 1:
            ckpt_writer = AsyncCheckpointWriter(workdir)
        elif verbose and primary:
            print(f"[{config.name}] ckpt_async requested but this is a multi-process run; "
                  "saves are synchronous")
    history: list[dict[str, float]] = []
    rollbacks, epoch = 0, start_epoch
    try:
        while epoch <= config.epochs:
            if grain:
                state, metrics = stream.run_epoch(
                    state, runner, _grain_seed(seed, epoch, rollbacks),
                    next_seed=(_grain_seed(seed, epoch + 1, rollbacks)
                               if epoch < config.epochs else None))
            elif sharded:  # JAX's pre-stacked mesh epochs
                batches = shard_batch(stacked_epoch(train_ds, bs, np_rng), mesh, dim=1)
                state, metrics = runner(state, {k: v.to(device) for k, v in batches.items()})
            else:
                state, pos, metrics = runner(state, train_arrays, pos if persist else None,
                                             force_shuffle)
            force_shuffle = False
            if fault_hook is not None:
                state = fault_hook(epoch, state)
            host = _fetch(metrics)
            losses = host["loss"]
            if writer is not None:
                for rec in _train_records(host, epoch, state.step - len(losses),
                                          config.log_interval):
                    writer.write(rec)
            train_finite = bool(np.isfinite(losses).all())
            test_elbo = float("nan")
            if train_finite or config.nan_rollback == 0:
                if whole is not None:
                    state.layout.gather_into(state.eval_model, whole)
                test_elbo = _split_elbo(evaluate, test_split, test_ds.size, eval_segs, device,
                                        eval_bs)
            if config.nan_rollback > 0 and not (train_finite and np.isfinite(test_elbo)):
                if rollbacks >= config.nan_rollback:
                    raise RuntimeError(
                        f"[{config.name}] epoch {epoch} went non-finite after {rollbacks} "
                        f"rollback(s) -- nan_rollback budget exhausted")
                rollbacks += 1
                if ckpt_writer is not None:
                    # The restore reads the pointer and the directories that
                    # the worker flips and prunes, and should get its newest.
                    ckpt_writer.drain()
                tag = ROLLBACK_TAG + rollbacks
                runner = evaluate = None  # their graphs hold the old tensors
                restored = latest_epoch(workdir)
                if restored is None:
                    state, restored = fresh_state(_fold(seed, tag)), 0
                else:
                    state, _ = load_checkpoint(workdir, state, which="last",
                                               generators=generators)
                state = replicated(state)
                for g in generators.values():
                    _perturb(g, tag)
                runner, evaluate = runners(state)
                if writer is not None:
                    writer.write({"kind": "event", "event": "nan_rollback",
                                  "failed_epoch": epoch, "restored_epoch": int(restored),
                                  "rollbacks": rollbacks})
                if verbose and primary:
                    print(f"[{config.name}] epoch {epoch:3d} non-finite; rolled back to epoch "
                          f"{int(restored)} ({rollbacks}/{config.nan_rollback})")
                epoch = int(restored) + 1
                force_shuffle = True
                continue
            meter = AverageMeter()
            meter.update(float(losses.mean()), len(losses) * bs)
            is_best = test_elbo < best
            best = min(best, test_elbo)
            record = {"epoch": epoch, "train_loss": meter.avg, "test_elbo": test_elbo}
            for key in _EXTRA_TRAIN_METRICS:
                if key in host:
                    record[key] = float(host[key].mean())
            history.append(record)
            if writer is not None:
                rec = {"kind": "eval", **record}
                if stream is not None:
                    rec["stream_hit_rate"] = stream.hit_rate
                if ckpt_writer is not None:
                    rec.update(ckpt_saved=ckpt_writer.saved, ckpt_skipped=ckpt_writer.skipped)
                writer.write(rec)
            if verbose and primary:
                print(
                    f"[{config.name}] epoch {epoch:3d} train {meter.avg:10.2f} "
                    f"test {test_elbo:10.2f}" + (" *best*" if is_best else "")
                )
            if ckpt_writer is not None:
                ckpt_writer.poll()
            if workdir is not None and (
                epoch % max(config.ckpt_every, 1) == 0 or epoch == config.epochs
            ):
                save = dict(is_best=test_elbo < best_saved, extra={"best_test_elbo": best},
                            keep_epochs=config.keep_epoch_ckpts, generators=generators)
                if ckpt_writer is not None and epoch != config.epochs:
                    if ckpt_writer.stage(state, epoch, **save):
                        best_saved = min(best_saved, test_elbo)
                else:
                    if ckpt_writer is not None:
                        # The last save's pointer flip is the last word.
                        ckpt_writer.finalize()
                        ckpt_writer = None
                    save_checkpoint(workdir, state, epoch, **save)
                    best_saved = min(best_saved, test_elbo)
            epoch += 1
        if ckpt_writer is not None:  # a resume of a finished run
            ckpt_writer.finalize()
            ckpt_writer = None
    finally:
        if stream is not None:
            stream.close()
        if ckpt_writer is not None:  # an exception left the loop
            ckpt_writer.finalize()
        if writer is not None:
            writer.close()
    model = state.model
    if whole is not None:
        model = state.layout.gather_into(
            state.model, build_model(config, seed=seed, device=device, dtype=dtype))
    return TrainResult(config, model, state, best, history)


def _postprocess(
    model,
    recons: dict[str, torch.Tensor],
    z: torch.Tensor,
    temperature: float | torch.Tensor,
    generator: torch.Generator | None,
    rng=None,
) -> dict[str, torch.Tensor]:
    """Decode dict -> user-facing tensors: probabilities for bernoulli
    modalities, class indices for categorical ones, and for each sequence
    modality the tokens ``model.generate_text`` draws from ``z`` (from
    ``generator``, or from the per-row streams of ``rng``, a
    ``core.rowrng.RowRng``, in the traced decode)."""
    kinds = model.decode_kinds()
    out = {}
    for key, value in recons.items():
        if kinds[key] == "bernoulli":
            out[key] = torch.sigmoid(value)
        elif kinds[key] == "categorical":
            out[key] = torch.argmax(value, dim=-1)
        else:
            raise NotImplementedError(
                f"generating {kinds[key]!r} modalities is not yet ported"
            )
    for spec in model.specs():
        if spec.kind == "seq":
            out[spec.name] = model.generate_text(z, temperature, generator, rng)
    return out


@torch.no_grad()
def generate(
    config: str | ExperimentConfig,
    condition: dict[str, Any],
    *,
    n: int | None = None,
    model=None,
    state_dict: dict[str, torch.Tensor] | None = None,
    workdir: str | None = None,
    which: str = "best",
    device: torch.device | str | None = None,
    sample_z: bool = False,
    temperature: float = 1.0,
    generator: torch.Generator | None = None,
    component: torch.Tensor | None = None,
    eps: torch.Tensor | None = None,
    dtype: torch.dtype | None = None,
) -> dict[str, torch.Tensor]:
    """Cross-modal generation from any modality subset.

    ``condition`` maps batch keys or modality names to observed values
    (empty: prior sampling). A batch key that carries several modalities
    observes them all (CelebA's ``attrs``, ``(n, 18)``); a modality that
    is one column of such a key is observed alone (``attr_i``, ``(n,)``),
    as in the JAX ``generate``. The whole batch is encoded, with absent
    modalities as zeros that the presence mask leaves out; the observed
    experts are fused with the prior under the config's objective
    (``core.fuse_observed_z``: the PoE for mvae and mvtcae, the mixture over
    the observed set for mmvae and mopoe); z is the posterior mean (the
    mixture's mean), or a draw from ``generator`` (on ``device``) when
    ``sample_z``, or from ``component`` ``(n,)`` and ``eps`` ``(n, L)``
    when given (a mixture's component index and the noise, for parity with
    the JAX ``generate``'s draw); a row that observes nothing falls back to
    the prior. ALL modalities are decoded. A sequence modality is generated token by token: argmax
    when ``temperature <= 0``, else a draw at ``temperature`` from
    ``generator``. The weights come as in :func:`eval_elbo` (``model``,
    ``state_dict``, or ``workdir``'s checkpoint ``which``), at the compute
    ``dtype``.
    """
    config, model, device = _resolve(config, model, state_dict, device, workdir, which)
    names = [s.name for s in model.specs()]
    if n is None:
        n = len(next(iter(condition.values()))) if condition else 1
    batch = model.dummy_batch(n)
    carried = model.batch_modalities()
    columns = {m: (key, j) for key, mods in carried.items() if len(mods) > 1
               for j, m in enumerate(mods)}
    presence = torch.zeros((n, len(names)), device=device)
    # Single columns first, so that a whole key given beside them wins,
    # as in the JAX ``generate``.
    for key, value in sorted(condition.items(), key=lambda kv: kv[0] not in columns):
        if key in columns:
            stacked, j = columns[key]
            batch[stacked][:, j] = torch.as_tensor(
                value, dtype=batch[stacked].dtype, device=device
            )
            presence[:, names.index(key)] = 1.0
        elif key in batch:
            batch[key] = torch.as_tensor(value, dtype=batch[key].dtype, device=device)
            for m in carried[key]:
                presence[:, names.index(m)] = 1.0
        else:
            raise ValueError(
                f"unknown modality {key!r}; have {list(batch) + list(columns)}"
            )
    with model.at_dtype(dtype):
        mu_e, lv_e = model.encode(batch)
        z = fuse_observed_z(
            mu_e, lv_e, presence, config.objective, sample=sample_z,
            generator=generator, component=component, eps=eps,
        )
        return _postprocess(model, model.decode(z), z, temperature, generator)


def sample(
    config: str | ExperimentConfig,
    n: int = 64,
    *,
    model=None,
    state_dict: dict[str, torch.Tensor] | None = None,
    workdir: str | None = None,
    which: str = "best",
    device: torch.device | str | None = None,
    temperature: float = 1.0,
    generator: torch.Generator | None = None,
    dtype: torch.dtype | None = None,
) -> dict[str, torch.Tensor]:
    """Unconditional samples: z ~ N(0, I) decoded into every modality
    (the weights and ``dtype`` as in :func:`generate`)."""
    return generate(
        config, {}, n=n, model=model, state_dict=state_dict, workdir=workdir, which=which,
        device=device, sample_z=True, temperature=temperature, generator=generator,
        dtype=dtype,
    )
