"""User-facing entry points (port of ``mmvae_tpu/api.py``).

  * :func:`train` -- train a config from its seeded init (``api.py:414``),
    into a workdir (``config.json``, ``metrics.jsonl``, checkpoints) when
    one is given, and resume from it; with gradient accumulation, the
    cosine LR schedule, ``nan_rollback`` and overlapped saves
    (``ckpt_async``) where the config asks for them;
  * :func:`eval_elbo` -- mean multi-term ELBO over a split (``api.py:1013``);
  * :func:`log_likelihood` -- mean IWAE estimate of log p(x) over a split
    (``api.py:1212``);
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
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from mmvae_torch.configs import ExperimentConfig, build_model, get_config
from mmvae_torch.core import fuse_observed_z
from mmvae_torch.data import Dataset, load_dataset, stacked_epoch_padded
from mmvae_torch.device import resolve_device
from mmvae_torch.train import (
    TrainState,
    create_train_state,
    make_epoch_runner,
    make_eval_runner,
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
    return ExperimentConfig(**d)


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
    """The config, the model with its weights, and the device. With no
    ``model`` and no ``state_dict`` the weights come from ``workdir``."""
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
) -> float:
    """Mean multi-term ELBO over a split, beta = 1 and z = posterior mean.

    The weights are ``model``'s, ``state_dict``'s, or those of
    ``workdir``'s checkpoint ``which`` ("best", else "last"; the EMA
    weights where tracked), whose saved config is used when ``config``
    names it. ``dataset`` defaults to the config's synthetic ``split``
    ("test" or "train") of ``config.test_size`` examples
    (``mmvae_tpu/api.py:1020``).
    The split is padded to whole batches (wrapping to its front); the
    validity mask is the presence mask, so pad rows contribute 0 and the
    result is ``sum(batch losses) * bs / size``.
    """
    config, model, device = _resolve(config, model, state_dict, device, workdir, which)
    if dataset is None:
        dataset = load_dataset(config.dataset, split, n=config.test_size)
    batch_size = min(batch_size or config.batch_size, dataset.size)
    stacked = _padded_split(dataset, batch_size, model.n_modalities, device)
    runner = make_eval_runner(model, config.objective, config.mvtcae_alpha)
    return _split_elbo(runner, stacked, dataset.size)


def _padded_split(
    dataset: Dataset, batch_size: int, n_modalities: int, device: torch.device
) -> dict[str, torch.Tensor]:
    """The split stacked into whole batches on ``device``, the last padded,
    with the validity mask as an all-modalities ``presence``."""
    stacked = _valid_split(dataset, batch_size, device)
    stacked["presence"] = stacked.pop("valid")[..., None].expand(-1, -1, n_modalities)
    return stacked


def _valid_split(
    dataset: Dataset, batch_size: int, device: torch.device
) -> dict[str, torch.Tensor]:
    """The split stacked into whole batches on ``device``, the last padded
    (wrapping to its front), with its ``(n_batches, bs)`` ``valid`` mask."""
    batches, valid = stacked_epoch_padded(dataset, batch_size)
    stacked = {k: torch.as_tensor(v, device=device) for k, v in batches.items()}
    stacked["valid"] = torch.as_tensor(valid, device=device)
    return stacked


def _split_elbo(runner: Callable, stacked: dict[str, torch.Tensor], size: int) -> float:
    """Mean ELBO of a :func:`_padded_split` of ``size`` examples through an
    eval ``runner`` (``make_eval_runner``): the pad rows contribute 0, so
    it is ``sum(batch losses) * bs / size``."""
    metrics = runner(stacked)
    return float(metrics["loss"].sum()) * stacked["presence"].shape[1] / size


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
    ``fold_in(key(seed), i)``, which torch cannot reproduce). The JAX
    ``mesh`` and ``segment_steps`` are not ported.
    """
    config, model, device = _resolve(config, model, state_dict, device, workdir, which)
    if dataset is None:
        dataset = load_dataset(config.dataset, split, n=config.test_size)
    batch_size = min(batch_size or config.batch_size, dataset.size)
    stacked = _valid_split(dataset, batch_size, device)
    if eps is not None:
        eps = torch.as_tensor(eps, dtype=torch.float32, device=device)
        want = (*stacked["valid"].shape, k, model.n_latents)
        if tuple(eps.shape) != want:
            raise ValueError(f"eps must be {want}, got {tuple(eps.shape)}")
        stacked["eps"] = eps
    runner = make_iwae_runner(
        model, k, generator=torch.Generator(device=device).manual_seed(seed))
    return float(runner(stacked)["log_likelihood"].double().sum()) / dataset.size


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
) -> TrainResult:
    """Train ``config`` from its seeded init, evaluating the test split
    after each epoch (``mmvae_tpu/api.py:414``, single device).

    Each epoch takes a fresh permutation of the train split from a
    ``torch.Generator`` seeded with ``seed`` (what the JAX defaults,
    ``reshuffle_every=1`` and ``shuffle_granularity=1``, give), in whole
    batches; beta ramps over ``annealing_epochs * steps_per_epoch`` steps;
    the posterior noise and any presence dropout come from a generator on
    ``device`` seeded with ``seed``. ``accum_steps > 1`` averages the
    gradients of that many steps before each update (an update may span
    two epochs); ``lr_schedule="cosine"`` warms the rate up over
    ``warmup_epochs`` and decays it over the run, in updates of the loaded
    split (``train/state.py::learning_rate``). On the card each epoch and
    each test eval run as replays of captured CUDA graphs (the eval graph
    is built once a run, on the EMA shadow when one is tracked, which the
    test ELBO is computed on). ``fault_hook(epoch, state) -> state`` is
    called after each epoch's train pass.

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
    device = resolve_device(device)
    if workdir is not None:
        _save_run_config(workdir, config)
    train_ds = load_dataset(config.dataset, "train", n=config.train_size)
    test_ds = load_dataset(config.dataset, "test", n=config.test_size)
    bs = config.batch_size
    steps_per_epoch = train_ds.size // bs
    if steps_per_epoch == 0:
        raise ValueError(f"train split of {train_ds.size} holds no batch of {bs}")
    lr = learning_rate(config, steps_per_epoch)

    def fresh_state(model_seed: int) -> TrainState:
        return create_train_state(
            build_model(config, seed=model_seed, device=device), lr,
            grad_clip=config.grad_clip, ema_decay=config.ema_decay,
            accum_steps=config.accum_steps,
        )

    state = fresh_state(seed)
    noise = torch.Generator(device=device).manual_seed(seed)
    order = torch.Generator().manual_seed(seed)
    generators = {"order": order, "noise": noise}
    start_epoch, best = 1, float("inf")
    if resume and workdir is not None and latest_epoch(workdir) is not None:
        # Before any runner: a CUDA graph holds the addresses of what the
        # load makes anew (Adam's moments).
        state, extra = load_checkpoint(workdir, state, which="last", generators=generators)
        start_epoch = int(extra["epoch"]) + 1
        best = float(extra["best_test_elbo"])
    # The best checkpoint pointer can only name an epoch that was saved.
    best_saved = best

    def runners(state: TrainState) -> tuple[Callable, Callable]:
        return (
            make_epoch_runner(
                state.model, annealing_steps=config.annealing_epochs * steps_per_epoch,
                generator=noise, **step_options(config)),
            make_eval_runner(state.eval_model, config.objective, config.mvtcae_alpha),
        )

    runner, evaluate = runners(state)
    train_arrays = {k: torch.as_tensor(v, device=device) for k, v in train_ds.arrays.items()}
    test_split = _padded_split(
        test_ds, min(bs, test_ds.size), state.model.n_modalities, device
    )
    writer = MetricsWriter(workdir) if workdir is not None else None
    ckpt_writer = (AsyncCheckpointWriter(workdir)
                   if config.ckpt_async and workdir is not None else None)
    history: list[dict[str, float]] = []
    rollbacks, epoch = 0, start_epoch
    try:
        while epoch <= config.epochs:
            perm = torch.randperm(train_ds.size, generator=order)[: steps_per_epoch * bs]
            perm = perm.to(device)
            batches = {
                k: v[perm].reshape((steps_per_epoch, bs) + v.shape[1:])
                for k, v in train_arrays.items()
            }
            state, metrics = runner(state, batches)
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
                test_elbo = _split_elbo(evaluate, test_split, test_ds.size)
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
                for g in generators.values():
                    _perturb(g, tag)
                runner, evaluate = runners(state)
                writer.write({"kind": "event", "event": "nan_rollback", "failed_epoch": epoch,
                              "restored_epoch": int(restored), "rollbacks": rollbacks})
                if verbose:
                    print(f"[{config.name}] epoch {epoch:3d} non-finite; rolled back to epoch "
                          f"{int(restored)} ({rollbacks}/{config.nan_rollback})")
                epoch = int(restored) + 1
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
                if ckpt_writer is not None:
                    rec.update(ckpt_saved=ckpt_writer.saved, ckpt_skipped=ckpt_writer.skipped)
                writer.write(rec)
            if verbose:
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
        if ckpt_writer is not None:  # an exception left the loop
            ckpt_writer.finalize()
        if writer is not None:
            writer.close()
    return TrainResult(config, state.model, state, best, history)


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
    ``state_dict``, or ``workdir``'s checkpoint ``which``).
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
) -> dict[str, torch.Tensor]:
    """Unconditional samples: z ~ N(0, I) decoded into every modality
    (the weights as in :func:`generate`)."""
    return generate(
        config, {}, n=n, model=model, state_dict=state_dict, workdir=workdir, which=which,
        device=device, sample_z=True, temperature=temperature, generator=generator,
    )
