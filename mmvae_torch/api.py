"""User-facing entry points (port of ``mmvae_tpu/api.py``).

  * :func:`train` -- train a config from its seeded init (``api.py:414``),
    without checkpoints yet;
  * :func:`eval_elbo` -- mean multi-term ELBO over a split (``api.py:1013``);
  * :func:`generate` -- cross-modal generation from any observed subset
    (``api.py:1504``);
  * :func:`sample` -- unconditional samples (``api.py:1474``).

Every entry point runs on ``device``, which defaults to the card
(``torch.device("cuda")``) and raises when there is none; pass
``device="cpu"`` to run on the CPU. Weights come from a ``model`` the
caller built (``configs.build_model``, or ``convert.from_flax_params``
loaded into it), a ``state_dict``, or :func:`train`'s result; checkpoints
are not ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from mmvae_torch.configs import (
    UNPORTED_TRAIN_FIELDS,
    ExperimentConfig,
    build_model,
    get_config,
)
from mmvae_torch.core import fuse_observed_z
from mmvae_torch.data import Dataset, load_dataset, stacked_epoch_padded
from mmvae_torch.device import resolve_device
from mmvae_torch.train import (
    TrainState,
    create_train_state,
    make_epoch_runner,
    make_eval_runner,
)

__all__ = ["TrainResult", "train", "step_options", "eval_elbo", "generate", "sample"]


def _resolve(config, model, state_dict, device):
    if isinstance(config, str):
        config = get_config(config)
    device = resolve_device(device)
    if model is None:
        if state_dict is None:
            raise ValueError("need a model or a state_dict")
        model = build_model(config, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return config, model.to(device), device


def eval_elbo(
    config: str | ExperimentConfig,
    *,
    model=None,
    state_dict: dict[str, torch.Tensor] | None = None,
    dataset: Dataset | None = None,
    batch_size: int | None = None,
    device: torch.device | str | None = None,
) -> float:
    """Mean multi-term ELBO over a split, beta = 1 and z = posterior mean.

    ``dataset`` defaults to the config's synthetic test split. The split
    is padded to whole batches (wrapping to its front); the validity mask
    is the presence mask, so pad rows contribute 0 and the result is
    ``sum(batch losses) * bs / size``.
    """
    config, model, device = _resolve(config, model, state_dict, device)
    if dataset is None:
        dataset = load_dataset(config.dataset, "test", n=config.test_size)
    batch_size = min(batch_size or config.batch_size, dataset.size)
    stacked = _padded_split(dataset, batch_size, model.n_modalities, device)
    return _split_elbo(model, config.objective, stacked, dataset.size)


def _padded_split(
    dataset: Dataset, batch_size: int, n_modalities: int, device: torch.device
) -> dict[str, torch.Tensor]:
    """The split stacked into whole batches on ``device``, the last padded,
    with the validity mask as an all-modalities ``presence``."""
    batches, valid = stacked_epoch_padded(dataset, batch_size)
    stacked = {k: torch.as_tensor(v, device=device) for k, v in batches.items()}
    stacked["presence"] = (
        torch.as_tensor(valid, device=device)[..., None].expand(-1, -1, n_modalities)
    )
    return stacked


def _split_elbo(model, objective: str, stacked: dict[str, torch.Tensor], size: int) -> float:
    """Mean ELBO of a :func:`_padded_split` of ``size`` examples: the pad
    rows contribute 0, so it is ``sum(batch losses) * bs / size``."""
    metrics = make_eval_runner(model, objective)(stacked)
    return float(metrics["loss"].sum()) * stacked["presence"].shape[1] / size


class TrainResult(NamedTuple):
    config: ExperimentConfig
    model: Any
    state: TrainState
    best_test_elbo: float
    history: list[dict[str, float]]


def _check_trainable(config: ExperimentConfig) -> None:
    """Raise on a config that sets a training feature not ported yet."""
    set_knobs = [k for k in UNPORTED_TRAIN_FIELDS if getattr(config, k)]
    if set_knobs:
        raise NotImplementedError(
            f"config {config.name!r} sets {set_knobs}: not yet ported to mmvae_torch"
        )


def step_options(config: ExperimentConfig) -> dict[str, Any]:
    """The keywords of ``make_train_step`` (and ``make_epoch_runner``) that
    ``config`` sets: presence dropout and the loss's options
    (``mmvae_tpu/api.py:591-613``)."""
    return dict(
        p_modality_drop=config.p_modality_drop,
        cross_recon=config.cross_recon,
        cross_recon_weight=config.cross_recon_weight,
        cycle_weight=config.cycle_weight,
        cycle_render_grad=config.cycle_render_grad,
        cycle_render_binarize=config.cycle_render_binarize,
        objective=config.objective,
        member_prune=config.member_prune,
    )


def train(
    config: str | ExperimentConfig,
    workdir: str | None = None,
    *,
    seed: int = 0,
    device: torch.device | str | None = None,
    resume: bool = False,
    verbose: bool = True,
    fault_hook=None,
) -> TrainResult:
    """Train ``config`` from its seeded init, evaluating the test split
    after each epoch (``mmvae_tpu/api.py:414``, single device).

    Each epoch takes a fresh permutation of the train split from a
    ``torch.Generator`` seeded with ``seed`` (what the JAX defaults,
    ``reshuffle_every=1`` and ``shuffle_granularity=1``, give), in whole
    batches; beta ramps over ``annealing_epochs * steps_per_epoch`` steps;
    the posterior noise and any presence dropout come from a generator on
    ``device`` seeded with ``seed``. The test ELBO is computed on the EMA
    parameters when they are tracked. Returns the config, the model (the
    live parameters), the train state, the best test ELBO and one history
    record per epoch (its mean train loss, its mean ``cycle_ce`` where the
    config has the cycle term, and its test ELBO). ``workdir``, ``resume``
    and ``fault_hook`` (checkpoints, failure recovery) are not ported yet
    and raise, as does a config that sets a training feature not ported
    yet.
    """
    if isinstance(config, str):
        config = get_config(config)
    for name, given in (("workdir", workdir is not None), ("resume", resume),
                        ("fault_hook", fault_hook is not None)):
        if given:
            raise NotImplementedError(f"train({name}=...) is not yet ported to mmvae_torch")
    _check_trainable(config)
    device = resolve_device(device)
    model = build_model(config, seed=seed, device=device)
    train_ds = load_dataset(config.dataset, "train", n=config.train_size)
    test_ds = load_dataset(config.dataset, "test", n=config.test_size)
    bs = config.batch_size
    steps_per_epoch = train_ds.size // bs
    if steps_per_epoch == 0:
        raise ValueError(f"train split of {train_ds.size} holds no batch of {bs}")
    state = create_train_state(
        model, config.learning_rate, grad_clip=config.grad_clip,
        ema_decay=config.ema_decay,
    )
    runner = make_epoch_runner(
        model,
        annealing_steps=config.annealing_epochs * steps_per_epoch,
        generator=torch.Generator(device=device).manual_seed(seed),
        **step_options(config),
    )
    order = torch.Generator().manual_seed(seed)
    train_arrays = {k: torch.as_tensor(v, device=device) for k, v in train_ds.arrays.items()}
    test_split = _padded_split(
        test_ds, min(bs, test_ds.size), model.n_modalities, device
    )
    best = float("inf")
    history: list[dict[str, float]] = []
    for epoch in range(1, config.epochs + 1):
        perm = torch.randperm(train_ds.size, generator=order)[: steps_per_epoch * bs]
        perm = perm.to(device)
        batches = {
            k: v[perm].reshape((steps_per_epoch, bs) + v.shape[1:])
            for k, v in train_arrays.items()
        }
        state, metrics = runner(state, batches)
        train_loss = float(metrics["loss"].mean())
        test_elbo = _split_elbo(state.eval_model, config.objective, test_split, test_ds.size)
        is_best = test_elbo < best
        best = min(best, test_elbo)
        record = {"epoch": epoch, "train_loss": train_loss, "test_elbo": test_elbo}
        if "cycle_ce" in metrics:
            record["cycle_ce"] = float(metrics["cycle_ce"].mean())
        history.append(record)
        if verbose:
            print(
                f"[{config.name}] epoch {epoch:3d} train {train_loss:10.2f} "
                f"test {test_elbo:10.2f}" + (" *best*" if is_best else "")
            )
    return TrainResult(config, model, state, best, history)


def _postprocess(
    model,
    recons: dict[str, torch.Tensor],
    z: torch.Tensor,
    temperature: float,
    generator: torch.Generator | None,
) -> dict[str, torch.Tensor]:
    """Decode dict -> user-facing tensors: probabilities for bernoulli
    modalities, class indices for categorical ones, and for each sequence
    modality the tokens ``model.generate_text`` draws from ``z``."""
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
            out[spec.name] = model.generate_text(z, temperature, generator)
    return out


@torch.no_grad()
def generate(
    config: str | ExperimentConfig,
    condition: dict[str, Any],
    *,
    n: int | None = None,
    model=None,
    state_dict: dict[str, torch.Tensor] | None = None,
    device: torch.device | str | None = None,
    sample_z: bool = False,
    temperature: float = 1.0,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Cross-modal generation from any modality subset.

    ``condition`` maps batch keys or modality names to observed values
    (empty: prior sampling). A batch key that carries several modalities
    observes them all (CelebA's ``attrs``, ``(n, 18)``); a modality that
    is one column of such a key is observed alone (``attr_i``, ``(n,)``),
    as in the JAX ``generate``. The whole batch is encoded, with absent
    modalities as zeros that the presence mask leaves out; the observed
    experts are fused with the prior; z is the posterior mean, or a draw
    from ``generator`` (on ``device``) when ``sample_z``; ALL modalities
    are decoded. A sequence modality is generated token by token: argmax
    when ``temperature <= 0``, else a draw at ``temperature`` from
    ``generator``.
    """
    config, model, device = _resolve(config, model, state_dict, device)
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
        generator=generator,
    )
    return _postprocess(model, model.decode(z), z, temperature, generator)


def sample(
    config: str | ExperimentConfig,
    n: int = 64,
    *,
    model=None,
    state_dict: dict[str, torch.Tensor] | None = None,
    device: torch.device | str | None = None,
    temperature: float = 1.0,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Unconditional samples: z ~ N(0, I) decoded into every modality."""
    return generate(
        config, {}, n=n, model=model, state_dict=state_dict, device=device,
        sample_z=True, temperature=temperature, generator=generator,
    )
